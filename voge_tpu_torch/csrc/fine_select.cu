// K2: streaming top-K select with fused erf weights and fused attribute image.
//
// Replaces voge_tpu/ops/pallas_fine2.py::_kernel_tc (reached through
// fine_select_compact_pallas <- fine._rt_fine_compact_impl).  For every ray
// of a supertile (2x2 bins of bs x bs pixels) it streams the supertile's
// emission-compacted candidate rows in ascending order and keeps the K
// nearest passing hits by ascending length:
//   msk = A.r, ksk = r^T Lambda r, len = msk / ksk,
//   act = d^T Lambda d with d = mu - len * r  (the compensated residual form),
//   pass iff act < thr_act and the ray's sub-bin bit is set in the row's bits.
// At the flush it writes idx / len / act / dsd, the erf compositing weights
//   w_j = exp(-ow * sum_k e^{-act_k} (erf((l_j - l_k) sqrt(dsd_k + 1e-10)) + 1) / 2)
//         * e^{-act_j} * e^{0.5}
// and, given attributes, img = sum_k w_k attrs[idx_k], straight into image
// layout (B, H, W, K) / (B, H, W, d).
//
// Design.  A block is 128 rays of one supertile (grid: supertiles x ray
// chunks), one thread per ray.  Candidate rows (16 features + bits, 68 B) are
// staged through shared memory in tiles of 128; every thread reads the same
// row at once (a broadcast).  The running top-K lives in registers: the
// kernel is templated on a K bucket (8/16/32/64/128) and the insertion loop is
// fully unrolled, so at K <= 32 the (len, act, dsd, slot) arrays never touch
// local memory.  Insertion uses strict '<' and then shifts, so an earlier
// candidate wins a tie (ray_trace_voge.cu:197-213, pallas_fine2.py:25-28).
// The hit bitmap, visit lists and the any-hit gate of the TPU kernel are
// skip machinery for its lockstep grid and are left out.
//
// What bounds it on the H100: not throughput.  At the 10K-Gaussian headline
// (256x256, bin 10) the 169 supertiles hold 19,492 candidate rows (1.3 MB),
// and only 3.0M (ray, candidate) pairs pass the sub-bin test: ~0.15 GFLOP,
// microseconds of FP32 issue.  The time (~0.5 ms on an H100) is set by
// latency: each thread walks its supertile's rows in order, the densest
// supertile holds 767 rows against a mean of 115, and the K=20 bucket uses
// 255 registers, so few warps hide the division and shared-memory latency.
// Splitting dense supertiles across blocks and a merge of partial top-Ks is
// the next step for speed.
//
// Exactness: compiled with -fmad=false.  The TPU kernel evaluates the hit
// test as separate multiplies and adds on its vector unit; keeping every
// product rounded once makes this kernel agree with the plain PyTorch
// version (ops/cuda_fine.py::fine_select_plain) to the last bit for
// len / act / dsd, so both select the same candidates.  Only the weights
// (erff / expf inside libdevice) may differ by an ulp.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attr_merge.cuh"

namespace {

constexpr int THREADS = 128;  // rays per block
constexpr int TILE = 128;     // candidate rows staged per step
constexpr float INF = 1e10f;  // fill for len / act
constexpr float E_HALF = 1.6487212707001282f;

struct Args {
  const float* rays;   // (B, H, W, 3)
  const float* table;  // (nb, M, 16) feature rows
  const int* bits;     // (nb, M) sub-bin membership bits
  const int* ids;      // (nb, M) global flattened ids
  const int* counts;   // (nb,) occupied rows
  const float* attrs;  // (n_rows, d) or null
  int* o_idx;          // (B, H, W, K)
  float* o_len;
  float* o_act;
  float* o_dsd;
  float* o_w;
  float* o_img;        // (B, H, W, d) or null
  int H, W, bs, BW2, nst, M, K, d;
  long long n_rows;
  float thr_act, ow;
};

template <int KB>
__device__ __forceinline__ void composite_weights(const float (&tl)[KB],
                                                  float (&ea)[KB],
                                                  const float (&sq)[KB], int K,
                                                  float ow, float* w_out) {
  // pallas_fine2.py:386-406, summed over k < K in ascending order
  if constexpr (KB <= 32) {
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      if (j < K) {
        float occ = 0.0f;
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          if (k < K) {
            const float ca = (tl[j] - tl[k]) * sq[k];
            occ = occ + ea[k] * (0.5f * (erff(ca) + 1.0f));
          }
        }
        w_out[j] = expf(-ow * occ) * ea[j] * E_HALF;
      }
    }
  } else {
#pragma unroll 1
    for (int j = 0; j < K; ++j) {
      float occ = 0.0f;
#pragma unroll 1
      for (int k = 0; k < K; ++k) {
        const float ca = (tl[j] - tl[k]) * sq[k];
        occ = occ + ea[k] * (0.5f * (erff(ca) + 1.0f));
      }
      w_out[j] = expf(-ow * occ) * ea[j] * E_HALF;
    }
  }
}

template <int KB>
__global__ void __launch_bounds__(THREADS) fine_select_kernel(const Args a) {
  __shared__ float4 s_tab[TILE * 4];
  __shared__ int s_bits[TILE];

  const int s = blockIdx.x;  // supertile row: b * nst + sy * BW2 + sx
  const int b = s / a.nst;
  const int sy = (s % a.nst) / a.BW2;
  const int sx = (s % a.nst) % a.BW2;
  const int st = 2 * a.bs;
  const int r = blockIdx.y * THREADS + threadIdx.x;
  const int lr = r / st, lc = r % st;
  const int y = sy * st + lr, x = sx * st + lc;
  const bool live = (r < st * st) && (y < a.H) && (x < a.W);
  if (!__syncthreads_or(live)) return;
  const int g = 2 * (lr / a.bs) + (lc / a.bs);  // sub-bin: bit 2*iy + ix

  float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
  const size_t pix = ((size_t)b * a.H + y) * a.W + x;
  if (live) {
    r0 = a.rays[pix * 3 + 0];
    r1 = a.rays[pix * 3 + 1];
    r2 = a.rays[pix * 3 + 2];
  }
  const float rv[3] = {r0, r1, r2};
  float rr[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) rr[3 * i + j] = rv[i] * rv[j];

  float tl[KB], ta[KB], td[KB];
  int ts[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    tl[k] = INF;
    ta[k] = INF;
    td[k] = 0.0f;
    ts[k] = -1;
  }

  const int cnt = a.counts[s];
  const float4* rows = reinterpret_cast<const float4*>(a.table + (size_t)s * a.M * 16);
  const int* brow = a.bits + (size_t)s * a.M;
  for (int c0 = 0; c0 < cnt; c0 += TILE) {
    const int n = min(TILE, cnt - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < n * 4; t += THREADS) s_tab[t] = rows[(size_t)c0 * 4 + t];
    for (int t = threadIdx.x; t < n; t += THREADS) s_bits[t] = brow[c0 + t];
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < n; ++c) {
      if (!((s_bits[c] >> g) & 1)) continue;
      const float* f = reinterpret_cast<const float*>(s_tab + 4 * c);
      // pallas_fine2.py:273-303, same association
      float msk = f[0] * r0;
      msk = msk + f[1] * r1;
      msk = msk + f[2] * r2;
      float ksk = f[4] * rr[0];
#pragma unroll
      for (int q = 1; q < 9; ++q) ksk = ksk + f[4 + q] * rr[q];
      const float len = msk / ksk;
      const float d0 = f[13] - len * r0;
      const float d1 = f[14] - len * r1;
      const float d2 = f[15] - len * r2;
      const float e0 = (d0 * f[4] + d1 * f[7]) + d2 * f[10];
      const float e1 = (d0 * f[5] + d1 * f[8]) + d2 * f[11];
      const float e2 = (d0 * f[6] + d1 * f[9]) + d2 * f[12];
      const float act = (e0 * d0 + e1 * d1) + e2 * d2;
      if (!(act < a.thr_act) || !(len < tl[KB - 1])) continue;
      // stable insertion: strict '<' finds the slot, then everything shifts
      float cl = len, ca = act, cd = ksk;
      int cs = c0 + c;
      bool shift = false;
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const bool take = shift || (cl < tl[k]);
        if (take) {
          const float xl = tl[k], xa = ta[k], xd = td[k];
          const int xs = ts[k];
          tl[k] = cl; ta[k] = ca; td[k] = cd; ts[k] = cs;
          cl = xl; ca = xa; cd = xd; cs = xs;
        }
        shift = take;
      }
    }
  }
  if (!live) return;

  const size_t o = pix * a.K;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (k < a.K) {
      a.o_idx[o + k] = ts[k] >= 0 ? a.ids[(size_t)s * a.M + ts[k]] : -1;
      a.o_len[o + k] = tl[k];
      a.o_act[o + k] = ta[k];
      a.o_dsd[o + k] = td[k];
    }
  }
  // e^{-act} and sqrt(dsd + 1e-10) once per slot, in place
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    ta[k] = expf(-ta[k]);
    td[k] = sqrtf(td[k] + 1e-10f);
  }
  composite_weights<KB>(tl, ta, td, a.K, a.ow, a.o_w + o);
  if (a.o_img != nullptr) {
    for (int ch = 0; ch < a.d; ++ch)
      a.o_img[pix * a.d + ch] = voge_attr_merge_one(
          a.o_idx + o, a.o_w + o, a.K, a.attrs, a.n_rows, a.d, ch);
  }
}

template <int KB>
cudaError_t launch(const Args& a, int nb, cudaStream_t stream) {
  const int st = 2 * a.bs;
  const dim3 grid(nb, (st * st + THREADS - 1) / THREADS);
  fine_select_kernel<KB><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int voge_fine_select(
    const void* rays, const void* table, const void* bits, const void* ids,
    const void* counts, const void* attrs, void* o_idx, void* o_len,
    void* o_act, void* o_dsd, void* o_w, void* o_img, int nb, int H, int W,
    int bs, int BW2, int nst, int M, int K, int d, long long n_rows,
    float thr_act, float ow, void* stream) {
  if (nb <= 0 || bs <= 0 || K <= 0 || K > 128) return (int)cudaErrorInvalidValue;
  Args a;
  a.rays = (const float*)rays;
  a.table = (const float*)table;
  a.bits = (const int*)bits;
  a.ids = (const int*)ids;
  a.counts = (const int*)counts;
  a.attrs = (const float*)attrs;
  a.o_idx = (int*)o_idx;
  a.o_len = (float*)o_len;
  a.o_act = (float*)o_act;
  a.o_dsd = (float*)o_dsd;
  a.o_w = (float*)o_w;
  a.o_img = (float*)o_img;
  a.H = H; a.W = W; a.bs = bs; a.BW2 = BW2; a.nst = nst; a.M = M; a.K = K;
  a.d = d; a.n_rows = n_rows; a.thr_act = thr_act; a.ow = ow;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (K <= 8) err = launch<8>(a, nb, s);
  else if (K <= 16) err = launch<16>(a, nb, s);
  else if (K <= 32) err = launch<32>(a, nb, s);
  else if (K <= 64) err = launch<64>(a, nb, s);
  else err = launch<128>(a, nb, s);
  return (int)err;
}

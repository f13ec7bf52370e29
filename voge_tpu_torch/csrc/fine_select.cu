// K2: streaming top-K select with fused erf weights and fused attribute image.
//
// Three entries share one kernel.  Two replace
// voge_tpu/ops/pallas_fine2.py::_kernel_tc through both of its entries:
//  - compacted (voge_fine_select; fine_select_compact_pallas <-
//    fine._rt_fine_compact_impl): the candidates of a supertile are its
//    emission-compacted rows (nb, M, 16), with their ids and counts;
//  - global (voge_fine_select_global; fine_select_mask_pallas <-
//    fine._rt_fine_kern, the no-coarse path): the candidates of supertile s
//    are all P Gaussians of its image b = s / nst, read in place from one
//    (B * P, 16) table (no copy per supertile), slot n has id b * P + n, and
//    the sub-bin bits come from an optional (nb, P) plane (null: every
//    Gaussian is a member of every sub-bin, which is what no-coarse means).
// The third replaces voge_tpu/ops/pallas_fine.py::_kernel (fine_select_pallas
// <- fine._fine_forward, the public two-stage tracer ray_tracing_fine):
//  - per-bin lists (voge_fine_select_bins): a block's rays are those of one
//    bin (bsh x bsw pixels), its candidates the bin's list of flattened ids
//    (nb, M), -1 where empty; each staged row is gathered from the
//    (B * P, 16) table by its id, every listed Gaussian is a member of the
//    whole bin (no bits test), and no weights or image are written.  The TPU
//    kernel extracts K minima from a dense (rays x candidates) block, the
//    lowest lane winning a tie; streaming the list in order with the stable
//    insertion below keeps the same K in the same order.
// For every ray of a supertile (2x2 bins of bs x bs pixels) it streams the
// candidates in ascending order and keeps the K nearest passing hits by
// ascending length:
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
// The 64 and 128 buckets cannot live in registers: they keep K slots in
// thread-private memory with dynamic indices, insert from the far end over
// the occupied slots only, and composite the weights over the occupied slots
// from the values just written.  (Unrolled like the small buckets they
// spilled 11 KB a thread, and at the texture shapes, 172,032 rays at K = 80
// with at most 19 hits a ray, the 128 bucket took 1.65 s a render on an H100
// 80GB HBM3 at 700 W, nearly all of it the K^2 weight sweep over the spilled
// arrays; in this form it takes 5.9 ms there.)
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
// The global entry is bound the same way, by arithmetic latency: at the
// ShapeFitting step (5 views, 128x128, bin 10: 245 supertiles of 400 rays,
// 2,562 Gaussians) every ray tests every Gaussian of its image, 210M pairs.
// The TPU kernel's any-hit gate skips a chunk no ray of the tile passes; a
// thread here skips the insertion of every pair that fails the test, which
// is what that gate saves on a GPU: the hit test itself cannot be skipped
// without a bound that culls, and no-coarse culls nothing.  Measured there on
// an H100 80GB HBM3 at 700 W: 2.42 ms (the K = 32 bucket, 255 registers),
// 59% of the trainer step's device time; the plain version takes 66 ms.
// Each supertile's fourth block holds 16 live rays of 128; with no bits
// plane, blocks of 128 consecutive rays of an image would avoid that.
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
  const float* table;  // (nb, M, 16) feature rows; global: (B * M, 16);
                       // lists: (n_tab, 16), read by id
  const int* bits;     // (nb, M) sub-bin membership bits; null: all members
  const int* ids;      // (nb, M) global flattened ids; global: null
  const int* counts;   // (nb,) occupied rows; null: all M
  const float* attrs;  // (n_rows, d) or null
  int* o_idx;          // (B, H, W, K)
  float* o_len;
  float* o_act;
  float* o_dsd;
  float* o_w;          // or null (lists: no weights)
  float* o_img;        // (B, H, W, d) or null
  int H, W, bs, M, K, d;
  int th, tw, TW, ntile;  // a block's ray tile: height and width in pixels
                          // (2 bs; lists: the bin), tiles per image row and
                          // per image
  int gather;           // lists: rows are table[ids[...]], n_tab rows
  long long n_rows, n_tab;
  float thr_act, ow;
};

template <int KB>
__device__ __forceinline__ void composite_weights(const float (&tl)[KB],
                                                  float (&ea)[KB],
                                                  const float (&sq)[KB], int K,
                                                  float ow, float* w_out) {
  // pallas_fine2.py:386-406, summed over k < K in ascending order
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
}

// The same weights for the large buckets, from the slot values the thread has
// just written to (len, act, dsd) in device memory, over the nv occupied
// slots only.  An empty slot k has e^{-act_k} = 0 and adds exactly 0 to every
// sum, and an empty slot j has weight exactly 0, so skipping them changes no
// bit.  (Sweeping thread-private arrays of 128 entries here cost 1.6 s a
// render at the texture shapes: see the design note above.)
__device__ __forceinline__ void composite_weights_sparse(
    const float* s_len, const float* s_act, const float* s_dsd, int nv, int K,
    float ow, float* w_out) {
#pragma unroll 1
  for (int j = 0; j < nv; ++j) {
    const float lj = s_len[j];
    float occ = 0.0f;
#pragma unroll 1
    for (int k = 0; k < nv; ++k) {
      const float ca = (lj - s_len[k]) * sqrtf(s_dsd[k] + 1e-10f);
      occ = occ + expf(-s_act[k]) * (0.5f * (erff(ca) + 1.0f));
    }
    w_out[j] = expf(-ow * occ) * expf(-s_act[j]) * E_HALF;
  }
  for (int j = nv; j < K; ++j) w_out[j] = 0.0f;
}

template <int KB>
__global__ void __launch_bounds__(THREADS) fine_select_kernel(const Args a) {
  __shared__ float4 s_tab[TILE * 4];
  __shared__ int s_bits[TILE];

  const int s = blockIdx.x;  // ray tile: b * ntile + sy * TW + sx
  const int b = s / a.ntile;
  const int sy = (s % a.ntile) / a.TW;
  const int sx = (s % a.ntile) % a.TW;
  const int r = blockIdx.y * THREADS + threadIdx.x;
  const int lr = r / a.tw, lc = r % a.tw;
  const int y = sy * a.th + lr, x = sx * a.tw + lc;
  const bool live = (r < a.th * a.tw) && (y < a.H) && (x < a.W);
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

  // The running top-K.  Buckets up to 32 keep KB slots in registers (every
  // index below is static after unrolling).  The larger buckets keep a.K
  // slots in thread-private memory, indexed dynamically, and count the
  // occupied ones.
  constexpr bool SMALL = KB <= 32;
  float tl[KB], ta[KB], td[KB];
  int ts[KB];
  int nfill = 0;
  if constexpr (SMALL) {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      tl[k] = INF;
      ta[k] = INF;
      td[k] = 0.0f;
      ts[k] = -1;
    }
  } else {
#pragma unroll 1
    for (int k = 0; k < a.K; ++k) {
      tl[k] = INF;
      ta[k] = INF;
      td[k] = 0.0f;
      ts[k] = -1;
    }
  }

  // compacted: the supertile's own rows; global: its image's Gaussians;
  // lists: the rows the bin's ids name
  const bool global = a.ids == nullptr;
  const int cnt = a.counts != nullptr ? a.counts[s] : a.M;
  const float4* rows = reinterpret_cast<const float4*>(
      a.gather ? a.table : a.table + (global ? (size_t)b : (size_t)s) * a.M * 16);
  const int* brow = a.bits != nullptr ? a.bits + (size_t)s * a.M : nullptr;
  const int* lrow = a.gather ? a.ids + (size_t)s * a.M : nullptr;
  for (int c0 = 0; c0 < cnt; c0 += TILE) {
    const int n = min(TILE, cnt - c0);
    __syncthreads();
    if (lrow != nullptr) {
      // THREADS == TILE: thread t stages list entry c0 + t; an empty (or
      // out-of-table) entry gets no bits and is skipped below
      int id = -1;
      if ((int)threadIdx.x < n) id = lrow[c0 + threadIdx.x];
      const bool ok = id >= 0 && id < a.n_tab;
      s_bits[threadIdx.x] = ok ? 0xF : 0;
      if (ok) {
        const float4* src = rows + (size_t)id * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) s_tab[4 * threadIdx.x + q] = src[q];
      }
      if (!__syncthreads_or(ok)) continue;  // no entry in this tile
    } else {
      for (int t = threadIdx.x; t < n * 4; t += THREADS) s_tab[t] = rows[(size_t)c0 * 4 + t];
      for (int t = threadIdx.x; t < n; t += THREADS) s_bits[t] = brow != nullptr ? brow[c0 + t] : 0xF;
      __syncthreads();
    }
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
      if (!(act < a.thr_act)) continue;
      if constexpr (SMALL) {
        if (!(len < tl[KB - 1])) continue;
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
      } else {
        // the same stable rule from the far end: the newcomer moves up past
        // strictly longer hits only, so an earlier candidate wins a tie; a
        // full list drops its last slot
        const int last = a.K - 1;
        if (!(len < tl[last])) continue;
        int k = nfill < a.K ? nfill : last;
        while (k > 0 && len < tl[k - 1]) {
          tl[k] = tl[k - 1]; ta[k] = ta[k - 1]; td[k] = td[k - 1]; ts[k] = ts[k - 1];
          --k;
        }
        tl[k] = len; ta[k] = act; td[k] = ksk; ts[k] = c0 + c;
        if (nfill < a.K) ++nfill;
      }
    }
  }
  if (!live) return;

  const size_t o = pix * a.K;
#define VOGE_PUT_SLOT(k)                                                      \
  a.o_idx[o + (k)] = ts[k] < 0 ? -1                                           \
                     : global ? b * a.M + ts[k]                               \
                              : a.ids[(size_t)s * a.M + ts[k]];               \
  a.o_len[o + (k)] = tl[k];                                                   \
  a.o_act[o + (k)] = ta[k];                                                   \
  a.o_dsd[o + (k)] = td[k];
  if constexpr (SMALL) {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (k < a.K) { VOGE_PUT_SLOT(k) }
    }
  } else {
#pragma unroll 1
    for (int k = 0; k < a.K; ++k) { VOGE_PUT_SLOT(k) }
  }
#undef VOGE_PUT_SLOT
  if (a.o_w == nullptr) return;
  if constexpr (SMALL) {
    // e^{-act} and sqrt(dsd + 1e-10) once per slot, in place
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      ta[k] = expf(-ta[k]);
      td[k] = sqrtf(td[k] + 1e-10f);
    }
    composite_weights<KB>(tl, ta, td, a.K, a.ow, a.o_w + o);
  } else {
    composite_weights_sparse(a.o_len + o, a.o_act + o, a.o_dsd + o, nfill, a.K,
                             a.ow, a.o_w + o);
  }
  if (a.o_img != nullptr) {
    for (int ch = 0; ch < a.d; ++ch)
      a.o_img[pix * a.d + ch] = voge_attr_merge_one(
          a.o_idx + o, a.o_w + o, a.K, a.attrs, a.n_rows, a.d, ch);
  }
}

template <int KB>
cudaError_t launch(const Args& a, int nb, cudaStream_t stream) {
  static_assert(THREADS == TILE, "the list staging maps a thread to a row");
  const dim3 grid(nb, (a.th * a.tw + THREADS - 1) / THREADS);
  fine_select_kernel<KB><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

int launch_k(const Args& a, int nb, cudaStream_t s) {
  cudaError_t err;
  if (a.K <= 8) err = launch<8>(a, nb, s);
  else if (a.K <= 16) err = launch<16>(a, nb, s);
  else if (a.K <= 32) err = launch<32>(a, nb, s);
  else if (a.K <= 64) err = launch<64>(a, nb, s);
  else err = launch<128>(a, nb, s);
  return (int)err;
}

}  // namespace

extern "C" int voge_fine_select(
    const void* rays, const void* table, const void* bits, const void* ids,
    const void* counts, const void* attrs, void* o_idx, void* o_len,
    void* o_act, void* o_dsd, void* o_w, void* o_img, int nb, int H, int W,
    int bs, int BW2, int nst, int M, int K, int d, long long n_rows,
    float thr_act, float ow, void* stream) {
  if (nb <= 0 || bs <= 0 || K <= 0 || K > 128 || bits == nullptr ||
      ids == nullptr || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a = {};
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
  a.H = H; a.W = W; a.bs = bs; a.M = M; a.K = K;
  a.th = a.tw = 2 * bs; a.TW = BW2; a.ntile = nst;
  a.d = d; a.n_rows = n_rows; a.thr_act = thr_act; a.ow = ow;
  return launch_k(a, nb, (cudaStream_t)stream);
}

// The global entry: candidates of supertile s are the P rows of image
// s / nst in ``table`` (B * P, 16); ``bits`` (nb, P) or null for all members.
extern "C" int voge_fine_select_global(
    const void* rays, const void* table, const void* bits, void* o_idx,
    void* o_len, void* o_act, void* o_dsd, void* o_w, int nb, int H, int W,
    int bs, int BW2, int nst, int P, int K, float thr_act, float ow,
    void* stream) {
  if (nb <= 0 || bs <= 0 || P <= 0 || K <= 0 || K > 128) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.rays = (const float*)rays;
  a.table = (const float*)table;
  a.bits = (const int*)bits;
  a.o_idx = (int*)o_idx;
  a.o_len = (float*)o_len;
  a.o_act = (float*)o_act;
  a.o_dsd = (float*)o_dsd;
  a.o_w = (float*)o_w;
  a.H = H; a.W = W; a.bs = bs; a.M = P; a.K = K;
  a.th = a.tw = 2 * bs; a.TW = BW2; a.ntile = nst;
  a.thr_act = thr_act; a.ow = ow;
  return launch_k(a, nb, (cudaStream_t)stream);
}

// The per-bin-list entry: candidates of bin s (nb = B * BH * BW bins of
// bsh x bsw pixels, row-major) are the rows of ``table`` (n_tab, 16) named by
// ``list`` (nb, M), -1 where empty; the outputs' idx holds those ids.
extern "C" int voge_fine_select_bins(
    const void* rays, const void* table, const void* list, void* o_idx,
    void* o_len, void* o_act, void* o_dsd, int nb, int H, int W, int bsh,
    int bsw, int BW, int nbin, int M, long long n_tab, int K, float thr_act,
    void* stream) {
  if (nb <= 0 || bsh <= 0 || bsw <= 0 || M <= 0 || n_tab <= 0 || K <= 0 || K > 128 ||
      list == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.rays = (const float*)rays;
  a.table = (const float*)table;
  a.ids = (const int*)list;
  a.o_idx = (int*)o_idx;
  a.o_len = (float*)o_len;
  a.o_act = (float*)o_act;
  a.o_dsd = (float*)o_dsd;
  // bs only places the sub-bin bit, which no list entry tests (bit 0)
  a.H = H; a.W = W; a.bs = bsh > bsw ? bsh : bsw; a.M = M; a.K = K;
  a.th = bsh; a.tw = bsw; a.TW = BW; a.ntile = nbin;
  a.gather = 1; a.n_tab = n_tab;
  a.thr_act = thr_act;
  return launch_k(a, nb, (cudaStream_t)stream);
}

// K3f: attribute merge forward,
//   img[p, c] = sum_k w[p, k] * attrs[idx[p, k], c]
// over the slots with 0 <= idx < n_rows, in ascending slot order.
//
// Replaces voge_tpu/ops/pallas_attr.py::_fwd_kernel (reached through
// _attr_fwd_call <- attr_merge_compact / attr_merge_fwd_pallas).  The TPU
// kernel streams candidate chunks, builds an id-match matrix per chunk and
// contracts it with the attribute planes on the MXU, because element gathers
// are slow there.  On Hopper a gather of an L2-resident row is cheap, so this
// is merge_final (aggregation.py:131-154) as one gather-and-reduce pass.
//
// Design.  tpp = the power of 2 >= ceil(d / 4) (at most 32) threads share
// a pixel, so a warp holds 32 / tpp whole pixels and a block of 128 threads
// P = 128 / tpp consecutive pixels.  Each warp copies its pixels' ids (one
// contiguous run of the idx array) into shared memory with cp.async: 16-byte
// copies where K % 4 == 0, 4-byte ones otherwise, consecutive lanes on
// consecutive addresses; KC slots of each pixel at a time (all K unless
// P x K exceeds SLAB_SLOTS), so any K fits in under 48 KB.  Each lane waits
// for its own copies and the warp syncs: no warp waits for another's ids.
// In shared memory a pixel's row is padded to KS slots with KS / 4 odd, which
// keeps the 16-byte reads below free of bank conflicts.  Thread j of a pixel
// sums channels 4j .. 4j + 3 (and, past d = 128, the groups 32 further on,
// one pass each) in registers, four slots at a time, five groups unrolled:
// one 16-byte shared read of ids, then the weights of the valid slots read
// straight from global memory beside their attribute rows (as float4 where
// d % 4 == 0, as scalars otherwise; the channel count is a template
// parameter for d <= 4), all issued before the sums; a group with no valid
// slot costs its test alone.  Most slots of a render are empty (78% at the
// headline, 84% at the texture shapes), so the weights of the others are
// never read, and they come in the same round trip as the rows: staging them
// in shared memory behind the ids took a second one.  The block's outputs,
// one contiguous range of P x d floats, go out through shared memory as
// 16-byte stores (past d = 128 a pixel's row is written straight, 32
// threads on 128 consecutive floats).
//
// Rounding: each channel is a chain of fmaf(w, a, acc) from 0 in ascending
// slot order, the products contracted, as the kernel of one thread per
// (pixel, channel) before it compiled `acc += w * a` (this file builds
// without -fmad=false), so images keep their bits.  K2's fused attribute
// image keeps attr_merge.cuh (fine_select.cu, built with -fmad=false).
//
// What bounds it on the H100: the bytes of the ids, 4 per slot read once,
// and of the valid slots' weights (in 32-byte sectors), plus d floats out per
// pixel; the attribute rows are gathered from L1 / L2.  At the texture
// shapes (172,032 pixels, K = 80, d = 4: the sampler's backward) the ids
// alone are 55 MB, ~16 us at 3.35 TB/s; at the headline (65,536 pixels,
// K = 20, d = 3) 5 MB, ~1.6 us, where the launch, one wave of blocks and
// two dependent reads from DRAM (the ids, then the weights and rows they
// name) dominate, and the wrapper's host time more still.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 128;      // a block's threads: P pixels x tpp
constexpr int SLAB_SLOTS = 4096;  // slots a pixel row x P in shared memory at a time
constexpr int STAGED_D = 128;     // outputs of d <= 128 go out through shared memory
constexpr int SLOTS = 4;          // slots a thread gathers at once

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The ids of slots k0 .. k0 + kc of one warp's nw pixels (rows pw0 ..
// pw0 + nw of the block's slab, KS slots a row), copied by the warp's lanes
// on consecutive addresses; each lane waits for its own copies and the warp
// syncs, so no warp waits for another's.
template <bool VEC_SLOTS>
__device__ __forceinline__ void stage_ids(const int* __restrict__ idx, int* s_idx, long long p0,
                                          int pw0, int nw, int K, int k0, int kc, int KS) {
  const int lane = threadIdx.x & 31;
  if (VEC_SLOTS) {  // K, k0 and kc are multiples of 4
    const int q = kc / 4;
    for (int i = lane; i < nw * q; i += 32) {
      const int r = pw0 + i / q, c = 4 * (i % q);
      cp_async16(s_idx + r * KS + c, idx + (p0 + r) * K + k0 + c);
    }
  } else {
    for (int i = lane; i < nw * kc; i += 32) {
      const int r = pw0 + i / kc, c = i % kc;
      cp_async4(s_idx + r * KS + c, idx + (p0 + r) * K + k0 + c);
    }
  }
  cp_async_wait_all();
  __syncwarp();
}

// acc[c] += w[q] * attrs[id[q], c0 + c] for the valid slots q of a group of
// SLOTS, in slot order: the weights of the valid slots (wg: the group's in
// global memory) and their attribute rows are all loaded before the sums,
// and a group without a valid slot costs its test alone.  NC: the channels a
// thread sums, 4 (float4 rows, d % 4 == 0) or d itself (1 to 3); 0 for a
// count known at run time (d > 4 and d % 4 != 0).
template <int NC>
__device__ __forceinline__ void add_slots(float (&acc)[4], const int (&id)[SLOTS],
                                          const float* __restrict__ wg, int n_left,
                                          const float* __restrict__ attrs, unsigned nr,
                                          int d, int c0) {
  bool ok[SLOTS];
  bool any = false;
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) {
    ok[q] = q < n_left && (unsigned)id[q] < nr;
    any |= ok[q];
  }
  if (!any) return;
  const int nc = NC ? NC : min(4, d - c0);
  float wt[SLOTS];
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) wt[q] = ok[q] ? __ldg(wg + q) : 0.0f;
  float v[SLOTS][4];
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) {
    const float* row = attrs + (size_t)(ok[q] ? id[q] : 0) * d + c0;
    if (NC == 4) {
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ok[q]) a = __ldg(reinterpret_cast<const float4*>(row));
      v[q][0] = a.x, v[q][1] = a.y, v[q][2] = a.z, v[q][3] = a.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[q][c] = ok[q] && c < nc ? __ldg(row + c) : 0.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < SLOTS; ++q)
#pragma unroll
    for (int c = 0; c < (NC ? NC : 4); ++c)
      if (ok[q] && (NC || c < nc)) acc[c] = __fmaf_rn(wt[q], v[q][c], acc[c]);
}

// Slots k .. k + SLOTS of a pixel's staged ids (rows hold KS >= kc rounded
// up to 4) and of its weights in global memory (wg: the chunk's first) into
// acc.
template <int NC>
__device__ __forceinline__ void add_group(float (&acc)[4], const int* si,
                                          const float* __restrict__ wg,
                                          int k, int kc, const float* __restrict__ attrs,
                                          unsigned nr, int d, int c0) {
  int id[SLOTS];
#pragma unroll
  for (int h = 0; h < SLOTS; h += 4) {
    int4 a = make_int4(-1, -1, -1, -1);
    if (k + h < kc) a = *reinterpret_cast<const int4*>(si + k + h);
    id[h] = a.x, id[h + 1] = a.y, id[h + 2] = a.z, id[h + 3] = a.w;
  }
  add_slots<NC>(acc, id, wg + k, kc - k, attrs, nr, d, c0);
}

// A minimum of one block an SM lets ptxas spend registers on the unrolled
// gathers (see the ptxas report of chip_smoke.py's build); its default
// allotment ran slower on an H100.
template <bool VEC_SLOTS, int NC>
__global__ void __launch_bounds__(THREADS, 1)
attr_merge_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                  const float* __restrict__ attrs, float* __restrict__ out,
                  long long n_pix, int K, int d, long long n_rows, int P, int tpp,
                  int KC, int KS) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_idx = reinterpret_cast<int*>(smem);          // P rows of KS slots
  float* s_out = reinterpret_cast<float*>(s_idx + P * KS);  // P x d, when d <= STAGED_D
  const long long p0 = (long long)blockIdx.x * P;
  const int np = (int)min((long long)P, n_pix - p0);
  const int pl = threadIdx.x / tpp, j = threadIdx.x - pl * tpp;
  const int pw0 = (threadIdx.x >> 5) * (32 / tpp);  // the warp's first pixel
  const int nw = max(0, min(32 / tpp, np - pw0));  // and its count
  const bool staged = d <= STAGED_D;
  const int groups = (d + 3) / 4, n_kc = (K + KC - 1) / KC;
  const int* si = s_idx + pl * KS;
  // a slot is valid when (unsigned)id < nr: ids are int32
  const unsigned nr = n_rows > 0x7fffffffLL ? 0x80000000u : (unsigned)n_rows;

  for (int g0 = 0; g0 < groups; g0 += tpp) {  // one pass unless d > 128
    const int c0 = 4 * (g0 + j);
    const bool mine = pl < np && c0 < d;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kq = 0; kq < n_kc; ++kq) {
      const int k0 = kq * KC, kc = min(KC, K - k0);
      const bool fresh = g0 == 0 || n_kc > 1;
      if (fresh) {
        if (g0 > 0 || kq > 0) __syncwarp();  // the warp's rows are read
        stage_ids<VEC_SLOTS>(idx, s_idx, p0, pw0, nw, K, k0, kc, KS);
      }
      if (!mine) continue;
      const float* wg = w + (p0 + pl) * K + k0;
      // five groups at once: the headline's 20 slots all in flight
#pragma unroll 5
      for (int k = 0; k < kc; k += SLOTS) add_group<NC>(acc, si, wg, k, kc, attrs, nr, d, c0);
    }
    if (mine) {
      const int nc = min(4, d - c0);
      float* dst = staged ? s_out + pl * d + c0 : out + (p0 + pl) * d + c0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < nc) dst[q] = acc[q];
    }
  }
  if (!staged) return;
  __syncthreads();
  // the block's outputs are out[p0 * d, (p0 + np) * d), 16-byte aligned
  const int n = np * d, n4 = n / 4;
  float4* o4 = reinterpret_cast<float4*>(out + p0 * d);
  const float4* s4 = reinterpret_cast<const float4*>(s_out);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) o4[i] = s4[i];
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) out[p0 * d + i] = s_out[i];
}

struct Args {
  const int* idx;
  const float* w;
  const float* attrs;
  float* out;
  long long n_pix;
  int K, d;
  long long n_rows;
  int P, tpp, KC, KS;
};

template <bool VEC_SLOTS, int NC>
void launch(dim3 grid, dim3 block, size_t smem, cudaStream_t s, const Args& a) {
  attr_merge_kernel<VEC_SLOTS, NC><<<grid, block, smem, s>>>(
      a.idx, a.w, a.attrs, a.out, a.n_pix, a.K, a.d, a.n_rows, a.P, a.tpp, a.KC, a.KS);
}

template <bool VEC_SLOTS>
void launch_nc(int nc, dim3 grid, dim3 block, size_t smem, cudaStream_t s, const Args& a) {
  switch (nc) {
    case 1: launch<VEC_SLOTS, 1>(grid, block, smem, s, a); break;
    case 2: launch<VEC_SLOTS, 2>(grid, block, smem, s, a); break;
    case 3: launch<VEC_SLOTS, 3>(grid, block, smem, s, a); break;
    case 4: launch<VEC_SLOTS, 4>(grid, block, smem, s, a); break;
    default: launch<VEC_SLOTS, 0>(grid, block, smem, s, a);
  }
}

}  // namespace

extern "C" int voge_attr_merge(const void* idx, const void* w,
                               const void* attrs, void* out, long long n_pix,
                               int K, int d, long long n_rows, void* stream) {
  if (n_pix <= 0 || K <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  int tpp = 1;  // a power of 2, so that a warp holds whole pixels
  while (tpp < 32 && 4 * tpp < d) tpp *= 2;
  const int P = THREADS / tpp;
  const int KC = (long long)P * K <= SLAB_SLOTS ? K : std::max(4, (SLAB_SLOTS / P) & ~3);
  int KS = (KC + 3) & ~3;
  if ((KS / 4) % 2 == 0) KS += 4;  // KS / 4 odd: conflict-free 16-byte row reads
  const size_t smem = (size_t)P * KS * 4 + (d <= STAGED_D ? (size_t)P * d * 4 : 0);
  const long long blocks = (n_pix + P - 1) / P;
  if (blocks >= 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(P * tpp);
  const int nc = d % 4 == 0 ? 4 : d < 4 ? d : 0;
  Args a{(const int*)idx, (const float*)w, (const float*)attrs, (float*)out, n_pix, K, d,
         n_rows, P, tpp, KC, KS};
  cudaStream_t s = (cudaStream_t)stream;
  if (K % 4 == 0)
    launch_nc<true>(nc, grid, block, smem, s, a);
  else
    launch_nc<false>(nc, grid, block, smem, s, a);
  return (int)cudaGetLastError();
}

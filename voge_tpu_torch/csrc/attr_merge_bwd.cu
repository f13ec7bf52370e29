// K4b and its two halves: the backward of the attribute merge
// img = sum_k w_k attrs[idx_k] (K3f, attr_merge.cu), deterministic, no float
// atomics.  Three entries share two device kernels:
//   voge_attr_dw       d_w[p, k] = attrs[idx[p, k]] . g[p]   (attr_dw_kernel);
//                      replaces voge_tpu/ops/pallas_attr.py::_bwd_w_kernel
//                      (:190, attr_merge_bwd_w_pallas);
//   voge_attr_scatter  out[j] = sum over slots with idx == j of w * g[pixel]
//                      (attr_scatter_kernel); replaces _bwd_attr_kernel
//                      (:168, attr_merge_bwd_attr_pallas).  With the image
//                      (plus a ones channel) as g it is the texture sampler's
//                      forward: the scatter of pixel features onto Gaussians;
//   voge_attr_merge_bwd both in one call; replaces _bwd_unified_kernel (:90,
//                      attr_merge_bwd_unified_pallas / _attr_bwd_call).
// The TPU kernels id-match candidate chunks against the selections and
// contract on the MXU, because a TPU gathers slowly.  Here d_w is a gather and
// the scatter a segmented sum: the caller groups the flattened idx by id with
// the grouping kernel of slot_runs.cu (a stable radix sort of the valid slots;
// the same (order, starts) a stable torch.sort and searchsorted gave), so each
// row's slots form one run in ascending slot order, and passes the run starts.
//
// The scatter sums each run as a block of 128 threads would: thread t takes
// slots t, t + 128, ... of the run, a fixed shuffle tree combines each warp and
// the four warp sums are added in warp order.  The order is fixed, so two runs
// give the same bits.  Two kernels share the rows.  The first gives each row a
// warp: an empty or short run (LONG_RUN slots at most) is summed there, lane l
// playing the four threads l, l + 32, l + 64, l + 96 with four accumulators,
// so the warp adds in the block's order and gives its bits, and an empty row
// costs a warp writing zeros, not a block; a longer run's row goes on a list
// (an integer atomic: the list's order changes from run to run, no sum does).
// The second kernel's blocks walk that list, a whole block to a long run, so
// every long run is in flight at once; a run takes as long as its longest
// thread's chain of dependent gathers.  Runs are uneven: ~100 slots a row at
// the 10K-Gaussian headline (65,536 pixels, K = 20), all taken by warps, but
// thousands at the texture shapes (172,032 pixels x 80 slots on ~1,200 visible
// Gaussians of 10,242, ~9,000 rows empty), where a thread per (row, channel)
// would leave the card to a few thousand threads walking long runs.  Channels
// go eight at a time through registers.
//
// d_w gives each thread DW_SLOTS = 4 consecutive slots of one pixel: one
// 16-byte load of ids (4-byte loads where K % 4 != 0), so consecutive threads
// read consecutive ids and, at K % 4 == 0, thread t's slots are 4t .. 4t + 3
// of the flattened array; where one of the four is valid, the pixel's g row
// read once for them, as float4 where d % 4 == 0, and each valid slot's
// attribute row as float4 (L2 hits: the rows are ~10K x d floats); where none
// is (most slots of a render are empty), no g row at all; the four results
// out as one 16-byte store.  A pixel's last thread takes K mod 4 slots when
// K % 4 != 0.  Blocks of 128 threads, at most 40 registers a thread (12
// blocks an SM): at 32 the kernel spills, and with more registers too few
// threads are left to hide the id loads (both ran slower on an H100).  Each result is a chain of fmaf(attrs[id, c], g[c], acc) from
// 0 in ascending c, as the kernel of one thread per slot before it compiled
// `acc += a * g` (this file builds without -fmad=false), so d_w keeps its
// bits.
//
// What bounds it on the H100: memory.  The scatter reads order 4 B, w 4 B and
// d floats of g per slot through two dependent gathers, and waits on the
// latency of those gathers along the longest run; d_w reads idx and writes
// d_w, 8 B per slot (110 MB at the texture shapes, ~33 us at 3.35 TB/s),
// which four slots a thread keep in flight with a quarter of the load
// instructions the kernel of one thread per slot issued.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;      // d_w: threads a block
constexpr int DW_BLOCKS_AN_SM = 12;  // d_w: 40 registers a thread at most
constexpr int DW_SLOTS = 4;       // d_w: slots a thread
constexpr int ROW_THREADS = 128;  // scatter: the threads a run is summed as
constexpr int ROWS = ROW_THREADS / 32;  // scatter: rows a block, one a warp
constexpr int LONG_RUN = 128;     // scatter: longer runs take a whole block
constexpr int LONG_BLOCKS_AN_SM = 16;  // scatter: blocks walking the long rows
constexpr int CH = 8;             // scatter: channels per pass

// d_w[p, k] = attrs[idx[p, k]] . g[p] for DW_SLOTS slots of pixel p a thread.
template <bool VEC_SLOTS, bool VEC_D>
__global__ void __launch_bounds__(THREADS, DW_BLOCKS_AN_SM)
attr_dw_kernel(const int* __restrict__ idx, const float* __restrict__ g,
               const float* __restrict__ attrs, float* __restrict__ d_w, long long n_pix,
               int K, int d, long long n_rows) {
  const int tpp = (K + DW_SLOTS - 1) / DW_SLOTS;  // threads a pixel
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long p = t / tpp;
  if (p >= n_pix) return;
  const int k0 = DW_SLOTS * (int)(t - p * tpp);
  const int ns = min(DW_SLOTS, K - k0);
  const long long s0 = p * K + k0;
  int id[DW_SLOTS];
  if (VEC_SLOTS) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(idx + s0));
    id[0] = v.x, id[1] = v.y, id[2] = v.z, id[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < DW_SLOTS; ++q) id[q] = q < ns ? __ldg(idx + s0 + q) : -1;
  }
  bool ok[DW_SLOTS];
  bool any = false;
  const float* row[DW_SLOTS];
#pragma unroll
  for (int q = 0; q < DW_SLOTS; ++q) {
    ok[q] = id[q] >= 0 && id[q] < n_rows;
    any |= ok[q];
    row[q] = attrs + (size_t)(ok[q] ? id[q] : 0) * d;
  }
  const float* gp = g + p * d;
  float acc[DW_SLOTS] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (any) {  // most slots of a render are empty: their g row is not read
    if (VEC_D) {
      for (int c = 0; c < d; c += 4) {
        const float4 gv = __ldg(reinterpret_cast<const float4*>(gp + c));
#pragma unroll
        for (int q = 0; q < DW_SLOTS; ++q) {
          if (!ok[q]) continue;
          const float4 a = __ldg(reinterpret_cast<const float4*>(row[q] + c));
          acc[q] = __fmaf_rn(a.x, gv.x, acc[q]);
          acc[q] = __fmaf_rn(a.y, gv.y, acc[q]);
          acc[q] = __fmaf_rn(a.z, gv.z, acc[q]);
          acc[q] = __fmaf_rn(a.w, gv.w, acc[q]);
        }
      }
    } else {
      for (int c = 0; c < d; ++c) {
        const float gc = __ldg(gp + c);
#pragma unroll
        for (int q = 0; q < DW_SLOTS; ++q)
          if (ok[q]) acc[q] = __fmaf_rn(__ldg(row[q] + c), gc, acc[q]);
      }
    }
  }
  if (VEC_SLOTS) {
    *reinterpret_cast<float4*>(d_w + s0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int q = 0; q < DW_SLOTS; ++q)
      if (q < ns) d_w[s0 + q] = acc[q];
  }
}

// Thread t's partial sums (channels c0 .. c0 + nc) over the run q0 .. q1 for
// the threads t = t0 + 32 v, v < V, of a 128-thread block: slots q0 + t,
// q0 + t + 128, ... in that order.
template <int V>
__device__ __forceinline__ void run_partials(const int* __restrict__ order,
                                             const float* __restrict__ w,
                                             const float* __restrict__ g, long long q0,
                                             long long q1, int t0, int K, int d, int c0,
                                             int nc, float (&acc)[V][CH]) {
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[v][c] = 0.0f;
  for (long long q = q0 + t0; q < q1; q += ROW_THREADS) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (q + 32 * v >= q1) break;
      const long long slot = order[q + 32 * v];
      const float ws = w[slot];
      const float* gp = g + (slot / K) * d + c0;
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (c < nc) acc[v][c] += ws * gp[c];
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int c = 0; c < CH; ++c)
      for (int off = 16; off > 0; off >>= 1)
        acc[v][c] += __shfl_down_sync(0xffffffffu, acc[v][c], off);
}

// A short or empty run by one warp, as the four warps of a block would sum it.
__device__ __forceinline__ void warp_row(const int* __restrict__ order,
                                         const float* __restrict__ w,
                                         const float* __restrict__ g, float* __restrict__ orow,
                                         long long q0, long long q1, int K, int d) {
  const int lane = threadIdx.x & 31;
  if (q0 == q1) {
    for (int c = lane; c < d; c += 32) orow[c] = 0.0f;
    return;
  }
  for (int c0 = 0; c0 < d; c0 += CH) {
    const int nc = min(CH, d - c0);
    float acc[ROWS][CH];
    run_partials<ROWS>(order, w, g, q0, q1, lane, K, d, c0, nc, acc);
    if (lane == 0)
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float t = acc[0][c];
#pragma unroll
        for (int v = 1; v < ROWS; ++v) t += acc[v][c];
        if (c < nc) orow[c0 + c] = t;
      }
  }
}

// A long run by the whole block.
__device__ __forceinline__ void block_row(const int* __restrict__ order,
                                          const float* __restrict__ w,
                                          const float* __restrict__ g, float* __restrict__ orow,
                                          long long q0, long long q1, int K, int d,
                                          float (*s_part)[CH]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < d; c0 += CH) {
    const int nc = min(CH, d - c0);
    float acc[1][CH];
    run_partials<1>(order, w, g, q0, q1, threadIdx.x, K, d, c0, nc, acc);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < CH; ++c) s_part[warp][c] = acc[0][c];
    }
    __syncthreads();
    if ((int)threadIdx.x < nc) {
      float t = s_part[0][threadIdx.x];
      for (int v = 1; v < ROWS; ++v) t += s_part[v][threadIdx.x];
      orow[c0 + threadIdx.x] = t;
    }
    __syncthreads();
  }
}

// One warp a row: the empty and the short runs; a long run's row goes on the
// list of long rows (its place there does not change its sum).
__global__ void __launch_bounds__(ROW_THREADS)
attr_scatter_kernel(const int* __restrict__ order, const long long* __restrict__ starts,
                    const float* __restrict__ w, const float* __restrict__ g,
                    float* __restrict__ out, int K, int d, long long n_rows,
                    int* __restrict__ long_rows, int* __restrict__ n_long) {
  const long long j = ((long long)blockIdx.x * ROW_THREADS + threadIdx.x) >> 5;
  if (j >= n_rows) return;  // j is the same for the whole warp
  const long long q0 = starts[j], q1 = starts[j + 1];
  if (q1 - q0 <= LONG_RUN) {
    warp_row(order, w, g, out + j * d, q0, q1, K, d);
  } else if ((threadIdx.x & 31) == 0) {
    long_rows[atomicAdd(n_long, 1)] = (int)j;
  }
}

// The long runs: a block each, the blocks walking the list.
__global__ void __launch_bounds__(ROW_THREADS)
attr_scatter_long_kernel(const int* __restrict__ order, const long long* __restrict__ starts,
                         const float* __restrict__ w, const float* __restrict__ g,
                         float* __restrict__ out, int K, int d,
                         const int* __restrict__ long_rows, const int* __restrict__ n_long) {
  __shared__ float s_part[ROWS][CH];
  const int m = *n_long;
  for (int i = blockIdx.x; i < m; i += gridDim.x) {
    const long long j = long_rows[i];
    block_row(order, w, g, out + j * d, starts[j], starts[j + 1], K, d, s_part);
  }
}

cudaError_t launch_dw(const void* idx, const void* g, const void* attrs,
                      void* d_w, long long n_pix, int K, int d,
                      long long n_rows, cudaStream_t s) {
  const long long n = n_pix * ((K + DW_SLOTS - 1) / DW_SLOTS);
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  const int* i_ = (const int*)idx;
  const float *g_ = (const float*)g, *a_ = (const float*)attrs;
  float* o_ = (float*)d_w;
  const bool vs = K % DW_SLOTS == 0, vd = d % 4 == 0;
  if (vs && vd)
    attr_dw_kernel<true, true><<<blocks, THREADS, 0, s>>>(i_, g_, a_, o_, n_pix, K, d, n_rows);
  else if (vs)
    attr_dw_kernel<true, false><<<blocks, THREADS, 0, s>>>(i_, g_, a_, o_, n_pix, K, d, n_rows);
  else if (vd)
    attr_dw_kernel<false, true><<<blocks, THREADS, 0, s>>>(i_, g_, a_, o_, n_pix, K, d, n_rows);
  else
    attr_dw_kernel<false, false><<<blocks, THREADS, 0, s>>>(i_, g_, a_, o_, n_pix, K, d, n_rows);
  return cudaGetLastError();
}

// ``rows_scratch`` (n_rows + 1 int32): the list of long rows and its length.
cudaError_t launch_scatter(const void* order, const void* starts,
                           const void* w, const void* g, void* out, int K,
                           int d, long long n_rows, void* rows_scratch, cudaStream_t s) {
  int* long_rows = (int*)rows_scratch;
  int* n_long = long_rows + n_rows;
  cudaError_t err = cudaMemsetAsync(n_long, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  attr_scatter_kernel<<<(unsigned)((n_rows + ROWS - 1) / ROWS), ROW_THREADS, 0, s>>>(
      (const int*)order, (const long long*)starts, (const float*)w, (const float*)g,
      (float*)out, K, d, n_rows, long_rows, n_long);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;  // the SM count of the card that launches
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  attr_scatter_long_kernel<<<(unsigned)(sms * LONG_BLOCKS_AN_SM), ROW_THREADS, 0, s>>>(
      (const int*)order, (const long long*)starts, (const float*)w, (const float*)g,
      (float*)out, K, d, long_rows, n_long);
  return cudaGetLastError();
}

bool bad_shape(long long n_pix, int K, int d, long long n_rows) {
  return n_pix <= 0 || K <= 0 || d <= 0 || n_rows <= 0 ||
         n_rows >= 2147483647LL;
}

}  // namespace

// d_w (n_pix, K) of idx (n_pix, K), g (n_pix, d), attrs (n_rows, d).
extern "C" int voge_attr_dw(const void* idx, const void* g, const void* attrs,
                            void* d_w, long long n_pix, int K, int d,
                            long long n_rows, void* stream) {
  if (bad_shape(n_pix, K, d, n_rows)) return (int)cudaErrorInvalidValue;
  return (int)launch_dw(idx, g, attrs, d_w, n_pix, K, d, n_rows,
                        (cudaStream_t)stream);
}

// out (n_rows, d): row j sums w[slot] * g[slot / K] over the run
// order[starts[j] : starts[j + 1]] of the slot ids grouped by id (slot_runs.cu;
// order int32, starts int64); rows_scratch holds n_rows + 1 int32s.
extern "C" int voge_attr_scatter(const void* order, const void* starts,
                                 const void* w, const void* g, void* out,
                                 void* rows_scratch, long long n_pix, int K, int d,
                                 long long n_rows, void* stream) {
  if (bad_shape(n_pix, K, d, n_rows)) return (int)cudaErrorInvalidValue;
  return (int)launch_scatter(order, starts, w, g, out, K, d, n_rows, rows_scratch,
                             (cudaStream_t)stream);
}

// Both halves: d_w (n_pix, K) and d_attr (n_rows, d).
extern "C" int voge_attr_merge_bwd(const void* idx, const void* w,
                                   const void* attrs, const void* g,
                                   const void* order, const void* starts,
                                   void* d_w, void* d_attr, void* rows_scratch,
                                   long long n_pix, int K, int d, long long n_rows,
                                   void* stream) {
  if (bad_shape(n_pix, K, d, n_rows) || d_w == nullptr || d_attr == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = launch_dw(idx, g, attrs, d_w, n_pix, K, d, n_rows, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_scatter(order, starts, w, g, d_attr, K, d, n_rows, rows_scratch, s);
}

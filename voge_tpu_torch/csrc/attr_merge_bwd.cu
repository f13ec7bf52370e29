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
// What bounds it on the H100: memory (the scatter reads order 4 B, w 4 B and
// d floats of g per slot through two dependent gathers; d_w reads idx and
// writes d_w, 8 B per slot) and, for the scatter, the latency of those
// gathers along the longest run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // d_w: slots per block
constexpr int ROW_THREADS = 128;  // scatter: the threads a run is summed as
constexpr int ROWS = ROW_THREADS / 32;  // scatter: rows a block, one a warp
constexpr int LONG_RUN = 128;     // scatter: longer runs take a whole block
constexpr int LONG_BLOCKS_AN_SM = 16;  // scatter: blocks walking the long rows
constexpr int CH = 8;             // scatter: channels per pass

__global__ void attr_dw_kernel(const int* __restrict__ idx,
                               const float* __restrict__ g,
                               const float* __restrict__ attrs,
                               float* __restrict__ d_w, long long n_slots,
                               int K, int d, long long n_rows) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_slots) return;
  const int id = idx[t];
  float acc = 0.0f;
  if (id >= 0 && id < n_rows) {
    const float* gp = g + (t / K) * d;
    const float* ap = attrs + (size_t)id * d;
    for (int c = 0; c < d; ++c) acc += ap[c] * gp[c];
  }
  d_w[t] = acc;
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
  const long long n = n_pix * K;
  attr_dw_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      (const int*)idx, (const float*)g, (const float*)attrs, (float*)d_w, n, K,
      d, n_rows);
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
  static int sms = 0;  // read once: the port drives one card
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
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

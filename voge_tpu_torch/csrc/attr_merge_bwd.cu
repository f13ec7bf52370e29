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
// the scatter a segmented sum: the caller sorts the flattened idx with a
// stable sort (PyTorch glue, as K1's key sort), so each row's slots form one
// run in ascending slot order, and passes the run starts.
//
// The scatter gives each run a block of 128 threads: thread t takes slots
// t, t + 128, ... of the run, a fixed shuffle tree combines each warp and the
// four warp sums are added in warp order.  The order is fixed, so two runs
// give the same bits.  Runs are uneven: ~100 slots a row at the 10K-Gaussian
// headline (65,536 pixels, K = 20), but thousands at the texture shapes
// (172,032 pixels x 80 slots on ~1,200 visible Gaussians of 10,242), where a
// thread per (row, channel) would leave the card to a few thousand threads
// walking long runs.  Channels go eight at a time through registers.
//
// What bounds it on the H100: memory (the scatter reads order 8 B, w 4 B and
// d floats of g per slot through two dependent gathers; d_w reads idx and
// writes d_w, 8 B per slot) and, for the scatter, the latency of those
// gathers along the longest run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // d_w: slots per block
constexpr int ROW_THREADS = 128;  // scatter: threads per row
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

__global__ void __launch_bounds__(ROW_THREADS)
attr_scatter_kernel(const long long* __restrict__ order,
                    const long long* __restrict__ starts,
                    const float* __restrict__ w, const float* __restrict__ g,
                    float* __restrict__ out, int K, int d) {
  __shared__ float s_part[ROW_THREADS / 32][CH];
  const long long j = blockIdx.x;
  const long long q0 = starts[j], q1 = starts[j + 1];
  float* orow = out + j * d;
  if (q0 == q1) {
    for (int c = threadIdx.x; c < d; c += ROW_THREADS) orow[c] = 0.0f;
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < d; c0 += CH) {
    const int nc = min(CH, d - c0);
    float acc[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[c] = 0.0f;
    for (long long q = q0 + threadIdx.x; q < q1; q += ROW_THREADS) {
      const long long slot = order[q];
      const float ws = w[slot];
      const float* gp = g + (slot / K) * d + c0;
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (c < nc) acc[c] += ws * gp[c];
    }
#pragma unroll
    for (int c = 0; c < CH; ++c)
      for (int off = 16; off > 0; off >>= 1)
        acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < CH; ++c) s_part[warp][c] = acc[c];
    }
    __syncthreads();
    if ((int)threadIdx.x < nc) {
      float t = s_part[0][threadIdx.x];
      for (int v = 1; v < ROW_THREADS / 32; ++v) t += s_part[v][threadIdx.x];
      orow[c0 + threadIdx.x] = t;
    }
    __syncthreads();
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

cudaError_t launch_scatter(const void* order, const void* starts,
                           const void* w, const void* g, void* out, int K,
                           int d, long long n_rows, cudaStream_t s) {
  attr_scatter_kernel<<<(unsigned)n_rows, ROW_THREADS, 0, s>>>(
      (const long long*)order, (const long long*)starts, (const float*)w,
      (const float*)g, (float*)out, K, d);
  return cudaGetLastError();
}

bool bad_shape(long long n_pix, int K, int d, long long n_rows) {
  return n_pix <= 0 || K <= 0 || d <= 0 || n_rows <= 0 ||
         n_rows > 2147483647LL;
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
// order[starts[j] : starts[j + 1]] of a stable sort of the slot ids.
extern "C" int voge_attr_scatter(const void* order, const void* starts,
                                 const void* w, const void* g, void* out,
                                 long long n_pix, int K, int d,
                                 long long n_rows, void* stream) {
  if (bad_shape(n_pix, K, d, n_rows)) return (int)cudaErrorInvalidValue;
  return (int)launch_scatter(order, starts, w, g, out, K, d, n_rows,
                             (cudaStream_t)stream);
}

// Both halves: d_w (n_pix, K) and d_attr (n_rows, d).
extern "C" int voge_attr_merge_bwd(const void* idx, const void* w,
                                   const void* attrs, const void* g,
                                   const void* order, const void* starts,
                                   void* d_w, void* d_attr, long long n_pix,
                                   int K, int d, long long n_rows, void* stream) {
  if (bad_shape(n_pix, K, d, n_rows) || d_w == nullptr || d_attr == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = launch_dw(idx, g, attrs, d_w, n_pix, K, d, n_rows, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_scatter(order, starts, w, g, d_attr, K, d, n_rows, s);
}

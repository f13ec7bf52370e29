// K4b: the backward of the attribute merge img = sum_k w_k attrs[idx_k]
// (K3f, attr_merge.cu), deterministic, no float atomics.
//
// Replaces voge_tpu/ops/pallas_attr.py::_bwd_unified_kernel (:90, reached
// through attr_merge_bwd_unified_pallas / _attr_bwd_call), which id-matches
// candidate chunks against the selections and contracts on the MXU.  Here the
// two halves are a gather and a segmented sum:
//   d_w[p, k]  = attrs[idx[p, k]] . g_img[p]         (attr_dw_kernel, one
//                thread per slot, channels ascending);
//   d_attr[j]  = sum over slots with idx == j of w * g_img[pixel]
//                (attr_dattr_kernel, one thread per (row, channel)).
// The caller sorts the flattened idx with a stable sort (PyTorch glue, as
// K1's key sort), so each row's slots form one run in ascending slot order,
// and passes the run starts; the kernel sums each run in that order.  Two
// runs give the same bits.
//
// What bounds it on the H100: memory and latency.  At the headline
// (65,536 pixels, K = 20, d = 3) it reads the 1.3M slots twice and writes
// 5 MB of d_w; the per-row runs are short (rows hold ~100 slots) but skewed,
// so the longest run sets the d_attr kernel's tail.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

__global__ void attr_dattr_kernel(const long long* __restrict__ order,
                                  const long long* __restrict__ starts,
                                  const float* __restrict__ w,
                                  const float* __restrict__ g,
                                  float* __restrict__ d_attr, long long n_rows,
                                  int K, int d) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_rows * d) return;
  const long long j = t / d;
  const int c = (int)(t % d);
  float acc = 0.0f;
  for (long long q = starts[j]; q < starts[j + 1]; ++q) {
    const long long slot = order[q];
    acc += w[slot] * g[(slot / K) * d + c];
  }
  d_attr[t] = acc;
}

}  // namespace

extern "C" int voge_attr_merge_bwd(const void* idx, const void* w,
                                   const void* attrs, const void* g,
                                   const void* order, const void* starts,
                                   void* d_w, void* d_attr, long long n_pix,
                                   int K, int d, long long n_rows, void* stream) {
  if (n_pix <= 0 || K <= 0 || d <= 0 || n_rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d_w != nullptr) {
    const long long n = n_pix * K;
    attr_dw_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        (const int*)idx, (const float*)g, (const float*)attrs, (float*)d_w, n,
        K, d, n_rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (d_attr != nullptr) {
    const long long n = n_rows * d;
    attr_dattr_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        (const long long*)order, (const long long*)starts, (const float*)w,
        (const float*)g, (float*)d_attr, n_rows, K, d);
  }
  return (int)cudaGetLastError();
}

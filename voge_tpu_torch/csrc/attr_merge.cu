// K3f: attribute merge forward, img[b, h, w, :] = sum_k w * attrs[idx, :].
//
// Replaces voge_tpu/ops/pallas_attr.py::_fwd_kernel (reached through
// _attr_fwd_call <- attr_merge_compact / attr_merge_fwd_pallas).  The TPU
// kernel streams candidate chunks, builds an id-match matrix per chunk and
// contracts it with the attribute planes on the MXU, because element gathers
// are slow there.  On Hopper a gather is cheap, so this is merge_final
// (aggregation.py:131-154) as one gather-and-reduce pass: one thread per
// (pixel, channel).
//
// What bounds it on the H100: memory.  At 256x256, K=20, d=3 it reads
// 2 * 4 B * K per pixel of slots (10.5 MB, each read by d threads through L1)
// plus the gathered attribute rows (L2-resident: 10K rows * 12 B), and
// writes 0.8 MB: microseconds at 3.35 TB/s, so launch latency dominates.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attr_merge.cuh"

namespace {

__global__ void attr_merge_kernel(const int* __restrict__ idx,
                                  const float* __restrict__ w,
                                  const float* __restrict__ attrs,
                                  float* __restrict__ out, long long n_pix,
                                  int K, int d, long long n_rows) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_pix * d) return;
  const long long pix = t / d;
  const int ch = (int)(t % d);
  out[t] = voge_attr_merge_one(idx + pix * K, w + pix * K, K, attrs, n_rows,
                               d, ch);
}

}  // namespace

extern "C" int voge_attr_merge(const void* idx, const void* w,
                               const void* attrs, void* out, long long n_pix,
                               int K, int d, long long n_rows, void* stream) {
  if (n_pix <= 0 || K <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long n = n_pix * d;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  attr_merge_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)w, (const float*)attrs, (float*)out,
      n_pix, K, d, n_rows);
  return (int)cudaGetLastError();
}

// Shared by K2 (fine_select.cu, its fused attribute image) and K3f
// (attr_merge.cu): one pixel's composited attribute channel,
//   out = sum_k w[k] * attrs[idx[k], ch]   over slots with idx[k] >= 0,
// summed in ascending slot order.  Slots whose id falls outside the
// attribute table read nothing.
#pragma once

__device__ __forceinline__ float voge_attr_merge_one(
    const int* __restrict__ idx, const float* __restrict__ w, int K,
    const float* __restrict__ attrs, long long n_rows, int d, int ch) {
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int i = idx[k];
    if (i >= 0 && i < n_rows) acc += w[k] * attrs[(size_t)i * d + ch];
  }
  return acc;
}

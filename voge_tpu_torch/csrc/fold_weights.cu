// The weight-cotangent fold on its own: g_w -> (dl, da, dd) for every ray.
//
// Replaces voge_tpu/ops/pallas_fine2.py::fold_weights_pallas (kernel at
// :627), which the TPU runs on the select kernel's transposed (slots x rays)
// buffers so that its K occluder sweeps fill the 128 lanes.  Here the fold is
// the device function of fine_bwd.cuh, one thread per ray on image-layout
// (rays, K) arrays; K3 (fine_bwd.cu) calls the same function in its prologue,
// and this entry gives the fold its own check against the plain version.
//
// What bounds it on the H100: arithmetic latency.  Per ray it evaluates
// 2 K^2 exp and K^2 erf (at the headline, 65,536 rays x K = 20: 52M exp and
// 26M erf, ~0.5 GFLOP-equivalent), and reads / writes 8 K floats (42 MB).
// The design keeps the slot arrays in registers (K bucket template, unrolled
// for K <= 32) and never forms a K x K tensor.
// Measured at the headline on an H100 80GB HBM3 at 700 W: 0.36 ms; the K = 20
// bucket holds 219 registers, so few warps hide the exp / erf latency.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fine_bwd.cuh"

namespace {

constexpr int THREADS = 128;

struct Args {
  const float *l, *a, *d, *w, *gw;  // (n_rays, K)
  float *dl, *da, *dd;              // (n_rays, K)
  long long n_rays;
  int K;
  float ow;
};

template <int KB>
__global__ void __launch_bounds__(THREADS) fold_kernel(const Args p) {
  const long long ray = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (ray >= p.n_rays) return;
  const size_t o = (size_t)ray * p.K;
  float l[KB], e[KB], s[KB], G[KB];
  voge_fold_load<KB>(p.l + o, p.a + o, p.d + o, p.K, l, e, s);
#pragma unroll
  for (int k = 0; k < KB; ++k) G[k] = k < p.K ? p.gw[o + k] * p.w[o + k] : 0.0f;
  voge_fold_ray<KB>(l, e, s, G, p.K, p.ow,
                        [&](int k, float dl, float da, float dd) {
                          p.dl[o + k] = dl;
                          p.da[o + k] = da;
                          p.dd[o + k] = dd;
                        });
}

template <int KB>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((p.n_rays + THREADS - 1) / THREADS);
  fold_kernel<KB><<<blocks, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int voge_fold_weights(const void* l, const void* a, const void* d,
                                 const void* w, const void* gw, void* dl,
                                 void* da, void* dd, long long n_rays, int K,
                                 float ow, void* stream) {
  if (n_rays <= 0 || K <= 0 || K > 128) return (int)cudaErrorInvalidValue;
  Args p;
  p.l = (const float*)l;
  p.a = (const float*)a;
  p.d = (const float*)d;
  p.w = (const float*)w;
  p.gw = (const float*)gw;
  p.dl = (float*)dl;
  p.da = (float*)da;
  p.dd = (float*)dd;
  p.n_rays = n_rays;
  p.K = K;
  p.ow = ow;
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 8) return (int)launch<8>(p, s);
  if (K <= 16) return (int)launch<16>(p, s);
  if (K <= 32) return (int)launch<32>(p, s);
  if (K <= 64) return (int)launch<64>(p, s);
  return (int)launch<128>(p, s);
}

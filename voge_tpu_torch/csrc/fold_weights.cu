// The weight-cotangent fold on its own: g_w -> (dl, da, dd) for every ray.
//
// Replaces voge_tpu/ops/pallas_fine2.py::fold_weights_pallas (kernel at
// :627), which the TPU runs on the select kernel's transposed (slots x rays)
// buffers so that its K occluder sweeps fill the 128 lanes.  Here the fold is
// the per-slot device code of fine_bwd.cuh on image-layout (rays, K) arrays,
// one thread per (ray, slot); K3's per-slot stage (fine_bwd.cu) calls the same
// functions, so the fold's entry and K3 cannot drift apart, and this entry
// gives the fold its own check against the plain version.  No main path runs
// it: a frozen scene's backward folds inside K3's per-slot kernel.
//
// What bounds it on the H100: arithmetic.  Per ray it evaluates 2 K^2 exp
// and K^2 erf (at the headline, 65,536 rays x K = 20: 52M exp and 26M erf)
// over the slots up to the ray's last occupied one, and reads / writes 8 K
// floats a ray (42 MB).  A thread holds one slot and loops over its ray's
// slots in shared memory, so it needs few registers and many warps hide the
// exp / erf latency; the loads and stores are coalesced.  Measured by
// chip_smoke.py on an H100 80GB HBM3 at 700 W: 32 registers, no spills,
// 0.030 ms at the headline.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fine_bwd.cuh"

namespace {

struct Args {
  const float *l, *a, *d, *w, *gw;  // (n_rays, K)
  float *dl, *da, *dd;              // (n_rays, K)
  long long n_rays;
  int K;
  float ow;
};

__global__ void __launch_bounds__(VOGE_SLOT_THREADS) fold_kernel(const Args p) {
  __shared__ VogeFoldBlock fb;
  const int K = p.K, RB = voge_rays_per_block(K);
  const int t = threadIdx.x, r = t / K, k = t - r * K;
  const long long ray = (long long)blockIdx.x * RB + r;
  const bool live = ray < p.n_rays;
  const size_t o = (size_t)ray * K + k;
  voge_fold_clear(fb, RB);
  __syncthreads();
  if (live) voge_fold_put(fb, t, r, k, p.l[o], p.a[o], p.d[o], p.gw[o] * p.w[o]);
  __syncthreads();
  if (!live) return;
  float dl, da, dd;
  voge_fold_slot(fb, r, k, K, p.ow, dl, da, dd);
  p.dl[o] = dl;
  p.da[o] = da;
  p.dd[o] = dd;
}

}  // namespace

extern "C" int voge_fold_weights(const void* l, const void* a, const void* d,
                                 const void* w, const void* gw, void* dl,
                                 void* da, void* dd, long long n_rays, int K,
                                 float ow, void* stream) {
  if (n_rays <= 0 || K <= 0 || K > 128) return (int)cudaErrorInvalidValue;
  const int RB = voge_rays_per_block(K);
  const long long blocks = (n_rays + RB - 1) / RB;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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
  fold_kernel<<<(unsigned)blocks, RB * K, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

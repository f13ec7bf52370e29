// K3: the fine backward of the select (with the weight fold and the fused
// attribute VJP), deterministic, no float atomics.  Two C entries, one per
// step below (voge_fine_bwd_slots, voge_fine_bwd_runs), serve both of the
// port's wrappers:
//  - fine_bwd, the emission-compacted path, with d attribute columns:
//    replaces voge_tpu/ops/pallas_bwd.py::_bwd_t_kernel (reached through
//    fine_bwd_compact_t_pallas <- fine._rt_fine_kern_c_bwd);
//  - fine_bwd_global, the global candidate space (the no-coarse path and the
//    two-stage tracer), with none: replaces pallas_bwd.py::_bwd_unified_kernel
//    (fine_bwd_unified_pallas <- fine._rt_fine_kern_bwd).
// Both compute what their TPU kernels compute, from the select's saved
// image-layout outputs, as per-Gaussian rows (B * P, 12 + d): a slot's id
// b * P + p is its row of the (B * P, 16) feature table and of the output.
//
//  1. per slot (fine_bwd_slots_kernel, one thread per (ray, slot); the block
//     geometry and the fold are the device code of fine_bwd.cuh):
//     - with attributes, d_w = attrs[id] . g_img (channels ascending,
//       pallas_bwd.py:639-684), added to the weight cotangent g_w;
//     - the fold of g_w w into (g_len, g_act, g_dsd) (pallas_bwd.py:697-759).
//       With neither g_w nor attributes the fold is skipped: with G = 0 each
//       of its terms is a signed zero, and adding a zero to a cotangent (or
//       to the +0 of an absent one) leaves its bits, so the result equals the
//       fold of an explicit zero g_w to the bit (and w, act may be absent);
//     - the entry-space chain rule from the saved primals, ksk = dsd and
//       msk = len * dsd (pallas_bwd.py:760-772):
//         g_ksk = (g_a msk - g_l) msk / ksk^2 + g_d
//         g_msk = (g_l - 2 g_a msk) / ksk,   g_msm = g_a;
//       each slot keeps (g_d, c = g_l / ksk, g_a, l), zero on empty slots,
//       written once (16 bytes, coalesced);
//     - when ray gradients are wanted (pallas_bwd.py:883-909), each thread
//       forms its slot's term g_sk (Lambda + Lambda^T) r + g_msk Lambda^T mu
//       from the feature row it reads by id, and one thread per (ray,
//       component) sums the K terms from shared memory in ascending slot
//       order: the order of the split per-ray half (fine_bwd_split.cu).
//  2. per Gaussian (fine_bwd_runs_kernel, pallas_bwd.py:835-881): the caller
//     sorts the flattened slot ids with one stable sort and passes each id's
//     run (order, starts), as K4b does; one warp walks one run, lane l
//     taking slots l, l + 32, ... in run (= slot) order, and a fixed shuffle
//     tree sums the lanes:
//       g_mu     = sum g_msk Lambda r + g_msm (Lambda + Lambda^T) mu
//       g_Lambda = sum g_ksk r r^T + g_msk mu r^T + g_msm mu mu^T
//       d_attr   = sum w g_img
//     An empty run writes its zero row and reads no table row.  Two runs of
//     the entry give the same bits.  No slot is compared with a Gaussian it
//     does not hold (the TPU kernels' one-hot match costs O(P R K)).
//
// Both sides evaluate the chain rule around the residual delta = mu - l r, as
// the forward evaluates act = delta^T Lambda delta (ops/cuda_fine_bwd.py has
// the three formulas): voge_tpu's terms in mu mu^T and mu r^T are ~l^2 (~36 at
// the headline) times larger than their sum, and the TPU kernel's
// sum-then-combine (T0, Tr, Trr per row, then mu) loses that factor in float32.
//
// Not carried over from the TPU kernels: the transposed (Kp, R) layout, the
// doubled grid, the visit lists, the per-supertile candidate rows and their
// gather back to Gaussians through the inverse emission map, and the MXU
// one-hot contractions.
//
// What bounds it on the H100.  Step 1 is arithmetic: 2 K^2 exp and K^2 erf a
// ray, over the occupied slots (headline: 65,536 rays, K = 20), spread over
// one thread a slot.  Step 2 reads 8 bytes of `order`, 16 of coefficients and
// 12 of the ray a slot, scattered, and 64 bytes of table a Gaussian.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 40 and 56
// registers, no spills; at the headline 0.040 ms for step 1, 0.139 for the
// sort (torch, in the wrapper: the largest part) and 0.020 for step 2; at
// the ShapeFitting shapes 0.083, 0.191 and 0.021.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fine_bwd.cuh"

namespace {

constexpr int GAUSS_THREADS = 128;  // 4 warps, a Gaussian each
constexpr int CH = 4;               // attribute channels a pass over a run

struct Args {
  const float* rays;     // (n_pix, 3)
  const float* table;    // (n_tab, 16) feature rows, indexed by slot id
  const int* idx;        // (n_pix, K) selected ids, -1 empty
  const float* len;      // (n_pix, K) saved primals (act, w: null without the fold)
  const float* act;
  const float* dsd;
  const float* w;
  const float* g_len;    // (n_pix, K) cotangents, each may be null
  const float* g_act;
  const float* g_dsd;
  const float* g_w;
  const float* attrs;    // (n_tab, d) or null
  const float* g_img;    // (n_pix, d) or null
  float4* coef;          // (n_pix, K) scratch: g_d, g_l / ksk, g_a, len
  float* o_rays;         // (n_pix, 3) or null
  long long n_pix, n_tab;
  int K, d;
  float ow;
  bool fold;
};

__global__ void __launch_bounds__(VOGE_SLOT_THREADS) fine_bwd_slots_kernel(const Args a) {
  __shared__ VogeFoldBlock fb;
  __shared__ float s_term[VOGE_SLOT_THREADS * 3];  // each slot's ray-gradient term
  const int K = a.K, RB = voge_rays_per_block(K);
  const int t = threadIdx.x, r = t / K, k = t - r * K;
  const long long ray0 = (long long)blockIdx.x * RB;
  const long long pix = ray0 + r;
  const bool live = pix < a.n_pix;
  const size_t o = (size_t)pix * K + k;
  const int id = live ? a.idx[o] : -1;

  float dl = 0.0f, da = 0.0f, dd = 0.0f;
  if (a.fold) {
    voge_fold_clear(fb, RB);
    __syncthreads();
    if (live) {
      float gw = voge_ld(a.g_w, o);
      if (a.attrs != nullptr && id >= 0 && id < a.n_tab) {
        float dw = 0.0f;  // channels ascending
        for (int c = 0; c < a.d; ++c)
          dw += a.attrs[(size_t)id * a.d + c] * a.g_img[(size_t)pix * a.d + c];
        gw += dw;
      }
      voge_fold_put(fb, t, r, k, a.len[o], a.act[o], a.dsd[o], gw * a.w[o]);
    }
    __syncthreads();
    if (id >= 0) voge_fold_slot(fb, r, k, K, a.ow, dl, da, dd);
  }

  float4 cf = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (id >= 0) {
    const float ga = voge_ld(a.g_act, o) + da;
    const float gd = voge_ld(a.g_dsd, o) + dd;
    const float cl = (voge_ld(a.g_len, o) + dl) / a.dsd[o];
    cf = make_float4(gd, cl, ga, a.len[o]);
  }
  if (live) a.coef[o] = cf;
  if (a.o_rays == nullptr) return;  // the same for the whole block

  float g[3] = {0.0f, 0.0f, 0.0f};
  if (id >= 0 && id < a.n_tab) {
    const float rv[3] = {a.rays[pix * 3 + 0], a.rays[pix * 3 + 1], a.rays[pix * 3 + 2]};
    voge_slot_ray(a.table + (size_t)id * 16, rv, cf.x, cf.y, cf.z, cf.w, g);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) s_term[t * 3 + i] = g[i];
  __syncthreads();
  for (int u = t; u < 3 * RB; u += blockDim.x) {  // component u % 3 of ray u / 3
    const int rr = u / 3, ci = u - rr * 3;
    if (ray0 + rr < a.n_pix) {
      float sum = 0.0f;
      for (int q = 0; q < K; ++q) sum += s_term[(rr * K + q) * 3 + ci];
      a.o_rays[(ray0 + rr) * 3 + ci] = sum;
    }
  }
}

// One warp per Gaussian j of the (n_tab, 16) table: g_mu (3), g_Lambda (9)
// and d attribute columns summed over the slots order[starts[j] ..
// starts[j + 1]) (step 2).
__global__ void __launch_bounds__(GAUSS_THREADS) fine_bwd_runs_kernel(
    const float* __restrict__ table, const float* __restrict__ rays,
    const float4* __restrict__ coef, const float* __restrict__ w,
    const float* __restrict__ g_img, const long long* __restrict__ order,
    const long long* __restrict__ starts, float* __restrict__ out, long long n_tab,
    int K, int d) {
  const long long j = ((long long)blockIdx.x * GAUSS_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= n_tab) return;  // j is the same for the whole warp
  const int C = 12 + d;
  const long long t0 = starts[j], t1 = starts[j + 1];
  float* o = out + (size_t)j * C;
  if (t0 == t1) {  // an empty run: the zero row, and no table read
    for (int c = lane; c < C; c += 32) o[c] = 0.0f;
    return;
  }
  float L[9], mu[3];
  const float* f = table + (size_t)j * 16;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    mu[i] = f[13 + i];
#pragma unroll
    for (int q = 0; q < 3; ++q) L[3 * i + q] = f[4 + 3 * i + q];
  }
  float acc[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) acc[q] = 0.0f;
  for (long long t = t0 + lane; t < t1; t += 32) {
    const long long slot = order[t];
    const float4 cf = coef[slot];  // (g_d, c, g_a, l)
    const float* rp = rays + (slot / K) * 3;
    const float r[3] = {rp[0], rp[1], rp[2]};
    voge_slot_gauss(L, mu, r, cf.x, cf.y, cf.z, cf.w, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < 12; ++q) acc[q] += __shfl_down_sync(0xffffffffu, acc[q], off);
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < 12; ++q) o[q] = acc[q];

  for (int c0 = 0; c0 < d; c0 += CH) {  // the attribute columns, CH at a time
    float ta[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) ta[c] = 0.0f;
    for (long long t = t0 + lane; t < t1; t += 32) {
      const long long slot = order[t];
      const float wk = w[slot];
      const float* gp = g_img + (slot / K) * d + c0;
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (c0 + c < d) ta[c] += wk * gp[c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int c = 0; c < CH; ++c) ta[c] += __shfl_down_sync(0xffffffffu, ta[c], off);
    if (lane == 0)
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (c0 + c < d) o[12 + c0 + c] = ta[c];
  }
}

}  // namespace

// Step 1.  ``table`` (n_tab = B * P, 16) and ``attrs`` (n_tab, d; null when
// d = 0) are indexed by slot id; ``coef`` (n_pix, K, 4) receives the slots'
// coefficients, ``o_rays`` (n_pix, 3) the ray gradient (null: skipped).  The
// fold runs when g_w or attributes are given, and then needs act and w.
extern "C" int voge_fine_bwd_slots(
    const void* rays, const void* table, const void* idx, const void* len,
    const void* act, const void* dsd, const void* w, const void* g_len,
    const void* g_act, const void* g_dsd, const void* g_w, const void* attrs,
    const void* g_img, void* coef, void* o_rays, long long n_pix, long long n_tab,
    int K, int d, float ow, void* stream) {
  if (n_pix <= 0 || n_tab <= 0 || K <= 0 || K > 128 || d < 0)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.fold = g_w != nullptr || d > 0;
  if (d > 0 && (attrs == nullptr || g_img == nullptr)) return (int)cudaErrorInvalidValue;
  if (a.fold && (act == nullptr || w == nullptr)) return (int)cudaErrorInvalidValue;
  const int RB = voge_rays_per_block(K);
  const long long blocks = (n_pix + RB - 1) / RB;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.rays = (const float*)rays;
  a.table = (const float*)table;
  a.idx = (const int*)idx;
  a.len = (const float*)len;
  a.act = (const float*)act;
  a.dsd = (const float*)dsd;
  a.w = (const float*)w;
  a.g_len = (const float*)g_len;
  a.g_act = (const float*)g_act;
  a.g_dsd = (const float*)g_dsd;
  a.g_w = (const float*)g_w;
  a.attrs = d > 0 ? (const float*)attrs : nullptr;
  a.g_img = d > 0 ? (const float*)g_img : nullptr;
  a.coef = (float4*)coef;
  a.o_rays = (float*)o_rays;
  a.n_pix = n_pix;
  a.n_tab = n_tab;
  a.K = K;
  a.d = d;
  a.ow = ow;
  fine_bwd_slots_kernel<<<(unsigned)blocks, RB * K, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Step 2.  ``order`` / ``starts`` are the stable sort of the flattened idx
// (n_pix * K, int64) and each id's run start (n_tab + 1, int64; slots that
// hold no row sort behind the last run); ``coef`` is step 1's; ``w`` and
// ``g_img`` (n_pix, d) are read only when d > 0; ``o_rows`` (n_tab, 12 + d).
extern "C" int voge_fine_bwd_runs(
    const void* table, const void* rays, const void* coef, const void* w,
    const void* g_img, const void* order, const void* starts, void* o_rows,
    long long n_tab, int K, int d, void* stream) {
  if (n_tab <= 0 || K <= 0 || d < 0) return (int)cudaErrorInvalidValue;
  if (d > 0 && (w == nullptr || g_img == nullptr)) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_tab * 32 + GAUSS_THREADS - 1) / GAUSS_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fine_bwd_runs_kernel<<<(unsigned)blocks, GAUSS_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)rays, (const float4*)coef, (const float*)w,
      (const float*)g_img, (const long long*)order, (const long long*)starts,
      (float*)o_rows, n_tab, K, d);
  return (int)cudaGetLastError();
}

// K3: the fine backward of the select (with the weight fold and the fused
// attribute VJP), deterministic, no float atomics.  Two kernels, one C entry
// each (voge_fine_bwd_slots, voge_fine_bwd_runs), serve every backward
// wrapper of the port (ops/cuda_fine_bwd.py):
//  - fine_bwd, the emission-compacted path, with d attribute columns:
//    replaces voge_tpu/ops/pallas_bwd.py::_bwd_t_kernel (reached through
//    fine_bwd_compact_t_pallas <- fine._rt_fine_kern_c_bwd);
//  - fine_bwd_global, the global candidate space (the no-coarse path and the
//    two-stage tracer), with none: replaces pallas_bwd.py::_bwd_unified_kernel
//    (fine_bwd_unified_pallas <- fine._rt_fine_kern_bwd);
//  - fine_bwd_gauss, the per-Gaussian half of the global backward split in
//    two: replaces pallas_bwd.py::_bwd_gauss_kernel (fine_bwd_gauss_pallas);
//    step 1 with the fold and the ray gradient off, then step 2;
//  - fine_bwd_rays, the per-ray half: replaces pallas_bwd.py::_bwd_rays_kernel
//    (fine_bwd_rays_pallas); step 1 alone with no coefficient written, the
//    fold fused in where a weight cotangent is given (a frozen scene).
// All compute what their TPU kernels compute, from the select's saved
// image-layout outputs, as per-Gaussian rows (B * P, 12 + d): a slot's id
// b * P + p is its row of the (B * P, 16) feature table and of the output.
// voge_tpu splits the backward past 262,144 Gaussians (the unified kernel's
// output block outgrows the TPU's VMEM); the card has no such limit, so the
// split is only a question of what is wanted: the per-Gaussian half (rows)
// and the per-ray half (rays) are the two steps below, and a frozen scene
// runs step 1 alone.
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
//       written once when step 2 follows (16 bytes, coalesced; no write for a
//       rays-only launch);
//     - when ray gradients are wanted (pallas_bwd.py:883-909), each thread
//       reads its slot's feature row by id (three 16-byte loads) and forms
//       its term g_sk (Lambda + Lambda^T) r + g_msk Lambda^T mu, and one
//       thread per (ray, component) sums the K terms from shared memory in
//       ascending slot order (the order of the per-ray TPU kernel, which
//       walks a ray's slots in turn).  The same pass can sum each ray's
//       slots' mean gradients g_mu the same way: minus their sum over an
//       image's rays is the gradient of its camera centre, so a scene that
//       needs no gradient of its own (pose refinement) needs no step 2.
//  2. per Gaussian (fine_bwd_runs_kernel, pallas_bwd.py:835-881): the caller
//     groups the flattened slot ids by id (slot_runs.cu: the valid slots in
//     slot order) and passes each id's run (order, starts), as K4b does; a
//     group of G lanes walks one run, lane l taking slots l, l + G, ... in
//     run (= slot) order, and a fixed shuffle tree of log2 G levels sums the
//     lanes:
//       g_mu     = sum g_msk Lambda r + g_msm (Lambda + Lambda^T) mu
//       g_Lambda = sum g_ksk r r^T + g_msk mu r^T + g_msm mu mu^T
//       d_attr   = sum w g_img
//     An empty run writes its zero row and reads no table row.  Two runs of
//     the entry give the same bits; G is the wrapper's function of the shapes
//     alone (ops/cuda_fine_bwd.py, group_width), 32 wherever a Gaussian holds
//     many slots, where this is the warp a Gaussian of earlier versions, bit
//     for bit.  No slot is compared with a Gaussian it does not hold (the TPU
//     kernels' one-hot match costs O(P R K)).
//
// Both sides evaluate the chain rule around the residual delta = mu - l r, as
// the forward evaluates act = delta^T Lambda delta (ops/cuda_fine_bwd.py has
// the three formulas): voge_tpu's terms in mu mu^T and mu r^T are ~l^2 (~36 at
// the headline) times larger than their sum, and the TPU kernel's
// sum-then-combine (T0, Tr, Trr per row, then mu) loses that factor in float32.
//
// Not carried over from the TPU kernels: the transposed (Kp, R) layout, the
// doubled grid, the (chunk, bin, ray-chunk) grid that revisits an output
// block, the visit lists and culling masks, the per-supertile candidate rows
// and their gather back to Gaussians through the inverse emission map, and
// the MXU one-hot contractions.
//
// What bounds it on the H100.  Step 1 is arithmetic where it folds: 2 K^2
// exp and K^2 erf a ray, over the occupied slots (headline: 65,536 rays,
// K = 20), spread over one thread a slot; without the fold it reads the slot
// planes (coalesced) and a 64-byte table row a slot (scattered, mostly from
// L2: neighbouring rays select the same Gaussians).  Step 2 reads 4 bytes of
// `order`, 16 of coefficients and 12 of the ray a slot, scattered, and 64
// bytes of table a Gaussian.  Where Gaussians hold few slots (a 300,000-point
// cloud at 320x320, K = 20: 5.8 a Gaussian that holds any, two fifths hold
// none), a warp a Gaussian leaves most lanes idle and spends five shuffle
// levels on a handful of terms, so G falls to 4 there.  Measured by
// chip_smoke.py on an H100 80GB HBM3 at 700 W: 40 registers for step 1, 56
// for step 2 at every G, no spills; times in PERF.md section 6, rows 6-9.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fine_bwd.cuh"

namespace {

constexpr int GAUSS_THREADS = 128;  // 128 / G Gaussians a block
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
  float4* coef;          // (n_pix, K) g_d, g_l / ksk, g_a, len; or null
  float* o_rays;         // (n_pix, 3) or null
  float* o_mu;           // (n_pix, 3) or null: each ray's slots' g_mu summed
  long long n_pix, n_tab;
  int K, d;
  float ow;
  bool fold;
};

// The mean's side of one slot's chain rule (the first three sums of
// voge_slot_gauss, from the slot's feature row f): g += g_mu.
__device__ __forceinline__ void voge_slot_mu(const float* f, const float (&r)[3],
                                             float c, float ga, float l,
                                             float (&g)[3]) {
  const float gal = ga * l;
  float dlt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dlt[i] = f[13 + i] - l * r[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float Lr = 0.0f, La = 0.0f, Lsd = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float lij = f[4 + 3 * i + j], lji = f[4 + 3 * j + i];
      Lr += lij * r[j];
      La += (lij - lji) * r[j];
      Lsd += (lij + lji) * dlt[j];
    }
    g[i] += c * Lr - gal * La + ga * Lsd;
  }
}

__global__ void __launch_bounds__(VOGE_SLOT_THREADS) fine_bwd_slots_kernel(const Args a) {
  __shared__ VogeFoldBlock fb;
  __shared__ float s_term[VOGE_SLOT_THREADS * 6];  // each slot's ray / mean terms
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
  if (live && a.coef != nullptr) a.coef[o] = cf;
  // terms a slot: the ray's (3) then the mean's (3), as asked; the same for
  // the whole block
  const int nr = a.o_rays != nullptr ? 3 : 0;
  const int C = nr + (a.o_mu != nullptr ? 3 : 0);
  if (C == 0) return;

  float g[3] = {0.0f, 0.0f, 0.0f}, m[3] = {0.0f, 0.0f, 0.0f};
  if (id >= 0 && id < a.n_tab) {
    float f[16];  // Lambda at 4..12, mu at 13..15: three 16-byte loads
    const float4* row = reinterpret_cast<const float4*>(a.table) + (size_t)id * 4;
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      const float4 v = row[q];
      f[4 * q + 0] = v.x;
      f[4 * q + 1] = v.y;
      f[4 * q + 2] = v.z;
      f[4 * q + 3] = v.w;
    }
    const float rv[3] = {a.rays[pix * 3 + 0], a.rays[pix * 3 + 1], a.rays[pix * 3 + 2]};
    if (nr) voge_slot_ray(f, rv, cf.x, cf.y, cf.z, cf.w, g);
    if (a.o_mu != nullptr) voge_slot_mu(f, rv, cf.y, cf.z, cf.w, m);
  }
  float* st = s_term + t * C;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (nr) st[i] = g[i];
    if (C > nr) st[nr + i] = m[i];
  }
  __syncthreads();
  for (int u = t; u < C * RB; u += blockDim.x) {  // component u % C of ray u / C
    const int rr = u / C, ci = u - rr * C;
    if (ray0 + rr < a.n_pix) {
      float sum = 0.0f;
      for (int q = 0; q < K; ++q) sum += s_term[(rr * K + q) * C + ci];
      float* out = ci < nr ? a.o_rays : a.o_mu;
      out[(ray0 + rr) * 3 + (ci < nr ? ci : ci - nr)] = sum;
    }
  }
}

// A group of G lanes a Gaussian j of the (n_tab, 16) table: g_mu (3),
// g_Lambda (9) and d attribute columns summed over the slots order[starts[j]
// .. starts[j + 1]) (step 2).  Every lane of a warp reaches the shuffles (no
// early exit), so a warp may hold groups past n_tab or with empty runs.
template <int G>
__global__ void __launch_bounds__(GAUSS_THREADS) fine_bwd_runs_kernel(
    const float* __restrict__ table, const float* __restrict__ rays,
    const float4* __restrict__ coef, const float* __restrict__ w,
    const float* __restrict__ g_img, const int* __restrict__ order,
    const long long* __restrict__ starts, float* __restrict__ out, long long n_tab,
    int K, int d) {
  const long long j = ((long long)blockIdx.x * GAUSS_THREADS + threadIdx.x) / G;
  const int lane = threadIdx.x & (G - 1);
  const bool own = j < n_tab;
  const long long t0 = own ? starts[j] : 0, t1 = own ? starts[j + 1] : 0;
  const int C = 12 + d;
  float* o = out + (size_t)j * C;
  float acc[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) acc[q] = 0.0f;
  if (t1 > t0) {  // an empty run reads no table row
    float L[9], mu[3];
    const float* f = table + (size_t)j * 16;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mu[i] = f[13 + i];
#pragma unroll
      for (int q = 0; q < 3; ++q) L[3 * i + q] = f[4 + 3 * i + q];
    }
    for (long long t = t0 + lane; t < t1; t += G) {
      const long long slot = order[t];
      const float4 cf = coef[slot];  // (g_d, c, g_a, l)
      const float* rp = rays + (slot / K) * 3;
      const float r[3] = {rp[0], rp[1], rp[2]};
      voge_slot_gauss(L, mu, r, cf.x, cf.y, cf.z, cf.w, acc);
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < 12; ++q) acc[q] += __shfl_down_sync(0xffffffffu, acc[q], off, G);
  if (own && lane == 0)
#pragma unroll
    for (int q = 0; q < 12; ++q) o[q] = acc[q];

  for (int c0 = 0; c0 < d; c0 += CH) {  // the attribute columns, CH at a time
    float ta[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) ta[c] = 0.0f;
    for (long long t = t0 + lane; t < t1; t += G) {
      const long long slot = order[t];
      const float wk = w[slot];
      const float* gp = g_img + (slot / K) * d + c0;
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (c0 + c < d) ta[c] += wk * gp[c];
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
      for (int c = 0; c < CH; ++c) ta[c] += __shfl_down_sync(0xffffffffu, ta[c], off, G);
    if (own && lane == 0)
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (c0 + c < d) o[12 + c0 + c] = ta[c];
  }
}

template <int G>
int launch_runs(const float* table, const float* rays, const float4* coef, const float* w,
                const float* g_img, const int* order, const long long* starts, float* out,
                long long n_tab, int K, int d, cudaStream_t stream) {
  const long long blocks = (n_tab * G + GAUSS_THREADS - 1) / GAUSS_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fine_bwd_runs_kernel<G><<<(unsigned)blocks, GAUSS_THREADS, 0, stream>>>(
      table, rays, coef, w, g_img, order, starts, out, n_tab, K, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Step 1.  ``table`` (n_tab = B * P, 16) and ``attrs`` (n_tab, d; null when
// d = 0) are indexed by slot id; ``coef`` (n_pix, K, 4) receives the slots'
// coefficients (null: none written), ``o_rays`` (n_pix, 3) the ray gradient
// and ``o_mu`` (n_pix, 3) each ray's slots' mean gradients summed (each null:
// skipped).  The fold runs when g_w or attributes are given, and then needs
// act and w.
extern "C" int voge_fine_bwd_slots(
    const void* rays, const void* table, const void* idx, const void* len,
    const void* act, const void* dsd, const void* w, const void* g_len,
    const void* g_act, const void* g_dsd, const void* g_w, const void* attrs,
    const void* g_img, void* coef, void* o_rays, void* o_mu, long long n_pix,
    long long n_tab, int K, int d, float ow, void* stream) {
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
  a.o_mu = (float*)o_mu;
  a.n_pix = n_pix;
  a.n_tab = n_tab;
  a.K = K;
  a.d = d;
  a.ow = ow;
  fine_bwd_slots_kernel<<<(unsigned)blocks, RB * K, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Step 2.  ``order`` / ``starts`` are the flattened idx's valid slots
// grouped by id in slot order (int32) and each id's run start (n_tab + 1,
// int64), from slot_runs.cu; ``coef`` is step 1's; ``w`` and
// ``g_img`` (n_pix, d) are read only when d > 0; ``o_rows`` (n_tab, 12 + d);
// ``group`` the lanes a Gaussian: 4, 8, 16 or 32.
extern "C" int voge_fine_bwd_runs(
    const void* table, const void* rays, const void* coef, const void* w,
    const void* g_img, const void* order, const void* starts, void* o_rows,
    long long n_tab, int K, int d, int group, void* stream) {
  if (n_tab <= 0 || K <= 0 || d < 0) return (int)cudaErrorInvalidValue;
  if (d > 0 && (w == nullptr || g_img == nullptr)) return (int)cudaErrorInvalidValue;
  const float* tb = (const float*)table;
  const float* rs = (const float*)rays;
  const float4* cf = (const float4*)coef;
  const float* wp = (const float*)w;
  const float* gi = (const float*)g_img;
  const int* od = (const int*)order;
  const long long* st = (const long long*)starts;
  float* out = (float*)o_rows;
  cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 4: return launch_runs<4>(tb, rs, cf, wp, gi, od, st, out, n_tab, K, d, s);
    case 8: return launch_runs<8>(tb, rs, cf, wp, gi, od, st, out, n_tab, K, d, s);
    case 16: return launch_runs<16>(tb, rs, cf, wp, gi, od, st, out, n_tab, K, d, s);
    case 32: return launch_runs<32>(tb, rs, cf, wp, gi, od, st, out, n_tab, K, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

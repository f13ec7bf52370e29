// Device code shared by the fine backward kernels: the analytic backward of
// the erf transmittance compositing (the weight fold: K3's per-slot stage in
// fine_bwd.cu and the standalone fold, fold_weights.cu), and one slot's chain
// rule (the per-Gaussian and per-ray sides of fine_bwd.cu, at the end of this
// file).
//
// Replaces the body of voge_tpu/ops/pallas_fine2.py::fold_weights_pallas
// (kernel at :627; the same math sits in pallas_bwd.py:697-759).  With
//   w_m   = e_m exp(-ow occ_m) e^0.5,   e_m = exp(-a_m),  s_k = sqrt(d_k + 1e-10)
//   occ_m = sum_k e_k Phi((l_m - l_k) s_k),  Phi = (erf + 1) / 2,
//   phi   = exp(-x^2) / sqrt(pi),  G_m = g_w_m w_m
// the cotangents of (l, a, d) are
//   da_k = -G_k + ow e_k A_k               A_k = sum_m G_m Phi((l_m - l_k) s_k)
//   dl_k = -ow (G_k B_k - e_k s_k C_k)     B_k = sum_j e_j s_j phi((l_k - l_j) s_j)
//   dd_k = -ow e_k D_k / (2 s_k)           C_k = sum_m G_m phi((l_m - l_k) s_k)
//                                          D_k = sum_m G_m phi(...) (l_m - l_k)
// Every sum runs over slots in ascending order.  Invalid slots carry
// l = 1e10, e = 0, s = 1e-5 and G = 0, which zeroes their contributions.
//
// One thread per (ray, slot).  A block takes whole rays, VOGE_SLOT_THREADS /
// K of them (one when K passes it), thread t holding slot t % K of ray t / K,
// so a warp's lanes hold consecutive slots and no lane idles between rays.
// The block stages l, e, s and G of its rays in shared memory (loads and the
// later stores coalesced over the image layout), then each thread forms B, A,
// C and D of its own slot in one loop over the ray's slots.  No per-thread
// array of length K, no K template: the registers stay few at every K and
// enough warps are in flight to hide the exp / erf latency.  The loop stops
// after the ray's last slot with e or G nonzero: every later slot adds an
// exact zero to each sum (e = G = 0 and, for finite inputs, phi and Phi are
// finite), and a sum that starts at +0 is unchanged by adding zeros, so the
// bits are those of the full loop; the select leaves its empty slots last, so
// a ray with few hits folds few slots.
#pragma once

#include <cuda_runtime.h>

constexpr float VOGE_INV_SQRT_PI = 0.5641895835477563f;
constexpr int VOGE_SLOT_THREADS = 256;   // the most threads a per-slot block holds

// Rays a per-slot block takes at K slots a ray; its threads are that times K.
__host__ __device__ inline int voge_rays_per_block(int K) {
  return K >= VOGE_SLOT_THREADS ? 1 : VOGE_SLOT_THREADS / K;
}

// One block's rays, slot t = r * K + k, staged for the fold.
struct VogeFoldBlock {
  float l[VOGE_SLOT_THREADS], e[VOGE_SLOT_THREADS], s[VOGE_SLOT_THREADS],
      G[VOGE_SLOT_THREADS];
  int n[VOGE_SLOT_THREADS];  // per ray: 1 + its last slot with e or G nonzero
};

// Before staging (then __syncthreads): no ray has a slot to fold yet.
__device__ __forceinline__ void voge_fold_clear(VogeFoldBlock& fb, int rays) {
  if ((int)threadIdx.x < rays) fb.n[threadIdx.x] = 0;
}

// Stage slot k of the block's ray r (then __syncthreads) from its len l, act
// a, dsd d and weight cotangent times weight G.
__device__ __forceinline__ void voge_fold_put(VogeFoldBlock& fb, int t, int r, int k,
                                              float l, float a, float d, float G) {
  const float e = expf(-a);
  fb.l[t] = l;
  fb.e[t] = e;
  fb.s[t] = sqrtf(d + 1e-10f);
  fb.G[t] = G;
  if (e != 0.0f || G != 0.0f) atomicMax(&fb.n[r], k + 1);  // an integer max: no order
}

// The fold of slot k of the block's ray r (K slots a ray): (dl, da, dd).
__device__ __forceinline__ void voge_fold_slot(const VogeFoldBlock& fb, int r, int k,
                                               int K, float ow, float& dl, float& da,
                                               float& dd) {
  const float* l = fb.l + r * K;
  const float* e = fb.e + r * K;
  const float* s = fb.s + r * K;
  const float* G = fb.G + r * K;
  const float lk = l[k], sk = s[k];
  float B = 0.0f, A = 0.0f, C = 0.0f, D = 0.0f;
  const int n = fb.n[r];
  for (int m = 0; m < n; ++m) {
    const float lm = l[m], sm = s[m], Gm = G[m];
    const float cb = (lk - lm) * sm;
    B = B + (e[m] * sm) * (expf(-cb * cb) * VOGE_INV_SQRT_PI);
    const float diff = lm - lk;
    const float ca = diff * sk;
    const float phi = expf(-ca * ca) * VOGE_INV_SQRT_PI;
    const float Phi = (erff(ca) + 1.0f) * 0.5f;
    A = A + Gm * Phi;
    C = C + Gm * phi;
    D = D + Gm * phi * diff;
  }
  const float ek = e[k], Gk = G[k];
  dl = -ow * (Gk * B - ek * sk * C);
  da = -Gk + ow * ek * A;
  dd = -ow * ek * D * (0.5f / sk);
}

// A cotangent that may be absent (null: zero).
__device__ __forceinline__ float voge_ld(const float* p, size_t i) {
  return p != nullptr ? p[i] : 0.0f;
}

// One slot's chain rule around the residual delta = mu - l r
// (ops/cuda_fine_bwd.py has the three formulas), from the slot's coefficients
// g_d, c = g_l / ksk, g_a and its len l.  Every kernel of the fine backward
// that sums a Gaussian's or a ray's slots calls these two, so the compacted,
// the global, the per-Gaussian and the per-ray entries evaluate one
// arithmetic.
//
// The Gaussian's side, with its precision L (9, row-major) and mean mu:
// acc[0..2] += g_mu, acc[3..11] += g_Lambda (row-major),
//   g_mu     = c L r + g_a l (L^T - L) r + g_a (L + L^T) delta
//   g_Lambda = g_d r r^T + (c - g_a l) delta r^T + g_a l r delta^T
//              + g_a delta delta^T
__device__ __forceinline__ void voge_slot_gauss(const float (&L)[9],
                                                const float (&mu)[3],
                                                const float (&r)[3], float gd,
                                                float c, float ga, float l,
                                                float (&acc)[12]) {
  const float gal = ga * l;
  float dlt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dlt[i] = mu[i] - l * r[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float Lr = 0.0f, La = 0.0f, Lsd = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float lij = L[3 * i + j], lji = L[3 * j + i];
      Lr += lij * r[j];
      La += (lij - lji) * r[j];
      Lsd += (lij + lji) * dlt[j];
    }
    acc[i] += c * Lr - gal * La + ga * Lsd;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      acc[3 + 3 * i + j] += gd * r[i] * r[j] + (c - gal) * dlt[i] * r[j] +
                            gal * r[i] * dlt[j] + ga * dlt[i] * dlt[j];
  }
}

// The ray's side, from the slot's feature row f (16 floats: Lambda at 4..12,
// mu at 13..15): g += g_r,
//   g_r = g_d (L + L^T) r + g_a l^2 (L - L^T) r - c l L r
//         + (c - 2 g_a l) L^T delta
__device__ __forceinline__ void voge_slot_ray(const float* f,
                                              const float (&r)[3], float gd,
                                              float c, float ga, float l,
                                              float (&g)[3]) {
  float dlt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dlt[i] = f[13 + i] - l * r[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float Lr = 0.0f, La = 0.0f, Ls = 0.0f, Ltd = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float lij = f[4 + 3 * i + j], lji = f[4 + 3 * j + i];
      Lr += lij * r[j];
      La += (lij - lji) * r[j];
      Ls += (lij + lji) * r[j];
      Ltd += lji * dlt[j];
    }
    g[i] += gd * Ls + ga * l * l * La - c * l * Lr + (c - 2.0f * ga * l) * Ltd;
  }
}

// Device code shared by the fine backward kernels: the analytic backward of
// the erf transmittance compositing for one ray (K3's prologue in fine_bwd.cu,
// and the standalone fold, fold_weights.cu), and one slot's chain rule (the
// per-Gaussian and per-ray sides of fine_bwd.cu and fine_bwd_split.cu, at the
// end of this file).
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
// Registers: the slot arrays are held per thread.  Two passes keep five of
// them live instead of eight: pass 1 forms B for every slot, pass 2 forms
// A, C, D of one slot at a time and hands the finished (dl, da, dd) of that
// slot to the caller's ``emit(k, dl, da, dd)``, which folds it into the
// slot's incoming cotangents at once.  phi is evaluated in both passes;
// erf only in pass 2.  Buckets up to 32 are fully unrolled, as in K2, so the
// arrays stay in registers; larger buckets run from local memory.
#pragma once

#include <cuda_runtime.h>

constexpr float VOGE_INV_SQRT_PI = 0.5641895835477563f;

template <int KB, typename Emit>
__device__ __forceinline__ void voge_fold_ray(const float (&l)[KB],
                                                  const float (&e)[KB],
                                                  const float (&s)[KB],
                                                  const float (&G)[KB], int K,
                                                  float ow, Emit&& emit) {
  float Bm[KB];
  if constexpr (KB <= 32) {
#pragma unroll
    for (int m = 0; m < KB; ++m) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k < K) {
          const float ca = (l[m] - l[k]) * s[k];
          acc = acc + (e[k] * s[k]) * (expf(-ca * ca) * VOGE_INV_SQRT_PI);
        }
      }
      Bm[m] = acc;
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (k < K) {
        float A = 0.0f, C = 0.0f, D = 0.0f;
#pragma unroll
        for (int m = 0; m < KB; ++m) {
          if (m < K) {
            const float diff = l[m] - l[k];
            const float ca = diff * s[k];
            const float phi = expf(-ca * ca) * VOGE_INV_SQRT_PI;
            const float Phi = (erff(ca) + 1.0f) * 0.5f;
            A = A + G[m] * Phi;
            C = C + G[m] * phi;
            D = D + G[m] * phi * diff;
          }
        }
        emit(k, -ow * (G[k] * Bm[k] - e[k] * s[k] * C), -G[k] + ow * e[k] * A,
             -ow * e[k] * D * (0.5f / s[k]));
      }
    }
  } else {
#pragma unroll 1
    for (int m = 0; m < K; ++m) {
      float acc = 0.0f;
#pragma unroll 1
      for (int k = 0; k < K; ++k) {
        const float ca = (l[m] - l[k]) * s[k];
        acc = acc + (e[k] * s[k]) * (expf(-ca * ca) * VOGE_INV_SQRT_PI);
      }
      Bm[m] = acc;
    }
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      float A = 0.0f, C = 0.0f, D = 0.0f;
#pragma unroll 1
      for (int m = 0; m < K; ++m) {
        const float diff = l[m] - l[k];
        const float ca = diff * s[k];
        const float phi = expf(-ca * ca) * VOGE_INV_SQRT_PI;
        const float Phi = (erff(ca) + 1.0f) * 0.5f;
        A = A + G[m] * Phi;
        C = C + G[m] * phi;
        D = D + G[m] * phi * diff;
      }
      emit(k, -ow * (G[k] * Bm[k] - e[k] * s[k] * C), -G[k] + ow * e[k] * A,
           -ow * e[k] * D * (0.5f / s[k]));
    }
  }
}

// Load one ray's slot primals for the fold: l, e = exp(-a) and s = sqrt(d +
// 1e-10) for k < K, the invalid-slot fill beyond.
template <int KB>
__device__ __forceinline__ void voge_fold_load(const float* l_in,
                                               const float* a_in,
                                               const float* d_in, int K,
                                               float (&l)[KB], float (&e)[KB],
                                               float (&s)[KB]) {
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (k < K) {
      l[k] = l_in[k];
      e[k] = expf(-a_in[k]);
      s[k] = sqrtf(d_in[k] + 1e-10f);
    } else {
      l[k] = 1e10f;
      e[k] = 0.0f;
      s[k] = 1e-5f;
    }
  }
}

// A cotangent that may be absent (null: zero).
__device__ __forceinline__ float voge_ld(const float* p, size_t i) {
  return p != nullptr ? p[i] : 0.0f;
}

// One slot's chain rule around the residual delta = mu - l r
// (ops/cuda_fine_bwd.py has the three formulas), from the slot's coefficients
// g_d, c = g_l / ksk, g_a and its len l.  Every kernel of the fine backward
// that sums a Gaussian's or a ray's slots calls these two, so the compacted,
// the global and the split entries evaluate one arithmetic.
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

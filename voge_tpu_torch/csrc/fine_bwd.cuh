// The analytic backward of the erf transmittance compositing for one ray,
// shared by K3 (fine_bwd.cu, its prologue) and the standalone fold
// (fold_weights.cu).
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

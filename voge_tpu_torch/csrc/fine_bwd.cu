// K3: the fine backward of the select (with the weight fold and the fused
// attribute VJP), deterministic, no float atomics.  Two entries:
//  - voge_fine_bwd, over the emission-compacted candidate rows: replaces
//    voge_tpu/ops/pallas_bwd.py::_bwd_t_kernel (reached through
//    fine_bwd_compact_t_pallas <- fine._rt_fine_kern_c_bwd), steps 1 and 2
//    below;
//  - voge_fine_bwd_global, over the global candidate space of the no-coarse
//    path: replaces pallas_bwd.py::_bwd_unified_kernel (reached through
//    fine_bwd_unified_pallas <- fine._rt_fine_kern_bwd), steps 1 and 3.
// Each computes what its TPU kernel computes, from the select's saved
// image-layout outputs:
//
//  1. per ray (fine_bwd_rays_kernel, one thread per pixel):
//     - with attributes, d_w[k] = attrs[idx_k] . g_img  (pallas_bwd.py:639-684),
//       added to the weight cotangent g_w;
//     - the fold of g_w into (g_len, g_act, g_dsd) through the device function
//       of fine_bwd.cuh (pallas_bwd.py:697-759);
//     - the entry-space chain rule from the saved primals, ksk = dsd and
//       msk = len * dsd (pallas_bwd.py:760-772):
//         g_ksk = (g_a msk - g_l) msk / ksk^2 + g_d
//         g_msk = (g_l - 2 g_a msk) / ksk,   g_msm = g_a;
//       per slot it keeps (g_d, c = g_l / ksk, g_a, l), zero on invalid slots;
//     - when ray gradients are wanted (pallas_bwd.py:883-909),
//         g_ray = sum_k g_ksk (Lambda + Lambda^T) r + g_msk Lambda^T mu,
//       with the slot's features read from its candidate row.  A slot holds a
//       Gaussian id, not a row: the row is found by binary search of the
//       supertile's ids, which ascend because each row is a contiguous slice
//       of the sorted emission keys (ops/coarse.py).  ROADMAP queue 3 item 3
//       is the fault of assuming this where it does not hold.
//  2. per candidate row (fine_bwd_gauss_kernel, pallas_bwd.py:835-881), over
//     the slots of the row's supertile that hold the row's id:
//       g_mu     = sum g_msk Lambda r + g_msm (Lambda + Lambda^T) mu
//       g_Lambda = sum g_ksk r r^T + g_msk mu r^T + g_msm mu mu^T
//       d_attr   = sum w g_img
//     written as per-slot rows (nb, M, 12 + d) that the caller gathers back to
//     Gaussians through the inverse emission map (ops/fine.py).
//  3. global: per Gaussian (fine_bwd_global_gauss_kernel), the g_mu and
//     g_Lambda sums of step 2 over every slot that holds the Gaussian's id.
//     In the global space a slot's id is its row of the (B * P, 16) table,
//     so step 1 reads the row directly (no search).  The caller sorts the
//     flattened slot ids with a stable sort and passes each id's run
//     (order, starts), as K4b does; one warp walks one Gaussian's run, lane
//     l taking slots l, l + 32, ... in run order, and a fixed shuffle tree
//     sums the lanes: a fixed order, so two runs give the same bits.  No
//     slot is compared with a Gaussian it does not hold (the TPU kernel's
//     one-hot match costs O(P R K), 5.2G compares at the ShapeFitting step).
//     The runs are uneven (ShapeFitting: 901K valid slots over 12,810
//     Gaussians, a mean of 70, the front-facing ones hold far more): a warp
//     per run spreads a long run over 32 lanes, and with 12,810 warps in
//     flight the short runs fill the card around the long ones.  Measured
//     there on an H100 80GB HBM3 at 700 W: 0.016 ms for this kernel (56
//     registers), 1.20 ms for the whole entry with the per-ray kernel and
//     the sort (the plain version: 9.8 ms).
//
// Both sides evaluate the chain rule around the residual delta = mu - l r, as
// the forward evaluates act = delta^T Lambda delta (ops/cuda_fine_bwd.py has
// the three formulas): voge_tpu's terms in mu mu^T and mu r^T are ~l^2 (~36 at
// the headline) times larger than their sum, and the TPU kernel's
// sum-then-combine (T0, Tr, Trr per row, then mu) loses that factor in float32.
//
// Not carried over from the TPU kernel: the transposed (Kp, R) layout, the
// doubled grid, the visit lists and the MXU one-hot contractions.
//
// What bounds it on the H100.  Step 1 is arithmetic latency: the fold costs
// 2 K^2 exp and K^2 erf per ray (headline: 65,536 rays, K = 20).  Step 2 is
// the O(M R K) slot match the TPU kernel also pays: every row compares its id
// with each of the R K = 8,000 slot records of its supertile (headline: 169
// supertiles of 20x20 rays, rows up to 768 against a mean of 115).  Design:
// one block per (supertile, 128 rows); the block stages the supertile's slot
// records (id, four coefficients, w) and its rays in shared memory in
// ray chunks (<= 96 KB), and each thread scans them in (ray, slot) order, so
// every sum runs in a fixed order and two runs give the same bits.  Every
// thread reads the same record at once (a broadcast).  Splitting a row's scan
// across threads with an ordered combine is the next step for speed.
// Measured at the headline on an H100 80GB HBM3 at 700 W: 0.55 ms for the
// per-ray kernel (K = 20 bucket: 210 registers, no spill) and 0.90 ms for the
// per-row kernel per fitting step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fine_bwd.cuh"

namespace {

constexpr int RAY_THREADS = 128;
constexpr int ROW_THREADS = 128;
constexpr int GAUSS_THREADS = 128;     // global entry: 4 warps, a Gaussian each
constexpr int CH = 4;                  // attribute channels per gauss-side pass
constexpr int SMEM_BUDGET = 96 * 1024; // bytes of slot records per block

struct Args {
  const float* rays;     // (B, H, W, 3)
  const float* table;    // (nb, M, 16) candidate feature rows
  const int* ids;        // (nb, M) ascending ids, -1 pad
  const int* counts;     // (nb,) occupied rows
  const int* idx;        // (B, H, W, K) selected ids, -1 empty
  const float* len;      // (B, H, W, K) saved primals
  const float* act;
  const float* dsd;
  const float* w;
  const float* g_len;    // (B, H, W, K) cotangents, each may be null
  const float* g_act;
  const float* g_dsd;
  const float* g_w;
  const float* attrs;    // (n_rows, d) or null
  const float* g_img;    // (B, H, W, d) or null
  float4* coef;          // (B, H, W, K) scratch: g_d, g_l / ksk, g_a, len
  float* o_rows;         // (nb, M, 12 + d)
  float* o_rays;         // (B, H, W, 3) or null
  long long n_pix, n_rows;
  long long n_tab;       // global entry: rows of the (B * P, 16) table
  int H, W, bs, BW2, nst, M, K, d, rc;
  float ow;
};

// Rank of ``id`` in the ascending ids[0, cnt), or -1.
__device__ __forceinline__ int find_rank(const int* ids, int cnt, int id) {
  int lo = 0, hi = cnt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < id) lo = mid + 1;
    else hi = mid;
  }
  return (lo < cnt && ids[lo] == id) ? lo : -1;
}

template <int KB>
__global__ void __launch_bounds__(RAY_THREADS) fine_bwd_rays_kernel(const Args a) {
  const long long pix = (long long)blockIdx.x * RAY_THREADS + threadIdx.x;
  if (pix >= a.n_pix) return;
  const size_t o = (size_t)pix * a.K;
  // compacted: a slot's row is found in its supertile's ascending ids;
  // global (ids null): a slot's id is its row of the table
  const bool global = a.ids == nullptr;
  int s = 0, cnt = 0;
  if (!global) {
    const int x = (int)(pix % a.W);
    const int y = (int)((pix / a.W) % a.H);
    const int b = (int)(pix / ((long long)a.W * a.H));
    const int st = 2 * a.bs;
    s = b * a.nst + (y / st) * a.BW2 + (x / st);
    cnt = a.counts[s];
  }

  float l[KB], e[KB], sq[KB], G[KB];
  voge_fold_load<KB>(a.len + o, a.act + o, a.dsd + o, a.K, l, e, sq);
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    float gw = 0.0f;
    if (k < a.K) {
      gw = voge_ld(a.g_w, o + k);
      const int id = a.idx[o + k];
      if (a.attrs != nullptr && id >= 0 && id < a.n_rows) {
        float dw = 0.0f;  // channels ascending
        for (int c = 0; c < a.d; ++c)
          dw += a.attrs[(size_t)id * a.d + c] * a.g_img[(size_t)pix * a.d + c];
        gw += dw;
      }
      gw = gw * a.w[o + k];
    }
    G[k] = gw;
  }

  const float r0 = a.rays[pix * 3 + 0], r1 = a.rays[pix * 3 + 1],
              r2 = a.rays[pix * 3 + 2];
  const float r[3] = {r0, r1, r2};
  float gr[3] = {0.0f, 0.0f, 0.0f};
  voge_fold_ray<KB>(l, e, sq, G, a.K, a.ow, [&](int k, float dl, float da, float dd) {
    const int id = a.idx[o + k];
    if (id < 0) {
      a.coef[o + k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      return;
    }
    const float ga = voge_ld(a.g_act, o + k) + da;
    const float gd = voge_ld(a.g_dsd, o + k) + dd;
    const float lk = a.len[o + k];
    const float cl = (voge_ld(a.g_len, o + k) + dl) / a.dsd[o + k];
    a.coef[o + k] = make_float4(gd, cl, ga, lk);
    if (a.o_rays != nullptr) {
      const float* f = nullptr;
      if (global) {
        if (id < a.n_tab) f = a.table + (size_t)id * 16;
      } else {
        const int rank = find_rank(a.ids + (size_t)s * a.M, cnt, id);
        if (rank >= 0) f = a.table + ((size_t)s * a.M + rank) * 16;
      }
      if (f != nullptr) voge_slot_ray(f, r, gd, cl, ga, lk, gr);
    }
  });
  if (a.o_rays != nullptr) {
    a.o_rays[pix * 3 + 0] = gr[0];
    a.o_rays[pix * 3 + 1] = gr[1];
    a.o_rays[pix * 3 + 2] = gr[2];
  }
}

__global__ void __launch_bounds__(ROW_THREADS) fine_bwd_gauss_kernel(const Args a) {
  extern __shared__ float4 smem[];
  const int rc = a.rc;
  float4* s_c = smem;                          // rc * K slot coefficients
  float* s_w = reinterpret_cast<float*>(s_c + (size_t)rc * a.K);  // rc * K weights
  float* s_r = s_w + rc * a.K;                 // rc * 3 ray directions
  float* s_g = s_r + rc * 3;                   // rc * CH image cotangents
  int* s_id = reinterpret_cast<int*>(s_g + rc * CH);              // rc * K

  const int s = blockIdx.x;
  const int row0 = blockIdx.y * ROW_THREADS;
  const int cnt = a.counts[s];
  const int C = 12 + a.d;
  float* out = a.o_rows + (size_t)s * a.M * C;
  const int row = row0 + threadIdx.x;
  if (row0 >= cnt) {  // the whole block holds padding rows: zero them
    if (row < a.M)
      for (int c = 0; c < C; ++c) out[(size_t)row * C + c] = 0.0f;
    return;
  }
  const int b = s / a.nst;
  const int sy = (s % a.nst) / a.BW2;
  const int sx = (s % a.nst) % a.BW2;
  const int st = 2 * a.bs;
  const int R = st * st;
  const bool live = row < cnt;
  const int my_id = live ? a.ids[(size_t)s * a.M + row] : -2;
  const int n_pass = a.d > 0 ? (a.d + CH - 1) / CH : 1;
  float L[9], mu[3];  // the row's precision and mean
  {
    const float* f = a.table + ((size_t)s * a.M + (live ? row : 0)) * 16;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mu[i] = f[13 + i];
#pragma unroll
      for (int j = 0; j < 3; ++j) L[3 * i + j] = f[4 + 3 * i + j];
    }
  }

  for (int pass = 0; pass < n_pass; ++pass) {
    const int c0 = pass * CH;
    const int nc = min(CH, a.d - c0);  // <= 0 without attributes
    const bool geo = pass == 0;
    float acc[12], Ta[CH];  // g_mu (3), g_Lambda (9)
#pragma unroll
    for (int q = 0; q < 12; ++q) acc[q] = 0.0f;
#pragma unroll
    for (int c = 0; c < CH; ++c) Ta[c] = 0.0f;

    for (int r0 = 0; r0 < R; r0 += rc) {
      const int nr = min(rc, R - r0);
      __syncthreads();
      for (int t = threadIdx.x; t < nr * a.K; t += ROW_THREADS) {
        const int rl = r0 + t / a.K, k = t % a.K;
        const int y = sy * st + rl / st, x = sx * st + rl % st;
        int id = -1;
        float4 cf = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float wk = 0.0f;
        if (y < a.H && x < a.W) {
          const size_t o = (((size_t)b * a.H + y) * a.W + x) * a.K + k;
          id = a.idx[o];
          cf = a.coef[o];
          wk = a.w[o];
        }
        s_id[t] = id;
        s_c[t] = cf;
        s_w[t] = wk;
      }
      for (int t = threadIdx.x; t < nr; t += ROW_THREADS) {
        const int rl = r0 + t;
        const int y = sy * st + rl / st, x = sx * st + rl % st;
        const bool in = y < a.H && x < a.W;
        const size_t pix = ((size_t)b * a.H + y) * a.W + x;
#pragma unroll
        for (int i = 0; i < 3; ++i) s_r[t * 3 + i] = in ? a.rays[pix * 3 + i] : 0.0f;
#pragma unroll
        for (int c = 0; c < CH; ++c)
          s_g[t * CH + c] = (in && c < nc) ? a.g_img[pix * a.d + c0 + c] : 0.0f;
      }
      __syncthreads();
      if (!live) continue;
      for (int t = 0; t < nr * a.K; ++t) {
        if (s_id[t] != my_id) continue;
        const int rr = t / a.K;
        if (geo) {
          const float4 cf = s_c[t];  // (g_d, c, g_a, l)
          const float r[3] = {s_r[rr * 3], s_r[rr * 3 + 1], s_r[rr * 3 + 2]};
          voge_slot_gauss(L, mu, r, cf.x, cf.y, cf.z, cf.w, acc);
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) Ta[c] += s_w[t] * s_g[rr * CH + c];
      }
    }
    if (!live) continue;
    float* o = out + (size_t)row * C;
    if (geo) {
#pragma unroll
      for (int q = 0; q < 12; ++q) o[q] = acc[q];
    }
    for (int c = 0; c < nc; ++c) o[12 + c0 + c] = Ta[c];
  }
  if (!live && row < a.M)
    for (int c = 0; c < C; ++c) out[(size_t)row * C + c] = 0.0f;
}

// One warp per Gaussian j of the (B * P, 16) table: g_mu (3) and g_Lambda
// (9) summed over the slots order[starts[j] .. starts[j + 1]) (step 3).
__global__ void __launch_bounds__(GAUSS_THREADS) fine_bwd_global_gauss_kernel(
    const float* __restrict__ table, const float* __restrict__ rays,
    const float4* __restrict__ coef, const long long* __restrict__ order,
    const long long* __restrict__ starts, float* __restrict__ out,
    long long n_tab, int K) {
  const long long j = ((long long)blockIdx.x * GAUSS_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= n_tab) return;  // j is the same for the whole warp
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
  for (long long t = starts[j] + lane; t < starts[j + 1]; t += 32) {
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
    for (int q = 0; q < 12; ++q) out[(size_t)j * 12 + q] = acc[q];
}

template <int KB>
cudaError_t launch_rays(const Args& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.n_pix + RAY_THREADS - 1) / RAY_THREADS);
  fine_bwd_rays_kernel<KB><<<blocks, RAY_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_rays_k(const Args& a, cudaStream_t s) {
  if (a.K <= 8) return launch_rays<8>(a, s);
  if (a.K <= 16) return launch_rays<16>(a, s);
  if (a.K <= 32) return launch_rays<32>(a, s);
  if (a.K <= 64) return launch_rays<64>(a, s);
  return launch_rays<128>(a, s);
}

}  // namespace

extern "C" int voge_fine_bwd(
    const void* rays, const void* table, const void* ids, const void* counts,
    const void* idx, const void* len, const void* act, const void* dsd,
    const void* w, const void* g_len, const void* g_act, const void* g_dsd,
    const void* g_w, const void* attrs, const void* g_img, void* coef,
    void* o_rows, void* o_rays, long long n_pix, long long n_rows, int nb,
    int H, int W, int bs, int BW2, int nst, int M, int K, int d, float ow,
    void* stream) {
  if (n_pix <= 0 || nb <= 0 || M <= 0 || bs <= 0 || K <= 0 || K > 128 || d < 0)
    return (int)cudaErrorInvalidValue;
  if (d > 0 && (attrs == nullptr || g_img == nullptr)) return (int)cudaErrorInvalidValue;
  Args a;
  a.rays = (const float*)rays;
  a.table = (const float*)table;
  a.ids = (const int*)ids;
  a.counts = (const int*)counts;
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
  a.o_rows = (float*)o_rows;
  a.o_rays = (float*)o_rays;
  a.n_pix = n_pix;
  a.n_rows = n_rows;
  a.H = H; a.W = W; a.bs = bs; a.BW2 = BW2; a.nst = nst; a.M = M; a.K = K;
  a.d = d; a.ow = ow;
  a.n_tab = 0;
  const int R = 4 * bs * bs;
  const int rec = K * (int)(sizeof(float4) + sizeof(float) + sizeof(int)) +
                  (3 + CH) * (int)sizeof(float);
  const int fit = SMEM_BUDGET / rec;  // rays whose records fit the budget
  a.rc = fit < 1 ? 1 : (fit < R ? fit : R);
  cudaStream_t s = (cudaStream_t)stream;

  cudaError_t err = launch_rays_k(a, s);
  if (err != cudaSuccess) return (int)err;

  const size_t smem = (size_t)a.rc * rec;
  err = cudaFuncSetAttribute(fine_bwd_gauss_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, (M + ROW_THREADS - 1) / ROW_THREADS);
  fine_bwd_gauss_kernel<<<grid, ROW_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The global entry: ``table`` (n_tab = B * P, 16) is indexed by slot id;
// ``order`` / ``starts`` are the stable sort of the flattened idx and each
// id's run start (n_tab + 1); ``o_rows`` (n_tab, 12).
extern "C" int voge_fine_bwd_global(
    const void* rays, const void* table, const void* idx, const void* len,
    const void* act, const void* dsd, const void* w, const void* g_len,
    const void* g_act, const void* g_dsd, const void* g_w, const void* order,
    const void* starts, void* coef, void* o_rows, void* o_rays,
    long long n_pix, long long n_tab, int K, float ow, void* stream) {
  if (n_pix <= 0 || n_tab <= 0 || K <= 0 || K > 128) return (int)cudaErrorInvalidValue;
  Args a = {};
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
  a.coef = (float4*)coef;
  a.o_rays = (float*)o_rays;
  a.n_pix = n_pix;
  a.n_tab = n_tab;
  a.K = K;
  a.ow = ow;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_rays_k(a, s);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_tab * 32 + GAUSS_THREADS - 1) / GAUSS_THREADS;
  fine_bwd_global_gauss_kernel<<<(unsigned)blocks, GAUSS_THREADS, 0, s>>>(
      (const float*)table, (const float*)rays, (const float4*)coef,
      (const long long*)order, (const long long*)starts, (float*)o_rows, n_tab, K);
  return (int)cudaGetLastError();
}

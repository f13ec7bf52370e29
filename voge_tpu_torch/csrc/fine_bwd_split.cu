// The global-space fine backward split in two, taking cotangents that
// already hold the folded weight cotangent.  Two entries:
//  - voge_fine_bwd_gauss replaces voge_tpu/ops/pallas_bwd.py::_bwd_gauss_kernel
//    (reached through fine_bwd_gauss_pallas <- fine._rt_fine_kern_bwd): per
//    Gaussian, grad mu (3) and grad Lambda (9) summed over the slots that hold
//    it;
//  - voge_fine_bwd_rays replaces pallas_bwd.py::_bwd_rays_kernel
//    (fine_bwd_rays_pallas): per ray, grad r (3) summed over its K slots.
// voge_tpu takes the pair where a render's padded Gaussian count passes
// 262,144 (the unified kernel's output block no longer fits the TPU's VMEM),
// after fold_weights_pallas has turned the weight cotangent into cotangents of
// len / act / dsd.  The card has no such limit, and K3's unified entry
// (fine_bwd.cu) was as fast or faster than the fold's entry + this pair, with
// equal bits, at every shape timed (PERF.md section 6), so ops/fine.py takes
// the unified entry whenever the scene needs a gradient.  It runs the fold's
// entry and the per-ray half alone where only the rays need one (a frozen
// scene); the per-Gaussian half stays an entry that chip_smoke.py builds and
// holds against its plain version and against the unified entry.
//
// Both read the select's saved image-layout outputs (idx, len, dsd), the
// cotangents (g_len, g_act, g_dsd; each may be null for zero) and the
// (n_tab = B * P, 16) feature table indexed by slot id.  Per slot they form
// the entry-space chain rule's coefficients from the saved primals, ksk = dsd
// and msk = len * dsd (pallas_bwd.py:149-159),
//     g_d,   c = g_len / dsd,   g_a,   l = len,
// in the kernel: there is no per-ray pre-pass and no coefficient buffer (the
// unified entry of fine_bwd.cu writes and re-reads one of 16 bytes a slot).
// The chain rule itself is the device code of fine_bwd.cuh, in the residual
// form around mu - len r, so this pair and the unified entry cannot drift
// apart.  Slots with idx < 0 or idx >= n_tab contribute nothing (the TPU
// kernel's padding gate, pallas_bwd.py:142-147).
//
// Not carried over from the TPU kernels: the (chunk, bin, ray-chunk) grid that
// revisits an output block, the culling mask, and the one-hot match of every
// ray slot against every Gaussian of a chunk (O(P R K): 6e11 compares at
// 300,000 Gaussians, 102,400 rays and K = 20).
//
// Per Gaussian.  The caller groups the flattened slot ids by id (slot_runs.cu,
// as for the unified entry) and passes each id's run (order, starts).
// One warp takes one Gaussian: lane l sums slots l, l + 32, ... of the run in
// run order, a fixed shuffle tree sums the lanes, lane 0 writes the row.  No
// float atomics; the order is fixed, so two runs give the same bits.
// What bounds it: bytes and latency.  A slot costs 4 bytes of `order`, five
// 4-byte reads scattered by slot, 12 bytes of its ray and ~100 operations; a
// Gaussian 64 bytes of its table row and 48 of its output row.
// Empty runs: on a 300,000-point cloud seen at 320x320 with K = 20, two
// fifths of the Gaussians hold no slot (121,167: hidden behind nearer ones, or
// outside the image) and the other 178,833 hold 5.8 on average (1,045,300
// valid slots).  The launch still gives every Gaussian a warp, because the
// output is dense (every row must be written and the zero rows are part of
// the result): a warp whose run is empty reads its two `starts` entries (16
// bytes), writes its 48-byte zero row from lanes 0-11 and exits before it
// touches the feature table, so the empty runs cost ~8 MB of traffic and no
// arithmetic.  A compacted list of the occupied ids would save those warps
// only by adding a pass over `starts` and a separate zero fill of the rows.
// Measured there on an H100 80GB HBM3 at 700 W (chip_smoke.py): 0.18 ms for
// this kernel (64 registers), at most 0.09 of it for 300,000 empty runs when
// every slot is empty; the entry's grouping (slot_runs.cu) is timed in
// PERF.md section 6.  The plain version: 5.3 ms.
//
// Per ray.  One thread per ray walks its K slots in order and reads each
// slot's feature row by id (64 scattered bytes; neighbouring rays select
// mostly the same Gaussians, so the rows come from L2).  No sort, no search,
// no reduction across threads.  What bounds it: the scattered 64-byte row
// reads, K per ray.  Measured on the same render: 0.06 ms (48 registers; its
// bound by bytes is 31% of that); the plain version 3.6 ms.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fine_bwd.cuh"

namespace {

constexpr int GAUSS_THREADS = 128;  // 4 warps, a Gaussian each
constexpr int RAY_THREADS = 128;

struct Slots {
  const float* len;    // (n_pix, K) saved primals
  const float* dsd;
  const float* g_len;  // (n_pix, K) cotangents, each may be null
  const float* g_act;
  const float* g_dsd;
};

__global__ void __launch_bounds__(GAUSS_THREADS) bwd_gauss_kernel(
    const float* __restrict__ table, const float* __restrict__ rays, const Slots s,
    const int* __restrict__ order, const long long* __restrict__ starts,
    float* __restrict__ out, long long n_tab, int K) {
  const long long j = ((long long)blockIdx.x * GAUSS_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= n_tab) return;  // j is the same for the whole warp
  const long long t0 = starts[j], t1 = starts[j + 1];
  float* o = out + (size_t)j * 12;
  if (t0 == t1) {  // an empty run: the zero row, and no table read
    if (lane < 12) o[lane] = 0.0f;
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
    const size_t slot = (size_t)order[t];
    const float* rp = rays + (slot / K) * 3;
    const float r[3] = {rp[0], rp[1], rp[2]};
    voge_slot_gauss(L, mu, r, voge_ld(s.g_dsd, slot),
                    voge_ld(s.g_len, slot) / s.dsd[slot], voge_ld(s.g_act, slot),
                    s.len[slot], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < 12; ++q) acc[q] += __shfl_down_sync(0xffffffffu, acc[q], off);
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < 12; ++q) o[q] = acc[q];
}

__global__ void __launch_bounds__(RAY_THREADS) bwd_rays_kernel(
    const float* __restrict__ table, const float* __restrict__ rays,
    const int* __restrict__ idx, const Slots s, float* __restrict__ out,
    long long n_pix, long long n_tab, int K) {
  const long long pix = (long long)blockIdx.x * RAY_THREADS + threadIdx.x;
  if (pix >= n_pix) return;
  const size_t o = (size_t)pix * K;
  const float r[3] = {rays[pix * 3 + 0], rays[pix * 3 + 1], rays[pix * 3 + 2]};
  float g[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < K; ++k) {  // slots ascending: a fixed order
    const int id = idx[o + k];
    if (id < 0 || id >= n_tab) continue;
    voge_slot_ray(table + (size_t)id * 16, r, voge_ld(s.g_dsd, o + k),
                  voge_ld(s.g_len, o + k) / s.dsd[o + k], voge_ld(s.g_act, o + k),
                  s.len[o + k], g);
  }
  out[pix * 3 + 0] = g[0];
  out[pix * 3 + 1] = g[1];
  out[pix * 3 + 2] = g[2];
}

Slots slots(const void* len, const void* dsd, const void* g_len, const void* g_act,
            const void* g_dsd) {
  Slots s;
  s.len = (const float*)len;
  s.dsd = (const float*)dsd;
  s.g_len = (const float*)g_len;
  s.g_act = (const float*)g_act;
  s.g_dsd = (const float*)g_dsd;
  return s;
}

}  // namespace

// ``table`` (n_tab, 16) is indexed by slot id; ``order`` / ``starts`` are the
// flattened slot ids' valid slots grouped by id in slot order (int32) and each
// id's run start (n_tab + 1, int64), from slot_runs.cu; ``o_rows`` (n_tab, 12).
extern "C" int voge_fine_bwd_gauss(
    const void* rays, const void* table, const void* len, const void* dsd,
    const void* g_len, const void* g_act, const void* g_dsd, const void* order,
    const void* starts, void* o_rows, long long n_tab, int K, void* stream) {
  if (n_tab <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_tab * 32 + GAUSS_THREADS - 1) / GAUSS_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_gauss_kernel<<<(unsigned)blocks, GAUSS_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)rays, slots(len, dsd, g_len, g_act, g_dsd),
      (const int*)order, (const long long*)starts, (float*)o_rows, n_tab, K);
  return (int)cudaGetLastError();
}

// ``idx`` (n_pix, K) int32; ``o_rays`` (n_pix, 3).
extern "C" int voge_fine_bwd_rays(
    const void* rays, const void* table, const void* idx, const void* len,
    const void* dsd, const void* g_len, const void* g_act, const void* g_dsd,
    void* o_rays, long long n_pix, long long n_tab, int K, void* stream) {
  if (n_pix <= 0 || n_tab <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_pix + RAY_THREADS - 1) / RAY_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_rays_kernel<<<(unsigned)blocks, RAY_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)rays, (const int*)idx,
      slots(len, dsd, g_len, g_act, g_dsd), (float*)o_rays, n_pix, n_tab, K);
  return (int)cudaGetLastError();
}

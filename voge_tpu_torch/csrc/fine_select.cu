// K2: streaming top-K select with fused erf weights and fused attribute image.
//
// Three entries share one kernel (the global one in two modes, with one
// level of cone cull or two).  Two replace
// voge_tpu/ops/pallas_fine2.py::_kernel_tc through both of its entries:
//  - compacted (voge_fine_select; fine_select_compact_pallas <-
//    fine._rt_fine_compact_impl): the candidates of a supertile are its
//    emission-compacted slots (nb, M): their sub-bin bits, their flattened
//    ids b * P + n and the count of occupied slots; each survivor's row is
//    staged from the (B * P, 16) table by its id.  The table stays in the
//    L2 (19.7 MB at 32 poses of the 10K headline), where a copy of one row
//    a slot would write 354 MB, 89% of it padding;
//  - global (voge_fine_select_global; fine_select_mask_pallas <-
//    fine._rt_fine_kern, the no-coarse path): the candidates of a ray block
//    are all P Gaussians of its image, read in place from one (B * P, 16)
//    table (no copy per block), slot n has id b * P + n, and the sub-bin bits
//    come from an optional (nb, P) plane (null: every Gaussian is a member of
//    every sub-bin, which is what no-coarse means).
// The third replaces voge_tpu/ops/pallas_fine.py::_kernel (fine_select_pallas
// <- fine._fine_forward, the public two-stage tracer ray_tracing_fine):
//  - per-bin lists (voge_fine_select_bins): a block's rays are those of one
//    bin (bsh x bsw pixels), its candidates the bin's list of flattened ids
//    (nb, M), -1 where empty; each staged row is gathered from the
//    (B * P, 16) table by its id, every listed Gaussian is a member of the
//    whole bin (no bits test), and no weights or image are written.  The TPU
//    kernel extracts K minima from a dense (rays x candidates) block, the
//    lowest lane winning a tie; streaming the list in order with the stable
//    insertion below keeps the same K in the same order.
// For every ray it streams the candidates in ascending position and keeps the
// K nearest passing hits by ascending length:
//   msk = A.r, ksk = r^T Lambda r, len = msk / ksk,
//   act = d^T Lambda d with d = mu - len * r  (the compensated residual form),
//   pass iff act < thr_act and the ray's sub-bin bit is set in the row's bits.
// At the flush it writes idx / len / act / dsd, the erf compositing weights
//   w_j = exp(-ow * sum_k e^{-act_k} (erf((l_j - l_k) sqrt(dsd_k + 1e-10)) + 1) / 2)
//         * e^{-act_j} * e^{0.5}
// and, given attributes, img = sum_k w_k attrs[idx_k], straight into image
// layout (B, H, W, K) / (B, H, W, d).
//
// The selection as a key.  Stable insertion with a strict '<' keeps exactly
// the K smallest candidates by the key (len, candidate position), in that
// order (ray_trace_voge.cu:197-213, pallas_fine2.py:25-28).  Everything below
// that drops, reorders or batches candidates keeps them in ascending position
// within a ray's stream, so the selections and their order are those of the
// plain dense select (ops/cuda_fine.py) to the last bit.
//
// What bounds it on the H100, and what the design does about it.  The work is
// small against the card's rates (the 10K headline: 3.0 M pairs that pass the
// sub-bin test, ~0.15 GFLOP), so the time is latency: a thread walks its
// candidates in order, each pair costs a float division and four broadcast
// shared-memory reads, and few warps were resident to hide them.  An earlier
// form of this kernel kept the running top-K in registers (255 registers at
// K = 20, two blocks of 128 threads an SM; thread-private local memory above
// K = 32) and, on the global entry, tested every ray against every Gaussian.
//  (a) The top-K lives in shared memory, slot-major [k][ray], so a warp's
//      lanes hit distinct banks: (len, position) only, 8 bytes a slot, K KB a
//      block of 128 rays at any K up to 128 (one code path; no K buckets and
//      no local memory).  The list is unsorted: a thread keeps in registers
//      its fill count and, once K are held, the largest entry by the key and
//      its slot, so a pair that fails act < thr_act or len < largest touches
//      no top-K memory, and one that enters overwrites the largest and scans
//      for the next one to evict: the largest of each quarter of the list is
//      kept in registers, so only the quarter written to is read again
//      (independent loads; a sorted list's shift is a chain of dependent
//      loads and stores, which measured slower than the register version it
//      replaced).  Evicting the largest by (len, position) and refusing a
//      candidate that is not strictly shorter keeps exactly the K smallest
//      by the key; the flush sorts them by the key in place.  act and
//      dsd of the K kept candidates are computed again at the flush from
//      their feature rows (the same instructions on the same inputs: the
//      same bits), which halves the shared memory.  On an H100 (ptxas,
//      CUDA 12.8) the compacted, global and list instantiations hold at most
//      128 registers a thread (the compacted 121), so an SM keeps 4 blocks
//      at K <= 32, 2 at K = 64 and 80, 1 at K = 128; capped at 96 registers
//      (5 blocks) it measured within 3% either way.
//  (b) Candidates are compacted before they are tested.  Each step examines
//      4 x 128 candidates, one a thread (its sub-bin bits, its list id, or
//      its cull row), keeps those that can matter to some ray of the block,
//      and packs the survivors' 64-byte feature rows into shared memory in
//      ascending position (warp ballot + prefix over the four warps).  The
//      inner loop walks survivors only.  A candidate is dropped when none of
//      the block's rays lies in a sub-bin of its bits, when its list entry is
//      empty, or (global entry) when the cone cull below proves that no ray
//      of the block can pass the hit test.
//  (c) With no bits plane the global entry's blocks are 8 x 16 pixels of the
//      image, not 128-ray chunks of a 20 x 20 supertile: every lane of a
//      block is a live ray away from the image's edge, and the block's cone
//      of rays is narrow.
//  (d) Nothing waits for a copy it does not need yet: the next step's
//      per-candidate words (bits / ids / cull rows, 4 to 20 bytes a
//      candidate) are loaded into registers before the current step is
//      examined, and the survivors' rows travel by cp.async while the block
//      examines the following steps; the block waits for them only when 256
//      rows are staged or the stream ends.
//  (e) Accepted candidates wait in two register slots a lane and enter the
//      lists when the warp votes that some lane's slots are full: on dense
//      rows nearly every candidate is accepted by some lane of a warp, and a
//      scan run for one lane costs the warp as much as one run for all.
//  (f) At the flush the warp writes the empty slots of its 32 pixels
//      together, lane by slot, so the stores fill whole sectors.
// Tried and not kept: launching the compacted entry's supertiles longest row
// first (an order sorted from counts_c on the device) cost a sort and moved
// the kernel's time by less than it at the headline, the texture shapes and
// the 100K cloud: with 4 to 5 blocks resident an SM the whole grid is one
// wave and no dense supertile starts late.
// No tensor cores: the hit test is two small contractions (A.r over 3,
// Lambda:rr^T over 9) that wgmma could take only in TF32, whose 10-bit
// mantissa flips selections; the gate is exact equality with voge_tpu.  The
// card's gifts to this kernel are shared memory, asynchronous copies and
// occupancy.
//
// The cone cull (global entry), and why it drops nothing that could pass.
// Points are camera-centred, so every ray of a block is a line through the
// origin.  The glue beside the wrapper (ops/cuda_fine.py: block_cones,
// cull_rows; on the card small kernels at the end of this file, held
// against their plain versions) gives each block a cone: a unit axis c and a
// half-angle theta with angle(r, c) <= theta for each of its rays r; and each
// Gaussian a row (u, q): u = mu / |mu| and
// q = lo |mu|^2 / (thr_act (1 + 1e-3)), where lo is
// a lower bound of the least eigenvalue of Lambda's symmetric part, less
// 4e-6 ||Lambda||_F.
//   1. act as this kernel computes it is d^T Lambda d at d = mu - len r, a
//      point of the line offset from mu, whatever len came out of the
//      division.  d^T Lambda d = d^T sym(Lambda) d >= lambda_min |d|^2, and
//      |d| >= dist(mu, line r).
//   2. The angle between two lines through the origin (in [0, pi/2]) is a
//      metric.  With phi = angle(line mu, line c) = acos |u.c| and
//      angle(line r, line c) <= theta, the triangle inequality gives
//      angle(line mu, line r) >= phi - theta, so for phi > theta
//      dist(mu, line r) = |mu| sin angle(line mu, line r)
//                       >= |mu| sin(phi - theta).
//      Lines, not half-lines: len may be negative (a Gaussian behind the
//      camera is a candidate like any other).
//   3. Hence act >= lambda_min |mu|^2 sin^2(phi - theta) for every ray of the
//      block, and the pair (block, Gaussian) is dropped only when
//      lo |mu|^2 s^2 >= thr_act (1 + 1e-3), with
//      s = sin phi cos theta - cos phi sin theta - 1e-4 > 0.
//   4. Float32 (eps = 2^-24), with no assumption on |len| or on Lambda's
//      condition: len may be far larger than |mu| (up to sqrt(cond) |mu| for
//      an anisotropic Gaussian, and anything at all for a Lambda that is not
//      symmetric), so the error of d is not bounded in units of |mu|.  It is
//      bounded in angle instead.  The computed products are
//      len r_i (1 + e_i), |e_i| <= eps: exactly the point len r' of a line r'
//      within eps radians of r, which the 1e-6 the glue adds to theta
//      covers.  The subtraction rounds each component of mu - len r' by a
//      factor (1 + e), so the computed d has |d| >= (1 - eps) dist(mu, line
//      r') and steps 1-3 hold for it with a factor (1 - eps)^2, inside the
//      1e-3.  The quadratic form at the computed d is rounded by less than
//      32 eps ||Lambda||_F |d|^2 (taken off lo: lo > 0 also keeps cond below
//      2.5e5).  The 1e-4 off the sine covers the float32 rounding of u, c,
//      sin phi = |u x c|, cos phi, sin theta and cos theta (each a few eps);
//      the 1e-3 covers q's rounding, the product q s^2 and the threshold's.
//      q is 0 (never dropped) when |mu| ~ 0, lo <= 0, thr_act <= 0 or
//      anything is not finite, and a NaN anywhere fails both comparisons.
// A dropped pair is one the hit test would have rejected for every ray of
// the block, so selections, their order and every output bit are those of
// the kernel without the cull: nothing is truncated and overflow stays 0.
// tests/test_torch_cull.py holds the bound in float64 (hypothesis) and the
// glue against the plain float32 hit test, also on needles of axis ratio
// 1:100 at the edge of the cull; the wrapper's _cull=False walks every
// Gaussian with this same kernel, the reference where the dense plain
// version cannot reach (a whole 320x320 image of 300,000 Gaussians).
//
// The two-level cull (global entry without bits, where the 8 x 16 blocks of
// the launch times P reach 2^22; ops/cuda_fine.py::two_level).  One level
// tests every (block, Gaussian) pair: 240 M cone tests an image for the
// 300,000-point cloud at 320x320, 99.7% of them dropping the pair, and on an
// H100 the scan took most of the kernel.  Two levels:
//  1. Super-tiles of S x S blocks (S = 2: 16 x 32 pixels) each get a cone
//     holding the cones of their warps' 4 x 8 tiles (block_cones over 4 x 8
//     tiles, then the super-tiles' overload of block_cones_kernel), and
//     level 1 (the overload of fine_select_kernel; ops/cuda_fine.py::
//     cull_lists) tests every (super-tile, Gaussian) pair by cone_culls, the
//     blocks' own test, on the same cull rows: bit n % 32 of word n / 32 of
//     the super-tile's row of a (B, nsup, ceil(P / 128) * 4) mask, so a row
//     lists its survivors in ascending index with no scan, no capacity to
//     overflow and no host read (30 MB for the 300K cloud at B = 4).
//  2. fine_select_kernel<MASKED>: a block walks the set bits of its
//     super-tile's row in ascending index, reads each one's cull row by id,
//     tests the cones of its four warps and stages the rows some warp keeps,
//     their position the Gaussian's index n and their bits the warps that
//     keep them; a warp's 32 rays are the 4 x 8 quarter of the block its cone
//     covers, and it walks only the staged rows its cone keeps.  Each ray's
//     stream is then its image's Gaussians in ascending index less pairs
//     proven unable to pass, so the key (len, n), the selections, their
//     order and every output bit stay those of one level and of the cull off.
// Why a super-tile's cone drops nothing that could pass.  Steps 1-4 above
// ask only that every ray of the block (here: of the super-tile) lie within
// theta of the axis, with the 1e-6 to spare for the rounding of len r.  The
// float64 cone of a warp's tile j (before its float32 rounding) holds each
// of its rays within theta_j - 1e-6 of c_j.  Stored in float32 as (c'_j,
// sin, cos), its axis moves by at most ~sqrt(3) 2^-24 and atan2(sin, cos)
// by at most ~2^-24 from theta_j, so each ray lies within
// t_j = atan2(sin, cos) of u_j = c'_j / |c'_j|, with about 1e-6 - 2e-7 to
// spare.  The super-tile's axis a is the unit mean of the u_j and its
// half-angle theta = max_j (angle(a, u_j) + t_j) + 1e-5, at most pi / 2,
// both in float64 (errors near 1e-8, acos near 1 included).  By the triangle
// inequality for angles, a ray r of tile j has angle(r, a) <= angle(r, u_j)
// + angle(u_j, a) <= theta - 1e-5 - (1e-6 - 2e-7), and the float32 rounding
// of (a, sin theta, cos theta) costs a few 2^-24 more: steps 1-4 hold with
// the 1e-6 they need and room besides.  The 1e-5 beyond the proof's needs
// lets the super-tile's float32 test keep whatever a warp's keeps
// (tests/test_torch_cull.py checks it on the edge cases), so level 1 never
// leaves level 2 less than the warps would keep.  A NaN in any tile's cone
// makes the super-tile's NaN, which drops nothing.  A warp's cone in level 2
// is a block's cone over 32 rays: the same glue and the same proof.
//
// Exactness: compiled with -fmad=false.  The TPU kernel evaluates the hit
// test as separate multiplies and adds on its vector unit; keeping every
// product rounded once makes this kernel agree with the plain PyTorch
// version (ops/cuda_fine.py::fine_select_plain) to the last bit for
// len / act / dsd, so both select the same candidates.  Only the weights
// (erff / expf inside libdevice) may differ by an ulp.  No float atomics:
// two runs give equal bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attr_merge.cuh"

namespace {

constexpr int THREADS = 128;  // rays per block
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 4;        // sub-chunks of THREADS candidates examined a step
constexpr int CAP = 256;      // staged survivor rows; flushed above CAP - THREADS
constexpr float INF = 1e10f;  // fill for len / act
constexpr float E_HALF = 1.6487212707001282f;
constexpr float CULL_EPS = 1e-4f;
constexpr int COMPACT = 0, GLOBAL = 1, LISTS = 2, MASKED = 3;
constexpr int ROUND_WORDS = 4 * THREADS;  // level-1 mask words a round of MASKED: a uint4 a thread
constexpr int WARP_TH = 4, WARP_TW = 8;   // masked: a warp's rays, 4 x 8 of the 8 x 16 tile

struct Args {
  const float* rays;   // (B, H, W, 3)
  const float* table;  // (n_tab, 16) feature rows read by id (compacted,
                       // lists); global: (B * M, 16)
  const int* bits;     // (nb, M) sub-bin membership bits; null: all members
  const int* ids;      // (nb, M) global flattened ids; global: null
  const int* counts;   // (nb,) occupied rows; null: all M
  const float4* cull;  // global: (B * M,) cull rows (u, q); null: no cull
  const float* cones;  // global: (nb * nchunk, 8) block cones (c, sin, cos)
  const float* attrs;  // (n_rows, d) or null
  int* o_idx;          // (B, H, W, K)
  float* o_len;
  float* o_act;
  float* o_dsd;
  float* o_w;          // or null (lists: no weights)
  float* o_img;        // (B, H, W, d) or null
  int H, W, bs, M, K, d;
  int th, tw, TW, ntile;  // a block's ray tile: height and width in pixels
                          // (2 bs; lists: the bin; global without bits: 8 x
                          // 16), tiles per image row and per image
  int nchunk;             // blocks of THREADS rays a tile
  long long n_rows, n_tab;
  float thr_act, ow;
  const unsigned* mask;        // masked: (B, nsup, nwords) level-1 bits of the super-tiles
  int sup, STW, nsup, nwords;  // masked: tiles a super-tile's side, super-tiles a
                               // row and an image, mask words a super-tile
};

struct Hit {
  float len, act, ksk;
};

// pallas_fine2.py:273-303, same association; q0..q3 are the feature row
// [A0 A1 A2 msm | L00 L01 L02 L10 | L11 L12 L20 L21 | L22 mu0 mu1 mu2]
__device__ __forceinline__ Hit hit_test(const float4 q0, const float4 q1,
                                        const float4 q2, const float4 q3,
                                        const float r0, const float r1,
                                        const float r2, const float (&rr)[9]) {
  float msk = q0.x * r0;
  msk = msk + q0.y * r1;
  msk = msk + q0.z * r2;
  float ksk = q1.x * rr[0];
  ksk = ksk + q1.y * rr[1];
  ksk = ksk + q1.z * rr[2];
  ksk = ksk + q1.w * rr[3];
  ksk = ksk + q2.x * rr[4];
  ksk = ksk + q2.y * rr[5];
  ksk = ksk + q2.z * rr[6];
  ksk = ksk + q2.w * rr[7];
  ksk = ksk + q3.x * rr[8];
  Hit h;
  h.ksk = ksk;
  h.len = msk / ksk;
  const float d0 = q3.y - h.len * r0;
  const float d1 = q3.z - h.len * r1;
  const float d2 = q3.w - h.len * r2;
  const float e0 = (d0 * q1.x + d1 * q1.w) + d2 * q2.z;
  const float e1 = (d0 * q1.y + d1 * q2.x) + d2 * q2.w;
  const float e2 = (d0 * q1.z + d1 * q2.y) + d2 * q3.x;
  h.act = (e0 * d0 + e1 * d1) + e2 * d2;
  return h;
}

__device__ __forceinline__ void copy_row_async(float4* dst, const float4* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * q),
                 "l"(src + q));
}

// Does the cone (c, sin, cos) prove that no ray in it passes the hit test of
// the Gaussian with cull row q = (u, q)?  See the proof in the note above.
__device__ __forceinline__ bool cone_culls(const float4 q, const float c0, const float c1,
                                           const float c2, const float c_sin,
                                           const float c_cos) {
  const float t = fabsf((q.x * c0 + q.y * c1) + q.z * c2);
  const float x0 = q.y * c2 - q.z * c1;
  const float x1 = q.z * c0 - q.x * c2;
  const float x2 = q.x * c1 - q.y * c0;
  const float sp = sqrtf((x0 * x0 + x1 * x1) + x2 * x2);
  const float sd = (sp * c_cos - t * c_sin) - CULL_EPS;
  return sd > 0.0f && q.w * (sd * sd) >= 1.0f;
}

// The position of the set bit of w that has `rank` set bits below it.
__device__ __forceinline__ int nth_bit(unsigned w, int rank) {
  int bit = 0;
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    const int below = __popc(w & ((1u << sh) - 1u));
    if (rank >= below) { rank -= below; w >>= sh; bit += sh; }
  }
  return bit;
}

// One candidate's words, loaded a step ahead: its sub-bin bits (compacted,
// global) or its list id (lists), its cull row (global with a cull), and on
// the compacted entry its id, the table row it stages.
struct Meta {
  float4 q;
  int m;
  int id;
};

template <int MODE>
__global__ void __launch_bounds__(THREADS) fine_select_kernel(const Args a) {
  extern __shared__ float4 smem[];
  float4* s_tab = smem;                                          // CAP rows
  float2* s_ent = reinterpret_cast<float2*>(s_tab + CAP * 4);    // [K][THREADS]
  int* s_cpos = reinterpret_cast<int*>(s_ent + a.K * THREADS);   // [CAP]
  int* s_cbits = s_cpos + CAP;                                   // [CAP]
  int* s_wcnt = s_cbits + CAP;                                   // [2][SUB][WARPS]
  __shared__ int s_gmask;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the ray tile b * ntile + sy * TW + sx, and the chunk of its rays
  const int s = blockIdx.x / a.nchunk, chunk = blockIdx.x % a.nchunk;
  const int b = s / a.ntile;
  const int sy = (s % a.ntile) / a.TW;
  const int sx = (s % a.ntile) % a.TW;
  const int r = chunk * THREADS + tid;
  // masked: warp w takes the 4 x 8 quarter (w / 2, w % 2) of its 8 x 16 tile
  const int lr = MODE == MASKED ? WARP_TH * (warp / 2) + lane / WARP_TW : r / a.tw;
  const int lc = MODE == MASKED ? WARP_TW * (warp % 2) + lane % WARP_TW : r % a.tw;
  const int y = sy * a.th + lr, x = sx * a.tw + lc;
  const bool live = (r < a.th * a.tw) && (y < a.H) && (x < a.W);
  // sub-bin: bit 2*iy + ix of a row's bits; without a bits plane every row
  // carries all four; masked: bit w of a staged row's bits is set when warp
  // w's cone keeps it
  const int g = MODE == MASKED ? warp : a.bits != nullptr ? 2 * (lr / a.bs) + (lc / a.bs) : 0;
  if (tid == 0) s_gmask = 0;
  __syncthreads();
  if (live) atomicOr(&s_gmask, 1 << g);
  __syncthreads();
  const int gmask = s_gmask;  // the sub-bins this block's rays lie in
  if (gmask == 0) return;     // no live ray

  float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
  const size_t pix = ((size_t)b * a.H + y) * a.W + x;
  if (live) {
    r0 = a.rays[pix * 3 + 0];
    r1 = a.rays[pix * 3 + 1];
    r2 = a.rays[pix * 3 + 2];
  }
  const float rv[3] = {r0, r1, r2};
  float rr[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) rr[3 * i + j] = rv[i] * rv[j];

  // compacted: the supertile's own rows; global: its image's Gaussians;
  // lists: the rows the bin's ids name; masked: the loop below the next one
  // walks its super-tile's survivors instead
  const int cnt = MODE == MASKED ? 0 : a.counts != nullptr ? a.counts[s] : a.M;
  const size_t row0 = MODE == COMPACT ? (size_t)s * a.M
                      : MODE == GLOBAL || MODE == MASKED ? (size_t)b * a.M : 0;
  const float4* rows = reinterpret_cast<const float4*>(a.table);
  const int* brow = a.bits != nullptr ? a.bits + (size_t)s * a.M : nullptr;
  const int* lrow = MODE == LISTS ? a.ids + (size_t)s * a.M : nullptr;
  const bool culling = MODE == GLOBAL && a.cull != nullptr;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c_sin = 0.0f, c_cos = 0.0f;
  if (culling) {
    const float* cone = a.cones + ((size_t)s * a.nchunk + chunk) * 8;
    c0 = cone[0]; c1 = cone[1]; c2 = cone[2]; c_sin = cone[3]; c_cos = cone[4];
  }

  auto load_meta = [&](int c) {
    Meta m;
    m.q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    m.m = MODE == LISTS ? -1 : 0;
    m.id = -1;
    if (c < cnt) {
      if (MODE == LISTS) m.m = lrow[c];
      else m.m = brow != nullptr ? brow[c] : 0xF;
      if (culling) m.q = a.cull[row0 + c];
      if constexpr (MODE == COMPACT) m.id = a.ids[row0 + c];
    }
    return m;
  };
  // can this candidate matter to a ray of this block?  (lists: only an id
  // that names a row of the table; compacted: that test is made at the
  // packing, see there)
  auto keeps = [&](const Meta& m) {
    if (MODE == LISTS) return m.m >= 0 && m.m < a.n_tab;
    bool keep = (m.m & gmask) != 0;
    if (culling) keep = keep && !cone_culls(m.q, c0, c1, c2, c_sin, c_cos);
    return keep;
  };

  // the running top-K: K (len, position) entries in shared memory, unsorted;
  // in registers the fill count and, once K are held, the largest entry by
  // the key (len, position) and its slot: the one a better candidate evicts
  float kth = INF;
  int kth_pos = 0, kth_slot = 0, nfill = 0;
  const int K = a.K;
  float2* my_ent = s_ent + tid;

  // Accepted candidates wait in two register slots a lane; the warp puts them
  // into the lists together, when some lane's slots are full.  One scan of K
  // entries then serves every lane with a candidate waiting (taken one at a
  // time, a scan costs the whole warp its instructions for one lane's sake).
  // A candidate waits in arrival order and meets the same strict '<' against
  // the largest entry when its turn comes, so the list is the one immediate
  // insertion would build.
  float pend_len0 = 0.0f, pend_len1 = 0.0f;
  int pend_pos0 = 0, pend_pos1 = 0, npend = 0;

  // The largest entry is kept by quarters of the list: each quarter's largest
  // (len, position, slot) in registers, the list's largest the largest of the
  // four.  A newcomer overwrites it and only its quarter is scanned again.
  const int quarter = (K + 3) / 4;
  float q_len[4];
  int q_pos[4], q_slot[4];
  auto scan_quarter = [&](int qi) {
    const int lo = qi * quarter, hi = min(lo + quarter, K);
    float bl = -INFINITY;    // below every entry: an empty quarter never wins
    int bp = -1, bs = lo;
#pragma unroll 4
    for (int k = lo; k < hi; ++k) {
      const float2 x = my_ent[k * THREADS];
      const int xp = __float_as_int(x.y);
      if (x.x > bl || (x.x == bl && xp > bp)) { bl = x.x; bp = xp; bs = k; }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i == qi) { q_len[i] = bl; q_pos[i] = bp; q_slot[i] = bs; }
  };
  auto insert = [&](float len, int pos) {
    // strict '<': a later candidate never displaces an equal earlier one
    if (!(len < kth)) return;
    const float2 e = make_float2(len, __int_as_float(pos));
    if (nfill < K) {
      my_ent[nfill * THREADS] = e;
      if (++nfill < K) return;
      // masked: one copy of the scan (unrolled, the kernel measured 1.2x
      // slower on the 300K cloud)
#pragma unroll(MODE == MASKED ? 1 : 4)
      for (int i = 0; i < 4; ++i) scan_quarter(i);     // the list is full
    } else {
      my_ent[kth_slot * THREADS] = e;
      scan_quarter(kth_slot / quarter);
    }
    // the entry to evict next: the largest len and among equal lens the
    // latest position
    kth = q_len[0]; kth_pos = q_pos[0]; kth_slot = q_slot[0];
#pragma unroll
    for (int i = 1; i < 4; ++i)
      if (q_len[i] > kth || (q_len[i] == kth && q_pos[i] > kth_pos)) {
        kth = q_len[i]; kth_pos = q_pos[i]; kth_slot = q_slot[i];
      }
  };
  auto drain = [&]() {
    if (npend > 0) insert(pend_len0, pend_pos0);
    if (npend > 1) insert(pend_len1, pend_pos1);
    npend = 0;
  };

  // a passing hit that can still enter the list waits its turn; every thread
  // of the warp comes here (the vote), a dead ray accepts nothing
  auto accept = [&](bool member, const Hit& h, int c) {
    if (member && h.act < a.thr_act && h.len < kth) {
      if (npend == 0) { pend_len0 = h.len; pend_pos0 = s_cpos[c]; }
      else { pend_len1 = h.len; pend_pos1 = s_cpos[c]; }
      ++npend;
    }
    if (__any_sync(0xffffffffu, npend == 2)) drain();
  };
  // test the staged rows [0, n) against this thread's ray, two rows a turn:
  // their hit tests are independent chains (a division each) that overlap;
  // they are offered to the list in order
  auto test_staged = [&](int n) {
    for (int c = 0; c < n; c += 2) {
      const int c1 = c + 1 < n ? c + 1 : c;
      const bool m0 = live && ((s_cbits[c] >> g) & 1);
      const bool m1 = live && c + 1 < n && ((s_cbits[c1] >> g) & 1);
      if (!__any_sync(0xffffffffu, m0 || m1)) continue;
      const Hit h0 = hit_test(s_tab[4 * c], s_tab[4 * c + 1], s_tab[4 * c + 2],
                              s_tab[4 * c + 3], r0, r1, r2, rr);
      const Hit h1 = hit_test(s_tab[4 * c1], s_tab[4 * c1 + 1], s_tab[4 * c1 + 2],
                              s_tab[4 * c1 + 3], r0, r1, r2, rr);
      accept(m0, h0, c);
      accept(m1, h1, c1);
    }
  };
  // masked: a warp walks only the staged rows its own cone keeps (bit g of
  // their bits, the same for its 32 lanes), two a turn, in order
  auto test_warp = [&](int n) {
    for (int c0 = 0; c0 < n; c0 += 32) {
      unsigned mine =
          __ballot_sync(0xffffffffu, c0 + lane < n && ((s_cbits[c0 + lane] >> g) & 1));
      while (mine != 0u) {
        const int c = c0 + __ffs(mine) - 1;
        mine &= mine - 1u;
        const bool two = mine != 0u;
        const int c1 = two ? c0 + __ffs(mine) - 1 : c;
        if (two) mine &= mine - 1u;
        const Hit h0 = hit_test(s_tab[4 * c], s_tab[4 * c + 1], s_tab[4 * c + 2],
                                s_tab[4 * c + 3], r0, r1, r2, rr);
        const Hit h1 = hit_test(s_tab[4 * c1], s_tab[4 * c1 + 1], s_tab[4 * c1 + 2],
                                s_tab[4 * c1 + 3], r0, r1, r2, rr);
        // one copy of accept, and of the insertion it may run, takes both
        // rows: with two copies the masked kernel measured 1.3x slower on
        // the 300K cloud, where a warp's rows pass often and the insertion
        // runs often
        Hit h = h0;
        bool member = live;
        int cc = c;
#pragma unroll 1
        for (int t = 0; t < 2; ++t) {
          accept(member, h, cc);
          h = h1; member = live && two; cc = c1;
        }
      }
    }
  };

  int fill = 0, par = 0;
  Meta cur[SUB], nxt[SUB];
#pragma unroll
  for (int j = 0; j < SUB; ++j) cur[j] = load_meta(j * THREADS + tid);
  for (int base = 0; base < cnt; base += SUB * THREADS) {
#pragma unroll
    for (int j = 0; j < SUB; ++j)
      nxt[j] = load_meta(base + (SUB + j) * THREADS + tid);
    bool keep[SUB];
    unsigned ballot[SUB];
    int* wcnt = s_wcnt + par * SUB * WARPS;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      keep[j] = keeps(cur[j]);
      ballot[j] = __ballot_sync(0xffffffffu, keep[j]);
      if (lane == 0) wcnt[j * WARPS + warp] = __popc(ballot[j]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int n = wcnt[j * WARPS + w];
        if (w < warp) before += n;
        total += n;
      }
      if (keep[j]) {
        // ascending position: sub-chunk, then warp, then lane
        const int o = fill + before + __popc(ballot[j] & ((1u << lane) - 1u));
        const int c = base + j * THREADS + tid;
        s_cpos[o] = c;
        // compacted: a slot whose id names no row of the table stages row 0
        // with no sub-bin bits, so no ray takes it (tested here rather than
        // in the vote, the instantiation holds 121 registers and spills
        // nothing; in the vote it spilled 16 bytes at 128)
        const bool named = MODE != COMPACT || (cur[j].id >= 0 && cur[j].id < a.n_tab);
        s_cbits[o] = MODE == LISTS ? 0xF : named ? cur[j].m : 0;
        const size_t row = MODE == LISTS     ? (size_t)cur[j].m
                           : MODE == COMPACT ? (named ? (size_t)cur[j].id : 0)
                                             : row0 + c;
        copy_row_async(s_tab + 4 * o, rows + 4 * row);
      }
      fill += total;
      if (fill > CAP - THREADS) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        test_staged(fill);
        __syncthreads();
        fill = 0;
      }
    }
    par ^= 1;
#pragma unroll
    for (int j = 0; j < SUB; ++j) cur[j] = nxt[j];
  }
  if (MODE == MASKED) {
    // Level 2 of the two-level cull: the candidates are the Gaussians whose
    // bit is set in the block's super-tile row of the level-1 mask, in
    // ascending index.  A round takes ROUND_WORDS words (a uint4 a thread,
    // the next round's loaded meanwhile) and numbers their set bits by a
    // scan over the block; candidate k of the round is the bit that has k
    // set bits before it, found by a binary search over the words' running
    // counts.  Candidates then go SUB * THREADS at a time through the cone
    // test of each of the block's four warps (4 x 8 rays each; their cones
    // in a.cones, one a 4 x 8 tile of the image), on the cull row read by
    // id, and through the packing above with the Gaussian's index as their
    // position and the warps that keep it as their bits.
    unsigned* s_word = reinterpret_cast<unsigned*>(s_wcnt + 2 * SUB * WARPS);  // [ROUND_WORDS]
    int* s_run = reinterpret_cast<int*>(s_word + ROUND_WORDS);  // [ROUND_WORDS] inclusive counts
    int* s_wsum = s_run + ROUND_WORDS;                          // [WARPS]
    float* s_wcone = reinterpret_cast<float*>(s_wsum + WARPS);  // [WARPS][8]
    if (tid < 8 * WARPS) {
      // warp w's 4 x 8 tile; one with no ray in the image is never read
      const int w = tid / 8, ty = 2 * sy + w / 2, tx = 2 * sx + w % 2;
      const int TW4 = (a.W + WARP_TW - 1) / WARP_TW, TH4 = (a.H + WARP_TH - 1) / WARP_TH;
      s_wcone[tid] = ((gmask >> w) & 1)
                         ? a.cones[(((size_t)b * TH4 + ty) * TW4 + tx) * 8 + tid % 8]
                         : 0.0f;
    }
    const uint4* mrow = reinterpret_cast<const uint4*>(
        a.mask + ((size_t)b * a.nsup + (sy / a.sup) * a.STW + sx / a.sup) * a.nwords);
    const int nq = a.nwords / 4;
    const uint4 none = make_uint4(0u, 0u, 0u, 0u);
    uint4 wnext = tid < nq ? __ldg(mrow + tid) : none;
    for (int q0 = 0; q0 < nq; q0 += THREADS) {
      const uint4 wq = wnext;
      wnext = q0 + THREADS + tid < nq ? __ldg(mrow + q0 + THREADS + tid) : none;
      const unsigned w4[4] = {wq.x, wq.y, wq.z, wq.w};
      int run[4], mine = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) { mine += __popc(w4[j]); run[j] = mine; }
      int incl = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane == 31) s_wsum[warp] = incl;
      __syncthreads();
      int before = 0, n_round = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int v = s_wsum[w];
        if (w < warp) before += v;
        n_round += v;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_word[4 * tid + j] = w4[j];
        s_run[4 * tid + j] = before + incl - mine + run[j];
      }
      __syncthreads();
      for (int k0 = 0; k0 < n_round; k0 += SUB * THREADS) {
        Meta m[SUB];
        int id[SUB];
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          const int k = k0 + j * THREADS + tid;
          m[j].q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          m[j].m = 0;
          id[j] = 0;
          if (k < n_round) {
            int lo = 0, hi = ROUND_WORDS - 1;   // the first word whose count passes k
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              if (s_run[mid] > k) hi = mid; else lo = mid + 1;
            }
            const unsigned wd = s_word[lo];
            id[j] = 32 * (4 * q0 + lo) + nth_bit(wd, k - (s_run[lo] - __popc(wd)));
            m[j].q = a.cull[row0 + id[j]];
            m[j].m = gmask;
          }
        }
        bool keep[SUB];
        unsigned ballot[SUB];
        int wkeep[SUB];
        int* wcnt = s_wcnt + par * SUB * WARPS;
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          wkeep[j] = 0;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) {
            const float* c = s_wcone + 8 * w;
            if ((m[j].m >> w) & 1 && !cone_culls(m[j].q, c[0], c[1], c[2], c[3], c[4]))
              wkeep[j] |= 1 << w;
          }
          keep[j] = wkeep[j] != 0;
          ballot[j] = __ballot_sync(0xffffffffu, keep[j]);
          if (lane == 0) wcnt[j * WARPS + warp] = __popc(ballot[j]);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          int wbefore = 0, total = 0;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) {
            const int n = wcnt[j * WARPS + w];
            if (w < warp) wbefore += n;
            total += n;
          }
          if (keep[j]) {
            const int o = fill + wbefore + __popc(ballot[j] & ((1u << lane) - 1u));
            s_cpos[o] = id[j];
            s_cbits[o] = wkeep[j];
            copy_row_async(s_tab + 4 * o, rows + 4 * (row0 + id[j]));
          }
          fill += total;
          if (fill > CAP - THREADS) {
            asm volatile("cp.async.wait_all;\n" ::: "memory");
            __syncthreads();
            test_warp(fill);
            __syncthreads();
            fill = 0;
          }
        }
        par ^= 1;
      }
    }
  }
  if (fill > 0) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (MODE == MASKED) test_warp(fill);
    else test_staged(fill);
  }
  drain();

  // the flush.  Every thread stays (the warp writes the empty slots together);
  // a dead ray holds nothing and writes nothing of its own.
  const size_t o = live ? pix * K : 0;
  // the entries in ascending (len, position): a selection sort in place
  for (int k = 0; k + 1 < nfill; ++k) {
    float2 best = my_ent[k * THREADS];
    int at = k;
    for (int q = k + 1; q < nfill; ++q) {
      const float2 x = my_ent[q * THREADS];
      if (x.x < best.x || (x.x == best.x && __float_as_int(x.y) < __float_as_int(best.y))) {
        best = x; at = q;
      }
    }
    if (at != k) {
      my_ent[at * THREADS] = my_ent[k * THREADS];
      my_ent[k * THREADS] = best;
    }
  }
  // act and dsd of each kept candidate from its row again (the outputs alias
  // no input, so the next slots' loads may pass this slot's stores)
  {
  int* __restrict__ o_idx = a.o_idx;
  float* __restrict__ o_len = a.o_len;
  float* __restrict__ o_act = a.o_act;
  float* __restrict__ o_dsd = a.o_dsd;
  const int* __restrict__ id_of = MODE == COMPACT ? a.ids + row0 : lrow;
#pragma unroll 4
  for (int k = 0; k < nfill; ++k) {
    const float2 e = my_ent[k * THREADS];
    const int c = __float_as_int(e.y);
    const bool by_id = MODE == COMPACT || MODE == LISTS;
    const int id = by_id ? __ldg(id_of + c) : (int)(row0 + c);
    const float4* src = rows + 4 * (by_id ? (size_t)id : row0 + c);
    const Hit h = hit_test(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3),
                           r0, r1, r2, rr);
    o_idx[o + k] = id;
    o_len[o + k] = e.x;
    o_act[o + k] = h.act;
    o_dsd[o + k] = h.ksk;
    // the slot's sum of the compositing starts here, where the position was
    my_ent[k * THREADS] = make_float2(e.x, 0.0f);
  }
  }
  // The empty slots of the warp's 32 pixels, written by the warp together: a
  // pixel's slots are contiguous, so lane l takes slot nfill + l, + 32, ...
  // (a thread writing its own K slots touches a 32-byte sector for each 4
  // bytes; at K = 80 with 19 slots held that was most of the kernel's time).
  __syncwarp();
  for (int p = 0; p < 32; ++p) {
    const int first = __shfl_sync(0xffffffffu, live ? nfill : K, p);
    const unsigned long long at = __shfl_sync(0xffffffffu, (unsigned long long)o, p);
    for (int k = first + lane; k < K; k += 32) {
      a.o_idx[at + k] = -1;
      a.o_len[at + k] = INF;
      a.o_act[at + k] = INF;
      a.o_dsd[at + k] = 0.0f;
      if (a.o_w != nullptr) a.o_w[at + k] = 0.0f;
    }
  }
  if (a.o_w == nullptr || !live) return;
  // pallas_fine2.py:386-406, summed over the occupied slots in ascending
  // order: an empty slot k has e^{-act_k} = 0 and adds exactly 0 to every
  // sum, and an empty slot j has weight exactly 0.  Slot k's e^{-act} and
  // sqrt(dsd + 1e-10) are formed once and added into every slot j's sum,
  // which lives in the list's memory beside len_j; the next slot's act and
  // dsd are on their way from memory meanwhile.
  float act_k = nfill > 0 ? a.o_act[o] : 0.0f, dsd_k = nfill > 0 ? a.o_dsd[o] : 0.0f;
  for (int k = 0; k < nfill; ++k) {
    const float ea = expf(-act_k), sq = sqrtf(dsd_k + 1e-10f);
    const float lk = my_ent[k * THREADS].x;
    if (k + 1 < nfill) { act_k = a.o_act[o + k + 1]; dsd_k = a.o_dsd[o + k + 1]; }
#pragma unroll 4
    for (int j = 0; j < nfill; ++j) {
      float2 ej = my_ent[j * THREADS];
      const float ca = (ej.x - lk) * sq;
      ej.y = ej.y + ea * (0.5f * (erff(ca) + 1.0f));
      my_ent[j * THREADS] = ej;
    }
  }
  for (int j = 0; j < nfill; ++j) {
    const float2 ej = my_ent[j * THREADS];
    a.o_w[o + j] = expf(-a.ow * ej.y) * expf(-a.o_act[o + j]) * E_HALF;
  }
  if (a.o_img != nullptr) {
    // the empty slots add nothing: the sum runs over the occupied ones
    for (int ch = 0; ch < a.d; ++ch)
      a.o_img[pix * a.d + ch] = voge_attr_merge_one(
          a.o_idx + o, a.o_w + o, nfill, a.attrs, a.n_rows, a.d, ch);
  }
}

template <int MODE>
int launch(Args& a, int nb, cudaStream_t stream) {
  a.nchunk = (a.th * a.tw + THREADS - 1) / THREADS;
  const size_t smem = (size_t)CAP * 64 + (size_t)a.K * THREADS * 8 + (size_t)CAP * 8 +
                      2 * SUB * WARPS * sizeof(int) +
                      (MODE == MASKED ? (2 * ROUND_WORDS + 9 * WARPS) * sizeof(int) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fine_select_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fine_select_kernel<MODE><<<(unsigned)nb * a.nchunk, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- the global entry's glue on the card -----------------------------------
// The cull rows and the block cones the kernel above reads, as
// ops/cuda_fine.py::cull_rows_plain / block_cones_plain compute them (float64,
// the same formulas; the slack in the bound covers the last bits between the
// two).  One thread a Gaussian; one block of 128 threads a ray block.

constexpr double CULL_MARGIN = 1e-3, CONE_SLACK = 1e-6, EIG_SLACK = 4e-6;
constexpr int EIG_NEWTON_STEPS = 6;

__global__ void cull_rows_kernel(const float* __restrict__ table,
                                 float4* __restrict__ out, long long n,
                                 double thr_act) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4* row = reinterpret_cast<const float4*>(table) + 4 * i;
  const float4 q1 = row[1], q2 = row[2], q3 = row[3];
  const double L[9] = {q1.x, q1.y, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, q3.x};
  const double mu[3] = {q3.y, q3.z, q3.w};
  // the symmetric part, [[a d e] [d b f] [e f c]]
  const double a = L[0], b = L[4], c = L[8];
  const double d = 0.5 * (L[1] + L[3]), e = 0.5 * (L[2] + L[6]), f = 0.5 * (L[5] + L[7]);
  const double tr = a + b + c;
  const double c2 = (a * b - d * d) + (a * c - e * e) + (b * c - f * f);
  const double det = a * (b * c - f * f) - d * (d * c - f * e) + e * (d * f - b * e);
  const bool spd = tr > 0 && c2 > 0 && det > 0;
  // det / (trace / 2)^2 <= lambda_min; Newton on det(S - x I) rises from there
  // and never passes the least root
  double x = spd ? det / ((0.5 * tr) * (0.5 * tr)) : 0.0;
  for (int it = 0; it < EIG_NEWTON_STEPS; ++it) {
    const double p = ((tr - x) * x - c2) * x + det;
    const double dp = (2.0 * tr - 3.0 * x) * x - c2;
    if (spd && p > 0 && dp < 0) x = x - p / dp;
  }
  double fro = 0.0;
  for (int k = 0; k < 9; ++k) fro += L[k] * L[k];
  const double lo = x - EIG_SLACK * sqrt(fro);
  const double n2 = mu[0] * mu[0] + mu[1] * mu[1] + mu[2] * mu[2];
  const double q = thr_act > 0 ? lo * n2 / (thr_act * (1.0 + CULL_MARGIN)) : 0.0;
  const double inv = 1.0 / sqrt(n2);
  const double u0 = mu[0] * inv, u1 = mu[1] * inv, u2 = mu[2] * inv;
  const bool ok = spd && q > 0 && n2 > 1e-20 && isfinite(q) && isfinite(u0) &&
                  isfinite(u1) && isfinite(u2);
  out[i] = ok ? make_float4((float)u0, (float)u1, (float)u2, (float)fmin(q, 1e30))
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// a minimum that keeps a NaN
__device__ __forceinline__ double nan_min(double x, double y) {
  return x != x ? x : (y != y ? y : (x < y ? x : y));
}

// (sum over the block, every thread gets it; fixed shuffle tree)
__device__ __forceinline__ double block_sum(double v, double* s_red) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = s_red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) t += s_red[w];
  return t;
}

__global__ void __launch_bounds__(THREADS) block_cones_kernel(
    const float* __restrict__ rays, float* __restrict__ cones, int H, int W,
    int th, int tw, int TW, int ntile, int nchunk) {
  __shared__ double s_red[WARPS];
  const int tid = threadIdx.x;
  const int s = blockIdx.x / nchunk, chunk = blockIdx.x % nchunk;
  const int b = s / ntile, sy = (s % ntile) / TW, sx = (s % ntile) % TW;
  const int r = chunk * THREADS + tid;
  const int y = sy * th + r / tw, x = sx * tw + r % tw;
  const bool live = (r < th * tw) && (y < H) && (x < W);
  double u0 = 0.0, u1 = 0.0, u2 = 0.0;
  if (live) {
    const size_t pix = ((size_t)b * H + y) * W + x;
    u0 = rays[pix * 3 + 0]; u1 = rays[pix * 3 + 1]; u2 = rays[pix * 3 + 2];
    const double inv = 1.0 / sqrt(u0 * u0 + u1 * u1 + u2 * u2);
    u0 *= inv; u1 *= inv; u2 *= inv;
  }
  const double n_live = block_sum(live ? 1.0 : 0.0, s_red);
  double c0 = block_sum(u0, s_red), c1 = block_sum(u1, s_red), c2 = block_sum(u2, s_red);
  const double inv = 1.0 / sqrt(c0 * c0 + c1 * c1 + c2 * c2);
  c0 *= inv; c1 *= inv; c2 *= inv;
  // the least cosine between a ray of the block and its axis
  double cs = live ? (u0 * c0 + u1 * c1) + u2 * c2 : 1.0;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) cs = nan_min(cs, __shfl_xor_sync(0xffffffffu, cs, m));
  __syncthreads();
  if ((tid & 31) == 0) s_red[tid >> 5] = cs;
  __syncthreads();
  if (tid != 0) return;
  for (int w = 1; w < WARPS; ++w) cs = nan_min(cs, s_red[w]);
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  double theta = nan;
  if (n_live > 0 && cs == cs) {
    theta = acos(fmin(fmax(cs, -1.0), 1.0)) + CONE_SLACK;
    theta = fmin(theta, 1.5707963267948966);
  }
  float* out = cones + (size_t)blockIdx.x * 8;
  out[0] = (float)c0; out[1] = (float)c1; out[2] = (float)c2;
  out[3] = (float)sin(theta); out[4] = (float)cos(theta);
  out[5] = out[6] = out[7] = 0.0f;
}

// ---- the two-level cull's level 1 ------------------------------------------
// The cones of the super-tiles, as ops/cuda_fine.py::super_cones_plain
// computes them: super-tile (b, SY, SX) holds the tiles (SY G + i, SX G + j)
// of image b's TH x TW grid that exist (tiles of a warp's 4 x 8 rays), and
// its cone holds each of their float32 cones with SUPER_SLACK to spare
// (float64 inside; see the note).  One warp a super-tile, its lanes over the
// tiles, the sums and the widest reach by a fixed shuffle tree.  (An
// overload of the blocks' cones' kernel: the same layer's glue.)
constexpr double SUPER_SLACK = 1e-5;

__device__ __forceinline__ double nan_max(double x, double y) {
  return x != x ? x : (y != y ? y : (x > y ? x : y));
}

__global__ void __launch_bounds__(THREADS) block_cones_kernel(
    const float* __restrict__ cones, float* __restrict__ sup, int n, int TH, int TW, int G,
    int STH, int STW) {
  const int i = (blockIdx.x * THREADS + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (i >= n) return;   // a whole warp
  const int nst = STH * STW, b = i / nst, SY = (i % nst) / STW, SX = (i % nst) % STW;
  const int y0 = SY * G, x0 = SX * G, gw = min(G, TW - x0), m = min(G, TH - y0) * gw;
  auto cone = [&](int k) { return cones + (((size_t)b * TH + y0 + k / gw) * TW + x0 + k % gw) * 8; };
  double a0 = 0.0, a1 = 0.0, a2 = 0.0;
  for (int k = lane; k < m; k += 32) {
    const float* c = cone(k);
    const double u0 = c[0], u1 = c[1], u2 = c[2];
    const double inv = 1.0 / sqrt(u0 * u0 + u1 * u1 + u2 * u2);
    a0 += u0 * inv; a1 += u1 * inv; a2 += u2 * inv;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a0 += __shfl_xor_sync(0xffffffffu, a0, o);
    a1 += __shfl_xor_sync(0xffffffffu, a1, o);
    a2 += __shfl_xor_sync(0xffffffffu, a2, o);
  }
  const double inv = 1.0 / sqrt(a0 * a0 + a1 * a1 + a2 * a2);
  a0 *= inv; a1 *= inv; a2 *= inv;
  // the widest a tile's cone reaches from the axis
  double theta = 0.0;
  for (int k = lane; k < m; k += 32) {
    const float* c = cone(k);
    const double u0 = c[0], u1 = c[1], u2 = c[2];
    const double cs = (a0 * u0 + a1 * u1 + a2 * u2) / sqrt(u0 * u0 + u1 * u1 + u2 * u2);
    theta = nan_max(theta, acos(fmin(fmax(cs, -1.0), 1.0)) + atan2((double)c[3], (double)c[4]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) theta = nan_max(theta, __shfl_xor_sync(0xffffffffu, theta, o));
  if (lane != 0) return;
  if (theta == theta && a0 == a0) theta = fmin(theta + SUPER_SLACK, 1.5707963267948966);
  else theta = __longlong_as_double(0x7ff8000000000000LL);
  float* out = sup + (size_t)i * 8;
  out[0] = (float)a0; out[1] = (float)a1; out[2] = (float)a2;
  out[3] = (float)sin(theta); out[4] = (float)cos(theta);
  out[5] = out[6] = out[7] = 0.0f;
}

// Level 1: bit n % 32 of word n / 32 of super-tile t's row is set when
// Gaussian n of the image survives t's cone by the warps' own test, so a
// row lists its survivors in ascending index with no scan and nothing to
// overflow.  One thread a Gaussian, its cull row read once; a warp's ballot
// is one word.  A block's 32 warps take 32 consecutive words of 32
// super-tiles (blockIdx.z the super-tiles' group), gathered in shared memory
// and stored a row's 128 bytes by one warp.  (An overload of the select's
// kernel: the same layer.)
constexpr int L1_WARPS = 32;

__global__ void __launch_bounds__(32 * L1_WARPS) fine_select_kernel(
    const float4* __restrict__ cull, const float4* __restrict__ sup,
    unsigned* __restrict__ mask, unsigned long long* __restrict__ kept, int P, int nsup,
    int nwords) {
  __shared__ unsigned s_w[32][L1_WARPS];  // [super-tile of the 32][warp]
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * 32 * L1_WARPS + threadIdx.x, w0 = blockIdx.x * L1_WARPS;
  const float4 q = n < P ? cull[(size_t)b * P + n] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* cone = sup + (size_t)b * nsup * 2;
  const int t0 = blockIdx.z * 32, nt = min(32, nsup - t0);
  unsigned long long n_kept = 0;
  for (int i = 0; i < nt; ++i) {
    const float4 c = __ldg(cone + 2 * (t0 + i)), e = __ldg(cone + 2 * (t0 + i) + 1);
    const unsigned word =
        __ballot_sync(0xffffffffu, n < P && !cone_culls(q, c.x, c.y, c.z, c.w, e.x));
    if (lane == 0) s_w[i][warp] = word;
    n_kept += __popc(word);
  }
  // tracing's count of the rows kept (integer sums: the same in any order)
  if (kept != nullptr && lane == 0 && n_kept > 0) atomicAdd(kept, n_kept);
  __syncthreads();
  if (warp < nt && w0 + lane < nwords)
    mask[((size_t)b * nsup + t0 + warp) * nwords + w0 + lane] = s_w[warp][lane];
}

}  // namespace

// Cull rows (n, 4) of the feature rows ``table`` (n, 16).
extern "C" int voge_cull_rows(const void* table, void* out, long long n,
                              double thr_act, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cull_rows_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)table, (float4*)out, n, thr_act);
  return (int)cudaGetLastError();
}

// Cones (nb * ceil(th tw / 128), 8) of the ray blocks of ``rays`` (B, H, W, 3)
// in nb = B * ntile tiles of th x tw pixels, TW a row.
extern "C" int voge_block_cones(const void* rays, void* cones, int nb, int H,
                                int W, int th, int tw, int TW, int ntile,
                                void* stream) {
  if (nb <= 0 || th <= 0 || tw <= 0) return (int)cudaErrorInvalidValue;
  const int nchunk = (th * tw + THREADS - 1) / THREADS;
  block_cones_kernel<<<(unsigned)nb * nchunk, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)rays, (float*)cones, H, W, th, tw, TW, ntile, nchunk);
  return (int)cudaGetLastError();
}

// Cones (B * STH * STW, 8) of the super-tiles of G x G tiles over the tiles'
// cones ``cones`` (B * TH * TW, 8).
extern "C" int voge_super_cones(const void* cones, void* sup, int B, int TH, int TW,
                                int G, void* stream) {
  if (B <= 0 || TH <= 0 || TW <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  const int STH = (TH + G - 1) / G, STW = (TW + G - 1) / G, n = B * STH * STW;
  const int warps = THREADS / 32;
  block_cones_kernel<<<(unsigned)((n + warps - 1) / warps), THREADS, 0,
                       (cudaStream_t)stream>>>((const float*)cones, (float*)sup, n, TH, TW,
                                               G, STH, STW);
  return (int)cudaGetLastError();
}

// Level 1's mask (B, nsup, ceil(P / 128) * 4) of the cull rows ``cull``
// (B * P, 4) against the super-tiles' cones ``sup`` (B * nsup, 8); the bits
// it sets are added to ``kept`` (one int64) unless it is null.
extern "C" int voge_cull_lists(const void* cull, const void* sup, void* mask, void* kept,
                               int B, int P, int nsup, void* stream) {
  if (B <= 0 || P <= 0 || nsup <= 0 || B > 65535 || nsup > 32 * 65535)
    return (int)cudaErrorInvalidValue;
  const int nwords = (P + THREADS - 1) / THREADS * 4;
  const int nblk = (nwords + L1_WARPS - 1) / L1_WARPS;
  fine_select_kernel<<<dim3((unsigned)nblk, (unsigned)B, (unsigned)((nsup + 31) / 32)),
                       32 * L1_WARPS, 0, (cudaStream_t)stream>>>(
      (const float4*)cull, (const float4*)sup, (unsigned*)mask, (unsigned long long*)kept, P,
      nsup, nwords);
  return (int)cudaGetLastError();
}

// The compacted entry: candidates of supertile s (nb = B * nst supertiles of
// 2 bs x 2 bs pixels, BW2 a row) are its first ``counts[s]`` slots of
// ``bits`` and ``ids`` (nb, M); a slot's row is ``table`` (n_tab, 16) at its
// id, and an id outside [0, n_tab) is no candidate.
extern "C" int voge_fine_select(
    const void* rays, const void* table, const void* bits, const void* ids,
    const void* counts, const void* attrs, void* o_idx,
    void* o_len, void* o_act, void* o_dsd, void* o_w, void* o_img, int nb, int H,
    int W, int bs, int BW2, int nst, int M, int K, int d, long long n_rows,
    long long n_tab, float thr_act, float ow, void* stream) {
  if (nb <= 0 || bs <= 0 || K <= 0 || K > 128 || n_tab <= 0 || bits == nullptr ||
      ids == nullptr || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.rays = (const float*)rays;
  a.table = (const float*)table;
  a.bits = (const int*)bits;
  a.ids = (const int*)ids;
  a.counts = (const int*)counts;
  a.attrs = (const float*)attrs;
  a.o_idx = (int*)o_idx;
  a.o_len = (float*)o_len;
  a.o_act = (float*)o_act;
  a.o_dsd = (float*)o_dsd;
  a.o_w = (float*)o_w;
  a.o_img = (float*)o_img;
  a.H = H; a.W = W; a.bs = bs; a.M = M; a.K = K;
  a.th = a.tw = 2 * bs; a.TW = BW2; a.ntile = nst;
  a.d = d; a.n_rows = n_rows; a.n_tab = n_tab; a.thr_act = thr_act; a.ow = ow;
  return launch<COMPACT>(a, nb, (cudaStream_t)stream);
}

// The global entry: candidates of ray tile s (nb = B * ntile tiles of
// th x tw pixels, row-major, TW a row) are the P rows of image s / ntile in
// ``table`` (B * P, 16).  ``bits`` (nb, P) or null for all members; with bits
// the tiles are the supertiles (th = tw = 2 bs).  ``cull`` (B * P, 4) and
// ``cones`` (nb * ceil(th tw / 128), 8), or both null for no cull.
// Two levels (S > 0; a cull, no bits, tiles of 8 x 16): ``cones``, ``sup``
// and ``mask`` are the route's workspace, which this call fills before the
// select: the cones of the 4 x 8 tiles of the warps (B * TH4 * TW4, 8), of
// the super-tiles of S x S tiles (B * nsup, 8), and level 1's mask (B, nsup,
// ceil(P / 128) * 4), its kept bits added to ``kept`` unless it is null.
extern "C" int voge_fine_select_global(
    const void* rays, const void* table, const void* bits, const void* cull,
    void* cones, void* sup, void* mask, void* kept, void* o_idx, void* o_len,
    void* o_act, void* o_dsd, void* o_w, int nb, int H, int W, int bs, int th, int tw,
    int TW, int ntile, int P, int K, int S, float thr_act, float ow, void* stream) {
  if (nb <= 0 || bs <= 0 || th <= 0 || tw <= 0 || P <= 0 || K <= 0 || K > 128 ||
      (cull == nullptr) != (cones == nullptr) ||
      (S > 0 && (cull == nullptr || bits != nullptr || th != 2 * WARP_TH ||
                 tw != 2 * WARP_TW || sup == nullptr || mask == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.rays = (const float*)rays;
  a.table = (const float*)table;
  a.bits = (const int*)bits;
  a.cull = (const float4*)cull;
  a.cones = (const float*)cones;
  a.o_idx = (int*)o_idx;
  a.o_len = (float*)o_len;
  a.o_act = (float*)o_act;
  a.o_dsd = (float*)o_dsd;
  a.o_w = (float*)o_w;
  a.H = H; a.W = W; a.bs = bs; a.M = P; a.K = K;
  a.th = th; a.tw = tw; a.TW = TW; a.ntile = ntile;
  a.thr_act = thr_act; a.ow = ow;
  if (S <= 0) return launch<GLOBAL>(a, nb, (cudaStream_t)stream);
  const int B = nb / ntile, TH4 = (H + WARP_TH - 1) / WARP_TH, TW4 = (W + WARP_TW - 1) / WARP_TW;
  int err = voge_block_cones(rays, cones, B * TH4 * TW4, H, W, WARP_TH, WARP_TW, TW4,
                             TH4 * TW4, stream);
  if (err == 0) err = voge_super_cones(cones, sup, B, TH4, TW4, 2 * S, stream);
  a.mask = (const unsigned*)mask;
  a.sup = S;
  a.STW = (TW + S - 1) / S;
  a.nsup = ((ntile / TW + S - 1) / S) * a.STW;
  a.nwords = (P + THREADS - 1) / THREADS * 4;
  if (err == 0) err = voge_cull_lists(cull, sup, mask, kept, B, P, a.nsup, stream);
  return err != 0 ? err : launch<MASKED>(a, nb, (cudaStream_t)stream);
}

// The per-bin-list entry: candidates of bin s (nb = B * BH * BW bins of
// bsh x bsw pixels, row-major) are the rows of ``table`` (n_tab, 16) named by
// ``list`` (nb, M), -1 where empty; the outputs' idx holds those ids.
extern "C" int voge_fine_select_bins(
    const void* rays, const void* table, const void* list, void* o_idx,
    void* o_len, void* o_act, void* o_dsd, int nb, int H, int W, int bsh,
    int bsw, int BW, int nbin, int M, long long n_tab, int K, float thr_act,
    void* stream) {
  if (nb <= 0 || bsh <= 0 || bsw <= 0 || M <= 0 || n_tab <= 0 || K <= 0 || K > 128 ||
      list == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.rays = (const float*)rays;
  a.table = (const float*)table;
  a.ids = (const int*)list;
  a.o_idx = (int*)o_idx;
  a.o_len = (float*)o_len;
  a.o_act = (float*)o_act;
  a.o_dsd = (float*)o_dsd;
  // no bits plane: every listed Gaussian is a member of the whole bin
  a.H = H; a.W = W; a.bs = bsh > bsw ? bsh : bsw; a.M = M; a.K = K;
  a.th = bsh; a.tw = bsw; a.TW = BW; a.ntile = nbin;
  a.n_tab = n_tab;
  a.thr_act = thr_act;
  return launch<LISTS>(a, nb, (cudaStream_t)stream);
}

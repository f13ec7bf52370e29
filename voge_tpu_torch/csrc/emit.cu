// The coarse stage of the compacted render path, from cameras and Gaussians
// to the per-supertile candidate rows, in three kernels and the grouping of
// csrc/slot_runs.cu:
//
//   emit_rows  (K1) per Gaussian: the window cells' row ids and sub-bin bits,
//              the (u, v, rx, ry) planes, the oversize flags as bit words and
//              the widest window the finite oversize Gaussians need;
//   slot_runs  the window cells grouped by row id (csrc/slot_runs.cu);
//   globals    per image: the first n_globals oversize Gaussians by index,
//              their bits over every supertile, each row's full count, the
//              densest row and the dropped globals;
//   rows       per row: the ascending local run merged with the row's
//              ascending global members into pos_c, bits_c, ids_c at width
//              M, the counts, the overflow and (on request) the inverse map.
//
// It replaces voge_tpu/ops/pallas_coarse.py::_emit_kernel (reached through
// emit_keys_pallas <- coarse.emit_supertile_candidates), which packs an int
// sort key ((img * nst + st) * S + idx) * 16 + bits per window cell, and the
// XLA glue around it (voge_tpu/ops/coarse.py:380-440: top_k of the oversize
// Gaussians, their bits, one sort of every key, searchsorted of the row
// edges, a dynamic_slice per row).  The port's first version kept that
// layout: an int64 torch.sort, searchsorted and ~100 PyTorch launches of glue
// a render, with two or three host reads.
//
// Why the rows are the sorted route's, bit for bit.  A row's keys differ in
// idx (a Gaussian emits one cell per supertile, and an oversize Gaussian no
// local cell), so the sort orders each row by Gaussian index.  Here the
// window cells are laid out (B, P, win^2), Gaussian-major within an image,
// and slot_runs is stable, so each row's local run comes out ascending; the
// global members are found in ascending index, so the merge by position
// (rank = own index + the other list's members below) is the sorted row.
// The first M of it are kept, as the sorted route's slice keeps them.
//
// What bounds it on the H100: launches.  The emission reads 48 B and writes
// 5 win^2 + 16 B a Gaussian (~2 MB at 100K Gaussians, under a microsecond of
// HBM time); the rows kernel writes 12 B a row slot.  The design: one pass a
// stage, no shared state across blocks but integer atomics into a three-int
// buffer (densest row, dropped globals, wider window), which the wrapper
// reads once per render.
//
// Exactness: this file is compiled with -fmad=false and keeps the Pallas
// kernel's operation order term for term (pallas_coarse.py:50-132; the
// globals' bits in the order of voge_tpu/ops/coarse.py:_bits), so every
// product and sum rounds once, as each PyTorch elementwise op does.  The
// outputs equal the plain versions' (ops/cuda_coarse.py) bit for bit: a
// contracted FMA would move a bin-edge comparison and flip a membership bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int EMIT_THREADS = 256;
constexpr int GLOBALS_THREADS = 512;
constexpr int ROWS_THREADS = 256;
constexpr int MAX_SMEM_GLOBALS = 4096;  // 8 B a global member: 32 KB of the rows kernel's 48 KB

// info[]: what the host reads once per render
constexpr int INFO_DENSEST = 0, INFO_DROPPED = 1, INFO_WIDER = 2, INFO_LEN = 3;

struct Window {
  int f0;
  int w;
  bool fin;
};

__device__ __forceinline__ Window window(float c, float r, float fb, float st) {
  const float lo = ((c - r) - fb) / st;
  const float hi = (c + r) / st;
  Window out;
  out.fin = isfinite(lo) && isfinite(hi);
  const float f0 = out.fin ? floorf(lo) : 0.0f;
  const float f1 = out.fin ? floorf(hi) : -2.0f;
  const float lim = 1073741824.0f;  // 2^30
  out.f0 = (int)fminf(fmaxf(f0, -lim), lim);
  out.w = (int)fminf(fmaxf(f1, -lim), lim) - out.f0 + 1;
  return out;
}

// Exclusive prefix of v over the block's threads in thread order; every
// thread must call it.  s_tmp holds blockDim.x / 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_tmp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_tmp[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < warps; ++w) {
    const int t = s_tmp[w];
    if (w < warp) before += t;
    total += t;
  }
  __syncthreads();
  return before + x - v;
}

// K1: one thread per Gaussian.
__global__ void __launch_bounds__(EMIT_THREADS) emit_rows_kernel(
    const float* __restrict__ Rm,        // (B, 9) row-major
    const float* __restrict__ focal,     // (B, 2)
    const float* __restrict__ principal, // (B, 2)
    const float* __restrict__ points,    // (B, P, 3) camera-centred means
    const float* __restrict__ isig,      // (B, P, 9) Lambda row-major
    int* __restrict__ rid,               // (B, P, win*win) row id or -1
    uint8_t* __restrict__ bits_out,      // (B, P, win*win) sub-bin bits
    float* __restrict__ planes,          // (B, 4, P): u, v, rx, ry
    unsigned* __restrict__ over,         // (B, nw) oversize flags, bit p % 32 of word p / 32
    int* __restrict__ info, int P, int nw, float nlt, float fb, int H, int W, int BH2,
    int BW2, int nst, int win, int max_win) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  const bool live = p < P;
  bool oversize = false;
  if (live) {
    const float* c = Rm + (size_t)b * 9;
    const float* pt = points + ((size_t)b * P + p) * 3;
    const float* L = isig + ((size_t)b * P + p) * 9;
    const float st = 2.0f * fb;

    // camera planes (pallas_coarse.py:56-60)
    float view[3];
    for (int d = 0; d < 3; ++d)
      view[d] = (pt[0] * c[d] + pt[1] * c[3 + d]) + pt[2] * c[6 + d];
    const float z = view[2];
    const float fx = focal[2 * b], fy = focal[2 * b + 1];
    const float u = principal[2 * b] - (view[0] * fx) / z;
    const float v = principal[2 * b + 1] - (view[1] * fy) / z;

    // pixel radii of the thr-level ellipse (pallas_coarse.py:63-77)
    float Lc[2][2];
    for (int a = 0; a < 2; ++a) {
      for (int bb = 0; bb < 2; ++bb) {
        float acc = 0.0f;
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j)
            acc = acc + (c[3 * i + a] * c[3 * j + bb]) * L[3 * i + j];
        Lc[a][bb] = acc;
      }
    }
    const float det = Lc[0][0] * Lc[1][1] - Lc[0][1] * Lc[1][0];
    const float col_x = ((fx * fx) * Lc[1][1] - (fy * fx) * Lc[1][0]) / det;
    const float col_y = (((-fx) * fy) * Lc[0][1] + (fy * fy) * Lc[0][0]) / det;
    const float rx = sqrtf(nlt * col_x) / z;
    const float ry = sqrtf(nlt * col_y) / z;
    const bool keep = !(z < 0.0f);

    // supertile window (pallas_coarse.py:81-93)
    const Window wx = window(u, rx, fb, st);
    const Window wy = window(v, ry, fb, st);
    oversize = keep && (!wx.fin || !wy.fin || wx.w > win || wy.w > win);
    // the window a re-emission would need for the finite oversize ones
    if (oversize && wx.fin && wy.fin && wx.w <= max_win && wy.w <= max_win)
      atomicMax(&info[INFO_WIDER], wx.w > wy.w ? wx.w : wy.w);

    // per-axis bin overlap tests for the window's 2*win bin columns / rows,
    // one bit each (pallas_coarse.py:96-106)
    const float lo_u = u - rx, hi_u = u + rx;
    const float lo_v = v - ry, hi_v = v + ry;
    const float fx0f = (float)wx.f0, fy0f = (float)wy.f0;
    unsigned xo = 0u, yo = 0u;
    for (int m = 0; m < 2 * win; ++m) {
      const float bx = (2.0f * fx0f + (float)m) * fb;
      if ((lo_u <= bx + fb) && (bx < hi_u) && (bx < (float)W)) xo |= 1u << m;
      const float by = (2.0f * fy0f + (float)m) * fb;
      if ((lo_v <= by + fb) && (by < hi_v) && (by < (float)H)) yo |= 1u << m;
    }

    const bool base_ok = keep && !oversize;
    const int n_emit = win * win;
    int* rout = rid + ((size_t)b * P + p) * n_emit;
    uint8_t* bout = bits_out + ((size_t)b * P + p) * n_emit;
    for (int e = 0; e < n_emit; ++e) {
      const int cx = e % win, cy = e / win;
      int bits = 0;
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          if (((yo >> (2 * cy + i)) & 1u) && ((xo >> (2 * cx + j)) & 1u))
            bits |= 1 << (2 * i + j);
      const int sx = wx.f0 + cx, sy = wy.f0 + cy;
      const bool ok = base_ok && sx >= 0 && sx < BW2 && sy >= 0 && sy < BH2 && bits != 0;
      rout[e] = ok ? b * nst + sy * BW2 + sx : -1;
      bout[e] = ok ? (uint8_t)bits : (uint8_t)0;
    }

    float* pl = planes + (size_t)b * 4 * P + p;
    pl[0 * (size_t)P] = u;
    pl[1 * (size_t)P] = v;
    pl[2 * (size_t)P] = rx;
    pl[3 * (size_t)P] = ry;
  }
  // a warp holds 32 consecutive Gaussians (blockDim is a multiple of 32)
  const unsigned word = __ballot_sync(FULL, oversize);
  const int wi = p >> 5;
  if ((threadIdx.x & 31) == 0 && wi < nw) over[(size_t)b * nw + wi] = word;
}

// One block per image: the first ng oversize Gaussians by index (a stable
// compaction of the flag words), their bits over every supertile, each row's
// full count (local run + global members) and the maxima the host reads.
__global__ void __launch_bounds__(GLOBALS_THREADS) globals_kernel(
    const unsigned* __restrict__ over, const float* __restrict__ planes,
    const long long* __restrict__ starts, int* __restrict__ gpos, uint8_t* __restrict__ g_valid,
    uint8_t* __restrict__ bits_g,        // (B, ng, nst)
    int* __restrict__ gstat,             // (B, 2): global members, dropped
    int* __restrict__ info, int P, int nw, int nst, int BW2, float fb, int H, int W, int ng) {
  __shared__ int s_tmp[GLOBALS_THREADS / 32];
  const int b = blockIdx.x;
  const unsigned* ow = over + (size_t)b * nw;
  int* gp = gpos + (size_t)b * ng;

  // the compaction: each thread a contiguous range of words; the ranges'
  // counts scanned in thread order give each set bit its rank among the
  // oversize (one scan, the loads of a range in flight together)
  const int per = (nw + blockDim.x - 1) / blockDim.x;
  const int w0 = min(nw, (int)threadIdx.x * per), w1 = min(nw, w0 + per);
  int mine = 0;
  for (int wi = w0; wi < w1; ++wi) mine += __popc(ow[wi]);
  int n_over;
  int rank = block_exclusive_scan(mine, s_tmp, n_over);
  for (int wi = w0; wi < w1 && rank < ng; ++wi) {
    unsigned word = ow[wi];
    while (word && rank < ng) {
      gp[rank++] = wi * 32 + (__ffs(word) - 1);
      word &= word - 1u;
    }
  }
  const int n_g = n_over < ng ? n_over : ng;
  for (int g = threadIdx.x; g < ng; g += blockDim.x) {
    if (g >= n_g) gp[g] = 0;
    g_valid[(size_t)b * ng + g] = g < n_g;
  }
  const int dropped = n_over > ng ? n_over - ng : 0;
  if (threadIdx.x == 0) {
    gstat[2 * b] = n_g;
    gstat[2 * b + 1] = dropped;
    if (dropped) atomicMax(&info[INFO_DROPPED], dropped);
  }
  __syncthreads();  // gpos, written above by this block, is read below

  // each supertile's bits of every global member (coarse.py _bits' order);
  // a thread a supertile, so neighbouring threads store neighbouring bytes
  const float st = 2.0f * fb;
  const float* pu = planes + (size_t)b * 4 * P;
  int densest = 0;
  for (int s = threadIdx.x; s < nst; s += blockDim.x) {
    const float sxf = (float)(s % BW2) * st, syf = (float)(s / BW2) * st;
    uint8_t* out = bits_g + (size_t)b * ng * nst + s;
    int members = 0;
    for (int g = 0; g < ng; ++g) {
      int bits = 0;
      if (g < n_g) {
        const int q = gp[g];
        const float u = pu[q], v = pu[P + q], rx = pu[2 * (size_t)P + q],
                    ry = pu[3 * (size_t)P + q];
        for (int i = 0; i < 2; ++i) {
          const float byi = syf + (float)i * fb;
          const bool yo = ((v - ry) <= (byi + fb)) && (byi < (v + ry)) && (byi < (float)H);
          for (int j = 0; j < 2; ++j) {
            const float bxj = sxf + (float)j * fb;
            const bool xo = ((u - rx) <= (bxj + fb)) && (bxj < (u + rx)) && (bxj < (float)W);
            if (yo && xo) bits |= 1 << (2 * i + j);
          }
        }
      }
      out[(size_t)g * nst] = (uint8_t)bits;
      members += bits != 0;
    }
    const long long row = (long long)b * nst + s;
    const int full = (int)(starts[row + 1] - starts[row]) + members;
    densest = full > densest ? full : densest;
  }
  // one atomic a warp
  for (int o = 16; o > 0; o >>= 1) {
    const int y = __shfl_down_sync(FULL, densest, o);
    densest = y > densest ? y : densest;
  }
  if ((threadIdx.x & 31) == 0 && densest > 0) atomicMax(&info[INFO_DENSEST], densest);
}

// The Gaussian index of window slot q of (B, P, E).
__device__ __forceinline__ int slot_gauss(int q, int E, int P) { return (q / E) % P; }

// One block per row: the local run (ascending) merged with the row's global
// members (ascending) by position.
__global__ void __launch_bounds__(ROWS_THREADS) rows_kernel(
    const int* __restrict__ order, const long long* __restrict__ starts,
    const uint8_t* __restrict__ bits, const int* __restrict__ gpos,
    const uint8_t* __restrict__ bits_g, const int* __restrict__ gstat, int* __restrict__ pos_c,
    int* __restrict__ bits_c, int* __restrict__ ids_c, int* __restrict__ counts_c,
    int* __restrict__ overflow_c, int* __restrict__ dst_l, int* __restrict__ dst_g, int P, int E,
    int nst, int ng, int M) {
  extern __shared__ int s_dyn[];
  int* s_gp = s_dyn;        // the row's global members: Gaussian index
  int* s_gk = s_dyn + ng;   // and g * 16 + bits
  __shared__ int s_tmp[ROWS_THREADS / 32];
  const int r = blockIdx.x;
  const int b = r / nst, s = r - b * nst;

  // the row's members among the image's n_g globals, in g order
  const int n_g = gstat[2 * b];
  int n_mem = 0;
  for (int g0 = 0; g0 < n_g; g0 += blockDim.x) {
    const int g = g0 + threadIdx.x;
    const int bt = g < n_g ? bits_g[((size_t)b * ng + g) * nst + s] : 0;
    int total;
    const int at = n_mem + block_exclusive_scan(bt != 0, s_tmp, total);
    if (bt) {
      s_gp[at] = gpos[(size_t)b * ng + g];
      s_gk[at] = g * 16 + bt;
    }
    n_mem += total;
  }
  __syncthreads();

  const long long s0 = starts[r];
  const int n_loc = (int)(starts[r + 1] - s0);
  const int full = n_loc + n_mem;
  const int cnt = full < M ? full : M;
  const long long row0 = (long long)r * M;
  const int* run = order + s0;
  for (int i = threadIdx.x; i < n_loc; i += blockDim.x) {
    const int q = run[i];
    const int p = slot_gauss(q, E, P);
    int lo = 0, hi = n_mem;  // the members below p
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_gp[mid] < p) lo = mid + 1;
      else hi = mid;
    }
    const int rank = i + lo;
    if (rank < M) {
      pos_c[row0 + rank] = p;
      bits_c[row0 + rank] = bits[q];
      ids_c[row0 + rank] = b * P + p;
    }
    if (dst_l) dst_l[q] = rank < M ? (int)(row0 + rank) : -1;
  }
  for (int j = threadIdx.x; j < n_mem; j += blockDim.x) {
    const int p = s_gp[j], key = s_gk[j];
    int lo = 0, hi = n_loc;  // the local members below p
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (slot_gauss(run[mid], E, P) < p) lo = mid + 1;
      else hi = mid;
    }
    const int rank = j + lo;
    if (rank < M) {
      pos_c[row0 + rank] = p;
      bits_c[row0 + rank] = key & 15;
      ids_c[row0 + rank] = b * P + p;
    }
    if (dst_g) dst_g[((size_t)b * ng + (key >> 4)) * nst + s] = rank < M ? (int)(row0 + rank) : -1;
  }
  for (int t = cnt + threadIdx.x; t < M; t += blockDim.x) {
    pos_c[row0 + t] = 0;
    bits_c[row0 + t] = 0;
    ids_c[row0 + t] = -1;
  }
  if (threadIdx.x == 0) {
    counts_c[r] = cnt;
    // excess globals are a per-image count: charged to the image's first row
    overflow_c[r] = full - cnt + (s == 0 ? gstat[2 * b + 1] : 0);
  }
}

}  // namespace

extern "C" int voge_emit_rows(const void* R, const void* focal, const void* principal,
                              const void* points, const void* isig, void* rid, void* bits,
                              void* planes, void* over, void* info, int B, int P, float nlt,
                              float fb, int H, int W, int BH2, int BW2, int nst, int win,
                              int max_win, void* stream) {
  if (B <= 0 || P <= 0 || win < 1 || win > 8 || max_win > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(info, 0, INFO_LEN * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int nw = (P + 31) / 32;
  const dim3 grid((P + EMIT_THREADS - 1) / EMIT_THREADS, B);
  emit_rows_kernel<<<grid, EMIT_THREADS, 0, s>>>(
      (const float*)R, (const float*)focal, (const float*)principal, (const float*)points,
      (const float*)isig, (int*)rid, (uint8_t*)bits, (float*)planes, (unsigned*)over, (int*)info,
      P, nw, nlt, fb, H, W, BH2, BW2, nst, win, max_win);
  return (int)cudaGetLastError();
}

extern "C" int voge_coarse_globals(const void* over, const void* planes, const void* starts,
                                   void* gpos, void* g_valid, void* bits_g, void* gstat,
                                   void* info, int B, int P, int nst, int BW2, float fb, int H,
                                   int W, int ng, void* stream) {
  if (B <= 0 || P <= 0 || nst <= 0 || ng < 0 || ng > P) return (int)cudaErrorInvalidValue;
  globals_kernel<<<B, GLOBALS_THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned*)over, (const float*)planes, (const long long*)starts, (int*)gpos,
      (uint8_t*)g_valid, (uint8_t*)bits_g, (int*)gstat, (int*)info, P, (P + 31) / 32, nst, BW2,
      fb, H, W, ng);
  return (int)cudaGetLastError();
}

// With with_dst, dst_l (B * P * E) and dst_g (B, ng, nst) receive the inverse
// map; without, they are not touched.
extern "C" int voge_coarse_rows(const void* order, const void* starts, const void* bits,
                                const void* gpos, const void* bits_g, const void* gstat,
                                void* pos_c, void* bits_c, void* ids_c, void* counts_c,
                                void* overflow_c, int with_dst, void* dst_l, void* dst_g, int B,
                                int P, int E, int nst, int ng, int M, void* stream) {
  if (B <= 0 || P <= 0 || nst <= 0 || ng < 0 || ng > MAX_SMEM_GLOBALS || M < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!with_dst) dst_l = dst_g = nullptr;
  if (dst_l) {  // slots in no row, and globals off a row, map nowhere
    cudaError_t err = cudaMemsetAsync(dst_l, 0xff, (size_t)B * P * E * sizeof(int), s);
    if (err == cudaSuccess && ng)
      err = cudaMemsetAsync(dst_g, 0xff, (size_t)B * ng * nst * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  rows_kernel<<<B * nst, ROWS_THREADS, 2 * ng * sizeof(int), s>>>(
      (const int*)order, (const long long*)starts, (const uint8_t*)bits, (const int*)gpos,
      (const uint8_t*)bits_g, (const int*)gstat, (int*)pos_c, (int*)bits_c, (int*)ids_c,
      (int*)counts_c, (int*)overflow_c, (int*)dst_l, (int*)dst_g, P, E, nst, ng, M);
  return (int)cudaGetLastError();
}

// K1: coarse emission, one thread per Gaussian.
//
// Replaces voge_tpu/ops/pallas_coarse.py::_emit_kernel (reached through
// emit_keys_pallas <- coarse.emit_supertile_candidates).  Per Gaussian it
// projects the centre to (u, v, z), bounds the thr-level ellipse in pixels
// (rx, ry), picks the win x win supertile window, sets the four sub-bin
// membership bits of each window cell and packs the int64 sort key
// ((img * nst + st) * S + idx) * 16 + bits (sentinel: nb * S * 16).
//
// What bounds it on the H100: nothing but launch latency.  It reads 48 B and
// writes 8 * win^2 + 24 B per Gaussian (~1 MB at 10K Gaussians), far below
// a microsecond of HBM time.  The design is the plainest one: no shared
// memory, no cross-thread work.
//
// Exactness: this file is compiled with -fmad=false and keeps the Pallas
// kernel's operation order term for term (pallas_coarse.py:50-132), so every
// product and sum rounds once, as each PyTorch elementwise op does.  The keys
// then equal the plain version's (ops/cuda_coarse.py::emit_keys_plain) bit
// for bit: a contracted FMA would move a bin-edge comparison and flip a
// membership bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void emit_kernel(
    const float* __restrict__ cam,      // (B, 13): R row-major, fx, fy, px, py
    const float* __restrict__ points,   // (B, P, 3) camera-centred means
    const float* __restrict__ isig,     // (B, P, 9) Lambda row-major
    long long* __restrict__ keys,       // (B, P, win*win)
    float* __restrict__ aux,            // (B, 6, P): u, v, rx, ry, z, oversize
    int P, float nlt, float fb, int H, int W, int BH2, int BW2, int nst,
    long long S, long long big, int win) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= P) return;
  const float* c = cam + (size_t)b * 13;
  const float* pt = points + ((size_t)b * P + p) * 3;
  const float* L = isig + ((size_t)b * P + p) * 9;
  const float st = 2.0f * fb;

  // camera planes (pallas_coarse.py:56-60)
  float view[3];
  for (int d = 0; d < 3; ++d)
    view[d] = (pt[0] * c[d] + pt[1] * c[3 + d]) + pt[2] * c[6 + d];
  const float z = view[2];
  const float fx = c[9], fy = c[10];
  const float u = c[11] - (view[0] * fx) / z;
  const float v = c[12] - (view[1] * fy) / z;

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
  const bool oversize =
      keep && (!wx.fin || !wy.fin || wx.w > win || wy.w > win);

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
  long long* kout = keys + ((size_t)b * P + p) * n_emit;
  for (int e = 0; e < n_emit; ++e) {
    const int cx = e % win, cy = e / win;
    int bits = 0;
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        if (((yo >> (2 * cy + i)) & 1u) && ((xo >> (2 * cx + j)) & 1u))
          bits |= 1 << (2 * i + j);
    const int sx = wx.f0 + cx, sy = wy.f0 + cy;
    const bool ok = base_ok && sx >= 0 && sx < BW2 && sy >= 0 && sy < BH2 &&
                    bits != 0;
    kout[e] = ok ? ((((long long)b * nst + (long long)sy * BW2 + sx) * S + p) *
                        16 +
                    bits)
                 : big;
  }

  float* ax = aux + (size_t)b * 6 * P + p;
  ax[0 * (size_t)P] = u;
  ax[1 * (size_t)P] = v;
  ax[2 * (size_t)P] = rx;
  ax[3 * (size_t)P] = ry;
  ax[4 * (size_t)P] = z;
  ax[5 * (size_t)P] = oversize ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int voge_emit_keys(const void* cam, const void* points,
                              const void* isig, void* keys, void* aux, int B,
                              int P, float nlt, float fb, int H, int W, int BH2,
                              int BW2, int nst, long long S, long long big,
                              int win, void* stream) {
  if (B <= 0 || P <= 0 || win < 1 || win > 8) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((P + threads - 1) / threads, B);
  emit_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)cam, (const float*)points, (const float*)isig,
      (long long*)keys, (float*)aux, P, nlt, fb, H, W, BH2, BW2, nst, S, big,
      win);
  return (int)cudaGetLastError();
}

// The mean cosine similarity over pixels of a feature stack against a target
// feature map: out[b] = mean_pix dot(p, t) / ((|p| + 1e-8) (|t| + 1e-8)),
// pred (B, H, W, C), target (B or 1, H, W, C), the forward of
// models/pose.py::feature_similarity (pose scoring, pose refinement), and
// its gradient in pred (pose refinement's backward).
//
// Replaces no TPU kernel: voge_tpu/models/pose.py leaves the similarity and
// its VJP to XLA, which fuses each.  In PyTorch the forward was nine passes
// (the two norms, the two divides, the product, the sum over channels, the
// mean), each streaming the (B, H, W, C) stack or a stack-sized temporary
// through DRAM, the target expanded to the stack's shape; autograd's
// backward of that chain about a dozen more.
//
// What bounds both on the H100: DRAM bytes.  The forward reads the stack
// once and the target once and writes B floats: at pose scoring's
// (32, 256, 256, 128) that is 1.074 GB + 33.5 MB, 0.330 ms at 3.35 TB/s.
// The backward reads the stack and the target once more and writes the
// cotangent once: at pose refinement's (32, 256, 256, 128) with a target a
// pose, 3.22 GB, 0.96 ms.  A pixel's 128 channels take 3 x 128 FMAs (the
// backward 5 x 128), far under the card's rate.  So the design reads each
// byte once and keeps enough loads in flight:
// - a block owns a tile of pixels and loops over (up to kBatch of) the batch
//   inside; eight lanes take one pixel row, a lane 16-byte loads of 4
//   channels (C = 128: four loads a lane, 128 contiguous bytes an eight-lane
//   group a load, so every sector is used);
// - in the forward, a target shared by the batch (batch stride 0, as score's
//   expand gives) is read once a pixel into registers and held across the
//   batch loop, so the target crosses DRAM once, not B times (the backward,
//   whose callers send a target an image or B = 1, reads it beside each
//   stack row);
// - the batch loop is unrolled by kUnroll, so a lane has 4 x kUnroll
//   independent 16-byte loads of the stack in flight; they are streaming
//   loads (evict-first), since each byte is read exactly once; the
//   backward's cotangent rows are streaming stores;
// - C that is not a multiple of 4, over 128, or rows not 16-byte aligned,
//   take a general lane loop of 4-byte loads.
// Per (b, pixel) the dot product and |p|^2 (|t|^2 once a pixel) are reduced
// over the eight lanes with shuffles, in float32.  The sum over pixels uses
// no float atomics: each group's cosines land in shared memory, the block
// sums them in pixel order (float64) into one partial a (b, tile), and
// cos_finish_kernel each b's partials in one fixed order (float64), divided
// by the pixel count: the same inputs give the same bits on every call.  The
// backward has no sum across pixels, so no atomics either.
//
// The gradient (cos_grad_kernel) is the exact VJP of the expression
// models/pose.py's plain version evaluates,
//   pn = p / (|p| + 1e-8), tn = t / (|t| + 1e-8), out[b] = mean_pix pn . tn:
// with s = g[b] / n_pix, r = s / (|t| + 1e-8), q = |p| + 1e-8,
//   d p = (r / q) t - [|p| > 0] (r dot(p, t) / q^2 / |p|) p,
// staged as autograd stages it (the divide's two gradients, then the norm's,
// which is 0 at a zero row, as PyTorch's norm backward gives); a background
// pixel (p = 0) keeps the first term.  g is read from the device.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                       // lanes a pixel row
constexpr int kTile = kThreads / kLanes;        // pixels a block, one a group
constexpr int kBatch = 32;                      // batches a block (grid.y beyond)
constexpr int kUnroll = 2;                      // batches whose loads fly together
constexpr int kChunks = 4;                      // 16-byte chunks a lane: C <= 128
constexpr int kFinishThreads = 256;

struct Args {
  const float* pred;      // batch stride pred_bs, dense (H, W, C) rows
  const float* target;    // batch stride target_bs (0: one map for the batch)
  double* partial;        // (B, n_tiles)
  long long pred_bs, target_bs, n_pix;
  int B, C, n_tiles;
};

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float cosine(float dot, float pp, float tt) {
  return dot / ((sqrtf(pp) + 1e-8f) * (sqrtf(tt) + 1e-8f));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// Every thread of the block runs every iteration (a pixel past the end loads
// nothing and counts 0), so the shuffles see whole warps.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) cos_partial_kernel(const Args p) {
  __shared__ float cos_of[kTile][kBatch];
  const int g = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int b0 = blockIdx.y * kBatch, nb = min(kBatch, p.B - b0);
  const bool shared_t = p.target_bs == 0;
  const long long pix = (long long)blockIdx.x * kTile + g;
  const bool live = pix < p.n_pix;
  const size_t row = live ? (size_t)pix * p.C : 0;
  const float* prow = p.pred + (size_t)b0 * p.pred_bs + row;
  const float* trow = p.target + (size_t)b0 * p.target_bs + row;
  if constexpr (kVec) {
    const int n4 = p.C / 4;
    bool has[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) has[j] = live && lane + j * kLanes < n4;
    float4 t[kChunks];
    float tt = 0.f;
    auto load_target = [&](const float* base) {
      tt = 0.f;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        t[j] = has[j] ? __ldg(reinterpret_cast<const float4*>(base) + lane + j * kLanes)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        tt = dot4(t[j], t[j], tt);
      }
      tt = group_sum(tt);
    };
    if (shared_t) load_target(trow);
    for (int b = 0; b < nb; b += kUnroll) {
      float4 x[kUnroll][kChunks];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4* src =
            reinterpret_cast<const float4*>(prow + (size_t)(b + u) * p.pred_bs);
#pragma unroll
        for (int j = 0; j < kChunks; ++j)
          x[u][j] = has[j] && b + u < nb ? __ldcs(src + lane + j * kLanes)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // a step past the block's last batch (odd nb) loads no target: its
        // map would lie beyond the end of the target's allocation
        if (!shared_t && b + u < nb) load_target(trow + (size_t)(b + u) * p.target_bs);
        float dot = 0.f, pp = 0.f;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          dot = dot4(x[u][j], t[j], dot);
          pp = dot4(x[u][j], x[u][j], pp);
        }
        dot = group_sum(dot);
        pp = group_sum(pp);
        if (lane == 0 && b + u < nb) cos_of[g][b + u] = live ? cosine(dot, pp, tt) : 0.f;
      }
    }
  } else {
    for (int b = 0; b < nb; ++b) {
      const float* pr = prow + (size_t)b * p.pred_bs;
      const float* tr = trow + (size_t)b * p.target_bs;
      float dot = 0.f, pp = 0.f, tt = 0.f;
      for (int c = lane; live && c < p.C; c += kLanes) {
        const float x = __ldcs(pr + c), y = __ldg(tr + c);
        dot = fmaf(x, y, dot);
        pp = fmaf(x, x, pp);
        tt = fmaf(y, y, tt);
      }
      dot = group_sum(dot);
      pp = group_sum(pp);
      tt = group_sum(tt);
      if (lane == 0) cos_of[g][b] = live ? cosine(dot, pp, tt) : 0.f;
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    double s = 0.0;
    for (int i = 0; i < kTile; ++i) s += cos_of[i][b];
    p.partial[(size_t)(b0 + b) * p.n_tiles + blockIdx.x] = s;
  }
}

// One block a batch: each thread sums a fixed stride of the partials, then a
// fixed tree over the threads.
__global__ void __launch_bounds__(kFinishThreads)
    cos_finish_kernel(const double* partial, int n_tiles, long long n_pix, float* out) {
  __shared__ double s[kFinishThreads];
  const double* row = partial + (size_t)blockIdx.x * n_tiles;
  double v = 0.0;
  for (int i = threadIdx.x; i < n_tiles; i += kFinishThreads) v += row[i];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = kFinishThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = (float)(s[0] / (double)n_pix);
}

struct GradArgs {
  const float* pred;      // batch stride pred_bs, dense (H, W, C) rows
  const float* target;    // batch stride target_bs (0: one map for the batch)
  const float* grad;      // (B,) at stride grad_stride (0: one value for the batch)
  float* out;             // (B, H, W, C), dense
  long long pred_bs, target_bs, grad_stride, n_pix;
  int B, C;
};

// The two coefficients of a (b, pixel)'s cotangent row, a t + c p, from the
// gradient of its mean (s = g[b] / n_pix) and the row's reductions.
__device__ __forceinline__ void grad_coefs(float s, float dot, float pp, float tt,
                                           float& a, float& c) {
  const float np = sqrtf(pp), q = np + 1e-8f;
  const float r = s / (sqrtf(tt) + 1e-8f);
  a = r / q;
  c = np > 0.f ? -(r * dot) / (q * q) / np : 0.f;
}

__device__ __forceinline__ float4 axpy4(float a, float4 t, float c, float4 p) {
  return make_float4(fmaf(c, p.x, a * t.x), fmaf(c, p.y, a * t.y), fmaf(c, p.z, a * t.z),
                     fmaf(c, p.w, a * t.w));
}

// The vectorised rows (C a multiple of 4 up to 128, 16-byte aligned): the
// stack's and the target's rows are loaded side by side, streaming, a
// target for the batch (batch stride 0) as one a batch.  Every thread of the
// block runs every iteration, so the shuffles see whole warps; a pixel past
// the end, or a step past the block's last batch, loads and stores nothing.
__global__ void __launch_bounds__(kThreads) cos_grad_kernel(const GradArgs p) {
  const int g = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int b0 = blockIdx.y * kBatch, nb = min(kBatch, p.B - b0);
  const long long pix = (long long)blockIdx.x * kTile + g;
  const bool live = pix < p.n_pix;
  const size_t row = live ? (size_t)pix * p.C : 0;
  const long long out_bs = p.n_pix * p.C;
  const float* prow = p.pred + (size_t)b0 * p.pred_bs + row;
  const float* trow = p.target + (size_t)b0 * p.target_bs + row;
  float* orow = p.out + (size_t)b0 * out_bs + row;
  const float n = (float)p.n_pix;
  const int n4 = p.C / 4;
  bool has[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) has[j] = live && lane + j * kLanes < n4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b = 0; b < nb; b += kUnroll) {
    float4 x[kUnroll][kChunks], y[kUnroll][kChunks];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = b + u < nb;
      const float4* src = reinterpret_cast<const float4*>(prow + (size_t)(b + u) * p.pred_bs);
      const float4* tsrc =
          reinterpret_cast<const float4*>(trow + (size_t)(b + u) * p.target_bs);
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        x[u][j] = has[j] && in ? __ldcs(src + lane + j * kLanes) : zero;
        y[u][j] = has[j] && in ? __ldcs(tsrc + lane + j * kLanes) : zero;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f, pp = 0.f, tt = 0.f;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        dot = dot4(x[u][j], y[u][j], dot);
        pp = dot4(x[u][j], x[u][j], pp);
        tt = dot4(y[u][j], y[u][j], tt);
      }
      dot = group_sum(dot);
      pp = group_sum(pp);
      tt = group_sum(tt);
      if (b + u < nb) {
        float a, c;
        grad_coefs(__ldg(p.grad + (size_t)(b0 + b + u) * p.grad_stride) / n, dot, pp, tt, a, c);
        float4* dst = reinterpret_cast<float4*>(orow + (size_t)(b + u) * out_bs);
#pragma unroll
        for (int j = 0; j < kChunks; ++j)
          if (has[j]) __stcs(dst + lane + j * kLanes, axpy4(a, y[u][j], c, x[u][j]));
      }
    }
  }
}

// Any C and alignment: a lane loop of 4-byte loads reduces the row, a second
// pass over the same (cached) row writes it.
__global__ void __launch_bounds__(kThreads) cos_grad_lanes_kernel(const GradArgs p) {
  const int g = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int b0 = blockIdx.y * kBatch, nb = min(kBatch, p.B - b0);
  const long long pix = (long long)blockIdx.x * kTile + g;
  const bool live = pix < p.n_pix;
  const size_t row = live ? (size_t)pix * p.C : 0;
  const long long out_bs = p.n_pix * p.C;
  const float n = (float)p.n_pix;
  for (int b = 0; b < nb; ++b) {
    const float* pr = p.pred + (size_t)(b0 + b) * p.pred_bs + row;
    const float* tr = p.target + (size_t)(b0 + b) * p.target_bs + row;
    float dot = 0.f, pp = 0.f, tt = 0.f;
    for (int c = lane; live && c < p.C; c += kLanes) {
      const float x = __ldg(pr + c), y = __ldg(tr + c);
      dot = fmaf(x, y, dot);
      pp = fmaf(x, x, pp);
      tt = fmaf(y, y, tt);
    }
    dot = group_sum(dot);
    pp = group_sum(pp);
    tt = group_sum(tt);
    if (!live) continue;
    float a, cf;
    grad_coefs(__ldg(p.grad + (size_t)(b0 + b) * p.grad_stride) / n, dot, pp, tt, a, cf);
    float* dst = p.out + (size_t)(b0 + b) * out_bs + row;
    for (int c = lane; c < p.C; c += kLanes)
      __stcs(dst + c, fmaf(cf, __ldg(pr + c), a * __ldg(tr + c)));
  }
}

long long tiles(long long n_pix) { return (n_pix + kTile - 1) / kTile; }

}  // namespace

// Doubles of scratch that voge_feature_similarity takes for B batches of
// n_pix pixels (its partial sums).
extern "C" long long voge_feature_similarity_scratch(int B, long long n_pix) {
  return (long long)B * tiles(n_pix);
}

// out (B,) float32.  pred and target are float32 with dense (H, W, C) rows of
// n_pix pixels, batch strides pred_bs and target_bs in floats (target_bs 0:
// one map for every batch); partial holds voge_feature_similarity_scratch
// doubles.
extern "C" int voge_feature_similarity(const void* pred, const void* target,
                                       long long pred_bs, long long target_bs,
                                       void* partial, void* out, int B,
                                       long long n_pix, int C, void* stream) {
  if (B <= 0 || n_pix <= 0 || C <= 0 || pred_bs < 0 || target_bs < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = tiles(n_pix);
  const long long n_batch_blocks = (B + kBatch - 1) / kBatch;
  if (n_tiles > 0x7fffffffLL || n_batch_blocks > 65535) return (int)cudaErrorInvalidValue;
  Args a;
  a.pred = (const float*)pred;
  a.target = (const float*)target;
  a.partial = (double*)partial;
  a.pred_bs = pred_bs;
  a.target_bs = target_bs;
  a.n_pix = n_pix;
  a.B = B;
  a.C = C;
  a.n_tiles = (int)n_tiles;
  const bool vec = C % 4 == 0 && C <= 4 * kChunks * kLanes && pred_bs % 4 == 0 &&
                   target_bs % 4 == 0 && ((uintptr_t)pred & 15) == 0 &&
                   ((uintptr_t)target & 15) == 0;
  const dim3 grid((unsigned)n_tiles, (unsigned)n_batch_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    cos_partial_kernel<true><<<grid, kThreads, 0, s>>>(a);
  else
    cos_partial_kernel<false><<<grid, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cos_finish_kernel<<<B, kFinishThreads, 0, s>>>((const double*)partial, a.n_tiles, n_pix,
                                                 (float*)out);
  return (int)cudaGetLastError();
}

// out (B, H, W, C) float32, dense: the gradient in pred of
// voge_feature_similarity's out against grad (B,) float32 at grad_stride
// floats (0: one value for the batch).  pred and target as there.
extern "C" int voge_feature_similarity_grad(const void* pred, const void* target,
                                            const void* grad, long long pred_bs,
                                            long long target_bs, long long grad_stride,
                                            void* out, int B, long long n_pix, int C,
                                            void* stream) {
  if (B <= 0 || n_pix <= 0 || C <= 0 || pred_bs < 0 || target_bs < 0 || grad_stride < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = tiles(n_pix);
  const long long n_batch_blocks = (B + kBatch - 1) / kBatch;
  if (n_tiles > 0x7fffffffLL || n_batch_blocks > 65535) return (int)cudaErrorInvalidValue;
  GradArgs a;
  a.pred = (const float*)pred;
  a.target = (const float*)target;
  a.grad = (const float*)grad;
  a.out = (float*)out;
  a.pred_bs = pred_bs;
  a.target_bs = target_bs;
  a.grad_stride = grad_stride;
  a.n_pix = n_pix;
  a.B = B;
  a.C = C;
  const bool vec = C % 4 == 0 && C <= 4 * kChunks * kLanes && pred_bs % 4 == 0 &&
                   target_bs % 4 == 0 && ((uintptr_t)pred & 15) == 0 &&
                   ((uintptr_t)target & 15) == 0 && ((uintptr_t)out & 15) == 0;
  const dim3 grid((unsigned)n_tiles, (unsigned)n_batch_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    cos_grad_kernel<<<grid, kThreads, 0, s>>>(a);
  else
    cos_grad_lanes_kernel<<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

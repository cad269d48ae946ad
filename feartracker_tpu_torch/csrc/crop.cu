// K3: the tracking step's crop in one launch: for every stream, the bilinear
// out x out crop of its search or template window from the whole frame, with
// the stream's pad colour where a tap falls outside the frame, ImageNet
// normalization, and the write in the trunk's dtype.
//
// It replaces no TPU kernel. Its counterpart in the JAX package is the fused
// C++ host crop `feartracker_tpu.native.crop_resize_normalize`; on the TPU the
// crop ran as XLA's dense contractions (`crop_resize_mm`). Its plain PyTorch
// twin is `crop_plain` in feartracker_tpu_torch/ops/cuda/crop.py:
// `normalize_imagenet(crop_resize(...))`, then the cast to the output dtype.
//
// Per output value (stream s, row i, column j, channel c), as `_src_grid` and
// `crop_resize` (ops/crop.py) compute it, op for op:
//   d = (k + 0.5) * (1 / out) for k = i or j (torch multiplies by a Python
//     divisor's float reciprocal on the card);
//   src = origin + d * size - 0.5, clamped into [origin, origin + size - 1];
//   taps floor(src) and floor(src) + 1 on each axis; a tap outside the frame
//     reads the pad colour pad[s, c];
//   top = a * (1 - fx) + b * fx, bot likewise, v = top * (1 - fy) + bot * fy;
//   (v - mean[c] * 255) / (std[c] * 255), a true division;
//   one rounding to bfloat16 (to nearest even) where the output is bf16.
// All arithmetic is float32, and this file is compiled with -fmad=false
// (ops/cuda/build.py), so that every product and sum rounds where the twin's
// torch ops round: on the card the float32 output equals the twin's bit for
// bit, and the bfloat16 output equals the twin's float32 result rounded once.
//
// What bounds it on the H100: bytes. At S=128 and 256^2 it writes
// 128 * 256^2 * 3 values (50 MB in bf16) and reads at most 2 rows x 2 columns
// x 3 uint8 bytes an output pixel, capped by the window's area (<= 100 MB):
// <= 150 MB, 0.045 ms at HBM's 3.35 TB/s. No product is large enough to feed
// a tensor core (four taps a value), so there is no TMA and no wgmma. The
// design moves each byte once and computes each tap position once:
//   * one launch for all S streams: grid (bands of kRows output rows, S);
//   * a block computes its out column taps (element offsets, weight, in-frame
//     flags) once into shared memory, and its kRows row taps once;
//   * threads walk the band in NHWC order, a pixel a thread, so neighbouring
//     threads store neighbouring addresses and read neighbouring source bytes;
//   * the frame is read through the read-only path (__ldg); a source row is
//     read by one or two output rows, and L1/L2 catch that reuse;
//   * the frame's strides are taken as given: the stream stride may be 0 (one
//     frame shared by every stream, expanded as a view), and nothing is cast
//     or copied before the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // output rows a block

struct Params {
  const void* frames;
  long long fs, fh, fw, fc;  // element strides of (S, H, W, 3); fs may be 0
  const float* windows;      // (S, 4) x, y, w, h, integer-valued
  const float* pad;          // (S, 3)
  void* out;                 // (S, n, n, 3) contiguous
  int H, W, n;
  float mean[3], std[3];     // ImageNet mean and std, each times 255
};

// One axis position of the crop: the element offsets of its two taps along
// the axis (clamped into the frame), the second tap's weight, and whether
// each tap lies inside the frame (bit 0: the first, bit 1: the second).
struct Tap {
  long long o0, o1;
  float f;
  int in;
};

__device__ __forceinline__ Tap axis_tap(float origin, float size, int k, float inv_n, int len,
                                        long long stride) {
  const float d = ((float)k + 0.5f) * inv_n;
  float src = origin + d * size - 0.5f;
  src = fminf(fmaxf(src, origin), origin + size - 1.0f);
  const float s0 = floorf(src);
  Tap t;
  t.f = src - s0;
  // taps at or beyond -2 and len + 1 read the pad on both sides alike: the
  // clamp keeps the conversion to an integer defined for any window
  const long long i0 = (long long)fminf(fmaxf(s0, -2.0f), (float)len + 1.0f), i1 = i0 + 1;
  t.in = (i0 >= 0 && i0 < len ? 1 : 0) | (i1 >= 0 && i1 < len ? 2 : 0);
  t.o0 = (i0 < 0 ? 0 : i0 >= len ? len - 1 : i0) * stride;
  t.o1 = (i1 < 0 ? 0 : i1 >= len ? len - 1 : i1) * stride;
  return t;
}

__device__ __forceinline__ float load(const uint8_t* p) { return (float)__ldg(p); }
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads) crop_kernel(Params p) {
  extern __shared__ Tap cols[];  // the n column taps
  __shared__ Tap rows[kRows];
  const int s = blockIdx.y, n = p.n, r0 = blockIdx.x * kRows;
  const int nr = min(kRows, n - r0);
  const float* win = p.windows + 4 * s;
  const float inv_n = 1.0f / (float)n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) cols[j] = axis_tap(win[0], win[2], j, inv_n, p.W, p.fw);
  if (threadIdx.x < nr) rows[threadIdx.x] = axis_tap(win[1], win[3], r0 + threadIdx.x, inv_n, p.H, p.fh);
  __syncthreads();

  const In* frame = static_cast<const In*>(p.frames) + (long long)s * p.fs;
  const float pad[3] = {p.pad[3 * s], p.pad[3 * s + 1], p.pad[3 * s + 2]};
  Out* out = static_cast<Out*>(p.out) + ((long long)s * n + r0) * n * 3;
  for (int e = threadIdx.x; e < nr * n; e += blockDim.x) {
    const Tap ty = rows[e / n], tx = cols[e % n];
    const bool in00 = (ty.in & 1) && (tx.in & 1), in01 = (ty.in & 1) && (tx.in & 2);
    const bool in10 = (ty.in & 2) && (tx.in & 1), in11 = (ty.in & 2) && (tx.in & 2);
    const In* r0p = frame + ty.o0;
    const In* r1p = frame + ty.o1;
    const float wx = 1.0f - tx.f, wy = 1.0f - ty.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const long long oc = c * p.fc;
      const float a = in00 ? load(r0p + tx.o0 + oc) : pad[c];
      const float b = in01 ? load(r0p + tx.o1 + oc) : pad[c];
      const float g = in10 ? load(r1p + tx.o0 + oc) : pad[c];
      const float h = in11 ? load(r1p + tx.o1 + oc) : pad[c];
      const float top = a * wx + b * tx.f;
      const float bot = g * wx + h * tx.f;
      const float v = top * wy + bot * ty.f;
      store(out + 3 * e + c, (v - p.mean[c]) / p.std[c]);
    }
  }
}

template <typename In, typename Out>
int launch(const Params& p, int S, cudaStream_t stream) {
  const dim3 grid((p.n + kRows - 1) / kRows, S);
  crop_kernel<In, Out><<<grid, kThreads, p.n * sizeof(Tap), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// frames (S, H, W, 3) uint8 (u8 = 1) or float32 (u8 = 0) at the given element
// strides (fs may be 0); windows (S, 4) and pad (S, 3) float32 contiguous;
// out (S, n, n, 3) contiguous float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// mean and std the ImageNet constants times 255, per channel. All on the
// device of `stream`. Returns the launch's cudaError_t (0 = success).
extern "C" int fear_crop(const void* frames, int u8, long long fs, long long fh, long long fw, long long fc,
                         const void* windows, const void* pad, void* out, int bf16, int S, int H, int W, int n,
                         float mean0, float mean1, float mean2, float std0, float std1, float std2,
                         void* stream) {
  // the column taps live in shared memory: at most 48 KB without opting in
  if (S <= 0 || S > 65535 || H <= 0 || W <= 0 || n <= 0 || n * sizeof(Tap) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.frames = frames;
  p.fs = fs;
  p.fh = fh;
  p.fw = fw;
  p.fc = fc;
  p.windows = (const float*)windows;
  p.pad = (const float*)pad;
  p.out = out;
  p.H = H;
  p.W = W;
  p.n = n;
  p.mean[0] = mean0;
  p.mean[1] = mean1;
  p.mean[2] = mean2;
  p.std[0] = std0;
  p.std[1] = std1;
  p.std[2] = std2;
  const cudaStream_t st = (cudaStream_t)stream;
  if (u8)
    return bf16 ? launch<uint8_t, __nv_bfloat16>(p, S, st) : launch<uint8_t, float>(p, S, st);
  return bf16 ? launch<float, __nv_bfloat16>(p, S, st) : launch<float, float>(p, S, st);
}

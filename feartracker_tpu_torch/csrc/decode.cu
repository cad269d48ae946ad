// Fused penalty-window decode for the FEAR tracker, one warp per stream.
//
// Replaces the TPU kernel `_decode_kernel` of feartracker_tpu/ops/pallas/decode.py
// (launched by `postprocess_pallas`). Its plain PyTorch twin is
// feartracker_tpu_torch/core/postprocess.py:postprocess.
//
// Per stream, over the (H*W <= 256) score cells: sigmoid of the class logit;
// LTRB -> xyxy on the score grid; when `smooth`, the scale/ratio penalty
// exp(-(r_c*s_c - 1)*k) times the score, mixed with the Hanning window; the
// row-major first-match argmax; the box, raw confidence and penalty at the
// peak; when `smooth`, size smoothing with lr = penalty*conf*cfg.lr.
//
// What bounds it on the H100: nothing but launch latency. A stream is 5 KB of
// input, so at S=128 the kernel moves ~650 KB. The design therefore does the
// whole decode in one launch (the plain twin is a dozen small kernels): each
// lane holds 8 cells in registers, the max and the first-match index are
// found with warp shuffles (no shared memory, no block barrier), and the lane
// that owns the peak writes the result.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCellsPerLane = 8;  // 32 lanes * 8 = 256 cells (16x16 score map)
constexpr int kThreads = 128;     // 4 streams per block

struct Cell {
  float pscore, conf, penalty, x1, y1, x2, y2;
};

__device__ __forceinline__ float limit(float r) { return fmaxf(r, 1.0f / r); }

__device__ __forceinline__ float squared_size(float w, float h) {
  const float pad = (w + h) * 0.5f;
  return sqrtf((w + pad) * (h + pad));
}

__device__ __forceinline__ Cell eval_cell(const float* cls, const float* reg, const float* win,
                                          const float* gx, const float* gy, int cell, bool smooth,
                                          float prev_w, float prev_h, float penalty_k,
                                          float window_influence) {
  Cell c;
  c.conf = 1.0f / (1.0f + expf(-cls[cell]));
  const float4 r = reinterpret_cast<const float4*>(reg)[cell];
  c.x1 = gx[cell] - r.x;
  c.y1 = gy[cell] - r.y;
  c.x2 = gx[cell] + r.z;
  c.y2 = gy[cell] + r.w;
  if (smooth) {
    const float pw = c.x2 - c.x1, ph = c.y2 - c.y1;
    const float s_c = limit(squared_size(pw, ph) / squared_size(prev_w, prev_h));
    const float r_c = limit((prev_w / prev_h) / (pw / ph));
    c.penalty = expf(-(r_c * s_c - 1.0f) * penalty_k);
    c.pscore = (c.penalty * c.conf) * (1.0f - window_influence) + win[cell] * window_influence;
  } else {
    c.penalty = 1.0f;
    c.pscore = c.conf;
  }
  return c;
}

__global__ void __launch_bounds__(kThreads) decode_kernel(
    const float* __restrict__ cls, const float* __restrict__ reg,
    const float* __restrict__ prev, const float* __restrict__ win,
    const float* __restrict__ gx, const float* __restrict__ gy,
    float* __restrict__ bbox, float* __restrict__ conf, int32_t* __restrict__ coords,
    int S, int HW, int W, int smooth, float penalty_k, float window_influence, float lr) {
  const int s = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= S) return;  // uniform per warp: all lanes of a warp share s
  const float* c = cls + (size_t)s * HW;
  const float* r = reg + (size_t)s * HW * 4;
  const float prev_w = smooth ? prev[2 * s] : 1.0f;
  const float prev_h = smooth ? prev[2 * s + 1] : 1.0f;

  float ps[kCellsPerLane];
  float best = -INFINITY;
#pragma unroll
  for (int m = 0; m < kCellsPerLane; ++m) {
    const int cell = m * 32 + lane;
    ps[m] = -INFINITY;
    if (cell < HW) {
      ps[m] = eval_cell(c, r, win, gx, gy, cell, smooth, prev_w, prev_h, penalty_k,
                        window_influence).pscore;
      best = fmaxf(best, ps[m]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));

  // first match in row-major order: the smallest flat index holding the max
  int idx = INT32_MAX;
#pragma unroll
  for (int m = kCellsPerLane - 1; m >= 0; --m) {
    const int cell = m * 32 + lane;
    if (cell < HW && ps[m] == best) idx = cell;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) idx = min(idx, __shfl_xor_sync(0xffffffffu, idx, off));

  if (idx == INT32_MAX) idx = 0;  // all-NaN map: fall back to cell 0
  if (lane != (idx & 31)) return;
  const Cell p = eval_cell(c, r, win, gx, gy, idx, smooth, prev_w, prev_h, penalty_k,
                           window_influence);
  float bw = p.x2 - p.x1, bh = p.y2 - p.y1;
  if (smooth) {
    const float l = p.penalty * p.conf * lr;
    const float kw = prev_w * (1.0f - l), kh = prev_h * (1.0f - l);
    bw = kw + l * (bw * l + kw);
    bh = kh + l * (bh * l + kh);
  }
  reinterpret_cast<float4*>(bbox)[s] = make_float4(p.x1, p.y1, bw, bh);
  conf[s] = p.conf;
  coords[2 * s] = idx / W;
  coords[2 * s + 1] = idx % W;
}

}  // namespace

// cls (S,H,W) f32, reg (S,H,W,4) f32, prev (S,2) f32, win/gx/gy (H,W) f32;
// out bbox (S,4) f32, conf (S,) f32, coords (S,2) int32. All contiguous, on
// the device of `stream`. Returns the launch's cudaError_t (0 = success).
extern "C" int fear_decode(const void* cls, const void* reg, const void* prev, const void* win,
                           const void* gx, const void* gy, void* bbox, void* conf, void* coords,
                           int S, int H, int W, int smooth, float penalty_k,
                           float window_influence, float lr, void* stream) {
  if (S <= 0 || H * W > 32 * kCellsPerLane) return (int)cudaErrorInvalidValue;
  const int blocks = (S * 32 + kThreads - 1) / kThreads;
  decode_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)cls, (const float*)reg, (const float*)prev, (const float*)win,
      (const float*)gx, (const float*)gy, (float*)bbox, (float*)conf, (int32_t*)coords, S, H * W,
      W, smooth, penalty_k, window_influence, lr);
  return (int)cudaGetLastError();
}

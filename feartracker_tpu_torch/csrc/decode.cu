// K1: the decode region of a tracking step in one launch, one CUDA block per
// stream and one thread per score cell.
//
// Replaces the TPU kernel `_decode_kernel` of feartracker_tpu/ops/pallas/decode.py
// (launched by `postprocess_pallas`) and, in the batched step, the torch ops
// around it. Its plain PyTorch twins are in feartracker_tpu_torch/ops/cuda/decode.py:
// `decode_step_plain` for the whole region, `pp.postprocess` for the decode
// alone.
//
// Per stream, over the (H*W <= 256) score cells, reading cls and reg in the
// head's own dtype (float32 or bfloat16, widened exactly) at the strides given:
//   prologue (step mode): the previous size in crop pixels from the stream's
//     frame-space box and its search window (`crop_bbox_in_window(...)[:, 2:]`);
//   decode: sigmoid of the class logit; LTRB -> xyxy on the score grid; when
//     `smooth`, the scale/ratio penalty exp(-(r_c*s_c - 1)*k) times the score,
//     mixed with the Hanning window; the row-major first-match argmax (a NaN
//     score never wins; an all-NaN map falls back to cell 0); the box, raw
//     confidence and penalty at the peak; when `smooth`, size smoothing with
//     lr = penalty*conf*cfg.lr;
//   epilogue (step mode): the box rescaled to the frame with half-to-even
//     rounding and clamped into it (`clamp_bbox(rescale_crop_bbox(...))`), and
//     the APCE (max-min)^2 / mean((v-min)^2) of the sigmoid map.
//
// What bounds it on the H100: launch latency. A stream is 2.6 KB of bf16 head
// output, so at S=128 the region moves ~340 KB (0.1 us at 3.35 TB/s) against
// a launch floor of ~1.7 us. The design therefore does more per launch, not
// less per byte: the ~66 torch ops the step ran around the decode (casts,
// prev size, rescale, clamp, APCE) become this one launch. Inside it, each
// thread evaluates one cell, so the per-cell exp/sqrt/divisions run once and
// in parallel; the argmax is a warp max plus a ballot (the lowest set lane is
// the first match, since thread t holds cell t), then eight warp partials in
// shared memory; the winning thread still holds its cell's box, confidence and
// penalty in registers and writes every output itself.
//
// Numerics: the plain twin's ops run one at a time and round after each, so
// this file is compiled with -fmad=false (ops/cuda/build.py) and writes each
// expression in torch's order: `s / t` for a Python scalar s is
// reciprocal(t) * s, `t / s` multiplies by the scalar's float reciprocal,
// torch.round is rintf (half to even), clamp lets NaN through.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one thread per cell of the 16x16 score map
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* cls;
  const void* reg;
  long long cls_s, cls_h, cls_w;  // element strides of (S, H, W[, 1])
  long long reg_s, reg_h, reg_w, reg_c;  // element strides of (S, H, W, 4)
  const float* prev;     // (S, 2) previous size, postprocess mode with smooth; else null
  const float* state;    // (S, 4) frame-space boxes (step mode) or null
  const float* windows;  // (S, 4) search windows (step mode) or null
  const float* win;      // (H, W) Hanning window
  const float* gx;       // (H, W) grid x
  const float* gy;       // (H, W) grid y
  float* bbox;           // (S, 4) crop-space xywh
  float* conf;           // (S,)
  int32_t* coords;       // (S, 2) (row, col)
  float* frame;          // (S, 4) frame-space xywh (step mode) or null
  float* apce;           // (S,) (step mode) or null
  int HW, W, smooth;
  float penalty_k, keep, influence, lr;  // keep = 1 - window_influence, rounded once from double
  float out_size, frame_w, frame_h, min_side;
};

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) { return __bfloat162float(p[i]); }

__device__ __forceinline__ float limit(float r) { return fmaxf(r, 1.0f / r); }

__device__ __forceinline__ float squared_size(float w, float h) {
  const float pad = (w + h) * 0.5f;
  return sqrtf((w + pad) * (h + pad));
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min_nan(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Params p) {
  __shared__ float s_peak[kWarps], s_lo[kWarps], s_hi[kWarps], s_energy[kWarps];
  __shared__ int s_idx[kWarps];
  const int s = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool valid = t < p.HW;

  // the tables first: they do not wait on the head
  float wv = 0.0f, gxv = 0.0f, gyv = 0.0f;
  if (valid) {
    wv = p.win[t];
    gxv = p.gx[t];
    gyv = p.gy[t];
  }
  // per-stream constants, in registers
  float prev_w = 1.0f, prev_h = 1.0f;
  float4 window = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (p.windows) {
    const float* wrow = p.windows + 4 * s;
    window = make_float4(wrow[0], wrow[1], wrow[2], wrow[3]);
    // crop_bbox_in_window: scale = out_size / window = reciprocal(window) * out_size
    prev_w = p.state[4 * s + 2] * ((1.0f / window.z) * p.out_size);
    prev_h = p.state[4 * s + 3] * ((1.0f / window.w) * p.out_size);
  } else if (p.prev) {
    prev_w = p.prev[2 * s];
    prev_h = p.prev[2 * s + 1];
  }
  const float prev_ss = squared_size(prev_w, prev_h);
  const float prev_ratio = prev_w / prev_h;

  // this thread's cell
  float logit = NAN, r0 = 0.0f, r1 = 0.0f, r2 = 0.0f, r3 = 0.0f;
  if (valid) {
    const int row = t / p.W, col = t - row * p.W;
    const T* cls = static_cast<const T*>(p.cls);
    const T* reg = static_cast<const T*>(p.reg);
    logit = load(cls, s * p.cls_s + row * p.cls_h + col * p.cls_w);
    const long long r = s * p.reg_s + row * p.reg_h + col * p.reg_w;
    r0 = load(reg, r);
    r1 = load(reg, r + p.reg_c);
    r2 = load(reg, r + 2 * p.reg_c);
    r3 = load(reg, r + 3 * p.reg_c);
  }
  const float score = 1.0f / (1.0f + expf(-logit));
  const float x1 = gxv - r0, y1 = gyv - r1, x2 = gxv + r2, y2 = gyv + r3;
  float penalty = 1.0f, pscore = score;
  if (p.smooth) {
    const float pw = x2 - x1, ph = y2 - y1;
    const float s_c = limit(squared_size(pw, ph) / prev_ss);
    const float r_c = limit(prev_ratio / (pw / ph));
    penalty = expf(-(r_c * s_c - 1.0f) * p.penalty_k);
    pscore = (penalty * score) * p.keep + wv * p.influence;
  }
  if (!valid) pscore = NAN;  // never a candidate

  // argmax: the warp's max (fmaxf skips NaN), then its first lane holding it
  float peak = pscore;
  float lo = valid ? score : INFINITY, hi = valid ? score : -INFINITY;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    peak = fmaxf(peak, __shfl_xor_sync(kFull, peak, off));
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, off));
  }
  const unsigned hit = __ballot_sync(kFull, pscore == peak);
  if (lane == 0) {
    s_peak[warp] = peak;
    s_idx[warp] = hit ? warp * 32 + __ffs(hit) - 1 : INT32_MAX;
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  // any NaN score makes torch's amin/amax, so the APCE, NaN
  const int any_nan = __syncthreads_or(valid && isnan(score));
  float best = -INFINITY;
  lo = INFINITY;
  hi = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (s_idx[w] != INT32_MAX) best = fmaxf(best, s_peak[w]);
    lo = fminf(lo, s_lo[w]);
    hi = fmaxf(hi, s_hi[w]);
  }
  int idx = 0;  // an all-NaN map falls back to cell 0
#pragma unroll
  for (int w = kWarps - 1; w >= 0; --w)
    if (s_idx[w] != INT32_MAX && s_peak[w] == best) idx = s_idx[w];

  // APCE's energy, a second pass once the min is known (as torch computes it)
  const bool step = p.frame != nullptr;
  if (step) {
    const float d = valid ? score - lo : 0.0f;
    float e = d * d;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(kFull, e, off);
    if (lane == 0) s_energy[warp] = e;
    __syncthreads();
  }
  if (t != idx) return;

  // the winning thread: smoothing, crop-space result, frame-space box, APCE
  float bw = x2 - x1, bh = y2 - y1;
  if (p.smooth) {
    const float l = penalty * score * p.lr;
    const float kw = prev_w * (1.0f - l), kh = prev_h * (1.0f - l);
    bw = kw + l * (bw * l + kw);
    bh = kh + l * (bh * l + kh);
  }
  reinterpret_cast<float4*>(p.bbox)[s] = make_float4(x1, y1, bw, bh);
  p.conf[s] = score;
  p.coords[2 * s] = idx / p.W;
  p.coords[2 * s + 1] = idx % p.W;
  if (!step) return;

  // rescale_crop_bbox: window / out_size multiplies by the scalar's reciprocal
  const float inv_out = 1.0f / p.out_size;
  const float w_scale = window.z * inv_out, h_scale = window.w * inv_out;
  const float fx = rintf(x1 * w_scale + window.x);
  const float fy = rintf(y1 * h_scale + window.y);
  const float fw = clamp_min_nan(rintf(bw * w_scale), p.min_side);
  const float fh = clamp_min_nan(rintf(bh * h_scale), p.min_side);
  // clamp_bbox: ensure_bbox_boundaries (clamp, then trunc), then the min side
  const float cx1 = clamp_nan(fx, 0.0f, p.frame_w), cy1 = clamp_nan(fy, 0.0f, p.frame_h);
  const float cx2 = clamp_nan(cx1 + fw, 0.0f, p.frame_w), cy2 = clamp_nan(cy1 + fh, 0.0f, p.frame_h);
  float ox = truncf(cx1), oy = truncf(cy1), ow = truncf(cx2 - cx1), oh = truncf(cy2 - cy1);
  if (ow < p.min_side) {
    ox = ox - clamp_min_nan(ox + p.min_side - p.frame_w, 0.0f);
    ow = p.min_side;
  }
  if (oh < p.min_side) {
    oy = oy - clamp_min_nan(oy + p.min_side - p.frame_h, 0.0f);
    oh = p.min_side;
  }
  reinterpret_cast<float4*>(p.frame)[s] = make_float4(ox, oy, ow, oh);

  float energy = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) energy += s_energy[w];
  energy = energy * (1.0f / (float)p.HW);
  const float span = hi - lo;
  p.apce[s] = any_nan ? NAN : (span * span) / (energy + 1e-12f);
}

}  // namespace

// cls (S,H,W[,1]) and reg (S,H,W,4) float32 (bf16 = 0) or bfloat16 (bf16 = 1)
// at the given element strides; prev (S,2) f32 contiguous or null; state and
// windows (S,4) f32 contiguous, both null outside step mode; win/gx/gy (H,W)
// f32; out bbox (S,4) f32, conf (S,) f32, coords (S,2) int32, and in step
// mode frame (S,4) f32 and apce (S,) f32 (else null); bbox and frame 16-byte
// aligned. All on the device of `stream`. Returns the launch's cudaError_t
// (0 = success).
extern "C" int fear_decode(const void* cls, const void* reg, int bf16, long long cls_s, long long cls_h,
                           long long cls_w, long long reg_s, long long reg_h, long long reg_w,
                           long long reg_c, const void* prev, const void* state, const void* windows,
                           const void* win, const void* gx, const void* gy, void* bbox, void* conf,
                           void* coords, void* frame, void* apce, int S, int H, int W, int smooth,
                           float penalty_k, float keep, float influence, float lr, float out_size,
                           float frame_h, float frame_w, float min_side, void* stream) {
  if (S <= 0 || H * W > kThreads || (windows == nullptr) != (frame == nullptr) ||
      (windows != nullptr && (state == nullptr || apce == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.cls = cls;
  p.reg = reg;
  p.cls_s = cls_s;
  p.cls_h = cls_h;
  p.cls_w = cls_w;
  p.reg_s = reg_s;
  p.reg_h = reg_h;
  p.reg_w = reg_w;
  p.reg_c = reg_c;
  p.prev = (const float*)prev;
  p.state = (const float*)state;
  p.windows = (const float*)windows;
  p.win = (const float*)win;
  p.gx = (const float*)gx;
  p.gy = (const float*)gy;
  p.bbox = (float*)bbox;
  p.conf = (float*)conf;
  p.coords = (int32_t*)coords;
  p.frame = (float*)frame;
  p.apce = (float*)apce;
  p.HW = H * W;
  p.W = W;
  p.smooth = smooth;
  p.penalty_k = penalty_k;
  p.keep = keep;
  p.influence = influence;
  p.lr = lr;
  p.out_size = out_size;
  p.frame_w = frame_w;
  p.frame_h = frame_h;
  p.min_side = min_side;
  if (bf16)
    decode_kernel<__nv_bfloat16><<<S, kThreads, 0, (cudaStream_t)stream>>>(p);
  else
    decode_kernel<float><<<S, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

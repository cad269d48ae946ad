// Fused inverted-residual block (1x1 expand -> kxk depthwise -> 1x1 project)
// on folded (BN-free) weights, NHWC, float32 or bfloat16.
//
// Replaces the TPU kernel `_block_kernel` of feartracker_tpu/ops/pallas/ir_block.py
// (launched by `fused_ir_block`). Its plain PyTorch twin is
// feartracker_tpu_torch/ops/fused_trunk.py:plain_ir_block.
//
// What bounds it on the H100. Done the plain way, memory traffic: the
// expanded tensor is 3-6x wider than the block's input and output (up to 672
// channels for FEAR-XS, 1344 for FEAR-L) and would go to device memory and
// back twice. Kept on chip, the bound is the largest of three times: the
// block's input, output and weights moved once (0.081 ms over the 13
// FEAR-XS blocks at 256², S=128), the expand and project products on the
// tensor cores (0.062 ms), and the depthwise on the CUDA cores in float32
// (0.141 ms, the bound). The Pallas design held whole images per stream tile
// in ~14 MB of VMEM, which no SM has; here a block owns one tile of output
// positions of one stream:
//   * the input halo tile ((TH-1)*stride+k) x ((TW-1)*stride+k) x Cin is
//     staged once in shared memory (zero outside the image);
//   * the expanded channels are walked in chunks of 32. For each chunk the
//     block expands the halo (+bias, ReLU, rounded to the compute dtype),
//     writing 0 where the halo lies outside the image (the padding is zero
//     in expanded space, after bias and ReLU), runs the strided depthwise
//     (+bias, optional ReLU) into a (TH*TW, 32) buffer, and adds the chunk's
//     share of the project into a float32 (TH*TW, Cout) accumulator;
//   * the epilogue adds the project bias (+ optional ReLU), casts to the
//     compute dtype, then adds the residual in that dtype.
// Rounding points follow the Pallas kernel: the expanded tensor and the
// depthwise output are held in the compute dtype, sums in float32.
//
// The float32 kernel (the sequential tracker's f32 path, S=1, and the f32
// checks) runs every product as a float32 FMA on the CUDA cores (no TF32).
// At S=1 its bound is those FMAs (~0.48 GFLOP over FEAR-XS's 13 blocks at
// 256², 0.007 ms at 67 TFLOP/s), and what held the first version back was
// parallelism, not arithmetic: one 8x8 tile per block gives 64 blocks on
// the 64² map and 4 on the 16² maps of the widest blocks (Ce 672) for 132
// SMs, each walking every chunk in turn. So:
//   * the grid is (tiles, S, G): the chunks are split into G contiguous
//     groups (ops/cuda/ir_block.py:plan_split picks the smallest G whose
//     grid reaches 99 blocks, at most one chunk a group; G = 1 wherever the
//     tiles already fill the card, e.g. S=128);
//   * each chunk's expand weights, taps, biases and project weights are
//     staged once into shared memory with cp.async, the next chunk's
//     issued as soon as the current one is done with each buffer;
//   * the expand and the project are register-blocked: a thread keeps the
//     sums of several positions for four channels, so every weight and
//     activation it loads (16-byte loads) feeds 4-48 FMAs. The project sums
//     stay in registers across the block's chunks;
//   * with G > 1 each block writes its float32 partial (64 x Cout) to a
//     workspace; the last block of a tile to finish (a __threadfence and an
//     atomic ticket per tile) adds the G partials in group order 0..G-1, so
//     the result is deterministic, applies the epilogue, stores, and resets
//     the ticket to 0. One launch per block, no memset, no second kernel.
//
// The bfloat16 kernel (the batched main path):
//   * tiles of 16x16, 8x16 or 8x8 outputs (M = 256, 128 or 64 rows, each a
//     multiple of wgmma's 64), chosen per launch by the wrapper
//     (ops/cuda/ir_block.py:plan_tile) from the grid against the 132 SMs and
//     the shared-memory budget. A 16x16 tile cuts the recomputed expand at
//     the halo of a k5 stride-1 block from 2.25x (8x8) to 1.56x, and the
//     weight reads from L2 4x;
//   * the wrapper repacks the weights once into zero-padded chunk-major
//     tensors (expand (chunks, 32, Cin16) and project (chunks, Cout16, 32)
//     in bf16; depthwise taps and both biases (chunks, k*k+2, 32) in f32), so
//     that a chunk is whole 16-byte rows, ragged widths included. Each chunk
//     is staged with 16-byte cp.async into a double-buffered ring: chunk c+1
//     loads while chunk c computes;
//   * expand and project run on mma.sync m16n8k16 (bf16 in, f32 sums) fed by
//     ldmatrix. Its accumulator layout is documented, so bias, ReLU, the
//     zero outside the image and the bf16 rounding are applied to the
//     expand accumulators in registers and stored to shared memory as bf16.
//     The project accumulators stay in registers across all chunks, 64
//     floats a thread: M x Cout is split over 16 warps (8 for 8x8 tiles);
//   * the depthwise reads its taps from shared memory. A thread computes a
//     strip of 4-8 outputs of one row for a pair of channels and uses every
//     input column it loads for the whole strip;
//   * leading dimensions are padded by 8 bf16 (16 bytes), so that the eight
//     rows an ldmatrix reads fall in distinct banks.
// Three barriers a chunk separate expand, depthwise and project. wgmma and
// TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kTile = 8;     // float32: output positions per block side
constexpr int kQ = kTile * kTile;
constexpr int kChunk = 32;   // expanded channels per pass
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ constexpr int halo_side(int k, int s) { return (kTile - 1) * s + k; }

__device__ __forceinline__ float relu_if(float v, int on) { return on ? fmaxf(v, 0.0f) : v; }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// ---------------------------------------------------------------- float32 --

constexpr int kLdd = kChunk + 4;  // leading dimension of the depthwise output (16-byte rows, banks apart)
constexpr int kMaxQr = 16;        // project: output positions a thread holds, 4 channels each
// widest Cout: its channel quads times the fewest position groups (64 / kMaxQr) fill the threads
constexpr int kF32MaxCout = kThreads / (kQ / kMaxQr) * 4;

// Shared-memory regions in floats, each a whole number of 16-byte rows;
// ops/cuda/ir_block.py:f32_smem_bytes repeats the sum.
struct F32Layout {
  int ldx, co4;
  size_t xs, es, ds, we, wp, aux, flag, total;
};

__host__ __device__ inline F32Layout f32_layout(int k, int s, int Cin, int Cout) {
  F32Layout L;
  const size_t hp = (size_t)halo_side(k, s) * halo_side(k, s);
  L.ldx = round_up(Cin, 4);
  L.co4 = round_up(Cout, 4);
  size_t off = 0;
  L.xs = off; off += hp * L.ldx;              // [HP][ldx]       input halo
  L.es = off; off += hp * kChunk;             // [HP][32]        expanded chunk
  L.ds = off; off += kQ * kLdd;               // [64][36]        depthwise output
  L.we = off; off += (size_t)L.ldx * kChunk;  // [ldx][32]       expand weights
  L.wp = off; off += (size_t)kChunk * L.co4;  // [32][co4]       project weights
  L.aux = off; off += (k * k + 2) * kChunk;   // [k*k+2][32]     taps, expand bias, depthwise bias
  L.flag = off; off += 4;                     // the last-block flag
  L.total = off;
  return L;
}

// The project's thread map: channel quads x position groups, the groups a
// power of two (<= 64) that keeps the map within the block's threads.
__host__ __device__ inline int f32_pgroups(int co4) {
  int pg = kQ;
  while (pg * (co4 / 4) > kThreads) pg >>= 1;
  return pg;
}

// dst[r][c] = src[r * ld + c] for r < rows_in, c < cols_in, else 0; rows x
// cols floats (cols a multiple of 4), with cp.async of 16 bytes (v4: ld,
// cols_in and src 16-byte aligned) or 4.
__device__ __forceinline__ void stage_tile(float* dst, int rows, int cols, const float* src, int ld,
                                           int rows_in, int cols_in, bool v4) {
  if (v4) {
    const int segs = cols / 4;
    for (int e = threadIdx.x; e < rows * segs; e += kThreads) {
      const int r = e / segs, c = (e - r * segs) * 4;
      float* d = dst + r * cols + c;
      if (r < rows_in && c < cols_in)
        cp_async16(d, src + (size_t)r * ld + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e - r * cols;
      if (r < rows_in && c < cols_in)
        cp_async4(dst + e, src + (size_t)r * ld + c);
      else
        dst[e] = 0.0f;
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

__device__ __forceinline__ void fma4(float4& a, float v, const float4& w) {
  a.x = fmaf(v, w.x, a.x);
  a.y = fmaf(v, w.y, a.y);
  a.z = fmaf(v, w.z, a.z);
  a.w = fmaf(v, w.w, a.w);
}

// Grid (tiles, S, G): block (tile, n, g) computes chunks [g*nch/G, (g+1)*nch/G)
// of stream n's 8x8 output tile. With G > 1, ws holds (S, tiles, G, 64, co4)
// float32 partials and tickets (S * tiles) int32 zeros.
template <int K, int S>
__global__ void __launch_bounds__(kThreads, 1) ir_block_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ we, const float* __restrict__ be,
    const float* __restrict__ wd, const float* __restrict__ bd, const float* __restrict__ wp,
    const float* __restrict__ bp, float* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ tickets, int H, int W, int Cin, int Ce, int Cout, int Hout, int Wout,
    int tiles_x, int has_expand, int relu_dw, int relu_out, int residual) {
  constexpr int P = K / 2, HT = halo_side(K, S), HP = HT * HT;
  constexpr int R = (HP + 31) / 32;  // expand: halo positions a thread holds
  static_assert(kWarps == kTile, "depthwise: a warp per output row");

  const F32Layout L = f32_layout(K, S, Cin, Cout);
  const int ldx = L.ldx, co4 = L.co4;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem + L.xs;
  float* es = smem + L.es;
  float* ds = smem + L.ds;
  float* we_s = smem + L.we;
  float* wp_s = smem + L.wp;
  float* aux_s = smem + L.aux;  // [k*k][32] taps, then be, then bd
  int* last = reinterpret_cast<int*>(smem + L.flag);

  const int tile = blockIdx.x, n = blockIdx.y, g = blockIdx.z, G = gridDim.z;
  const int tiles = gridDim.x;
  const int oy0 = (tile / tiles_x) * kTile, ox0 = (tile % tiles_x) * kTile;
  const int iy0 = oy0 * S - P, ix0 = ox0 * S - P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nch = (Ce + kChunk - 1) / kChunk;
  const int cbeg = g * nch / G, cend = (g + 1) * nch / G;
  const float* xn = x + (size_t)n * H * W * Cin;
  const bool v4 = ((Cin | Ce | Cout) & 3) == 0 && aligned16(x) && aligned16(wd) && aligned16(bd) &&
                  aligned16(wp) && (!has_expand || (aligned16(we) && aligned16(be)));

  auto inside = [&](int p) {
    const int iy = iy0 + p / HT, ix = ix0 + p % HT;
    return iy >= 0 && iy < H && ix >= 0 && ix < W;
  };
  // chunk c's weights: expand (Cin rows of 32), taps + biases, project (32 rows of Cout)
  auto stage_we = [&](int c) {
    const int c0 = c * kChunk, cn = min(kChunk, Ce - c0);
    if (has_expand) stage_tile(we_s, ldx, kChunk, we + c0, Ce, Cin, cn, v4);
  };
  auto stage_aux = [&](int c) {
    const int c0 = c * kChunk, cn = min(kChunk, Ce - c0);
    stage_tile(aux_s, K * K, kChunk, wd + c0, Ce, K * K, cn, v4);
    stage_tile(aux_s + K * K * kChunk, 1, kChunk, has_expand ? be + c0 : nullptr, 0, has_expand, cn, v4);
    stage_tile(aux_s + (K * K + 1) * kChunk, 1, kChunk, bd + c0, 0, 1, cn, v4);
  };
  auto stage_wp = [&](int c) {
    const int c0 = c * kChunk, cn = min(kChunk, Ce - c0);
    stage_tile(wp_s, kChunk, co4, wp + (size_t)c0 * Cout, Cout, cn, Cout, v4);
  };

  // the input halo (zero outside the image and past Cin) with chunk cbeg's
  // expand weights, taps and biases: one cp.async group; its project
  // weights: a second
  if (v4) {
    const int segs = ldx / 4;
    for (int e = tid; e < HP * segs; e += kThreads) {
      const int p = e / segs, c = (e - p * segs) * 4;
      float* d = xs + p * ldx + c;
      if (inside(p))
        cp_async16(d, xn + ((size_t)(iy0 + p / HT) * W + ix0 + p % HT) * Cin + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int e = tid; e < HP * ldx; e += kThreads) {
      const int p = e / ldx, c = e - p * ldx;
      if (c < Cin && inside(p))
        cp_async4(xs + e, xn + ((size_t)(iy0 + p / HT) * W + ix0 + p % HT) * Cin + c);
      else
        xs[e] = 0.0f;
    }
  }
  stage_we(cbeg);
  stage_aux(cbeg);
  cp_async_commit();
  stage_wp(cbeg);
  cp_async_commit();

  // the project's map: channel quad pc, output positions pq + PG*m
  const int nq = co4 / 4, PG = f32_pgroups(co4), QR = kQ / PG;
  const bool proj = tid < nq * PG;
  const int pc = proj ? tid % nq : 0, pq = proj ? tid / nq : 0;
  float4 acc[kMaxQr];
#pragma unroll
  for (int m = 0; m < kMaxQr; ++m) acc[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int c = cbeg; c < cend; ++c) {
    const int c0 = c * kChunk;
    const bool more = c + 1 < cend;
    cp_async_wait<1>();
    __syncthreads();  // halo, expand weights, taps and biases of chunk c staged

    // expand: a thread takes channels 4*eq..4*eq+3 at halo positions
    // ep + 32*r; a 16-byte load of the input feeds 16 FMAs, one of the
    // weights R*4. Bias, ReLU, and 0 outside the image
    if (has_expand) {
      const int eq = tid & 7, ep = tid >> 3;
      float4 a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int i = 0; i < ldx; i += 4) {
        const float4 w0 = *reinterpret_cast<const float4*>(we_s + (i + 0) * kChunk + eq * 4);
        const float4 w1 = *reinterpret_cast<const float4*>(we_s + (i + 1) * kChunk + eq * 4);
        const float4 w2 = *reinterpret_cast<const float4*>(we_s + (i + 2) * kChunk + eq * 4);
        const float4 w3 = *reinterpret_cast<const float4*>(we_s + (i + 3) * kChunk + eq * 4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int p = min(ep + 32 * r, HP - 1);
          const float4 v = *reinterpret_cast<const float4*>(xs + p * ldx + i);
          fma4(a[r], v.x, w0);
          fma4(a[r], v.y, w1);
          fma4(a[r], v.z, w2);
          fma4(a[r], v.w, w3);
        }
      }
      const float4 b = *reinterpret_cast<const float4*>(aux_s + K * K * kChunk + eq * 4);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = ep + 32 * r;
        if (p >= HP) continue;
        const bool in = inside(p);
        *reinterpret_cast<float4*>(es + p * kChunk + eq * 4) =
            in ? make_float4(fmaxf(a[r].x + b.x, 0.0f), fmaxf(a[r].y + b.y, 0.0f), fmaxf(a[r].z + b.z, 0.0f),
                             fmaxf(a[r].w + b.w, 0.0f))
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {  // no expand (Ce == Cin): the chunk's input channels
      for (int e = tid; e < HP * kChunk; e += kThreads) {
        const int p = e / kChunk, j = e - p * kChunk;
        es[e] = c0 + j < Cin ? xs[p * ldx + c0 + j] : 0.0f;
      }
    }
    __syncthreads();
    if (more) stage_we(c + 1);
    cp_async_commit();

    // depthwise: warp per output row, lane per channel, the row's 8 outputs
    // in registers; each halo value loaded once feeds every output it
    // reaches; sums in (dy, dx) order
    {
      const int qy = warp;
      float s[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) s[r] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        float w[K];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) w[dx] = aux_s[(dy * K + dx) * kChunk + lane];
        const float* row = es + (qy * S + dy) * HT * kChunk + lane;
#pragma unroll
        for (int ix = 0; ix < HT; ++ix) {
          const float v = row[ix * kChunk];
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            const int dx = ix - r * S;
            if (dx >= 0 && dx < K) s[r] = fmaf(v, w[dx], s[r]);
          }
        }
      }
      const float b = aux_s[(K * K + 1) * kChunk + lane];
#pragma unroll
      for (int r = 0; r < kTile; ++r) ds[(qy * kTile + r) * kLdd + lane] = relu_if(s[r] + b, relu_dw);
    }
    __syncthreads();
    if (more) stage_aux(c + 1);
    cp_async_commit();
    cp_async_wait<2>();
    __syncthreads();  // chunk c's project weights staged

    // project: acc[m] (channels 4*pc.., position pq + PG*m) += ds @ wp; a
    // 16-byte load of the depthwise output feeds 16 FMAs, one of the
    // weights QR*4; sums over the chunk's channels in order
    if (proj) {
#pragma unroll 2
      for (int j = 0; j < kChunk; j += 4) {
        const float4 w0 = *reinterpret_cast<const float4*>(wp_s + (j + 0) * co4 + pc * 4);
        const float4 w1 = *reinterpret_cast<const float4*>(wp_s + (j + 1) * co4 + pc * 4);
        const float4 w2 = *reinterpret_cast<const float4*>(wp_s + (j + 2) * co4 + pc * 4);
        const float4 w3 = *reinterpret_cast<const float4*>(wp_s + (j + 3) * co4 + pc * 4);
#pragma unroll
        for (int m = 0; m < kMaxQr; ++m) {
          if (m < QR) {
            const float4 d = *reinterpret_cast<const float4*>(ds + (pq + PG * m) * kLdd + j);
            fma4(acc[m], d.x, w0);
            fma4(acc[m], d.y, w1);
            fma4(acc[m], d.z, w2);
            fma4(acc[m], d.w, w3);
          }
        }
      }
    }
    __syncthreads();
    if (more) stage_wp(c + 1);
    cp_async_commit();
  }
  cp_async_wait_all();

  if (G > 1) {
    // this group's partial to the workspace; the tile's last block to
    // arrive adds all G in group order and writes the output
    float* wtile = ws + ((size_t)n * tiles + tile) * G * kQ * co4;
    if (proj) {
#pragma unroll
      for (int m = 0; m < kMaxQr; ++m)
        if (m < QR) *reinterpret_cast<float4*>(wtile + ((size_t)g * kQ + pq + PG * m) * co4 + pc * 4) = acc[m];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = atomicAdd(tickets + (size_t)n * tiles + tile, 1) == G - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    if (proj) {
      // partial by partial, each one's QR loads independent of the sums
      // (its own partial read back too, so the order is 0..G-1 whichever
      // block is last)
      auto part = [&](int gg, int m) {
        return __ldcg(reinterpret_cast<const float4*>(wtile + ((size_t)gg * kQ + pq + PG * m) * co4 + pc * 4));
      };
#pragma unroll
      for (int m = 0; m < kMaxQr; ++m)
        if (m < QR) acc[m] = part(0, m);
#pragma unroll 2
      for (int gg = 1; gg < G; ++gg) {
#pragma unroll
        for (int m = 0; m < kMaxQr; ++m) {
          if (m < QR) {
            const float4 v = part(gg, m);
            acc[m] = make_float4(acc[m].x + v.x, acc[m].y + v.y, acc[m].z + v.z, acc[m].w + v.w);
          }
        }
      }
    }
    if (tid == 0) tickets[(size_t)n * tiles + tile] = 0;
  }

  // epilogue: bias (+ ReLU), then the residual (stride 1, Cin == Cout:
  // x(oy, ox) sits in the halo at (qy+P, qx+P))
  if (!proj) return;
  float* on = out + (size_t)n * Hout * Wout * Cout;
  const bool store4 = Cout % 4 == 0 && aligned16(out);
#pragma unroll
  for (int m = 0; m < kMaxQr; ++m) {
    if (m >= QR) continue;
    const int q = pq + PG * m, qy = q / kTile, qx = q % kTile, oy = oy0 + qy, ox = ox0 + qx;
    if (oy >= Hout || ox >= Wout) continue;
    float y[4] = {acc[m].x, acc[m].y, acc[m].z, acc[m].w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int co = min(pc * 4 + t, Cout - 1);
      y[t] = relu_if(y[t] + bp[co], relu_out);
      if (residual) y[t] += xs[((qy + P) * HT + qx + P) * ldx + co];
    }
    float* o = on + ((size_t)oy * Wout + ox) * Cout + pc * 4;
    if (store4) {
      *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (pc * 4 + t < Cout) o[t] = y[t];
    }
  }
}

size_t f32_smem_bytes(int k, int s, int Cin, int Cout) {
  return sizeof(float) * f32_layout(k, s, Cin, Cout).total;
}

// --------------------------------------------------------------- bfloat16 --

constexpr int kPad = 8;               // bf16 added to every leading dimension
constexpr int kLdc = kChunk + kPad;   // leading dimension of the chunk-wide buffers
constexpr int kMt = 2;                // m16 row tiles a warp holds in the project
constexpr int kAccPairs = 4;          // 16-column pairs of n8 tiles a warp holds

__host__ __device__ constexpr int bf16_warps(int th, int tw) { return th * tw >= 128 ? 16 : 8; }
// widest Cout (padded to 16) whose project accumulators the warps hold
__host__ __device__ constexpr int bf16_max_cout(int th, int tw) {
  return bf16_warps(th, tw) / (th * tw / (16 * kMt)) * kAccPairs * 16;
}

// Byte offsets of the shared-memory regions, each rounded to 128 bytes;
// ops/cuda/ir_block.py:bf16_smem_bytes repeats the sum.
struct Bf16Layout {
  int hpp, ldx, co16;
  size_t xs, es, ds, we, wp, aux, total;
};

__host__ __device__ inline Bf16Layout bf16_layout(int k, int s, int th, int tw, int Cin, int Cout) {
  Bf16Layout L;
  L.hpp = round_up(((th - 1) * s + k) * ((tw - 1) * s + k), 16);
  L.ldx = round_up(Cin, 16) + kPad;
  L.co16 = round_up(Cout, 16);
  size_t off = 0;
  L.xs = off; off += round_up(L.hpp * L.ldx * 2, 128);              // [hpp][ldx]       input halo
  L.es = off; off += round_up(L.hpp * kLdc * 2, 128);               // [hpp][40]        expanded chunk
  L.ds = off; off += round_up(th * tw * kLdc * 2, 128);             // [M][40]          depthwise out
  L.we = off; off += round_up(2 * kChunk * L.ldx * 2, 128);         // 2 x [32][ldx]    expand weights
  L.wp = off; off += round_up(2 * L.co16 * kLdc * 2, 128);          // 2 x [co16][40]   project weights
  L.aux = off; off += round_up(2 * (k * k + 2) * kChunk * 4, 128);  // 2 x [k*k+2][32]  taps, be, bd
  L.total = off;
  return L;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// A lane's ldmatrix row address. A [m][k] row-major, 16x16 at base: the four
// 8x8 matrices a0..a3 of an m16n8k16 A fragment. B stored [n][k], 16 rows of
// n at base: b0, b1 of the n8 tile n0 then of the n8 tile n0 + 8.
__device__ __forceinline__ const bf16* a_frag_addr(const bf16* base, int ld, int lane) {
  return base + (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ const bf16* b_frag_addr(const bf16* base, int ld, int lane) {
  return base + (((lane >> 4) << 3) + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}

template <int K, int S, int TH, int TW>
__global__ void __launch_bounds__(TH * TW >= 128 ? 512 : 256, 1) ir_block_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wep, const bf16* __restrict__ wpp,
    const float* __restrict__ auxp, const float* __restrict__ bp, bf16* __restrict__ out, int H,
    int W, int Cin, int Ce, int Cout, int Hout, int Wout, int tiles_x, int has_expand, int relu_dw,
    int relu_out, int residual) {
  constexpr int P = K / 2, HTW = (TW - 1) * S + K, HP = ((TH - 1) * S + K) * HTW;
  constexpr int M = TH * TW, NW = bf16_warps(TH, TW), NT = NW * 32;
  constexpr int WM = M / (16 * kMt), WN = NW / WM;  // project: WM x WN warps
  constexpr int R = M / (2 * NW), SEGS = TW / R;    // depthwise: strips of R outputs
  constexpr int NAUX = (K * K + 2) * kChunk;
  static_assert(WM * WN == NW && SEGS * R == TW && 16 * TH * SEGS == NT, "tile and warps disagree");

  const Bf16Layout L = bf16_layout(K, S, TH, TW, Cin, Cout);
  const int ldx = L.ldx, cin16 = L.ldx - kPad, co16 = L.co16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + L.xs);
  bf16* es = reinterpret_cast<bf16*>(smem_raw + L.es);
  bf16* ds = reinterpret_cast<bf16*>(smem_raw + L.ds);
  bf16* we_s = reinterpret_cast<bf16*>(smem_raw + L.we);
  bf16* wp_s = reinterpret_cast<bf16*>(smem_raw + L.wp);
  float* aux_s = reinterpret_cast<float*>(smem_raw + L.aux);

  const int n = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * TH, ox0 = (blockIdx.x % tiles_x) * TW;
  const int iy0 = oy0 * S - P, ix0 = ox0 * S - P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int nch = (Ce + kChunk - 1) / kChunk, npairs = co16 / 16;
  const bf16* xn = x + (size_t)n * H * W * Cin;

  // halo position p in the image (and not a padding row)
  auto inside = [&](int p) {
    const int hy = p / HTW, iy = iy0 + hy, ix = ix0 + p - hy * HTW;
    return p < HP && iy >= 0 && iy < H && ix >= 0 && ix < W;
  };
  auto x_at = [&](int p, int c) {
    const int hy = p / HTW;
    return xn + ((size_t)(iy0 + hy) * W + ix0 + p - hy * HTW) * Cin + c;
  };
  // chunk c's weights into ring slot c & 1, in 16-byte pieces
  auto stage = [&](int c) {
    const int b = c & 1;
    if (has_expand) {
      const int segs = cin16 / 8;
      const bf16* src = wep + (size_t)c * kChunk * cin16;
      for (int e = tid; e < kChunk * segs; e += NT) {
        const int j = e / segs, sg = e - j * segs;
        cp_async16(we_s + (b * kChunk + j) * ldx + sg * 8, src + j * cin16 + sg * 8);
      }
    }
    const bf16* src = wpp + (size_t)c * co16 * kChunk;
    for (int e = tid; e < co16 * 4; e += NT)
      cp_async16(wp_s + (b * co16 + (e >> 2)) * kLdc + (e & 3) * 8, src + e * 8);
    const float* asrc = auxp + (size_t)c * NAUX;
    for (int e = tid; e < NAUX / 4; e += NT) cp_async16(aux_s + b * NAUX + e * 4, asrc + e * 4);
  };

  // the input halo (zero outside the image, in rows >= HP and in channels
  // >= Cin), then chunk 0's weights: one cp.async group
  if (Cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int segs = cin16 / 8;
    for (int e = tid; e < L.hpp * segs; e += NT) {
      const int p = e / segs, sg = e - p * segs;
      bf16* dst = xs + p * ldx + sg * 8;
      if (sg * 8 < Cin && inside(p))
        cp_async16(dst, x_at(p, sg * 8));
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  } else {  // rows that are not whole 16-byte pieces: element by element
    for (int e = tid; e < L.hpp * cin16; e += NT) {
      const int p = e / cin16, c = e - p * cin16;
      xs[p * ldx + c] = (c < Cin && inside(p)) ? *x_at(p, c) : __float2bfloat16(0.0f);
    }
  }
  stage(0);
  cp_async_commit();

  float acc[kMt][2 * kAccPairs][4];
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < 2 * kAccPairs; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  for (int c = 0; c < nch; ++c) {
    const int b = c & 1, c0 = c * kChunk;
    cp_async_wait_all();
    __syncthreads();  // chunk c staged; every thread is done with chunk c-1
    if (c + 1 < nch) {
      stage(c + 1);
      cp_async_commit();
    }
    const float* taps = aux_s + b * NAUX;  // [k*k][32] taps, then be, then bd

    // expand on the tensor cores: es[hpp x 32] = xs[hpp x cin16] @ we^T, a
    // warp per 16-row tile and all 32 columns (one A fragment feeds four
    // mma); bias, ReLU, the zero outside the image and the bf16 rounding in
    // registers
    if (has_expand) {
      const bf16* wb = we_s + b * kChunk * ldx;
      const float* be_s = taps + K * K * kChunk;
      for (int t = warp; t < L.hpp / 16; t += NW) {
        const int m0 = t * 16;
        float e[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) e[nt][0] = e[nt][1] = e[nt][2] = e[nt][3] = 0.0f;
#pragma unroll 2
        for (int kk = 0; kk < cin16; kk += 16) {
          uint32_t a[4], b0[4], b1[4];
          ldmatrix_x4(a, a_frag_addr(xs + m0 * ldx + kk, ldx, lane));
          ldmatrix_x4(b0, b_frag_addr(wb + kk, ldx, lane));
          ldmatrix_x4(b1, b_frag_addr(wb + 16 * ldx + kk, ldx, lane));
          mma_bf16(e[0], a, b0[0], b0[1]);
          mma_bf16(e[1], a, b0[2], b0[3]);
          mma_bf16(e[2], a, b1[0], b1[1]);
          mma_bf16(e[3], a, b1[2], b1[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m0 + (lane >> 2) + h * 8;
          const bool in = inside(p);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int j = nt * 8 + (lane & 3) * 2;
            const float v0 = in ? fmaxf(e[nt][2 * h] + be_s[j], 0.0f) : 0.0f;
            const float v1 = in ? fmaxf(e[nt][2 * h + 1] + be_s[j + 1], 0.0f) : 0.0f;
            *reinterpret_cast<bf162*>(es + p * kLdc + j) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    } else {  // no expand (Ce == Cin): the chunk's input channels
      const bf16 z = __float2bfloat16(0.0f);
      for (int e = tid; e < L.hpp * (kChunk / 2); e += NT) {
        const int p = e / (kChunk / 2), j = (e % (kChunk / 2)) * 2;
        const bf16 v0 = c0 + j < Cin ? xs[p * ldx + c0 + j] : z;
        const bf16 v1 = c0 + j + 1 < Cin ? xs[p * ldx + c0 + j + 1] : z;
        *reinterpret_cast<bf162*>(es + p * kLdc + j) = __halves2bfloat162(v0, v1);
      }
    }
    __syncthreads();

    // depthwise on the CUDA cores: a thread takes a channel pair and a strip
    // of R outputs of one row; float32 sums in (dy, dx) order
    {
      const int j = (tid & 15) * 2, rest = tid >> 4;
      const int qy = rest % TH, q0 = (rest / TH) * R;
      float2 s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        float2 w[K];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) w[dx] = *reinterpret_cast<const float2*>(taps + (dy * K + dx) * kChunk + j);
        const bf16* row = es + ((qy * S + dy) * HTW + q0 * S) * kLdc + j;
#pragma unroll
        for (int ix = 0; ix < (R - 1) * S + K; ++ix) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const bf162*>(row + ix * kLdc));
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int dx = ix - r * S;
            if (dx >= 0 && dx < K) {
              s[r].x = fmaf(v.x, w[dx].x, s[r].x);
              s[r].y = fmaf(v.y, w[dx].y, s[r].y);
            }
          }
        }
      }
      const float2 bd = *reinterpret_cast<const float2*>(taps + (K * K + 1) * kChunk + j);
#pragma unroll
      for (int r = 0; r < R; ++r)
        *reinterpret_cast<bf162*>(ds + (qy * TW + q0 + r) * kLdc + j) =
            __floats2bfloat162_rn(relu_if(s[r].x + bd.x, relu_dw), relu_if(s[r].y + bd.y, relu_dw));
    }
    __syncthreads();

    // project on the tensor cores: acc[M x co16] += ds[M x 32] @ wp^T; a warp
    // holds kMt row tiles and the column pairs wn, wn + WN, ...
    const bf16* pb = wp_s + b * co16 * kLdc;
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 16) {
      uint32_t a[kMt][4];
#pragma unroll
      for (int i = 0; i < kMt; ++i) ldmatrix_x4(a[i], a_frag_addr(ds + (wm * kMt + i) * 16 * kLdc + ks, kLdc, lane));
#pragma unroll
      for (int pi = 0; pi < kAccPairs; ++pi) {
        const int pr = wn + WN * pi;
        if (pr < npairs) {
          uint32_t bb[4];
          ldmatrix_x4(bb, b_frag_addr(pb + pr * 16 * kLdc + ks, kLdc, lane));
#pragma unroll
          for (int i = 0; i < kMt; ++i) {
            mma_bf16(acc[i][2 * pi], a[i], bb[0], bb[1]);
            mma_bf16(acc[i][2 * pi + 1], a[i], bb[2], bb[3]);
          }
        }
      }
    }
  }

  // epilogue from the accumulators: bias (+ ReLU), bf16, then the residual
  // added in bf16, as in the reference (stride 1, Cin == Cout: x(oy, ox)
  // sits in the halo at (qy+P, qx+P))
  bf16* on = out + (size_t)n * Hout * Wout * Cout;
#pragma unroll
  for (int pi = 0; pi < kAccPairs; ++pi) {
    const int pr = wn + WN * pi;
    if (pr >= npairs) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int co = pr * 16 + nt * 8 + (lane & 3) * 2;
      if (co >= Cout) continue;
      const bool two = co + 1 < Cout;
      const float b0 = bp[co], b1 = two ? bp[co + 1] : 0.0f;
#pragma unroll
      for (int i = 0; i < kMt; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = (wm * kMt + i) * 16 + (lane >> 2) + h * 8;
          const int qy = q / TW, qx = q % TW, oy = oy0 + qy, ox = ox0 + qx;
          if (oy >= Hout || ox >= Wout) continue;
          float y0 = round_bf16(relu_if(acc[i][2 * pi + nt][2 * h] + b0, relu_out));
          float y1 = round_bf16(relu_if(acc[i][2 * pi + nt][2 * h + 1] + b1, relu_out));
          if (residual) {
            const bf16* xr = xs + ((qy + P) * HTW + qx + P) * ldx + co;
            y0 += __bfloat162float(xr[0]);
            if (two) y1 += __bfloat162float(xr[1]);
          }
          bf16* o = on + ((size_t)oy * Wout + ox) * Cout + co;
          if (two && Cout % 2 == 0) {
            *reinterpret_cast<bf162*>(o) = __floats2bfloat162_rn(y0, y1);
          } else {
            o[0] = __float2bfloat16(y0);
            if (two) o[1] = __float2bfloat16(y1);
          }
        }
    }
  }
}

// ----------------------------------------------------------------- launch --

struct Args {
  const void *x, *we, *be, *wd, *bd, *wp, *bp;
  void* out;
  int N, H, W, Cin, Ce, Cout, has_expand, relu_dw, relu_out, residual;
  int groups = 1;  // float32: chunk groups G
  void* ws = nullptr;
  void* tickets = nullptr;
};

// Launches, or with `query` returns resident blocks per SM (-1 when the
// shape does not fit).
template <int K, int S>
int f32_entry(const Args& a, bool query, cudaStream_t stream) {
  auto kernel = ir_block_f32_kernel<K, S>;
  if (round_up(a.Cout, 4) > kF32MaxCout) return query ? -1 : (int)cudaErrorInvalidValue;
  const int smem = (int)f32_smem_bytes(K, S, a.Cin, a.Cout);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (query) {
    int blocks = -1;
    if (err != cudaSuccess || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem))
      blocks = -1;
    cudaGetLastError();
    return blocks;
  }
  if (err != cudaSuccess) return (int)err;
  const int nch = (a.Ce + kChunk - 1) / kChunk;
  if (a.groups < 1 || a.groups > nch || (a.groups > 1 && (!a.ws || !a.tickets))) return (int)cudaErrorInvalidValue;
  const int Hout = a.H / S, Wout = a.W / S;
  const int tiles_y = (Hout + kTile - 1) / kTile, tiles_x = (Wout + kTile - 1) / kTile;
  kernel<<<dim3(tiles_y * tiles_x, a.N, a.groups), kThreads, smem, stream>>>(
      (const float*)a.x, (const float*)a.we, (const float*)a.be, (const float*)a.wd, (const float*)a.bd,
      (const float*)a.wp, (const float*)a.bp, (float*)a.out, (float*)a.ws, (int*)a.tickets, a.H, a.W, a.Cin,
      a.Ce, a.Cout, Hout, Wout, tiles_x, a.has_expand, a.relu_dw, a.relu_out, a.residual);
  return (int)cudaGetLastError();
}

// bfloat16: a.we, a.wd, a.wp are the packed expand, taps-and-biases and
// project tensors (a.be, a.bd unused)
template <int K, int S, int TH, int TW>
int bf16_entry(const Args& a, bool query, cudaStream_t stream) {
  auto kernel = ir_block_bf16_kernel<K, S, TH, TW>;
  constexpr int threads = bf16_warps(TH, TW) * 32;
  const int smem = (int)bf16_layout(K, S, TH, TW, a.Cin, a.Cout).total;
  if (round_up(a.Cout, 16) > bf16_max_cout(TH, TW)) return query ? -1 : (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (query) {
    int blocks = -1;
    if (err != cudaSuccess || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem))
      blocks = -1;
    cudaGetLastError();
    return blocks;
  }
  if (err != cudaSuccess) return (int)err;
  const int Hout = a.H / S, Wout = a.W / S;
  const int tiles_y = (Hout + TH - 1) / TH, tiles_x = (Wout + TW - 1) / TW;
  kernel<<<dim3(tiles_y * tiles_x, a.N), threads, smem, stream>>>(
      (const bf16*)a.x, (const bf16*)a.we, (const bf16*)a.wp, (const float*)a.wd, (const float*)a.bp,
      (bf16*)a.out, a.H, a.W, a.Cin, a.Ce, a.Cout, Hout, Wout, tiles_x, a.has_expand, a.relu_dw,
      a.relu_out, a.residual);
  return (int)cudaGetLastError();
}

template <int K, int S>
int entry_ks(const Args& a, int dtype, int th, int tw, bool query, cudaStream_t st) {
  if (dtype == 0) return f32_entry<K, S>(a, query, st);
  if (th == 16 && tw == 16) return bf16_entry<K, S, 16, 16>(a, query, st);
  if (th == 8 && tw == 16) return bf16_entry<K, S, 8, 16>(a, query, st);
  if (th == 8 && tw == 8) return bf16_entry<K, S, 8, 8>(a, query, st);
  return query ? -1 : (int)cudaErrorInvalidValue;
}

int entry(const Args& a, int k, int stride, int dtype, int th, int tw, bool query, cudaStream_t st) {
  if (k == 3 && stride == 1) return entry_ks<3, 1>(a, dtype, th, tw, query, st);
  if (k == 3 && stride == 2) return entry_ks<3, 2>(a, dtype, th, tw, query, st);
  if (k == 5 && stride == 1) return entry_ks<5, 1>(a, dtype, th, tw, query, st);
  if (k == 5 && stride == 2) return entry_ks<5, 2>(a, dtype, th, tw, query, st);
  return query ? -1 : (int)cudaErrorInvalidValue;
}

}  // namespace

// float32: x (N,H,W,Cin) NHWC; we (Cin,Ce) [null when !has_expand]; be (Ce,)
// [null when !has_expand]; wd (k*k,Ce); bd (Ce,); wp (Ce,Cout); bp (Cout,);
// out (N,H/stride,W/stride,Cout); all float32 (dtype 0; bfloat16 goes
// through fear_ir_block_bf16). The expanded chunks split into `groups`
// (1 .. ceil(Ce/32)); with groups > 1, ws is float32 scratch of
// N * tiles * groups * 64 * round_up(Cout, 4) and tickets N * tiles int32
// zeros (tiles = ceil(Hout/8) * ceil(Wout/8)), left zero again by the
// launch, used by one stream at a time. Returns the launch's cudaError_t.
extern "C" int fear_ir_block(const void* x, const void* we, const void* be, const void* wd,
                             const void* bd, const void* wp, const void* bp, void* out, int N,
                             int H, int W, int Cin, int Ce, int Cout, int k, int stride,
                             int has_expand, int relu_dw, int relu_out, int residual, int dtype,
                             int groups, void* ws, void* tickets, void* stream) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  Args a{x, we, be, wd, bd, wp, bp, out, N, H, W, Cin, Ce, Cout, has_expand, relu_dw, relu_out, residual};
  a.groups = groups;
  a.ws = ws;
  a.tickets = tickets;
  return entry(a, k, stride, 0, 0, 0, false, (cudaStream_t)stream);
}

// bfloat16, tiles of tile_h x tile_w outputs (16x16, 8x16 or 8x8): x and out
// as above in bf16; the weights packed by ops/cuda/ir_block.py:pack_block,
// chunk c holding expanded channels 32c .. 32c+31, zero past Ce, Cin, Cout:
// we (chunks,32,Cin16) bf16 [null when !has_expand]; aux (chunks,k*k+2,32)
// f32: the depthwise taps, the expand bias, the depthwise bias; wp
// (chunks,Cout16,32) bf16; bp (Cout,) f32. Returns the launch's cudaError_t.
extern "C" int fear_ir_block_bf16(const void* x, const void* we, const void* aux, const void* wp,
                                  const void* bp, void* out, int N, int H, int W, int Cin, int Ce,
                                  int Cout, int k, int stride, int has_expand, int relu_dw,
                                  int relu_out, int residual, int tile_h, int tile_w, void* stream) {
  const Args a{x, we, nullptr, aux, nullptr, wp, bp, out, N, H, W, Cin, Ce, Cout, has_expand, relu_dw, relu_out, residual};
  return entry(a, k, stride, 1, tile_h, tile_w, false, (cudaStream_t)stream);
}

// Dynamic shared memory, in bytes, of one launch (dtype 0 float32, whose tile
// is always 8x8 and whose count does not depend on the chunk groups; 1
// bfloat16 at tile_h x tile_w); -1 when no kernel takes it.
extern "C" int fear_ir_block_smem_bytes(int k, int stride, int Cin, int Cout, int dtype, int tile_h,
                                        int tile_w) {
  if (dtype == 0) return round_up(Cout, 4) > kF32MaxCout ? -1 : (int)f32_smem_bytes(k, stride, Cin, Cout);
  const bool tile = (tile_h == 16 && tile_w == 16) || (tile_h == 8 && (tile_w == 16 || tile_w == 8));
  if (!tile || round_up(Cout, 16) > bf16_max_cout(tile_h, tile_w)) return -1;
  return (int)bf16_layout(k, stride, tile_h, tile_w, Cin, Cout).total;
}

// Resident blocks per SM of one launch at this shape; -1 when it does not fit.
extern "C" int fear_ir_block_occupancy(int k, int stride, int Cin, int Cout, int dtype, int tile_h,
                                       int tile_w) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, Cin, Cin, Cout, 1, 1, 0, 0};
  return entry(a, k, stride, dtype, tile_h, tile_w, true, nullptr);
}

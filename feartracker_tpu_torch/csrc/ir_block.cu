// Fused inverted-residual block (1x1 expand -> kxk depthwise -> 1x1 project)
// on folded (BN-free) weights, NHWC, float32 or bfloat16.
//
// Replaces the TPU kernel `_block_kernel` of feartracker_tpu/ops/pallas/ir_block.py
// (launched by `fused_ir_block`). Its plain PyTorch twin is
// feartracker_tpu_torch/ops/fused_trunk.py:plain_ir_block.
//
// What bounds it on the H100: memory traffic, if done the plain way. The
// expanded tensor is 3-6x wider than the block's input and output (up to 672
// channels for FEAR-XS, 1344 for FEAR-L) and would go to device memory and
// back twice, between expand and depthwise and between depthwise and
// project. This kernel keeps it on chip. The Pallas design held whole images
// per stream tile in ~14 MB of VMEM, which no SM has; here a block owns one
// 8x8 tile of output positions of one stream:
//   * the input halo tile ((8-1)*stride+k)^2 x Cin is staged once in shared
//     memory (zero outside the image);
//   * the expanded channels are walked in chunks of 32. For each chunk the
//     block expands the halo (+bias, ReLU, rounded to the compute dtype),
//     writing 0 where the halo lies outside the image (the padding is zero
//     in expanded space, after bias and ReLU), runs the strided depthwise
//     (+bias, optional ReLU) into a (64, 32) buffer, and adds the chunk's
//     share of the project into a float32 (64, Cout) accumulator;
//   * the epilogue adds the project bias (+ optional ReLU), casts to the
//     compute dtype, then adds the residual in that dtype.
// Rounding points follow the Pallas kernel: the expanded tensor and the
// depthwise output are held in the compute dtype, sums in float32.
//
// Two kernels share that design. The bfloat16 one (the tracker's main path)
// runs the expand and project products on the tensor cores with WMMA
// 16x16x16 tiles, the project accumulators held in registers across chunks.
// The float32 one runs every product on the CUDA cores. The halo costs
// recomputed expansion at the tile border: (12/8)^2 = 2.25x the necessary
// expand work for k5 s1 blocks. wgmma/TMA pipelines are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kTile = 8;     // output positions per block side
constexpr int kQ = kTile * kTile;
constexpr int kChunk = 32;   // expanded channels per pass (one per lane)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAccTiles = 7;  // 16x16 accumulator tiles per warp: Cout <= 224

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ constexpr int halo_side(int k, int s) { return (kTile - 1) * s + k; }

__device__ __forceinline__ float relu_if(float v, int on) { return on ? fmaxf(v, 0.0f) : v; }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

// ---------------------------------------------------------------- float32 --

template <int K, int S>
__global__ void __launch_bounds__(kThreads) ir_block_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ we, const float* __restrict__ be,
    const float* __restrict__ wd, const float* __restrict__ bd, const float* __restrict__ wp,
    const float* __restrict__ bp, float* __restrict__ out, int H, int W, int Cin, int Ce,
    int Cout, int Hout, int Wout, int tiles_x, int has_expand, int relu_dw, int relu_out,
    int residual) {
  constexpr int P = K / 2, HT = halo_side(K, S), HP = HT * HT;
  extern __shared__ float smem[];
  float* xs = smem;                 // [HP][Cin]    input halo
  float* es = xs + HP * Cin;        // [HP][kChunk] expanded chunk
  float* ds = es + HP * kChunk;     // [kQ][kChunk] depthwise output chunk
  float* acc = ds + kQ * kChunk;    // [kQ][Cout]   project accumulator

  const int n = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * kTile, ox0 = (blockIdx.x % tiles_x) * kTile;
  const int iy0 = oy0 * S - P, ix0 = ox0 * S - P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xn = x + (size_t)n * H * W * Cin;

  for (int e = tid; e < HP * Cin; e += kThreads) {
    const int p = e / Cin, c = e - p * Cin;
    const int iy = iy0 + p / HT, ix = ix0 + p % HT;
    xs[e] = (iy >= 0 && iy < H && ix >= 0 && ix < W) ? xn[((size_t)iy * W + ix) * Cin + c] : 0.0f;
  }
  for (int e = tid; e < kQ * Cout; e += kThreads) acc[e] = 0.0f;
  __syncthreads();

  for (int c0 = 0; c0 < Ce; c0 += kChunk) {
    const int cn = min(kChunk, Ce - c0);
    const int c = c0 + lane;

    // expand: warp per halo position, lane per expanded channel
    for (int p = warp; p < HP; p += kWarps) {
      const int iy = iy0 + p / HT, ix = ix0 + p % HT;
      float v = 0.0f;
      if (lane < cn && iy >= 0 && iy < H && ix >= 0 && ix < W) {
        const float* xp = xs + p * Cin;
        if (has_expand) {
          float s = 0.0f;
          for (int i = 0; i < Cin; ++i) s = fmaf(xp[i], we[(size_t)i * Ce + c], s);
          v = fmaxf(s + be[c], 0.0f);
        } else {
          v = xp[c];
        }
      }
      es[p * kChunk + lane] = v;
    }
    __syncthreads();

    // depthwise: warp per output position, lane per channel
    for (int q = warp; q < kQ; q += kWarps) {
      const int qy = q / kTile, qx = q % kTile;
      float v = 0.0f;
      if (lane < cn) {
        float s = 0.0f;
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
            s = fmaf(es[((qy * S + dy) * HT + qx * S + dx) * kChunk + lane], wd[(dy * K + dx) * Ce + c], s);
        v = relu_if(s + bd[c], relu_dw);
      }
      ds[q * kChunk + lane] = v;
    }
    __syncthreads();

    // project: this chunk's partial products into the accumulator
    for (int e = tid; e < kQ * Cout; e += kThreads) {
      const int q = e / Cout, co = e - q * Cout;
      const float* dq = ds + q * kChunk;
      float s = acc[e];
      for (int j = 0; j < cn; ++j) s = fmaf(dq[j], wp[(size_t)(c0 + j) * Cout + co], s);
      acc[e] = s;
    }
    __syncthreads();
  }

  float* on = out + (size_t)n * Hout * Wout * Cout;
  for (int e = tid; e < kQ * Cout; e += kThreads) {
    const int q = e / Cout, co = e - q * Cout;
    const int qy = q / kTile, qx = q % kTile, oy = oy0 + qy, ox = ox0 + qx;
    if (oy >= Hout || ox >= Wout) continue;
    float y = relu_if(acc[e] + bp[co], relu_out);
    // stride 1, Cin == Cout: x(oy, ox) sits in the halo at (qy+P, qx+P)
    if (residual) y += xs[((qy + P) * HT + qx + P) * Cin + co];
    on[((size_t)oy * Wout + ox) * Cout + co] = y;
  }
}

size_t f32_smem_bytes(int k, int s, int Cin, int Cout) {
  const int hp = halo_side(k, s) * halo_side(k, s);
  return sizeof(float) * ((size_t)hp * (Cin + kChunk) + kQ * (kChunk + Cout));
}

// --------------------------------------------------------------- bfloat16 --

// Byte offsets of the shared-memory regions of the bfloat16 kernel. Matrix
// widths are padded to multiples of 16 (WMMA tiles), regions to 128 bytes.
struct Bf16Layout {
  int hpp, ldx, ldo;                  // padded halo rows, Cin, Cout
  size_t xs, we, es, ds, wp, ob, total;
};

__host__ __device__ inline Bf16Layout bf16_layout(int k, int s, int Cin, int Cout) {
  Bf16Layout L;
  L.hpp = round_up(halo_side(k, s) * halo_side(k, s), 16);
  L.ldx = round_up(Cin, 16);
  L.ldo = round_up(Cout, 16);
  size_t off = 0;
  L.xs = off; off += round_up(L.hpp * L.ldx * 2, 128);   // [hpp][ldx]    bf16 input halo
  L.we = off; off += round_up(L.ldx * kChunk * 2, 128);  // [ldx][32]     bf16 expand weights
  L.es = off; off += round_up(L.hpp * kChunk * 4, 128);  // [hpp][32]     f32 expanded chunk
  L.ds = off; off += round_up(kQ * kChunk * 2, 128);     // [64][32]      bf16 depthwise out
  L.wp = off; off += round_up(kChunk * L.ldo * 2, 128);  // [32][ldo]     bf16 project weights
  L.ob = off; off += round_up(kQ * L.ldo * 4, 128);      // [64][ldo]     f32 project result
  L.total = off;
  return L;
}

template <int K, int S>
__global__ void __launch_bounds__(kThreads) ir_block_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ we, const float* __restrict__ be,
    const float* __restrict__ wd, const float* __restrict__ bd, const bf16* __restrict__ wp,
    const float* __restrict__ bp, bf16* __restrict__ out, int H, int W, int Cin, int Ce,
    int Cout, int Hout, int Wout, int tiles_x, int has_expand, int relu_dw, int relu_out,
    int residual) {
  constexpr int P = K / 2, HT = halo_side(K, S), HP = HT * HT;
  const Bf16Layout L = bf16_layout(K, S, Cin, Cout);
  const int ldx = L.ldx, ldo = L.ldo;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + L.xs);
  bf16* we_s = reinterpret_cast<bf16*>(smem_raw + L.we);
  float* es = reinterpret_cast<float*>(smem_raw + L.es);
  bf16* ds = reinterpret_cast<bf16*>(smem_raw + L.ds);
  bf16* wp_s = reinterpret_cast<bf16*>(smem_raw + L.wp);
  float* ob = reinterpret_cast<float*>(smem_raw + L.ob);
  const bf16 zero = __float2bfloat16(0.0f);

  const int n = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * kTile, ox0 = (blockIdx.x % tiles_x) * kTile;
  const int iy0 = oy0 * S - P, ix0 = ox0 * S - P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* xn = x + (size_t)n * H * W * Cin;

  // halo (rows >= HP and channels >= Cin are zero padding for the tiles)
  for (int e = tid; e < L.hpp * ldx; e += kThreads) {
    const int p = e / ldx, c = e - p * ldx;
    const int iy = iy0 + p / HT, ix = ix0 + p % HT;
    const bool in = p < HP && c < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W;
    xs[e] = in ? xn[((size_t)iy * W + ix) * Cin + c] : zero;
  }

  const int ncol = ldo / 16, ntiles = (kQ / 16) * ncol;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxAccTiles];
#pragma unroll
  for (int m = 0; m < kMaxAccTiles; ++m) wmma::fill_fragment(acc[m], 0.0f);

  for (int c0 = 0; c0 < Ce; c0 += kChunk) {
    const int cn = min(kChunk, Ce - c0);
    if (has_expand)
      for (int e = tid; e < ldx * kChunk; e += kThreads) {
        const int i = e / kChunk, j = e - i * kChunk;
        we_s[e] = (i < Cin && j < cn) ? we[(size_t)i * Ce + c0 + j] : zero;
      }
    for (int e = tid; e < kChunk * ldo; e += kThreads) {
      const int j = e / ldo, co = e - j * ldo;
      wp_s[e] = (j < cn && co < Cout) ? wp[(size_t)(c0 + j) * Cout + co] : zero;
    }
    __syncthreads();

    // expand on the tensor cores: es[hpp x 32] = xs[hpp x ldx] @ we_s[ldx x 32]
    if (has_expand) {
      for (int t = warp; t < (L.hpp / 16) * 2; t += kWarps) {
        const int rt = t >> 1, ct = t & 1;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.0f);
        for (int kk = 0; kk < ldx; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, xs + rt * 16 * ldx + kk, ldx);
          wmma::load_matrix_sync(b, we_s + kk * kChunk + ct * 16, kChunk);
          wmma::mma_sync(c, a, b, c);
        }
        wmma::store_matrix_sync(es + rt * 16 * kChunk + ct * 16, c, kChunk, wmma::mem_row_major);
      }
    }
    __syncthreads();

    // bias + ReLU, rounded to bf16; zero outside the image (padding is zero
    // in expanded space) and past the chunk's last channel
    for (int e = tid; e < HP * kChunk; e += kThreads) {
      const int p = e / kChunk, j = e - p * kChunk;
      const int iy = iy0 + p / HT, ix = ix0 + p % HT;
      float v = 0.0f;
      if (j < cn && iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = has_expand ? round_bf16(fmaxf(es[e] + be[c0 + j], 0.0f))
                       : __bfloat162float(xs[p * ldx + c0 + j]);
      es[e] = v;
    }
    __syncthreads();

    // depthwise on the CUDA cores: warp per output position, lane per channel
    for (int q = warp; q < kQ; q += kWarps) {
      const int qy = q / kTile, qx = q % kTile;
      float v = 0.0f;
      if (lane < cn) {
        const int c = c0 + lane;
        float s = 0.0f;
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
            s = fmaf(es[((qy * S + dy) * HT + qx * S + dx) * kChunk + lane], wd[(dy * K + dx) * Ce + c], s);
        v = relu_if(s + bd[c], relu_dw);
      }
      ds[q * kChunk + lane] = __float2bfloat16(v);
    }
    __syncthreads();

    // project on the tensor cores: acc[64 x ldo] += ds[64 x 32] @ wp_s[32 x ldo]
#pragma unroll
    for (int m = 0; m < kMaxAccTiles; ++m) {
      const int t = warp + m * kWarps;
      if (t < ntiles) {
        const int rt = t / ncol, ct = t - rt * ncol;
#pragma unroll
        for (int ks = 0; ks < kChunk; ks += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, ds + rt * 16 * kChunk + ks, kChunk);
          wmma::load_matrix_sync(b, wp_s + ks * ldo + ct * 16, ldo);
          wmma::mma_sync(acc[m], a, b, acc[m]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kMaxAccTiles; ++m) {
    const int t = warp + m * kWarps;
    if (t < ntiles) {
      const int rt = t / ncol, ct = t - rt * ncol;
      wmma::store_matrix_sync(ob + rt * 16 * ldo + ct * 16, acc[m], ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  bf16* on = out + (size_t)n * Hout * Wout * Cout;
  for (int e = tid; e < kQ * Cout; e += kThreads) {
    const int q = e / Cout, co = e - q * Cout;
    const int qy = q / kTile, qx = q % kTile, oy = oy0 + qy, ox = ox0 + qx;
    if (oy >= Hout || ox >= Wout) continue;
    float y = round_bf16(relu_if(ob[q * ldo + co] + bp[co], relu_out));
    // stride 1, Cin == Cout: x(oy, ox) sits in the halo at (qy+P, qx+P);
    // the add is in bf16, after the cast, as in the reference
    if (residual) y += __bfloat162float(xs[((qy + P) * HT + qx + P) * ldx + co]);
    on[((size_t)oy * Wout + ox) * Cout + co] = __float2bfloat16(y);
  }
}

// ----------------------------------------------------------------- launch --

struct Args {
  const void *x, *we, *be, *wd, *bd, *wp, *bp;
  void* out;
  int N, H, W, Cin, Ce, Cout, has_expand, relu_dw, relu_out, residual;
};

template <typename T, typename Kernel>
int launch(Kernel kernel, const Args& a, int stride, size_t smem, cudaStream_t stream) {
  const int Hout = a.H / stride, Wout = a.W / stride;
  const int tiles_y = (Hout + kTile - 1) / kTile, tiles_x = (Wout + kTile - 1) / kTile;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(tiles_y * tiles_x, a.N), kThreads, smem, stream>>>(
      (const T*)a.x, (const T*)a.we, (const float*)a.be, (const float*)a.wd, (const float*)a.bd,
      (const T*)a.wp, (const float*)a.bp, (T*)a.out, a.H, a.W, a.Cin, a.Ce, a.Cout, Hout, Wout,
      tiles_x, a.has_expand, a.relu_dw, a.relu_out, a.residual);
  return (int)cudaGetLastError();
}

template <int K, int S>
int launch_ks(const Args& a, int dtype, cudaStream_t st) {
  if (dtype == 0)
    return launch<float>(ir_block_f32_kernel<K, S>, a, S, f32_smem_bytes(K, S, a.Cin, a.Cout), st);
  return launch<bf16>(ir_block_bf16_kernel<K, S>, a, S, bf16_layout(K, S, a.Cin, a.Cout).total, st);
}

}  // namespace

// x (N,H,W,Cin) NHWC; we (Cin,Ce) [null when !has_expand]; be (Ce,) f32
// [null when !has_expand]; wd (k*k,Ce) f32; bd (Ce,) f32; wp (Ce,Cout);
// bp (Cout,) f32; out (N,H/stride,W/stride,Cout). x/we/wp/out are float32
// (dtype 0) or bfloat16 (dtype 1). Returns the launch's cudaError_t.
extern "C" int fear_ir_block(const void* x, const void* we, const void* be, const void* wd,
                             const void* bd, const void* wp, const void* bp, void* out, int N,
                             int H, int W, int Cin, int Ce, int Cout, int k, int stride,
                             int has_expand, int relu_dw, int relu_out, int residual, int dtype,
                             void* stream) {
  if ((dtype != 0 && dtype != 1) || (dtype == 1 && round_up(Cout, 16) / 16 * (kQ / 16) > kMaxAccTiles * kWarps))
    return (int)cudaErrorInvalidValue;
  const Args a{x, we, be, wd, bd, wp, bp, out, N, H, W, Cin, Ce, Cout, has_expand, relu_dw, relu_out, residual};
  cudaStream_t st = (cudaStream_t)stream;
  if (k == 3 && stride == 1) return launch_ks<3, 1>(a, dtype, st);
  if (k == 3 && stride == 2) return launch_ks<3, 2>(a, dtype, st);
  if (k == 5 && stride == 1) return launch_ks<5, 1>(a, dtype, st);
  if (k == 5 && stride == 2) return launch_ks<5, 2>(a, dtype, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory, in bytes, that one launch of the kernel needs
// (dtype 0 float32, 1 bfloat16); -1 when the kernel does not take the shape.
extern "C" int fear_ir_block_smem_bytes(int k, int stride, int Cin, int Cout, int dtype) {
  if (dtype == 0) return (int)f32_smem_bytes(k, stride, Cin, Cout);
  if (round_up(Cout, 16) / 16 * (kQ / 16) > kMaxAccTiles * kWarps) return -1;
  return (int)bf16_layout(k, stride, Cin, Cout).total;
}

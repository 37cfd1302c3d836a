// Kernels K1, K7 and K8: the ATM transformer block and its window
// attention, for sm_90a.
//
// K7 / K8 (`window_attention_*`) replace `atmvfi_tpu/ops/
// attention_pallas.py::fused_window_attention_packed` (`_packed_kernel`)
// and `fused_window_attention` (`_kernel`): attention + motion moment
// from precomputed q [BW, N, C] and kv [BW, N, 2C] (packed), or q, k, v
// [BW, h, N, d] (head-major). One kernel serves both and K1's launch 2:
// it reads q, k, v and writes out and motion through (window, head,
// token) strides, so the q / kv column blocks of a qkv projection go in
// without a copy, and it reads the mask as mask[w % M] (no tiled copy
// over the batch). Bound: bytes at the base 1080p shapes (local, bf16:
// 6.4 GFLOP of products against 0.2 GB of q, kv and out, far below the
// card's operations per byte). The probabilities stay on chip and each
// q, k, v element is read once per (window, head). bf16 runs on the
// tensor cores (mma.sync m16n8k16, head dims 48, 84, 28 and 44 padded
// with zeros to 16 in shared memory, see `mma_attn`); f32 keeps scalar
// f32 FMAs on the CUDA cores as the parity mode (`attn_kernel`).
//
// K1 replaces `fused_atm_block` (`_block_kernel`). On packed windows
// x [BW, N, C]:
//   xn = LayerNorm(x) (f32 statistics, eps 1e-5), rounded to T
//   q  = xn @ Wq,  kv = xs @ Wkv, rounded to T, where xs is xn of the
//        partner window (i + BW/2) mod BW when `swap` (the other
//        frame's copy of the same window) and xn itself otherwise
//   per head: p = softmax(q k^T * scale + mask) in f32;
//        app = round_T(p) @ v; motion = (sum_k p*rel_x, sum_k p*rel_y)
//        from the f32 p
//   y  = xn + (round_T(app) @ Wproj + bproj)   (the residual goes onto
//        norm1(x), as in the reference model)
// T is float or bf16; every product accumulates in f32.
//
// Three launches behind one wrapper, intermediates in scratch buffers:
//   1. LayerNorm + [Wq | Wkv] projection of every token: one GEMM
//      [BW*N, C] x [C, 3C] that also stores xn for the residual. bf16
//      (namespace lg): a LayerNorm pass writes xn, once per row, and the
//      wgmma GEMM reads xn by TMA.
//      The swap is not applied here: launch 2 reads k and v from the
//      partner window by index, so the swapped tensor never exists.
//   2. attention + motion moment, one block per (window, head), k and
//      v of the partner window in shared memory: bf16 on the tensor
//      cores, one warp per 16 query rows (`mma_attn`); f32 with k and v
//      as f32 (odd row stride), each warp walking query rows with
//      scalar FMAs (`attn_kernel`). Windows of more than 160 keys (a
//      window size above 12) run key-tiled forms of both with an online
//      softmax, one block per (window, head, query block), k and v
//      streamed in 64-key tiles, so that shared memory does not grow
//      with the window: bf16 `mma_attn::attn_wg_tiled_kernel` (wgmma,
//      head dims up to 64) and `attn_mma_tiled_kernel` (mma.sync, above
//      64 and the general form), 128 query rows a block (the general
//      form 64); f32
//      `attn_tiled_kernel` (register-tiled on the CUDA cores). They read
//      the mask as one label a token and rel as one coordinate pair a
//      key where the wrapper finds them of that form (every mask and rel
//      the model builds), else stage mask and rel tiles beside k and v
//      (see "key-tiled forms" below).
//   3. projection GEMM with bias and the residual in its epilogue (bf16:
//      lg's GEMM without LayerNorm).
// A whole global window in bf16 is 144 x 672 x 2 B = 193 KB, more than
// a block can hold beside q, k and v, which is why the TPU's one-pass
// form is split here.
//
// Bound, bf16 at the 1080p shapes (PERF.md): launch 1 moves x, xn
// and qkv (local and enhance 0.25 GB, 0.075 ms at 3.35 TB/s, against
// 57.8 GFLOP, 0.058 ms at 989 TFLOP/s; the global block 46.8 GFLOP is
// bound by operations, 0.047 ms); launch 3 moves app, xn and y (0.045 /
// 0.021 ms). The bf16 GEMMs run wgmma with TMA-fed shared-memory tiles
// (lg); f32 runs on the CUDA cores in true f32 (the JAX kernel computes
// f32 at HIGHEST precision, so TF32 would not be the same function).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Arguments of one NT GEMM: out[m, n] = sum_k A[m, k] * W[n, k], where
// W is an nn.Linear weight [Nout, K]. MODE 0 normalises A's rows with
// (ln_g, ln_b) first and stores the normalised rows to xn_out; MODE 1
// adds bias[n] and resid[m, n] in the epilogue.
struct GemmArgs {
  const void* A;
  const void* W;
  void* out;
  int M, Nout, K;
  const float* ln_g;
  const float* ln_b;
  void* xn_out;
  const void* bias;
  const void* resid;
};

// Mean and 1/sqrt(var + eps) of rows [m0, m0 + ROWS) of A [M, K].
template <int ROWS, typename T>
__device__ void row_stats(const T* __restrict__ A, int M, int K, int m0,
                          float* s_mu, float* s_rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int r = warp; r < ROWS; r += nw) {
    const int m = m0 + r;
    float mu = 0.f, rs = 0.f;
    if (m < M) {
      const T* row = A + (int64_t)m * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += to_f(row[k]);
      mu = warp_sum(s) / K;
      float v = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float d = to_f(row[k]) - mu;
        v += d * d;
      }
      rs = 1.0f / sqrtf(warp_sum(v) / K + 1e-5f);
    }
    if (lane == 0) {
      s_mu[r] = mu;
      s_rs[r] = rs;
    }
  }
}

// ---- f32: CUDA-core GEMM, 64x64 tile, 4x4 outputs per thread -------
template <int MODE>
__global__ void __launch_bounds__(256) gemm_f32_kernel(GemmArgs g) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  __shared__ float s_mu[BM], s_rs[BM];
  const float* __restrict__ A = static_cast<const float*>(g.A);
  const float* __restrict__ W = static_cast<const float*>(g.W);
  float* out = static_cast<float*>(g.out);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = g.M, N = g.Nout, K = g.K;
  if (MODE == 0) {
    row_stats<BM>(A, M, K, m0, s_mu, s_rs);
    __syncthreads();
  }
  float acc[4][4] = {};
  const int lr = tid >> 2, lk = (tid & 3) * 4;  // loader: row, k offset
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + lr, k = k0 + lk + i;
      float v = 0.f;
      if (m < M && k < K) {
        v = A[(int64_t)m * K + k];
        if (MODE == 0) {
          v = (v - s_mu[lr]) * s_rs[lr] * g.ln_g[k] + g.ln_b[k];
          if (blockIdx.y == 0)
            static_cast<float*>(g.xn_out)[(int64_t)m * K + k] = v;
        }
      }
      As[lk + i][lr] = v;
      const int n = n0 + lr;
      Bs[lk + i][lr] = (n < N && k < K) ? W[(int64_t)n * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        b[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (MODE == 1)
        v = static_cast<const float*>(g.resid)[(int64_t)m * N + n] +
            (v + static_cast<const float*>(g.bias)[n]);
      out[(int64_t)m * N + n] = v;
    }
  }
}

// ---- bf16: the two GEMM launches on wgmma with TMA (namespace lg) -----
// out [M, N] = A [M, K] x W^T, W an nn.Linear weight [N, K] (K-major, as
// wgmma takes B). Tiles come by TMA from 2-D tensor maps (boxes of 64
// columns of K, 128-byte swizzled; K past its end, rows past M and
// columns past N are zero-filled and the k16 slices past K are not
// issued), one producer thread keeps a ring of stages full (full / empty
// mbarriers), and two consumer warpgroups issue wgmma m64nBNWk16 with
// both operands in shared memory and f32 sums in registers.
//  * gemm_kernel (launch 3, and launch 1 after ln_rows_kernel): one 128 x
//    BNW tile a block, each stage a k-chunk of A and of W, warpgroup g on
//    rows 64 g. BNW 128: 99 KB of shared memory and at most 113
//    registers a thread, so two blocks share an SM and one's epilogue
//    overlaps the other's products; BNW 224 (N = 2016 and 672, which it
//    divides; one block an SM) reads 27 % fewer bytes of A and W from L2
//    an output. Each tile reads its A and W from L2 once: at the local
//    and global shapes that traffic, ~5-6 TB/s, bounds it.
//    RESID adds the projection's bias and residual, y = xn + (sum +
//    bproj) in f32, rounded once; the residual tile comes by TMA while
//    the products run.
//  * ln_rows_kernel (launch 1's LayerNorm pass, K <= 1024) keeps the JAX
//    `_ln` order: f32 mean, then the mean squared deviation (eps 1e-5),
//    each value (x - mean) * rstd * g + b rounded to bf16 once. (A GEMM
//    that kept a block's rows of x whole in shared memory and normalised
//    them in place was no faster at the base shapes; PERF.md.)
// Epilogue (store_tile): stmatrix writes the rounded sums into padded
// shared-memory rows, stored from there as 16-byte vectors. (With the
// fragments shuffled into 16-byte pieces in registers and the residual
// read by 4-byte loads, the local launch 3 took 0.116 ms; with stmatrix
// and the residual by TMA, 0.089; PERF.md.)
namespace lg {
using namespace hopper;

constexpr int BK = 64;          // one 128-byte swizzled row of K
constexpr int BM = 128;         // gemm_kernel's rows a block
constexpr int CONSUMERS = 2;    // warpgroups
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of a block
constexpr int SMEM_HALF = 113 * 1024;  // ... of each of two blocks on an SM
constexpr int MAX_STAGES = 4;
constexpr int LN_UNITS = 4;     // ln_rows_kernel: K <= 32 * 8 * 4

struct Args {
  int M, N, K, nkc;
  int n_chunks, stages;
  const bf16* bias;   // RESID: [N]
  const bf16* resid;  // RESID: [M, N]
  bf16* out;          // [M, N]
};

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// LayerNorm arithmetic on one 16-byte unit of 8 bf16 values.
__device__ __forceinline__ float sum8(const uint4& u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) s += bf_lo(w[i]) + bf_hi(w[i]);
  return s;
}
__device__ __forceinline__ float sqdev8(const uint4& u, float mu) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d0 = bf_lo(w[i]) - mu, d1 = bf_hi(w[i]) - mu;
    s += d0 * d0 + d1 * d1;
  }
  return s;
}
// (x - mu) * rs * g + b for the unit's 8 values; g, b point at its first
// column (16-byte aligned)
__device__ __forceinline__ uint4 norm8(const uint4& u, float mu, float rs,
                                       const float* __restrict__ g,
                                       const float* __restrict__ b) {
  const float4 g0 = __ldg(reinterpret_cast<const float4*>(g));
  const float4 g1 = __ldg(reinterpret_cast<const float4*>(g) + 1);
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(b));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(b) + 1);
  const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = pack_bf16x2((bf_lo(w[i]) - mu) * rs * gg[2 * i] + bb[2 * i],
                       (bf_hi(w[i]) - mu) * rs * gg[2 * i + 1] +
                           bb[2 * i + 1]);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Launch 1's LayerNorm pass: xn = LN(x) for rows of K bf16, one warp a
// row, unit j = lane + 32 t of the row in u[t], 16-byte loads and stores
// (K % 8 == 0, rows 16-byte aligned).
__global__ void __launch_bounds__(256)
    ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ b, bf16* __restrict__ xn, int M,
                   int K) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= M) return;
  const int units = K / 8;
  const uint4* src = reinterpret_cast<const uint4*>(x + (long long)row * K);
  uint4* dst = reinterpret_cast<uint4*>(xn + (long long)row * K);
  uint4 u[LN_UNITS];
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < LN_UNITS; ++t) {
    u[t] = lane + 32 * t < units ? src[lane + 32 * t] : make_uint4(0, 0, 0, 0);
    s += sum8(u[t]);  // zero units add 0
  }
  const float mu = warp_sum(s) / K;
  float v = 0.f;
#pragma unroll
  for (int t = 0; t < LN_UNITS; ++t)
    if (lane + 32 * t < units) v += sqdev8(u[t], mu);
  const float rs = 1.0f / sqrtf(warp_sum(v) / K + 1e-5f);
#pragma unroll
  for (int t = 0; t < LN_UNITS; ++t) {
    const int j = lane + 32 * t;
    if (j < units) dst[j] = norm8(u[t], mu, rs, g + 8 * j, b + 8 * j);
  }
}

// Epilogue of a warp's 16 x BNW block: sum (lane / 4 + 8 h, 8 j + 2 (lane
// % 4) + e) is acc[4 j + 2 h + e]. The sums (with RESID + bias and the
// residual, read from the swizzled tile `rtile` at tile row rrow0 .. and
// column 0 ..) are rounded to bf16 pairs, written by stmatrix into the
// warp's staging rows `stg` and stored from there as 16-byte vectors,
// whole rows at a time, at rows row0 .. and columns col0 ..
template <int BNW, bool RESID>
__device__ __forceinline__ void store_tile(const float (&acc)[BNW / 2],
                                           const Args& a, int row0, int col0,
                                           int lane, bf16* stg,
                                           const unsigned char* rtile,
                                           int rrow0) {
  constexpr int SROW = BNW + 8;
  const int q = lane & 3, r = lane >> 2;
  uint32_t pk[BNW / 8][2];
#pragma unroll
  for (int j = 0; j < BNW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (RESID) {
        const int R = rrow0 + r + 8 * h, n = col0 + 8 * j + 2 * q;
        const uint32_t res = *reinterpret_cast<const uint32_t*>(
            rtile + (j / 8) * (BM * 128) + R * 128 +
            (((j % 8) ^ (R & 7)) << 4) + 4 * q);
        const uint32_t bb =
            n < a.N ? *reinterpret_cast<const uint32_t*>(a.bias + n) : 0u;
        v0 = bf_lo(res) + (v0 + bf_lo(bb));
        v1 = bf_hi(res) + (v1 + bf_hi(bb));
      }
      pk[j][h] = pack_bf16x2(v0, v1);
    }
  // matrices (j, h = 0), (j, 1), (j + 1, 0), (j + 1, 1); lane i addresses
  // row i % 8 (+ 8 for odd i / 8) of column group j + i / 16
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
  const uint32_t base = smem_u32(stg + lr * SROW + lc);
#pragma unroll
  for (int j = 0; j < BNW / 8; j += 2)
    stsm_x4(base + 16 * j, pk[j][0], pk[j][1], pk[j + 1][0], pk[j + 1][1]);
  __syncwarp();
  constexpr int P = BNW / 8;  // 16-byte pieces of a staged row
#pragma unroll 4
  for (int i = lane; i < 16 * P; i += 32) {
    const int rr = i / P, cp = i % P;
    const int m = row0 + rr, n = col0 + 8 * cp;
    if (m < a.M && n < a.N)
      *reinterpret_cast<uint4*>(a.out + (long long)m * a.N + n) =
          *reinterpret_cast<const uint4*>(stg + rr * SROW + 8 * cp);
  }
  __syncwarp();
}

// One 128 x BNW tile a block (n-chunks fastest, so the blocks sharing an
// A tile run together); each ring stage holds a 64-column chunk of A and
// of W. RESID: the residual's 128 x BNW tile comes by TMA (two swizzled
// [64, 128] boxes) while the products run. The epilogue stages its rows
// in the ring, whose loads are all consumed by then.
template <int BNW, bool RESID>
__global__ void __launch_bounds__(THREADS, BNW > 128 ? 1 : 2)
    gemm_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ CUtensorMap rmap,
                const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int A_BYTES = BM * 128, STAGE = (BM + BNW) * 128;
  constexpr int R_BOXES = (BNW + 63) / 64;  // [64, 128] boxes of residual
  constexpr int R_BYTES = RESID ? R_BOXES * BM * 128 : 0;
  unsigned char* rtile = ring + a.stages * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(rtile + R_BYTES);
  uint64_t* empty = full + a.stages;
  uint64_t* r_full = empty + a.stages;
  const int nc = blockIdx.x % a.n_chunks;
  const int m0 = (blockIdx.x / a.n_chunks) * BM, n0 = nc * BNW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(r_full, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {  // producer
    if (lane == 0)
      ss_produce<A_BYTES, STAGE>(&amap, &bmap, ring, full, empty, a.nkc,
                                 a.stages, m0, n0, [&] {
                                   if (!RESID) return;
                                   mbar_expect_tx(r_full, R_BYTES);
                                   for (int i = 0; i < R_BOXES; ++i)
                                     tma_load_2d(rtile + i * BM * 128, &rmap,
                                                 r_full, n0 + 64 * i, m0);
                                 });
    return;
  }

  const int cg = warp / 4;
  float acc[BNW / 2];
#pragma unroll
  for (int i = 0; i < BNW / 2; ++i) acc[i] = 0.0f;
  ss_consume<BNW, A_BYTES, STAGE>(acc, ring, full, empty, a.nkc, a.stages,
                                  a.K, cg);
  named_barrier(1, 128 * CONSUMERS);  // both warpgroups are off the ring
  if (RESID) mbar_wait(r_full, 0);
  const int rrow0 = 64 * cg + 16 * (warp & 3);
  store_tile<BNW, RESID>(
      acc, a, m0 + rrow0, n0, lane,
      reinterpret_cast<bf16*>(ring) + warp * 16 * (BNW + 8), rtile, rrow0);
}

// Block shapes; false for a shape the kernels do not take.
struct Plan {
  int bnw, stages, smem;
};

inline bool shape_ok(int N, int K) {
  return N >= 8 && N % 8 == 0 && K >= 8 && K % 8 == 0;
}

inline bool plan_stream(int N, int K, bool resid, Plan* p) {
  if (!shape_ok(N, K)) return false;
  const int cands[2] = {128, 224};
  const int bnw = least_padded(N, cands);
  const int stage = (BM + bnw) * 128;
  const int fixed = 1024 + (resid ? (bnw + 63) / 64 * BM * 128 : 0) +
                    (2 * MAX_STAGES + 1) * 8;
  // two blocks an SM up to 128 columns, one above
  int stages = ((bnw > 128 ? SMEM_MAX : SMEM_HALF) - fixed) / stage;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  *p = Plan{bnw, stages, fixed + stages * stage};
  // the epilogue stages 8 warps' rows in the ring
  return stages >= 2 && stages * stage >= 8 * 16 * (bnw + 8) * 2;
}

template <typename Kernel, typename... Maps>
cudaError_t launch(Kernel kernel, int smem, long long blocks,
                   cudaStream_t st, const Args& a, const Maps&... maps) {
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(int)blocks, THREADS, smem, st>>>(maps..., a);
  return cudaGetLastError();
}

inline Args args_for(int M, int N, int K, const Plan& pl, void* out) {
  Args a{};
  a.M = M;
  a.N = N;
  a.K = K;
  a.nkc = (K + BK - 1) / BK;
  a.n_chunks = (N + pl.bnw - 1) / pl.bnw;
  a.stages = pl.stages;
  a.out = static_cast<bf16*>(out);
  return a;
}

// out [M, N] = A [M, K] x W^T (+ bias and resid with RESID) through W's
// map `wmap` (atm_block_weight_map).
template <bool RESID>
cudaError_t gemm(const void* A, const void* wmap, void* out, int M, int N,
                 int K, const void* bias, const void* resid,
                 cudaStream_t st) {
  Plan pl;
  if (M < 1 || !plan_stream(N, K, RESID, &pl)) return cudaErrorInvalidValue;
  alignas(64) CUtensorMap amap, bmap, rmap;
  if (encode_rows(&amap, A, M, K, BM)) return cudaErrorInvalidValue;
  memcpy(&bmap, wmap, sizeof(bmap));
  rmap = amap;
  if (RESID && encode_rows(&rmap, resid, M, N, BM))
    return cudaErrorInvalidValue;
  Args a = args_for(M, N, K, pl, out);
  a.bias = static_cast<const bf16*>(bias);
  a.resid = static_cast<const bf16*>(resid);
  const long long blocks = (long long)(M + BM - 1) / BM * a.n_chunks;
  if (pl.bnw == 224)
    return launch(gemm_kernel<224, RESID>, pl.smem, blocks, st, a, amap,
                  bmap, rmap);
  return launch(gemm_kernel<128, RESID>, pl.smem, blocks, st, a, amap, bmap,
                rmap);
}

// Launch 1's LayerNorm pass.
inline cudaError_t ln_rows(const void* x, const float* g, const float* b,
                           void* xn, int M, int K, cudaStream_t st) {
  if (K % 8 || K > 32 * 8 * LN_UNITS) return cudaErrorInvalidValue;
  ln_rows_kernel<<<(M + 7) / 8, 256, 0, st>>>(
      static_cast<const bf16*>(x), g, b, static_cast<bf16*>(xn), M, K);
  return cudaGetLastError();
}

}  // namespace lg

// ---- attention + motion moment, one block per (window, head) -------
// Shared by K1 (launch 2 of the block) and the window-attention entry
// points K7 / K8, which read q, k and v at any strides.
constexpr int ATT_WARPS = 4;
constexpr int MAX_KEYS = 5;  // single-pass f32 form: 5 keys per lane
// Windows of up to this many keys run the single-pass forms (the main
// path's 8 x 8 and 12 x 12); larger ones the key-tiled forms.
constexpr int SINGLE_PASS_KEYS = 32 * MAX_KEYS;
constexpr int MAX_DIMS = 4;  // head_dim <= 128: 4 per lane

// One operand: element (window w, head, token n, channel d) at
// ptr[w * sw + head * sh + n * sn + d].
struct View {
  void* ptr;
  long long sw, sh, sn;
};

struct AttnArgs {
  View q, k, v, out;
  View motion;        // (mx, my) at d = 0, 1; ptr null: no motion
  const float* rel;   // [2, N, N]; null: no motion
  const float* mask;  // [mask_windows, N, N], window w reads w % M; or null
  // The compact forms of mask and rel, read by the key-tiled forms
  // alone (null: the general form stages mask and rel tiles instead):
  // labels [mask_windows, N], mask[w, q, k] = MASK_NEG where
  // labels[w, q] != labels[w, k], else 0; coords [2, N], rel[d, q, k] =
  // coords[d, k] - coords[d, q].
  const int* labels;
  const float* coords;
  int mask_windows, BW, N, hd, swap;  // swap: k, v of window (w + BW/2) % BW
  float scale;
  int width;  // bytes per copied piece of q, k, v, out (set by launch_attn)
};

template <typename T>
__device__ __forceinline__ T* at(const View& v, int w, int head, int n) {
  return static_cast<T*>(v.ptr) + (int64_t)w * v.sw + (int64_t)head * v.sh +
         (int64_t)n * v.sn;
}

template <typename T>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attn_kernel(const __grid_constant__ AttnArgs a) {
  extern __shared__ float sm[];
  const int head = blockIdx.x, w = blockIdx.y;
  const int N = a.N, hd = a.hd;
  const int hdp = hd | 1;  // odd row stride: conflict-free column reads
  float* Ks = sm;
  float* Vs = Ks + N * hdp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Qw = Vs + N * hdp + warp * (hdp + N);  // this warp's q row
  float* Pw = Qw + hdp;                         // and probabilities
  const int kw = a.swap ? (w + a.BW / 2) % a.BW : w;  // kv source window
  const T* kbase = at<T>(a.k, kw, head, 0);
  const T* vbase = at<T>(a.v, kw, head, 0);
  for (int e = threadIdx.x; e < N * hd; e += blockDim.x) {
    const int n = e / hd, d = e - n * hd;
    Ks[n * hdp + d] = to_f(kbase[(int64_t)n * a.k.sn + d]);
    Vs[n * hdp + d] = to_f(vbase[(int64_t)n * a.v.sn + d]);
  }
  __syncthreads();
  const float* rel = a.rel;
  const float* mwin =
      a.mask ? a.mask + (int64_t)(w % a.mask_windows) * N * N : nullptr;
  for (int q = warp; q < N; q += ATT_WARPS) {
    const T* qrow = at<T>(a.q, w, head, q);
    for (int d = lane; d < hd; d += 32) Qw[d] = to_f(qrow[d]);
    __syncwarp();
    float s[MAX_KEYS];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAX_KEYS; ++j) {
      const int k = lane + 32 * j;
      s[j] = -INFINITY;
      if (k < N) {
        const float* kr = Ks + k * hdp;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(Qw[d], kr[d], acc);
        acc *= a.scale;
        if (mwin) acc += mwin[q * N + k];
        s[j] = acc;
        mx = fmaxf(mx, acc);
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_KEYS; ++j) {
      const int k = lane + 32 * j;
      s[j] = k < N ? expf(s[j] - mx) : 0.f;
      sum += s[j];
    }
    sum = warp_sum(sum);
    float mxs = 0.f, mys = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_KEYS; ++j) {
      const int k = lane + 32 * j;
      if (k < N) {
        const float p = s[j] / sum;
        if (rel) {
          mxs = fmaf(p, rel[(int64_t)q * N + k], mxs);
          mys = fmaf(p, rel[(int64_t)N * N + (int64_t)q * N + k], mys);
        }
        Pw[k] = round_t<T>(p);  // attn @ v takes p in the working type
      }
    }
    if (rel) {
      mxs = warp_sum(mxs);
      mys = warp_sum(mys);
      if (lane == 0) {
        T* mo = at<T>(a.motion, w, head, q);
        mo[0] = from_f<T>(mxs);
        mo[1] = from_f<T>(mys);
      }
    }
    __syncwarp();
    float o[MAX_DIMS] = {};
    for (int k = 0; k < N; ++k) {
      const float p = Pw[k];
      const float* vr = Vs + k * hdp;
#pragma unroll
      for (int t = 0; t < MAX_DIMS; ++t) {
        const int d = lane + 32 * t;
        if (d < hd) o[t] = fmaf(p, vr[d], o[t]);
      }
    }
    T* orow = at<T>(a.out, w, head, q);
#pragma unroll
    for (int t = 0; t < MAX_DIMS; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) orow[d] = from_f<T>(o[t]);
    }
    __syncwarp();  // Qw / Pw are rewritten by the next query row
  }
}

// ---- bf16 attention + motion moment on the tensor cores -------------
// One block per (window, head), one warp per 16 query rows: N = 64 runs
// 4 warps, N = 144 runs 9. q, k and v of the (window, head) land in
// shared memory as bf16 through cp.async (16-, 8- or 4-byte pieces, the
// widest that the pointers, strides and head dim allow: a head's channel
// offset is 16-byte aligned at hd 48, 8-byte aligned at 84, 28 and 44);
// the head dim is padded with zeros to a multiple of 16, the tokens to
// the warp count times 16. Each warp computes its 16 x N score block
// with mma.sync m16n8k16 (q fragments by ldmatrix, k as the col-major B
// operand by ldmatrix), keeps it in registers (N = 144: 18 n8 tiles, 72
// f32 a thread), takes row max and row sum with quad shuffles and reads
// mask and rel at its own (q, k) positions (f32 pairs, 8-byte loads from
// L1 / L2). The exponentials are ex2.approx on FFMA-folded arguments and
// one reciprocal per row: the softmax, not the products, was what the
// SM spent its issue slots on (clock64 phase counts on an H100). The
// f32 probabilities give the motion moments; rounded to bf16 they are
// the A fragments of P @ V as they lie in the accumulators (no trip
// through shared memory), and v's B fragments come by ldmatrix.trans.
// v's copy is a second cp.async group that lands while the scores are
// computed. The output is staged in the warp's own q rows and written
// with the same piece width. Key columns past N get -inf before the
// max; rows past N are computed on zeros and never stored.
namespace mma_attn {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy one `width`-byte piece (16, 8, 4: cp.async; 2: a plain copy).
__device__ __forceinline__ void copy_piece(void* dst, const void* src,
                                           int width) {
  const unsigned d = smem_u32(dst);
  if (width == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else if (width == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else if (width == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  else
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
}

// Rows [0, n) of `head` of window w of one operand into shared rows
// `ld` elements apart. Each thread keeps one piece of a row and steps
// down the rows (no division in the loop).
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const View& v,
                                          int w, int head, int n, int bytes,
                                          int width) {
  const int per = bytes / width, pass = blockDim.x / per;
  if (pass == 0) {  // rows of more pieces than threads
    for (int e = threadIdx.x; e < n * per; e += blockDim.x) {
      const int r = e / per, c = (e - r * per) * width;
      copy_piece(reinterpret_cast<char*>(dst + r * ld) + c,
                 reinterpret_cast<const char*>(at<bf16>(v, w, head, r)) + c,
                 width);
    }
    return;
  }
  const int r0 = threadIdx.x / per, c = (threadIdx.x - r0 * per) * width;
  if (r0 >= pass) return;
  char* d = reinterpret_cast<char*>(dst + r0 * ld) + c;
  const char* s = reinterpret_cast<const char*>(at<bf16>(v, w, head, r0)) + c;
  for (int r = r0; r < n;
       r += pass, d += pass * ld * 2, s += pass * v.sn * 2)
    copy_piece(d, s, width);
}

// Store rows [0, n) of a warp's staged output (shared rows `ld` apart)
// to rows [row0, row0 + n) of `head` of window w.
__device__ __forceinline__ void store_rows(const bf16* src, int ld,
                                           const View& v, int w, int head,
                                           int row0, int n, int bytes,
                                           int width, int lane) {
  auto put = [&](int r, int c) {
    const char* s = reinterpret_cast<const char*>(src + r * ld) + c * width;
    char* d =
        reinterpret_cast<char*>(at<bf16>(v, w, head, row0 + r)) + c * width;
    if (width == 16)
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    else if (width == 8)
      *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
    else if (width == 4)
      *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
    else
      *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s);
  };
  const int per = bytes / width;  // pieces of a row
  if (per <= 32) {
    const int pass = 32 / per, r0 = lane / per, c = lane - r0 * per;
    if (r0 < pass)
      for (int r = r0; r < n; r += pass) put(r, c);
  } else {
    for (int e = lane; e < n * per; e += 32) put(e / per, e % per);
  }
}

// Zero channels [hd, dp) of rows [0, n) and every channel of rows
// [n, rows) of `bufs` buffers of `rows` rows each.
template <typename T>
__device__ __forceinline__ void zero_pad(T* buf, int bufs, int rows, int n,
                                         int hd, int dp, int ld) {
  const T zero = from_f<T>(0.0f);
  const int padc = dp - hd, padr = rows - n;
  if (padc)
    for (int e = threadIdx.x; e < bufs * n * padc; e += blockDim.x) {
      const int r = e / padc, b = r / n;
      buf[(b * rows + r - b * n) * ld + hd + e - r * padc] = zero;
    }
  if (padr)
    for (int e = threadIdx.x; e < bufs * padr * dp; e += blockDim.x) {
      const int r = e / dp, b = r / padr;
      buf[(b * rows + n + r - b * padr) * ld + e - r * dp] = zero;
    }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two neighbouring f32 (the second only if `two`), as one 8-byte load
// where `pair` says the address allows it.
__device__ __forceinline__ float2 ld2(const float* p, bool two, bool pair) {
  if (pair) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(__ldg(p), two ? __ldg(p + 1) : 0.0f);
}

// Scale, mask and softmax (f32) of a warp's scores for query rows
// [r0, r0 + 16): element e of tile j is row r0 + g + 8 (e >> 1), key
// 8j + 2 tig + (e & 1). Leaves the f32 probabilities in s and writes the
// motion moments from them. FULL: N is a multiple of 16, so no row or
// key lies past N and every mask / rel pair is one 8-byte load at an
// offset fixed at compile time from the thread's row pointers.
template <int KT, bool FULL>
__device__ __forceinline__ void softmax_motion(float (&s)[2 * KT][4],
                                               const AttnArgs& a, int w,
                                               int head, int r0, int lane) {
  const int N = a.N, kt = (N + 15) >> 4;
  const int g = lane >> 2, tig = lane & 3;
  const bool pair = FULL || N % 2 == 0;  // (q N + k) even
  const int qr[2] = {r0 + g, r0 + g + 8};
  const float* mrow[2] = {nullptr, nullptr};
  const float* rrow[2] = {nullptr, nullptr};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (FULL || qr[h] < N) {
      if (a.mask)
        mrow[h] = a.mask + ((int64_t)(w % a.mask_windows) * N + qr[h]) * N +
                  tig * 2;
      if (a.rel) rrow[h] = a.rel + qr[h] * N + tig * 2;
    }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    if (j >= 2 * kt) break;
    const int k = j * 8 + tig * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = -INFINITY, v1 = -INFINITY;
      if (FULL || k < N) {
        float2 m = make_float2(0.0f, 0.0f);
        if (mrow[h]) m = ld2(mrow[h] + j * 8, FULL || k + 1 < N, pair);
        v0 = __fadd_rn(__fmul_rn(s[j][2 * h], a.scale), m.x);
        if (FULL || k + 1 < N)
          v1 = __fadd_rn(__fmul_rn(s[j][2 * h + 1], a.scale), m.y);
      }
      s[j][2 * h] = v0;
      s[j][2 * h + 1] = v1;
      mx[h] = fmaxf(mx[h], fmaxf(v0, v1));
    }
  }
  // e^(v - max) = 2^(v log2 e - max log2 e): one FFMA and one ex2.approx
  // (2 ulp; p is rounded to bf16 for p @ v, motion keeps ~1e-7 relative)
  const float l2e = 1.4426950408889634f;
  float mb[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    mb[h] = mx[h] * l2e;
  }
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    if (j >= 2 * kt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = ex2(fmaf(s[j][e], l2e, -mb[e >> 1]));
      sum[e >> 1] += s[j][e];
    }
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    inv[h] = 1.0f / sum[h];
  }
  float mo[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    if (j >= 2 * kt) break;
    const int k = j * 8 + tig * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p0 = s[j][2 * h] * inv[h], p1 = s[j][2 * h + 1] * inv[h];
      s[j][2 * h] = p0;
      s[j][2 * h + 1] = p1;
      if (rrow[h] && (FULL || k < N)) {
        const float2 rx = ld2(rrow[h] + j * 8, FULL || k + 1 < N, pair);
        const float2 ry = ld2(rrow[h] + N * N + j * 8, FULL || k + 1 < N, pair);
        mo[h][0] = fmaf(p1, rx.y, fmaf(p0, rx.x, mo[h][0]));
        mo[h][1] = fmaf(p1, ry.y, fmaf(p0, ry.x, mo[h][1]));
      }
    }
  }
  if (a.rel) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        mo[h][c] += __shfl_xor_sync(0xffffffffu, mo[h][c], 1);
        mo[h][c] += __shfl_xor_sync(0xffffffffu, mo[h][c], 2);
      }
    if (tig == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (FULL || qr[h] < N) {
          bf16* m = at<bf16>(a.motion, w, head, qr[h]);
          m[0] = __float2bfloat16_rn(mo[h][0]);
          m[1] = __float2bfloat16_rn(mo[h][1]);
        }
  }
}

template <int KT, int DT>  // most 16-token tiles, 16-channel head tiles
__global__ void __launch_bounds__(KT * 32)
attn_mma_kernel(const __grid_constant__ AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem_attn[];
  const int head = blockIdx.x, w = blockIdx.y;
  const int N = a.N, hd = a.hd;
  const int kt = (N + 15) >> 4, dt = (hd + 15) >> 4;
  const int np = kt * 16, dp = dt * 16, ld = dp + 8;  // ld*2: odd x 16 B
  bf16* Qs = reinterpret_cast<bf16*>(smem_attn);  // [np][ld] each
  bf16* Ks = Qs + np * ld;
  bf16* Vs = Ks + np * ld;
  const int kw = a.swap ? (w + a.BW / 2) % a.BW : w;  // kv source window
  load_rows(Qs, ld, a.q, w, head, N, 2 * hd, a.width);
  load_rows(Ks, ld, a.k, kw, head, N, 2 * hd, a.width);
  cp_async_commit();
  load_rows(Vs, ld, a.v, kw, head, N, 2 * hd, a.width);
  cp_async_commit();
  zero_pad(Qs, 3, np, N, hd, dp, ld);
  cp_async_wait<1>();  // q and k
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3, r0 = warp * 16;
  bf16* Qw = Qs + r0 * ld;
  float s[2 * KT][4];
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    if (kk >= dt) break;
    uint32_t qa[4];
    ldsm_x4(qa, Qw + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j >= kt) break;
      uint32_t kb[4];
      ldsm_x4(kb, Ks + (j * 16 + (lane >> 4) * 8 + (lane & 7)) * ld +
                      kk * 16 + ((lane >> 3) & 1) * 8);
      mma16816(s[2 * j], qa, kb[0], kb[1]);
      mma16816(s[2 * j + 1], qa, kb[2], kb[3]);
    }
  }
  if (N == np)
    softmax_motion<KT, true>(s, a, w, head, r0, lane);
  else
    softmax_motion<KT, false>(s, a, w, head, r0, lane);

  // p rounded to bf16: the accumulators of tiles 2kk, 2kk+1 are the A
  // fragment of keys [16kk, 16kk + 16)
  uint32_t pa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    if (kk >= kt) break;
    pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
  cp_async_wait<0>();  // v
  __syncthreads();
  float o[2 * DT][4];
#pragma unroll
  for (int j = 0; j < 2 * DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    if (kk >= kt) break;
#pragma unroll
    for (int nt = 0; nt < DT; ++nt) {
      if (nt >= dt) break;
      uint32_t vb[4];
      ldsm_x4_t(vb, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                        nt * 16 + (lane >> 4) * 8);
      mma16816(o[2 * nt], pa[kk], vb[0], vb[1]);
      mma16816(o[2 * nt + 1], pa[kk], vb[2], vb[3]);
    }
  }
  // stage the rounded rows in this warp's q rows, then write them out
#pragma unroll
  for (int j = 0; j < 2 * DT; ++j) {
    if (j >= 2 * dt) break;
    const int c = j * 8 + tig * 2;
    *reinterpret_cast<__nv_bfloat162*>(Qw + g * ld + c) =
        __floats2bfloat162_rn(o[j][0], o[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(Qw + (g + 8) * ld + c) =
        __floats2bfloat162_rn(o[j][2], o[j][3]);
  }
  __syncwarp();
  store_rows(Qw, ld, a.out, w, head, r0, min(16, N - r0), 2 * hd, a.width,
             lane);
}

// m64n64k16 bf16 -> f32, A and B K-major from shared memory (128-byte
// swizzle descriptors); d = (accumulate ? d : 0) + A B^T. d[j][e]: n8
// tile j, e as in mma.sync's accumulator (rows g, g + 8 of the warp).
__device__ __forceinline__ void wg_qk(float (&d)[8][4], uint64_t a,
                                      uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// m64n32k16 bf16 -> f32, A (p) from registers in mma.sync's fragment
// layout, B (v) N-major from shared memory (transposed, 128-byte swizzle
// descriptor): d += A B.
__device__ __forceinline__ void wg_pv32(float (&d)[4][4],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// m64n48k16 bf16 -> f32, A (p) from registers in mma.sync's fragment
// layout, B (v) N-major from shared memory (transposed, 128-byte swizzle
// descriptor): d += A B.
__device__ __forceinline__ void wg_pv48(float (&d)[6][4],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// m64n64k16 bf16 -> f32, A (p) from registers in mma.sync's fragment
// layout, B (v) N-major from shared memory (transposed, 128-byte swizzle
// descriptor): d += A B.
__device__ __forceinline__ void wg_pv64(float (&d)[8][4],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- key-tiled forms (windows above 12): shared pieces --------------
// A block holds TQ query rows of one (window, head) at a time and walks
// the keys in tiles of TKEYS through a ring of shared-memory stages
// filled by cp.async, keeping an online softmax (running max m, sum l,
// the output and motion accumulators, rescaled at each tile).
//
// What a block reads besides q, k and v:
// * compact form (every mask and rel the model builds): the window's N
//   token labels (a region mask is exactly MASK_NEG where the labels of
//   q and k differ) and the N key coordinates (rel[d, q, k] = c_d(k) -
//   c_d(q), so the motion moment is sum_k p c(k) / l - c(q)): 12 bytes
//   a token instead of 12 bytes a score. The labels come with one flag
//   a mask window (labels [M, N], then M ints: 1 where they differ); a
//   window whose labels are all equal (no shift or pad region in it)
//   skips the mask;
// * general form (any other mask or rel: the wrapper's exact check
//   failed): the tile's mask and rel rows [TQ, TKEYS], staged in shared
//   memory beside its k and v, 16-byte pieces where N % 4 == 0.
constexpr int TKEYS = 64;
constexpr float MASK_NEG = -100.0f;  // the region masks' value

// Byte offsets of a key-tiled block's shared memory after its q (and,
// f32, P) buffers of `head` bytes: a stage is k and v (`kv` bytes) then,
// in the general form, the mask and rel tiles (`side` bytes each); then
// the compact form's labels (np + 4 ints: the labels, keys past N, the
// window's flag) and key coordinates (np float2), np = N rounded up to
// TKEYS.
struct TiledSmem {
  int stage, side_m, side_r, lab, crd, total;
};
__host__ __device__ inline TiledSmem tiled_smem(int head, int kv, int side,
                                                int stages, bool general,
                                                bool mask, bool rel,
                                                int N) {
  TiledSmem s;
  const int np = (N + TKEYS - 1) / TKEYS * TKEYS;
  s.side_m = kv;
  s.side_r = kv + (general && mask ? side : 0);
  s.stage = s.side_r + (general && rel ? 2 * side : 0);
  s.lab = head + stages * s.stage;
  s.crd = s.lab + (!general && mask ? (np + 4) * 4 : 0);
  s.total = s.crd + (!general && rel ? np * 8 : 0);
  return s;
}

// Rows [0, nq) x keys [0, nk) of one f32 [N, N] plane (already offset to
// the tile's first row and key) into shared rows `ldm` floats apart;
// keys [nk, TKEYS) are zeroed (p is 0 there, and 0 x stale data may
// not be).
__device__ __forceinline__ void load_side(float* dst, int ldm,
                                          const float* src, int N, int nq,
                                          int nk) {
  const int width =
      N % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 ? 16 : 4;
  const int per = nk * 4 / width;
  for (int e = threadIdx.x; e < nq * per; e += blockDim.x) {
    const int r = e / per, c = (e - r * per) * width;
    copy_piece(reinterpret_cast<char*>(dst + r * ldm) + c,
               reinterpret_cast<const char*>(src + (int64_t)r * N) + c,
               width);
  }
  if (nk < TKEYS)
    for (int e = threadIdx.x; e < nq * (TKEYS - nk); e += blockDim.x) {
      const int r = e / (TKEYS - nk);
      dst[r * ldm + nk + e - r * (TKEYS - nk)] = 0.0f;
    }
}

// The labels of one window and its flag (labels [M, N], then M flags)
// into a label buffer, by cp.async.
__device__ __forceinline__ void load_labels(int* dst, const AttnArgs& a,
                                            int w, int np) {
  const int N = a.N, m = w % a.mask_windows;
  const int* src = a.labels + (int64_t)m * N;
  const int width =
      N % 4 == 0 && reinterpret_cast<uintptr_t>(a.labels) % 16 == 0 ? 16 : 4;
  const int per = width / 4;
  for (int i = threadIdx.x * per; i < N; i += blockDim.x * per)
    copy_piece(dst + i, src + i, width);
  if (threadIdx.x == 0)
    copy_piece(dst + np, a.labels + (int64_t)a.mask_windows * N + m, 4);
}

// The key coordinates, interleaved (x, y) a key, keys [N, np) zero.
__device__ __forceinline__ void load_coords(float2* crd, const AttnArgs& a,
                                            int np) {
  for (int i = threadIdx.x; i < np; i += blockDim.x)
    crd[i] = i < a.N ? make_float2(a.coords[i], a.coords[a.N + i])
                     : make_float2(0.0f, 0.0f);
}

// One thread's share of copying rows of `bytes` bytes in `width`-byte
// pieces, fixed once a kernel: byte c of rows r0, r0 + pass, ... (none
// when r0 >= pass). Rows of at most blockDim.x pieces.
struct RowPlan {
  int r0, c, pass;
};
__device__ __forceinline__ RowPlan row_plan(int bytes, int width) {
  const int per = bytes / width, r0 = (int)threadIdx.x / per;
  return RowPlan{r0, ((int)threadIdx.x - r0 * per) * width,
                 (int)blockDim.x / per};
}
// Rows [0, n) of src (rows `sn` elements apart) into shared rows `ld`
// elements apart, by cp.async.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          int64_t sn, int n,
                                          const RowPlan& p, int width) {
  if (p.r0 >= p.pass) return;
  char* d = reinterpret_cast<char*>(dst + p.r0 * ld) + p.c;
  const char* s = reinterpret_cast<const char*>(src + p.r0 * sn) + p.c;
  for (int r = p.r0; r < n; r += p.pass, d += p.pass * ld * (int)sizeof(T),
           s += p.pass * sn * (int64_t)sizeof(T))
    copy_piece(d, s, width);
}

// Block `item` of a key-tiled launch: (window, head, first query row),
// the query blocks of one (window, head) next to each other, so that
// blocks running at the same time share its k and v in L2.
struct Item {
  int w, head, q0;
};
__device__ __forceinline__ Item item_of(int item, int heads, int nqb,
                                        int tq) {
  const int qb = item % nqb, rest = item / nqb;
  return Item{rest / heads, rest % heads, qb * tq};
}

// ---- bf16 attention over windows of any size: key tiles, online softmax
// Replaces, for N > 160 keys (windows above 12), what attn_mma_kernel
// does for the main path's windows, i.e. K1's attention launch
// (`atmvfi_tpu/ops/attention_pallas.py::fused_atm_block`), K7
// (`fused_window_attention_packed`) and K8 (`fused_window_attention`).
// Two kernels: attn_wg_tiled_kernel (below; the compact form at head
// dims up to 64, the model's local and enhancement sites and all lite
// sites) and this one, on mma.sync (the compact form at head dims 65-128,
// the base global sites, and the general form). Bound: bytes (local 16
// at 1080p: 0.25 GB of q, k, v and out, 0.075 ms at 3.35 TB/s). Above
// it, each of these alone would take 0.04-0.06 ms on an H100: the ex2 of
// 141.6 M scores on the MUFU, ~7 FP32 issues a score, the products on
// mma.sync, moving q, k, v and out.
//
// The form they replace (the first key-tiled form: 4 warps of 16 rows,
// a two-stage ring, mask and rel read from L2 as f32 pairs at every
// score and head) took
// 1.04 ms at local 16: 0.34 of it the loop itself, 0.37 the mask reads,
// 0.33 the rel reads (its time with neither, with the mask alone, with
// both). Both kernels
// * read the compact mask and rel (see above) from shared memory;
// * run one block per (window, head, 128 query rows), the query blocks
//   of a (window, head) next to each other in the grid, so they share k
//   and v in L2; a 3-stage cp.async ring with one barrier a tile, each
//   thread's pieces of a row fixed once (`RowPlan`);
// * take the tile's max on the raw products (scale > 0), then one FFMA
//   and one ex2.approx a score (scale log2 e folded, the mask added as
//   MASK_NEG / scale) and quad max reductions; p (f32)
//   feeds the motion sums and, rounded to bf16, the A fragments of
//   P @ V straight from the accumulators; out and motion are divided by
//   l at the end (p is rounded before the division, as in the plain
//   twin of tests/test_torch_attention_tiled.py).
// This kernel runs the compact form at head dims 65-128: 4 warps of 32
// rows at 65-96 (RT = 2: each k and v fragment feeds two row tiles), 8
// of 16 rows above; and the general form at every head dim, 4 warps of
// 16 rows and 2 stages (its mask and rel tiles take 55 KB a stage). The
// wgmma kernel below took over the compact form up to head dim 64
// because on mma.sync the loop's loads, products and softmax added their
// times. It repeats this kernel's softmax: one device function shared by
// both raised their registers into spills.
template <int DT, bool GENERAL, int RT>
__global__ void __launch_bounds__(GENERAL || RT == 2 ? 128 : 256, 1)
attn_mma_tiled_kernel(const __grid_constant__ AttnArgs a, int heads) {
  constexpr int WARPS = (GENERAL || RT == 2) ? 4 : 8, WR = 16 * RT;
  constexpr int TQ = WR * WARPS;
  constexpr int STAGES = GENERAL ? 2 : 3, LDM = 72;  // LDM: side row floats
  extern __shared__ __align__(16) unsigned char smem_attn[];
  const int N = a.N, hd = a.hd, dt = (hd + 15) >> 4;
  const int dp = dt * 16, ld = dp + 8;
  const int tiles = (N + TKEYS - 1) / TKEYS, np = tiles * TKEYS;
  const Item it = item_of(blockIdx.x, heads, (N + TQ - 1) / TQ, TQ);
  const int w = it.w, head = it.head, q0 = it.q0;
  const bool use_mask = GENERAL ? a.mask != nullptr : a.labels != nullptr;
  const bool use_rel = GENERAL ? a.rel != nullptr : a.coords != nullptr;
  const TiledSmem L = tiled_smem(TQ * ld * 2, 2 * TKEYS * ld * 2,
                                 TQ * LDM * 4, STAGES, GENERAL, use_mask,
                                 use_rel, N);
  bf16* Qs = reinterpret_cast<bf16*>(smem_attn);
  auto stage = [&](int t) {
    return smem_attn + TQ * ld * 2 + (t % STAGES) * L.stage;
  };
  const int kw = a.swap ? (w + a.BW / 2) % a.BW : w;
  const int nq = min(TQ, N - q0);
  const RowPlan plan = row_plan(2 * hd, a.width);
  const bf16* kbase = at<bf16>(a.k, kw, head, 0);
  const bf16* vbase = at<bf16>(a.v, kw, head, 0);
  const float* mplane =
      GENERAL && a.mask ? a.mask + (int64_t)(w % a.mask_windows) * N * N
                        : nullptr;
  auto load_tile = [&](int t) {
    const int k0 = t * TKEYS, n = min(TKEYS, N - k0);
    bf16* kb = reinterpret_cast<bf16*>(stage(t));
    copy_rows(kb, ld, kbase + k0 * a.k.sn, a.k.sn, n, plan, a.width);
    copy_rows(kb + TKEYS * ld, ld, vbase + k0 * a.v.sn, a.v.sn, n, plan,
              a.width);
    if (n < TKEYS) zero_pad(kb, 2, TKEYS, n, hd, dp, ld);  // rows past N
    if constexpr (GENERAL) {
      const int64_t off = (int64_t)q0 * N + k0;
      if (mplane)
        load_side(reinterpret_cast<float*>(stage(t) + L.side_m), LDM,
                  mplane + off, N, nq, n);
      if (a.rel) {
        float* r = reinterpret_cast<float*>(stage(t) + L.side_r);
        load_side(r, LDM, a.rel + off, N, nq, n);
        load_side(r + TQ * LDM, LDM, a.rel + (int64_t)N * N + off, N, nq, n);
      }
    }
  };
  // the head-dim padding of q and of every stage's k and v (no copy
  // writes it); q, the labels, the first tiles; the coordinates
  zero_pad(Qs, 1, TQ, TQ, hd, dp, ld);
  for (int t = 0; t < STAGES; ++t)
    zero_pad(reinterpret_cast<bf16*>(stage(t)), 2, TKEYS, TKEYS, hd, dp, ld);
  copy_rows(Qs, ld, at<bf16>(a.q, w, head, q0), a.q.sn, nq, plan, a.width);
  if (nq < TQ) zero_pad(Qs, 1, TQ, nq, hd, dp, ld);
  const int* lab = reinterpret_cast<const int*>(smem_attn + L.lab);
  if (!GENERAL && use_mask)
    load_labels(reinterpret_cast<int*>(smem_attn + L.lab), a, w, np);
  for (int t = 0; t < STAGES - 1; ++t) {  // one cp.async group a tile
    if (t < tiles) load_tile(t);
    cp_async_commit();
  }
  if (!GENERAL && use_rel)
    load_coords(reinterpret_cast<float2*>(smem_attn + L.crd), a, np);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3, r0 = warp * WR;
  const bool active = q0 + r0 < N;  // warp-uniform: rows left to compute
  bf16* Qw = Qs + r0 * ld;
  const float4* crd4 = reinterpret_cast<const float4*>(smem_attn + L.crd);
  const float l2e = 1.4426950408889634f;
  const float sl2 = a.scale * l2e, inv_scale = 1.0f / a.scale;
  const float neg = MASK_NEG * inv_scale;
  bool masked = false;
  // per 16-row tile rt of the warp and half h (rows g, g + 8 of it)
  int lq[RT][2] = {};
  float cq[RT][2][2] = {};
  uint32_t qa[RT][DT][4];
  float o[RT][2 * DT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 2 * DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[rt][j][e] = 0.0f;
  // raw units; in the compact form every tile holds a key < N with a
  // finite score, so m is finite after the first tile, where exp2(-inf)
  // = 0 starts l (the general form's -inf masks: see mu below)
  float m[RT][2], l[RT][2], mo[RT][2][2];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[rt][h] = -INFINITY;
      l[rt][h] = mo[rt][h][0] = mo[rt][h][1] = 0.0f;
    }

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed (this thread's part)
    __syncthreads();  // all of it; tile t - 1's stage is free again
    if (t + STAGES - 1 < tiles) load_tile(t + STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    if (t == 0) {  // q, the labels and coordinates have landed too
      masked = !GENERAL && use_mask && lab[np] != 0;
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
        for (int kk = 0; kk < DT; ++kk)
          if (kk < dt)
            ldsm_x4(qa[rt][kk], Qw + (16 * rt + (lane & 15)) * ld + kk * 16 +
                                    (lane >> 4) * 8);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = min(q0 + r0 + 16 * rt + g + 8 * h, N - 1);
          if (masked) lq[rt][h] = lab[q];
          if (!GENERAL && use_rel) {
            const float2 c = reinterpret_cast<const float2*>(crd4)[q];
            cq[rt][h][0] = c.x;
            cq[rt][h][1] = c.y;
          }
        }
      }
    }
    const bf16* Ks = reinterpret_cast<const bf16*>(stage(t));
    const bf16* Vs = Ks + TKEYS * ld;
    float s[RT][8][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[rt][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      if (kk >= dt) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t kb[4];
        ldsm_x4(kb, Ks + (j * 16 + (lane >> 4) * 8 + (lane & 7)) * ld +
                        kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          mma16816(s[rt][2 * j], qa[rt][kk], kb[0], kb[1]);
          mma16816(s[rt][2 * j + 1], qa[rt][kk], kb[2], kb[3]);
        }
      }
    }
    // raw products (+ mask / scale); keys past N: -inf; the tile's max
    const int kt0 = t * TKEYS;
    const bool ragged = kt0 + TKEYS > N;
    const float* Ms = reinterpret_cast<const float*>(stage(t) + L.side_m);
    const float* Rs = reinterpret_cast<const float*>(stage(t) + L.side_r);
    float mx[RT][2][2];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) mx[rt][h][0] = mx[rt][h][1] = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kl = j * 8 + tig * 2, k = kt0 + kl;
      int2 lk = make_int2(0, 0);
      if (masked) lk = *reinterpret_cast<const int2*>(lab + k);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = s[rt][j][2 * h], v1 = s[rt][j][2 * h + 1];
          if constexpr (GENERAL) {
            if (mplane) {
              const float2 mk = *reinterpret_cast<const float2*>(
                  Ms + (r0 + 16 * rt + g + 8 * h) * LDM + kl);
              v0 = fmaf(mk.x, inv_scale, v0);
              v1 = fmaf(mk.y, inv_scale, v1);
            }
          } else if (masked) {
            v0 += lk.x != lq[rt][h] ? neg : 0.0f;
            v1 += lk.y != lq[rt][h] ? neg : 0.0f;
          }
          if (ragged) {
            if (k >= N) v0 = -INFINITY;
            if (k + 1 >= N) v1 = -INFINITY;
          }
          s[rt][j][2 * h] = v0;
          s[rt][j][2 * h + 1] = v1;
          mx[rt][h][j & 1] = fmaxf(mx[rt][h][j & 1], fmaxf(v0, v1));
        }
    }
    float mb[RT][2], corr[RT][2];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = fmaxf(mx[rt][h][0], mx[rt][h][1]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float mn = fmaxf(m[rt][h], x);
        // a general mask may hide every key so far (-inf); 0 then keeps
        // corr and p at 0 instead of NaN (the compact form cannot: MASK_NEG
        // is finite and every tile holds a key < N)
        const float mu = GENERAL && mn == -INFINITY ? 0.0f : mn;
        corr[rt][h] = ex2((m[rt][h] - mu) * sl2);
        m[rt][h] = mn;
        mb[rt][h] = mu * sl2;
        l[rt][h] *= corr[rt][h];
        mo[rt][h][0] *= corr[rt][h];
        mo[rt][h][1] *= corr[rt][h];
      }
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int j = 0; j < 2 * DT; ++j) {
        if (j >= 2 * dt) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) o[rt][j][e] *= corr[rt][e >> 1];
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kl = j * 8 + tig * 2;
      float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // (x, y) of k, k + 1
      if (!GENERAL && use_rel) c = crd4[(kt0 + kl) >> 1];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = ex2(fmaf(s[rt][j][2 * h], sl2, -mb[rt][h]));
          const float p1 = ex2(fmaf(s[rt][j][2 * h + 1], sl2, -mb[rt][h]));
          s[rt][j][2 * h] = p0;
          s[rt][j][2 * h + 1] = p1;
          l[rt][h] += p0 + p1;
          if constexpr (GENERAL) {
            if (use_rel) {
              const int ro = (r0 + 16 * rt + g + 8 * h) * LDM + kl;
              const float2 rx = *reinterpret_cast<const float2*>(Rs + ro);
              const float2 ry =
                  *reinterpret_cast<const float2*>(Rs + TQ * LDM + ro);
              mo[rt][h][0] = fmaf(p1, rx.y, fmaf(p0, rx.x, mo[rt][h][0]));
              mo[rt][h][1] = fmaf(p1, ry.y, fmaf(p0, ry.x, mo[rt][h][1]));
            }
          } else if (use_rel) {
            mo[rt][h][0] = fmaf(p1, c.z, fmaf(p0, c.x, mo[rt][h][0]));
            mo[rt][h][1] = fmaf(p1, c.w, fmaf(p0, c.y, mo[rt][h][1]));
          }
        }
    }
    uint32_t pa[RT][4][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[rt][kk][0] = pack_bf16(s[rt][2 * kk][0], s[rt][2 * kk][1]);
        pa[rt][kk][1] = pack_bf16(s[rt][2 * kk][2], s[rt][2 * kk][3]);
        pa[rt][kk][2] = pack_bf16(s[rt][2 * kk + 1][0], s[rt][2 * kk + 1][1]);
        pa[rt][kk][3] = pack_bf16(s[rt][2 * kk + 1][2], s[rt][2 * kk + 1][3]);
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nt = 0; nt < DT; ++nt) {
        if (nt >= dt) break;
        uint32_t vb[4];
        ldsm_x4_t(vb, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               ld + nt * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          mma16816(o[rt][2 * nt], pa[rt][kk], vb[0], vb[1]);
          mma16816(o[rt][2 * nt + 1], pa[rt][kk], vb[2], vb[3]);
        }
      }
  }
  cp_async_wait<0>();  // no copy in flight when the block ends
  if (!active) return;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    const int qw = q0 + r0 + 16 * rt;
    if (qw >= N) break;
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[rt][h] += __shfl_xor_sync(0xffffffffu, l[rt][h], 1);
      l[rt][h] += __shfl_xor_sync(0xffffffffu, l[rt][h], 2);
      inv[h] = 1.0f / l[rt][h];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        mo[rt][h][c] += __shfl_xor_sync(0xffffffffu, mo[rt][h][c], 1);
        mo[rt][h][c] += __shfl_xor_sync(0xffffffffu, mo[rt][h][c], 2);
      }
    }
    if (use_rel && tig == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (qw + g + 8 * h < N) {
          bf16* mp = at<bf16>(a.motion, w, head, qw + g + 8 * h);
          mp[0] = __float2bfloat16_rn(mo[rt][h][0] * inv[h] - cq[rt][h][0]);
          mp[1] = __float2bfloat16_rn(mo[rt][h][1] * inv[h] - cq[rt][h][1]);
        }
    // stage the rounded rows in this row tile's q rows, then write them
    bf16* Qt = Qw + 16 * rt * ld;
#pragma unroll
    for (int j = 0; j < 2 * DT; ++j) {
      if (j >= 2 * dt) break;
      const int c = j * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(Qt + g * ld + c) =
          __floats2bfloat162_rn(o[rt][j][0] * inv[0], o[rt][j][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(Qt + (g + 8) * ld + c) =
          __floats2bfloat162_rn(o[rt][j][2] * inv[1], o[rt][j][3] * inv[1]);
    }
    __syncwarp();
    store_rows(Qt, ld, a.out, w, head, qw, min(16, N - qw), 2 * hd, a.width,
               lane);
  }
}

// Shared memory of a key-tiled launch, set as the kernel's limit above
// 48 KB; an error where it exceeds the card's 227 KB (very long windows).
template <typename K>
cudaError_t tiled_smem_limit(K kernel, int bytes) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int DT, bool GENERAL, int RT = 1>
cudaError_t launch_tiled(const AttnArgs& a, int heads, cudaStream_t st) {
  constexpr int TQ = GENERAL ? 64 : 128, STAGES = GENERAL ? 2 : 3;
  constexpr int THREADS = (GENERAL || RT == 2) ? 128 : 256;
  const int ld = (a.hd + 15) / 16 * 16 + 8;
  const bool mask = GENERAL ? a.mask != nullptr : a.labels != nullptr;
  const bool rel = GENERAL ? a.rel != nullptr : a.coords != nullptr;
  const int smem = tiled_smem(TQ * ld * 2, 2 * TKEYS * ld * 2, TQ * 72 * 4,
                              STAGES, GENERAL, mask, rel, a.N)
                       .total;
  const cudaError_t err =
      tiled_smem_limit(attn_mma_tiled_kernel<DT, GENERAL, RT>, smem);
  if (err != cudaSuccess) return err;
  attn_mma_tiled_kernel<DT, GENERAL, RT>
      <<<a.BW * heads * ((a.N + TQ - 1) / TQ), THREADS, smem, st>>>(a, heads);
  return cudaGetLastError();
}

// ---- bf16, head dims up to 64: the compact form on wgmma --------------
// attn_mma_tiled_kernel's compact form (see its note) with the products
// on wgmma: two warpgroups of 64 query rows a block; q and each k / v
// tile in the 128-byte swizzle (rows of 128 bytes, 16-byte chunks
// XOR-ed by the row index), written by cp.async, the head dim padded
// with zeros to 16 DT; q k^T as m64n64k16 with both operands in shared
// memory, p @ v as m64n(16 DT)k16 with p from registers (the score
// accumulators rounded to bf16 are its A fragments) and v read N-major
// (a transposed descriptor). The products leave the instruction stream
// to the softmax: a warpgroup issues q k^T in DT instructions where a
// warp issued 12 ldmatrix and 24 mma.sync, and p @ v runs while the
// next tile's barrier and copies are issued. Rows past N of an active
// warpgroup are computed on zeros and not stored.
template <int DT>
__global__ void __launch_bounds__(256, 2)
attn_wg_tiled_kernel(const __grid_constant__ AttnArgs a, int heads) {
  constexpr int TQ = 128, STAGES = 3, TB = TKEYS * 128;  // TB: one tile
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  const int N = a.N, hd = a.hd;
  const int tiles = (N + TKEYS - 1) / TKEYS, np = tiles * TKEYS;
  const Item it = item_of(blockIdx.x, heads, (N + TQ - 1) / TQ, TQ);
  const int w = it.w, head = it.head, q0 = it.q0;
  const bool use_mask = a.labels != nullptr, use_rel = a.coords != nullptr;
  const TiledSmem L = tiled_smem(TQ * 128, 2 * TB, 0, STAGES, false,
                                 use_mask, use_rel, N);
  unsigned char* Qs = smem_wg;
  auto stage = [&](int t) {
    return smem_wg + TQ * 128 + (t % STAGES) * 2 * TB;
  };
  const int kw = a.swap ? (w + a.BW / 2) % a.BW : w;
  const int nq = min(TQ, N - q0);
  const RowPlan plan = row_plan(2 * hd, a.width);
  // rows [0, n) of src (rows sn elements apart) into a swizzled tile
  auto copy_sw = [&](unsigned char* dst, const bf16* src, int64_t sn,
                     int n) {
    if (plan.r0 >= plan.pass) return;
    const char* s = reinterpret_cast<const char*>(src + plan.r0 * sn) + plan.c;
    for (int r = plan.r0; r < n; r += plan.pass, s += plan.pass * sn * 2)
      copy_piece(dst + r * 128 + ((((plan.c >> 4) ^ (r & 7)) << 4) |
                                  (plan.c & 15)),
                 s, a.width);
  };
  const bf16* kbase = at<bf16>(a.k, kw, head, 0);
  const bf16* vbase = at<bf16>(a.v, kw, head, 0);
  auto load_tile = [&](int t) {
    const int k0 = t * TKEYS, n = min(TKEYS, N - k0);
    copy_sw(stage(t), kbase + k0 * a.k.sn, a.k.sn, n);
    copy_sw(stage(t) + TB, vbase + k0 * a.v.sn, a.v.sn, n);
    for (int e = threadIdx.x; e < (TKEYS - n) * 8; e += blockDim.x)
      reinterpret_cast<uint4*>(stage(t) + TB + n * 128)[e] =
          make_uint4(0, 0, 0, 0);  // v rows past N: p is 0 there
  };
  // zeros where no copy writes (channels past the head dim), then q,
  // the labels, the first tiles, the coordinates
  for (int e = threadIdx.x; e < (TQ * 128 + STAGES * 2 * TB) / 16;
       e += blockDim.x)
    reinterpret_cast<uint4*>(smem_wg)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();  // before a copy lands where a zero is stored
  copy_sw(Qs, at<bf16>(a.q, w, head, q0), a.q.sn, nq);
  const int* lab = reinterpret_cast<const int*>(smem_wg + L.lab);
  if (use_mask) load_labels(reinterpret_cast<int*>(smem_wg + L.lab), a, w, np);
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) load_tile(t);
    cp_async_commit();
  }
  if (use_rel) load_coords(reinterpret_cast<float2*>(smem_wg + L.crd), a, np);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3, r0 = warp * 16;
  const int wg = warp >> 2;
  const bool active = q0 + wg * 64 < N;  // warpgroup-uniform
  const float4* crd4 = reinterpret_cast<const float4*>(smem_wg + L.crd);
  const float l2e = 1.4426950408889634f;
  const float sl2 = a.scale * l2e, neg = MASK_NEG / a.scale;
  bool masked = false;
  int lq[2] = {0, 0};
  float cq[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  float o[2 * DT][4];
#pragma unroll
  for (int j = 0; j < 2 * DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float mo[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  const uint64_t qdesc = hopper::sw128_desc(Qs + wg * 64 * 128);

  for (int t = 0; t < tiles; ++t) {
    hopper::wgmma_wait<0>();  // p @ v of tile t - 1 has read its stage
    cp_async_wait<STAGES - 2>();
    hopper::fence_proxy_async();  // copies and zeros before wgmma reads
    __syncthreads();
    if (t + STAGES - 1 < tiles) load_tile(t + STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    if (t == 0) {
      masked = use_mask && lab[np] != 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = min(q0 + r0 + g + 8 * h, N - 1);
        if (masked) lq[h] = lab[q];
        if (use_rel) {
          const float2 c = reinterpret_cast<const float2*>(crd4)[q];
          cq[h][0] = c.x;
          cq[h][1] = c.y;
        }
      }
    }
    const unsigned char* Ks = stage(t);
    const uint64_t kdesc = hopper::sw128_desc(Ks);
    const uint64_t vdesc = hopper::sw128_desc(Ks + TB);
    float s[8][4];
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DT; ++ks)
      wg_qk(s, qdesc + 2 * ks, kdesc + 2 * ks, ks);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    const int kt0 = t * TKEYS;
    const bool ragged = kt0 + TKEYS > N;
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kl = j * 8 + tig * 2, k = kt0 + kl;
      int2 lk = make_int2(0, 0);
      if (masked) lk = *reinterpret_cast<const int2*>(lab + k);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = s[j][2 * h], v1 = s[j][2 * h + 1];
        if (masked) {
          v0 += lk.x != lq[h] ? neg : 0.0f;
          v1 += lk.y != lq[h] ? neg : 0.0f;
        }
        if (ragged) {
          if (k >= N) v0 = -INFINITY;
          if (k + 1 >= N) v1 = -INFINITY;
        }
        s[j][2 * h] = v0;
        s[j][2 * h + 1] = v1;
        mx[h][j & 1] = fmaxf(mx[h][j & 1], fmaxf(v0, v1));
      }
    }
    float mb[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = fmaxf(mx[h][0], mx[h][1]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float mn = fmaxf(m[h], x);
      corr[h] = ex2((m[h] - mn) * sl2);
      m[h] = mn;
      mb[h] = mn * sl2;
      l[h] *= corr[h];
      mo[h][0] *= corr[h];
      mo[h][1] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 2 * DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kl = j * 8 + tig * 2;
      float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (use_rel) c = crd4[(kt0 + kl) >> 1];
      float p[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = ex2(fmaf(s[j][2 * h], sl2, -mb[h]));
        const float p1 = ex2(fmaf(s[j][2 * h + 1], sl2, -mb[h]));
        p[2 * h] = p0;
        p[2 * h + 1] = p1;
        l[h] += p0 + p1;
        if (use_rel) {
          mo[h][0] = fmaf(p1, c.z, fmaf(p0, c.x, mo[h][0]));
          mo[h][1] = fmaf(p1, c.w, fmaf(p0, c.y, mo[h][1]));
        }
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (DT == 2) wg_pv32(o, pa[kk], vdesc + 128 * kk);
      else if constexpr (DT == 3) wg_pv48(o, pa[kk], vdesc + 128 * kk);
      else wg_pv64(o, pa[kk], vdesc + 128 * kk);
    }
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
  cp_async_wait<0>();
  const int qw = q0 + r0;
  if (!active || qw >= N) return;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.0f / l[h];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      mo[h][c] += __shfl_xor_sync(0xffffffffu, mo[h][c], 1);
      mo[h][c] += __shfl_xor_sync(0xffffffffu, mo[h][c], 2);
    }
  }
  if (use_rel && tig == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qw + g + 8 * h < N) {
        bf16* mp = at<bf16>(a.motion, w, head, qw + g + 8 * h);
        mp[0] = __float2bfloat16_rn(mo[h][0] * inv[h] - cq[h][0]);
        mp[1] = __float2bfloat16_rn(mo[h][1] * inv[h] - cq[h][1]);
      }
  // stage the rounded rows, unswizzled, in this warp's own q rows
  bf16* Qw = reinterpret_cast<bf16*>(Qs + r0 * 128);
#pragma unroll
  for (int j = 0; j < 2 * DT; ++j) {
    const int c = j * 8 + tig * 2;
    *reinterpret_cast<__nv_bfloat162*>(Qw + g * 64 + c) =
        __floats2bfloat162_rn(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(Qw + (g + 8) * 64 + c) =
        __floats2bfloat162_rn(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  store_rows(Qw, 64, a.out, w, head, qw, min(16, N - qw), 2 * hd, a.width,
             lane);
}

template <int DT>
cudaError_t launch_tiled_wg(const AttnArgs& a, int heads, cudaStream_t st) {
  const int smem = tiled_smem(128 * 128, 2 * TKEYS * 128, 0, 3, false,
                              a.labels != nullptr, a.coords != nullptr, a.N)
                       .total;
  const cudaError_t err = tiled_smem_limit(attn_wg_tiled_kernel<DT>, smem);
  if (err != cudaSuccess) return err;
  attn_wg_tiled_kernel<DT>
      <<<a.BW * heads * ((a.N + 127) / 128), 256, smem, st>>>(a, heads);
  return cudaGetLastError();
}

// The compact form on wgmma up to head dim 64, above it on mma.sync (two
// 16-row tiles a warp up to 96, see the kernel's note); the general form
// on mma.sync at every head dim.
cudaError_t launch_tiled_compact(const AttnArgs& a, int heads,
                                 cudaStream_t st) {
  if (a.hd <= 32) return launch_tiled_wg<2>(a, heads, st);
  if (a.hd <= 48) return launch_tiled_wg<3>(a, heads, st);
  if (a.hd <= 64) return launch_tiled_wg<4>(a, heads, st);
  if (a.hd <= 96) return launch_tiled<6, false, 2>(a, heads, st);
  return launch_tiled<8, false>(a, heads, st);
}

cudaError_t launch_tiled_general(const AttnArgs& a, int heads,
                                 cudaStream_t st) {
  if (a.hd <= 32) return launch_tiled<2, true>(a, heads, st);
  if (a.hd <= 48) return launch_tiled<3, true>(a, heads, st);
  if (a.hd <= 96) return launch_tiled<6, true>(a, heads, st);
  return launch_tiled<8, true>(a, heads, st);
}

template <int KT, int DT>
cudaError_t launch(const AttnArgs& a, int heads, cudaStream_t st) {
  const int kt = (a.N + 15) / 16, ld = (a.hd + 15) / 16 * 16 + 8;
  const int smem = 3 * kt * 16 * ld * 2;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_mma_kernel<KT, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  attn_mma_kernel<KT, DT><<<dim3(heads, a.BW), kt * 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_dt(const AttnArgs& a, int heads, cudaStream_t st) {
  if (a.hd <= 32) return launch<KT, 2>(a, heads, st);
  if (a.hd <= 48) return launch<KT, 3>(a, heads, st);
  if (a.hd <= 96) return launch<KT, 6>(a, heads, st);
  return launch<KT, 8>(a, heads, st);
}

// Widest piece (16, 8, 4 or, in bf16, 2 bytes) that every row of q, k,
// v and out starts on and that divides a head's row.
template <typename T>
inline int piece_width(const AttnArgs& a) {
  const View* views[4] = {&a.q, &a.k, &a.v, &a.out};
  const long long e = sizeof(T);
  int w = 16;
  for (; w > (int)e; w /= 2) {
    bool ok = (e * a.hd) % w == 0;
    for (const View* v : views)
      ok = ok && reinterpret_cast<uintptr_t>(v->ptr) % w == 0 &&
           (e * v->sw) % w == 0 && (e * v->sh) % w == 0 &&
           (e * v->sn) % w == 0;
    if (ok) break;
  }
  return w;
}

}  // namespace mma_attn

// ---- f32 attention over windows of any size: key tiles, online softmax
// Replaces, for N > 160 keys in f32, what attn_kernel does for the main
// path's windows (K1's attention launch, K7, K8; see the bf16 form).
// True f32 on the CUDA cores: the JAX kernels compute f32 at HIGHEST
// precision, so TF32 products would not be the same function. Bound:
// operations (local 16 at 1080p: 27 GFLOP of f32 products, 0.41 ms at
// 67 TFLOP/s, against 0.5 GB of q, k, v and out).
//
// The form it replaces (the first key-tiled form: one key a lane, each
// product reading q and k from shared memory, 2 loads an FMA, 16 query
// rows a block) took
// 5.04 ms at local 16 on an H100, slower than the plain version's f32
// GEMMs (3.09 ms). This one is register-tiled: a block of 256 threads
// per (window, head, 64 query rows) walks 64-key tiles of k and v (a
// two-stage cp.async ring; rows 4 (head dim / 4 | 1) floats apart, so
// that 16-byte reads of 8 neighbouring rows fall in distinct banks).
// Thread (ty, tx) holds rows ty + 16i and keys tx + 16j (i, j < 4):
// * scores: per 4 channels, 4 q and 4 k float4 reads feed 64 FMAs;
// * the softmax in f32 (expf), row max over the 16 lanes of a row, p to
//   shared memory [64 rows][64 keys];
// * P @ V: the same rows and channel quads tx + 16c, per 4 keys 4 p and
//   4 v float4 reads feed 64 FMAs a quad; corr rescales in registers.
// Mask and rel as in the bf16 form (compact or staged general tiles);
// the general form keeps one stage. At local 16 it takes 1.45 ms, half
// its plain version's; at head dim 84 (global) 21 channel quads leave a
// third of the lanes idle in P @ V (global 24: 1.80 against 2.03 ms).
template <int DQ, bool GENERAL>
__global__ void __launch_bounds__(256, DQ == 1 ? 2 : 1)
attn_tiled_kernel(const __grid_constant__ AttnArgs a, int heads) {
  using namespace mma_attn;
  constexpr int TQ = 64, STAGES = GENERAL ? 1 : 2;
  constexpr int LDP = 80, LDM = 80;  // P / side rows: lanes 16-31 a row on
  extern __shared__ __align__(16) unsigned char smem_f32[];
  const int N = a.N, hd = a.hd, hd4 = (hd + 3) >> 2;
  const Item it = item_of(blockIdx.x, heads, (N + TQ - 1) / TQ, TQ);
  const int head = it.head, w = it.w, q0 = it.q0;
  const int ldk = 4 * (hd4 | 1), ldk4 = ldk >> 2;
  const bool use_mask = GENERAL ? a.mask != nullptr : a.labels != nullptr;
  const bool use_rel = GENERAL ? a.rel != nullptr : a.coords != nullptr;
  const TiledSmem L =
      tiled_smem((TQ * ldk + TQ * LDP) * 4, 2 * TKEYS * ldk * 4,
                 TQ * LDM * 4, STAGES, GENERAL, use_mask, use_rel, N);
  float* Qs = reinterpret_cast<float*>(smem_f32);
  float* Ps = Qs + TQ * ldk;
  auto stage = [&](int t) {
    return smem_f32 + (TQ * ldk + TQ * LDP) * 4 + (t % STAGES) * L.stage;
  };
  const int kw = a.swap ? (w + a.BW / 2) % a.BW : w;
  const int nq = min(TQ, N - q0), tiles = (N + TKEYS - 1) / TKEYS;
  const RowPlan plan = row_plan(4 * hd, a.width);
  const float* kbase = at<float>(a.k, kw, head, 0);
  const float* vbase = at<float>(a.v, kw, head, 0);
  const float* mplane =
      GENERAL && a.mask ? a.mask + (int64_t)(w % a.mask_windows) * N * N
                        : nullptr;
  auto load_tile = [&](int t) {
    const int k0 = t * TKEYS, n = min(TKEYS, N - k0);
    float* kb = reinterpret_cast<float*>(stage(t));
    copy_rows(kb, ldk, kbase + k0 * a.k.sn, a.k.sn, n, plan, a.width);
    copy_rows(kb + TKEYS * ldk, ldk, vbase + k0 * a.v.sn, a.v.sn, n, plan,
              a.width);
    if (n < TKEYS) zero_pad(kb, 2, TKEYS, n, hd, 4 * hd4, ldk);
    if constexpr (GENERAL) {
      const int64_t off = (int64_t)q0 * N + k0;
      if (mplane)
        load_side(reinterpret_cast<float*>(stage(t) + L.side_m), LDM,
                  mplane + off, N, nq, n);
      if (a.rel) {
        float* r = reinterpret_cast<float*>(stage(t) + L.side_r);
        load_side(r, LDM, a.rel + off, N, nq, n);
        load_side(r + TQ * LDM, LDM, a.rel + (int64_t)N * N + off, N, nq, n);
      }
    }
  };
  if (hd < 4 * hd4) {  // channels [hd, 4 hd4) of q and k are read
    zero_pad(Qs, 1, TQ, TQ, hd, 4 * hd4, ldk);
    for (int t = 0; t < STAGES; ++t)
      zero_pad(reinterpret_cast<float*>(stage(t)), 2, TKEYS, TKEYS, hd,
               4 * hd4, ldk);
    __syncthreads();
  }
  copy_rows(Qs, ldk, at<float>(a.q, w, head, q0), a.q.sn, nq, plan,
            a.width);
  if (nq < TQ) zero_pad(Qs, 1, TQ, nq, hd, 4 * hd4, ldk);
  if (STAGES > 1) load_tile(0);
  cp_async_commit();
  int* lab = reinterpret_cast<int*>(smem_f32 + L.lab);
  const float2* crd = reinterpret_cast<const float2*>(smem_f32 + L.crd);
  const bool masked = !GENERAL && use_mask &&
                      a.labels[(int64_t)a.mask_windows * N +
                               w % a.mask_windows] != 0;
  if constexpr (!GENERAL) {
    if (masked) load_labels(lab, a, w, tiles * TKEYS);
    cp_async_commit();
    if (use_rel)
      load_coords(reinterpret_cast<float2*>(smem_f32 + L.crd), a,
                  tiles * TKEYS);
    cp_async_wait<0>();
    __syncthreads();
  }

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  int lq[4] = {0, 0, 0, 0};
  float cq[4][2] = {};
  if constexpr (!GENERAL)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = min(q0 + ty + 16 * i, N - 1);
      if (masked) lq[i] = lab[q];
      if (use_rel) {
        cq[i][0] = crd[q].x;
        cq[i][1] = crd[q].y;
      }
    }
  float4 o[4][DQ];
  float m[4], l[4], mo[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = mo[i][0] = mo[i][1] = 0.0f;
#pragma unroll
    for (int c = 0; c < DQ; ++c) o[i][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float4* Q4 = reinterpret_cast<const float4*>(Qs);
  const float4* P4 = reinterpret_cast<const float4*>(Ps);

  for (int t = 0; t < tiles; ++t) {
    if (STAGES == 1) {
      __syncthreads();  // the previous tile is consumed
      load_tile(t);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();  // tile t (and q) has landed; P and tile t - 1 free
    if (STAGES > 1 && t + 1 < tiles) load_tile(t + 1);
    cp_async_commit();
    const float4* K4 = reinterpret_cast<const float4*>(stage(t));
    const float4* V4 = K4 + TKEYS * ldk4;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d4 = 0; d4 < hd4; ++d4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Q4[(ty + 16 * i) * ldk4 + d4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = K4[(tx + 16 * j) * ldk4 + d4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc = fmaf(qv[i].x, kv[j].x, s[i][j]);
          acc = fmaf(qv[i].y, kv[j].y, acc);
          acc = fmaf(qv[i].z, kv[j].z, acc);
          s[i][j] = fmaf(qv[i].w, kv[j].w, acc);
        }
    }
    const int kt0 = t * TKEYS, nk = min(TKEYS, N - kt0);
    const float* Ms = reinterpret_cast<const float*>(stage(t) + L.side_m);
    const float* Rs = reinterpret_cast<const float*>(stage(t) + L.side_r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = tx + 16 * j;
        float v = s[i][j] * a.scale;
        if constexpr (GENERAL) {
          if (mplane) v += Ms[r * LDM + kl];
        } else if (masked) {
          v += lab[kt0 + kl] != lq[i] ? MASK_NEG : 0.0f;
        }
        if (kl >= nk) v = -INFINITY;
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int o2 = 1; o2 < 16; o2 <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float mn = fmaxf(m[i], mx);
      // every key so far hidden by a general mask (-inf): 0 keeps corr
      // and p at 0 instead of NaN
      const float mu = GENERAL && mn == -INFINITY ? 0.0f : mn;
      const float corr = expf(m[i] - mu);  // 0 at the first tile
      m[i] = mn;
      float ls = 0.0f, mxs = 0.0f, mys = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = tx + 16 * j;
        const float p = expf(s[i][j] - mu);
        ls += p;
        if constexpr (GENERAL) {
          if (use_rel) {
            mxs = fmaf(p, Rs[r * LDM + kl], mxs);
            mys = fmaf(p, Rs[TQ * LDM + r * LDM + kl], mys);
          }
        } else if (use_rel) {
          const float2 c = crd[kt0 + kl];
          mxs = fmaf(p, c.x, mxs);
          mys = fmaf(p, c.y, mys);
        }
        Ps[r * LDP + kl] = p;
      }
      l[i] = fmaf(l[i], corr, ls);
      mo[i][0] = fmaf(mo[i][0], corr, mxs);
      mo[i][1] = fmaf(mo[i][1], corr, mys);
#pragma unroll
      for (int c = 0; c < DQ; ++c) {
        o[i][c].x *= corr;
        o[i][c].y *= corr;
        o[i][c].z *= corr;
        o[i][c].w *= corr;
      }
    }
    __syncthreads();  // P of the tile
    const int nk4 = (nk + 3) >> 2;
    for (int k4 = 0; k4 < nk4; ++k4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = P4[(ty + 16 * i) * (LDP / 4) + k4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4* vr = V4 + (4 * k4 + u) * ldk4;
#pragma unroll
        for (int c = 0; c < DQ; ++c) {
          if (tx + 16 * c >= hd4) break;
          const float4 vv = vr[tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z : pv[i].w;
            o[i][c].x = fmaf(p, vv.x, o[i][c].x);
            o[i][c].y = fmaf(p, vv.y, o[i][c].y);
            o[i][c].z = fmaf(p, vv.z, o[i][c].z);
            o[i][c].w = fmaf(p, vv.w, o[i][c].w);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o2 = 1; o2 < 16; o2 <<= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o2);
      mo[i][0] += __shfl_xor_sync(0xffffffffu, mo[i][0], o2);
      mo[i][1] += __shfl_xor_sync(0xffffffffu, mo[i][1], o2);
    }
    const int q = q0 + ty + 16 * i;
    if (q >= N) continue;
    const float inv = 1.0f / l[i];
    if (use_rel && tx == 0) {
      float* mp = at<float>(a.motion, w, head, q);
      mp[0] = mo[i][0] * inv - cq[i][0];
      mp[1] = mo[i][1] * inv - cq[i][1];
    }
    float* orow = at<float>(a.out, w, head, q);
#pragma unroll
    for (int c = 0; c < DQ; ++c) {
      const int d = 4 * (tx + 16 * c);
      if (d >= hd) break;
      const float4 v = make_float4(o[i][c].x * inv, o[i][c].y * inv,
                                   o[i][c].z * inv, o[i][c].w * inv);
      if (a.width == 16) {
        *reinterpret_cast<float4*>(orow + d) = v;
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
        for (int u = 0; u < 4 && d + u < hd; ++u) orow[d + u] = e[u];
      }
    }
  }
}

template <int DQ, bool GENERAL>
cudaError_t launch_tiled_f32(const AttnArgs& a, int heads, cudaStream_t st) {
  const int ldk = 4 * (((a.hd + 3) >> 2) | 1);
  const bool mask = GENERAL ? a.mask != nullptr : a.labels != nullptr;
  const bool rel = GENERAL ? a.rel != nullptr : a.coords != nullptr;
  const int smem = mma_attn::tiled_smem((64 * ldk + 64 * 80) * 4,
                                        2 * mma_attn::TKEYS * ldk * 4,
                                        64 * 80 * 4, GENERAL ? 1 : 2,
                                        GENERAL, mask, rel, a.N)
                       .total;
  const cudaError_t err =
      mma_attn::tiled_smem_limit(attn_tiled_kernel<DQ, GENERAL>, smem);
  if (err != cudaSuccess) return err;
  attn_tiled_kernel<DQ, GENERAL>
      <<<a.BW * heads * ((a.N + 63) / 64), 256, smem, st>>>(a, heads);
  return cudaGetLastError();
}

// The window-attention launch: bf16 on the tensor cores
// (mma_attn::attn_mma_kernel), f32 as true f32 on the CUDA cores
// (attn_kernel, the parity mode: JAX computes f32 at HIGHEST precision,
// so TF32 products would not be the same function); windows of more
// than SINGLE_PASS_KEYS keys run the key-tiled forms, compact where
// every given mask and rel comes with its compact form, else general.
template <typename T>
cudaError_t launch_attn(AttnArgs a, int heads, cudaStream_t st) {
  if (a.BW < 1 || a.N < 1 || heads < 1 || a.hd < 1 ||
      a.hd > 32 * MAX_DIMS || (a.swap && a.BW % 2) ||
      (a.mask && (a.mask_windows < 1 || a.BW % a.mask_windows)) ||
      (a.rel && !a.motion.ptr) || (a.labels && !a.mask) ||
      (a.coords && !a.rel) || (a.N + 63) / 64 > 65535)
    return cudaErrorInvalidValue;
  a.width = mma_attn::piece_width<T>(a);
  if (a.N > SINGLE_PASS_KEYS) {
    const bool general = (a.mask && !a.labels) || (a.rel && !a.coords);
    if constexpr (sizeof(T) == 2) {
      return general ? mma_attn::launch_tiled_general(a, heads, st)
                     : mma_attn::launch_tiled_compact(a, heads, st);
    } else {
      if (a.hd <= 64)
        return general ? launch_tiled_f32<1, true>(a, heads, st)
                       : launch_tiled_f32<1, false>(a, heads, st);
      return general ? launch_tiled_f32<2, true>(a, heads, st)
                     : launch_tiled_f32<2, false>(a, heads, st);
    }
  }
  if constexpr (sizeof(T) == 2) {
    if (a.N <= 64) return mma_attn::launch_dt<4>(a, heads, st);
    if (a.N <= 144) return mma_attn::launch_dt<9>(a, heads, st);
    return mma_attn::launch_dt<10>(a, heads, st);
  } else {
    const int hdp = a.hd | 1;
    const size_t smem = sizeof(float) * (2 * (size_t)a.N * hdp +
                                         ATT_WARPS * (size_t)(hdp + a.N));
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return err;
    }
    attn_kernel<T><<<dim3(heads, a.BW), ATT_WARPS * 32, smem, st>>>(a);
    return cudaGetLastError();
  }
}

template <int MODE>
cudaError_t launch_gemm_f32(const GemmArgs& g, cudaStream_t st) {
  dim3 grid((g.M + 63) / 64, (g.Nout + 63) / 64);
  gemm_f32_kernel<MODE><<<grid, 256, 0, st>>>(g);
  return cudaGetLastError();
}

// only: 0 runs the three launches; 1, 2 or 3 that launch alone (to time
// them apart, on scratch a whole call has filled). wmaps: bf16 only,
// 2 x 128 bytes of host memory from atm_block_weight_map, wqkv's map and
// then wproj's. bf16 takes C <= 1024 (ln_rows_kernel). labels and
// coords: the compact forms of mask and rel (AttnArgs), or null.
template <typename T>
int atm_block(int only, const void* x, const void* wqkv,
              const void* wproj, const void* bproj, const void* wmaps,
              const void* ln_g, const void* ln_b, const void* rel,
              const void* mask, int mask_windows, const void* labels,
              const void* coords, void* xn, void* qkv,
              void* app, void* y, void* motion, int BW, int N, int C,
              int heads, int swap, float scale, void* stream) {
  if (BW < 1 || N < 1 || heads < 1 || C % heads ||
      C % 8 || C / heads > 32 * MAX_DIMS || (swap && BW % 2) ||
      (mask && (mask_windows < 1 || BW % mask_windows)) ||
      (sizeof(T) == 2 &&
       (C > 32 * 8 * lg::LN_UNITS || !wmaps || reinterpret_cast<uintptr_t>(ln_g) % 16 ||
        reinterpret_cast<uintptr_t>(ln_b) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = BW * N;
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  const unsigned char* maps = static_cast<const unsigned char*>(wmaps);
  cudaError_t err = cudaSuccess;
  if (only == 0 || only == 1) {
    if constexpr (sizeof(T) == 2) {
      err = lg::ln_rows(x, g, b, xn, M, C, st);
      if (err == cudaSuccess)
        err = lg::gemm<false>(xn, maps, qkv, M, 3 * C, C, nullptr, nullptr,
                              st);
    } else {
      GemmArgs g1{x, wqkv, qkv, M, 3 * C, C, g, b, xn, nullptr, nullptr};
      err = launch_gemm_f32<0>(g1, st);
    }
  }
  if (err != cudaSuccess) return (int)err;

  // q, k, v are the three C-wide column blocks of qkv [BW, N, 3C]
  const long long sw = (long long)N * 3 * C;
  const int hd = C / heads;
  AttnArgs a{};
  a.q = View{qkv, sw, hd, 3 * C};
  a.k = View{static_cast<T*>(qkv) + C, sw, hd, 3 * C};
  a.v = View{static_cast<T*>(qkv) + 2 * C, sw, hd, 3 * C};
  a.out = View{app, (long long)N * C, hd, C};
  a.motion = View{motion, (long long)N * 2 * heads, 2, 2 * heads};
  a.rel = static_cast<const float*>(rel);
  a.mask = static_cast<const float*>(mask);
  a.labels = static_cast<const int*>(labels);
  a.coords = static_cast<const float*>(coords);
  a.mask_windows = mask_windows;
  a.BW = BW;
  a.N = N;
  a.hd = hd;
  a.swap = swap;
  a.scale = scale;
  if (only == 0 || only == 2) err = launch_attn<T>(a, heads, st);
  if (err != cudaSuccess) return (int)err;

  if (only == 0 || only == 3) {
    if constexpr (sizeof(T) == 2) {
      err = lg::gemm<true>(app, maps + sizeof(CUtensorMap), y, M, C, C,
                           bproj, xn, st);
    } else {
      GemmArgs g3{app, wproj, y, M, C, C, nullptr, nullptr, nullptr, bproj,
                  xn};
      err = launch_gemm_f32<1>(g3, st);
    }
  }
  return (int)err;
}

// K7 / K8: the attention launch alone on caller-given q, k, v. `strides`
// holds (sw, sh, sn) for q, k, v, out and motion, in that order; labels
// and coords as for atm_block.
template <typename T>
int window_attention(const void* q, const void* k, const void* v,
                     const int64_t* strides, void* out, void* motion,
                     const void* rel, const void* mask, int mask_windows,
                     const void* labels, const void* coords, int BW, int N,
                     int hd, int heads, float scale, void* stream) {
  void* ptrs[5] = {const_cast<void*>(q), const_cast<void*>(k),
                   const_cast<void*>(v), out, motion};
  View views[5];
  for (int i = 0; i < 5; ++i)
    views[i] = View{ptrs[i], strides[3 * i], strides[3 * i + 1],
                    strides[3 * i + 2]};
  AttnArgs a{};
  a.q = views[0];
  a.k = views[1];
  a.v = views[2];
  a.out = views[3];
  a.motion = views[4];
  a.rel = static_cast<const float*>(rel);
  a.mask = static_cast<const float*>(mask);
  a.labels = static_cast<const int*>(labels);
  a.coords = static_cast<const float*>(coords);
  a.mask_windows = mask_windows;
  a.BW = BW;
  a.N = N;
  a.hd = hd;
  a.swap = 0;
  a.scale = scale;
  return (int)launch_attn<T>(a, heads, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The tensor map of a bf16 weight w [N, K] (nn.Linear layout, K % 8 == 0,
// 16-byte aligned) for K1's gemm_kernel with those N and K: 128 bytes to
// map_out. Fails for a shape the kernel does not take.
extern "C" int atm_block_weight_map(const void* w, int N, int K,
                                    void* map_out) {
  lg::Plan pl;
  if (!lg::plan_stream(N, K, false, &pl) ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap map;
  if (hopper::encode_rows(&map, w, N, K, pl.bnw))
    return (int)cudaErrorInvalidValue;
  memcpy(map_out, &map, sizeof(map));
  return 0;
}

// The attention launch's threshold: windows of up to this many keys run
// the single-pass forms, larger ones the key-tiled forms (the wrappers
// count the launches of those).
extern "C" int attention_single_pass_keys() { return SINGLE_PASS_KEYS; }

#define ATM_BLOCK_ENTRY(NAME, LAUNCH_NAME, T)                                 \
  extern "C" int NAME(const void* x, const void* wqkv, const void* wproj,     \
                      const void* bproj, const void* wmaps,                   \
                      const void* ln_g, const void* ln_b, const void* rel,    \
                      const void* mask, int mask_windows,                     \
                      const void* labels, const void* coords, void* xn,       \
                      void* qkv, void* app, void* y, void* motion, int BW,    \
                      int N, int C, int heads, int swap, float scale,         \
                      void* stream) {                                         \
    return atm_block<T>(0, x, wqkv, wproj, bproj, wmaps, ln_g, ln_b, rel,     \
                        mask, mask_windows, labels, coords, xn, qkv, app, y,  \
                        motion, BW, N, C, heads, swap, scale, stream);        \
  }                                                                           \
  extern "C" int LAUNCH_NAME(                                                 \
      int only, const void* x, const void* wqkv, const void* wproj,           \
      const void* bproj, const void* wmaps, const void* ln_g,                 \
      const void* ln_b, const void* rel, const void* mask, int mask_windows,  \
      const void* labels, const void* coords, void* xn, void* qkv,            \
      void* app, void* y, void* motion, int BW, int N, int C, int heads,      \
      int swap, float scale, void* stream) {                                  \
    return atm_block<T>(only, x, wqkv, wproj, bproj, wmaps, ln_g, ln_b, rel,  \
                        mask, mask_windows, labels, coords, xn, qkv, app, y,  \
                        motion, BW, N, C, heads, swap, scale, stream);        \
  }

ATM_BLOCK_ENTRY(atm_block_f32, atm_block_launch_f32, float)
ATM_BLOCK_ENTRY(atm_block_bf16, atm_block_launch_bf16, bf16)

#define WINDOW_ATTENTION_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const int64_t* strides, void* out, void* motion,      \
                      const void* rel, const void* mask, int mask_windows,  \
                      const void* labels, const void* coords, int BW,       \
                      int N, int hd, int heads, float scale,                \
                      void* stream) {                                       \
    return window_attention<T>(q, k, v, strides, out, motion, rel, mask,    \
                               mask_windows, labels, coords, BW, N, hd,     \
                               heads, scale, stream);                       \
  }

WINDOW_ATTENTION_ENTRY(window_attention_f32, float)
WINDOW_ATTENTION_ENTRY(window_attention_bf16, bf16)

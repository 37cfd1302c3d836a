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
//      softmax (`attn_tiled_kernel`, `mma_attn::attn_mma_tiled_kernel`),
//      one block per (window, head, query block), so that shared memory
//      does not grow with the window.
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
  int mask_windows, BW, N, hd, swap;  // swap: k, v of window (w + BW/2) % BW
  float scale;
  int width;  // bf16 kernel: bytes per copied piece (set by launch_attn)
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

// ---- f32 attention over windows of any size: key tiles, online softmax
// attn_kernel holds a whole window (k and v, 2 N hd floats) and 5 scores
// a lane, so it takes N <= 160. Above that this form runs: one block per
// (window, head, 16 query rows), each warp keeping 4 query rows' state
// in registers (running max m, sum l, the lane's output channels and
// its part of the two motion moments) while k and v pass through shared
// memory 32 keys at a time, one key a lane. At each tile the state is
// rescaled by exp(m_old - m_new); out and motion are divided by l at
// the end. Shared memory (43 KB at hd 128) no longer grows with N; k and
// v are read once per 16 query rows.
constexpr int TILE_ROWS = 4;                    // query rows a warp keeps
constexpr int TILE_QB = ATT_WARPS * TILE_ROWS;  // query rows a block
constexpr int TILE_KEYS = 32;                   // keys a tile: one a lane

template <typename T>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attn_tiled_kernel(const __grid_constant__ AttnArgs a) {
  extern __shared__ float sm[];
  const int head = blockIdx.x, w = blockIdx.y, q0 = blockIdx.z * TILE_QB;
  const int N = a.N, hd = a.hd, hdp = hd | 1;
  float* Qs = sm;                         // [TILE_QB][hdp]
  float* Ks = Qs + TILE_QB * hdp;         // [TILE_KEYS][hdp]
  float* Vs = Ks + TILE_KEYS * hdp;       // [TILE_KEYS][hdp]
  float* Ps = Vs + TILE_KEYS * hdp;       // [TILE_QB][TILE_KEYS]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = a.swap ? (w + a.BW / 2) % a.BW : w;
  const int nq = min(TILE_QB, N - q0);
  for (int e = threadIdx.x; e < nq * hd; e += blockDim.x) {
    const int r = e / hd, d = e - r * hd;
    Qs[r * hdp + d] = to_f(at<T>(a.q, w, head, q0 + r)[d]);
  }
  const T* kbase = at<T>(a.k, kw, head, 0);
  const T* vbase = at<T>(a.v, kw, head, 0);
  const float* mwin =
      a.mask ? a.mask + (int64_t)(w % a.mask_windows) * N * N : nullptr;
  float m[TILE_ROWS], l[TILE_ROWS], mxs[TILE_ROWS], mys[TILE_ROWS];
  float o[TILE_ROWS][MAX_DIMS];
#pragma unroll
  for (int r = 0; r < TILE_ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = mxs[r] = mys[r] = 0.f;
#pragma unroll
    for (int t = 0; t < MAX_DIMS; ++t) o[r][t] = 0.f;
  }
  const int rw = warp * TILE_ROWS;  // this warp's first row in the block
  for (int k0 = 0; k0 < N; k0 += TILE_KEYS) {
    const int nk = min(TILE_KEYS, N - k0);
    __syncthreads();  // the previous tile is consumed (and q is stored)
    for (int e = threadIdx.x; e < nk * hd; e += blockDim.x) {
      const int n = e / hd, d = e - n * hd;
      Ks[n * hdp + d] = to_f(kbase[(int64_t)(k0 + n) * a.k.sn + d]);
      Vs[n * hdp + d] = to_f(vbase[(int64_t)(k0 + n) * a.v.sn + d]);
    }
    __syncthreads();
    const int k = k0 + lane;
#pragma unroll
    for (int r = 0; r < TILE_ROWS; ++r) {
      const int q = q0 + rw + r;
      if (q >= N) break;  // warp-uniform
      float s = -INFINITY;
      if (lane < nk) {
        const float* qr = Qs + (rw + r) * hdp;
        const float* kr = Ks + lane * hdp;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
        acc *= a.scale;
        if (mwin) acc += mwin[(int64_t)q * N + k];
        s = acc;
      }
      const float mn = fmaxf(m[r], warp_max(s));
      const float mu = mn == -INFINITY ? 0.f : mn;  // a row all -inf so far
      const float corr = expf(m[r] - mu);
      const float p = lane < nk ? expf(s - mu) : 0.f;
      m[r] = mn;
      l[r] = l[r] * corr + warp_sum(p);
      if (a.rel) {
        const float rx = lane < nk ? a.rel[(int64_t)q * N + k] : 0.f;
        const float ry =
            lane < nk ? a.rel[(int64_t)N * N + (int64_t)q * N + k] : 0.f;
        mxs[r] = fmaf(p, rx, mxs[r] * corr);
        mys[r] = fmaf(p, ry, mys[r] * corr);
      }
#pragma unroll
      for (int t = 0; t < MAX_DIMS; ++t) o[r][t] *= corr;
      Ps[(rw + r) * TILE_KEYS + lane] = p;
    }
    __syncwarp();
    for (int kk = 0; kk < nk; ++kk) {
      const float* vr = Vs + kk * hdp;
      float vv[MAX_DIMS];
#pragma unroll
      for (int t = 0; t < MAX_DIMS; ++t) {
        const int d = lane + 32 * t;
        vv[t] = d < hd ? vr[d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < TILE_ROWS; ++r) {
        const float p = Ps[(rw + r) * TILE_KEYS + kk];
#pragma unroll
        for (int t = 0; t < MAX_DIMS; ++t) o[r][t] = fmaf(p, vv[t], o[r][t]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TILE_ROWS; ++r) {
    const int q = q0 + rw + r;
    if (q >= N) break;
    const float inv = 1.f / l[r];
    T* orow = at<T>(a.out, w, head, q);
#pragma unroll
    for (int t = 0; t < MAX_DIMS; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) orow[d] = from_f<T>(o[r][t] * inv);
    }
    if (a.rel) {
      const float sx = warp_sum(mxs[r]), sy = warp_sum(mys[r]);
      if (lane == 0) {
        T* mo = at<T>(a.motion, w, head, q);
        mo[0] = from_f<T>(sx * inv);
        mo[1] = from_f<T>(sy * inv);
      }
    }
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
__device__ __forceinline__ void zero_pad(bf16* buf, int bufs, int rows,
                                         int n, int hd, int dp, int ld) {
  const bf16 zero = __float2bfloat16_rn(0.0f);
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

// ---- bf16 attention over windows of any size: key tiles, online softmax
// attn_mma_kernel holds a whole window's q, k and v in shared memory and
// a warp's 16 x N scores in registers (N <= 160). Above that this form
// runs: one block of 4 warps per (window, head, 64 query rows); q's
// fragments stay in registers, k and v pass through a two-stage
// cp.async ring 64 keys at a time, and each warp keeps for its 16 rows
// a running max m and sum l (per thread over its own keys; the quad
// sums them at the end), the output accumulators and the motion
// moments, rescaled by 2^((m_old - m_new) log2 e) at each tile. The
// probabilities of a tile, exp(s - m_new) in f32, feed the motion
// moments and, rounded to bf16, the A fragments of P @ V; out and
// motion are divided by l at the end (so p is rounded before the
// division, the one difference from the single-pass form). Mask and rel
// are read at the warp's own (q, k) positions, tile by tile, as there.
// Shared memory: 5 x 64 rows of (head dim padded to 16) + 8 bf16.
constexpr int TQ = 64, TKEYS = 64;  // query rows a block, keys a tile

template <int DT>
__global__ void __launch_bounds__(128)
attn_mma_tiled_kernel(const __grid_constant__ AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem_attn[];
  const int head = blockIdx.x, w = blockIdx.y, q0 = blockIdx.z * TQ;
  const int N = a.N, hd = a.hd, dt = (hd + 15) >> 4;
  const int dp = dt * 16, ld = dp + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_attn);  // then K0, V0, K1, V1
  auto kbuf = [&](int b) { return Qs + (1 + 2 * b) * TQ * ld; };
  const int kw = a.swap ? (w + a.BW / 2) % a.BW : w;
  const int nq = min(TQ, N - q0), tiles = (N + TKEYS - 1) / TKEYS;
  // a view of rows [row0, ...) of (window, head) of an operand
  auto rows_of = [](const View& v, int win, int hh, int row0) {
    View r = v;
    r.ptr = at<bf16>(v, win, hh, row0);
    return r;
  };
  auto load_tile = [&](int t) {
    const int n = min(TKEYS, N - t * TKEYS);
    bf16* kb = kbuf(t & 1);
    load_rows(kb, ld, rows_of(a.k, kw, head, t * TKEYS), 0, 0, n, 2 * hd,
              a.width);
    load_rows(kb + TQ * ld, ld, rows_of(a.v, kw, head, t * TKEYS), 0, 0, n,
              2 * hd, a.width);
    if (n < TKEYS) zero_pad(kb, 2, TKEYS, n, hd, dp, ld);  // rows past N
  };
  zero_pad(Qs, 5, TQ, TQ, hd, dp, ld);  // the head-dim padding
  __syncthreads();  // before any row padding overwrites it
  load_rows(Qs, ld, rows_of(a.q, w, head, q0), 0, 0, nq, 2 * hd, a.width);
  if (nq < TQ) zero_pad(Qs, 1, TQ, nq, hd, dp, ld);
  load_tile(0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3, r0 = warp * 16;
  bf16* Qw = Qs + r0 * ld;
  const int qr[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const bool pair = N % 2 == 0;  // (q N + k) even: 8-byte mask / rel pairs
  const float* mrow[2] = {nullptr, nullptr};
  const float* rrow[2] = {nullptr, nullptr};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (qr[h] < N) {
      if (a.mask)
        mrow[h] = a.mask + ((int64_t)(w % a.mask_windows) * N + qr[h]) * N +
                  tig * 2;
      if (a.rel) rrow[h] = a.rel + (int64_t)qr[h] * N + tig * 2;
    }
  const float l2e = 1.4426950408889634f;
  uint32_t qa[DT][4];
  float o[2 * DT][4];
#pragma unroll
  for (int j = 0; j < 2 * DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float mo[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {  // its buffer was last read in tile t - 1
      load_tile(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DT; ++kk)
        if (kk < dt)
          ldsm_x4(qa[kk], Qw + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* Ks = kbuf(t & 1);
    const bf16* Vs = Ks + TQ * ld;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      if (kk >= dt) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t kb[4];
        ldsm_x4(kb, Ks + (j * 16 + (lane >> 4) * 8 + (lane & 7)) * ld +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * j], qa[kk], kb[0], kb[1]);
        mma16816(s[2 * j + 1], qa[kk], kb[2], kb[3]);
      }
    }
    // scale + mask, the tile's row max (keys past N: -inf)
    const int kt0 = t * TKEYS;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = kt0 + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = -INFINITY, v1 = -INFINITY;
        if (k < N) {
          float2 mk = make_float2(0.0f, 0.0f);
          if (mrow[h]) mk = ld2(mrow[h] + kt0 + j * 8, k + 1 < N, pair);
          v0 = __fadd_rn(__fmul_rn(s[j][2 * h], a.scale), mk.x);
          if (k + 1 < N)
            v1 = __fadd_rn(__fmul_rn(s[j][2 * h + 1], a.scale), mk.y);
        }
        s[j][2 * h] = v0;
        s[j][2 * h + 1] = v1;
        mx[h] = fmaxf(mx[h], fmaxf(v0, v1));
      }
    }
    float mb[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      const float mu = mn == -INFINITY ? 0.0f : mn;  // a row all -inf so far
      corr[h] = ex2((m[h] - mu) * l2e);
      m[h] = mn;
      mb[h] = mu * l2e;
      l[h] *= corr[h];
      mo[h][0] *= corr[h];
      mo[h][1] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 2 * DT; ++j) {
      if (j >= 2 * dt) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = kt0 + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = ex2(fmaf(s[j][2 * h], l2e, -mb[h]));
        const float p1 = ex2(fmaf(s[j][2 * h + 1], l2e, -mb[h]));
        s[j][2 * h] = p0;
        s[j][2 * h + 1] = p1;
        l[h] += p0 + p1;
        if (rrow[h] && k < N) {
          const int off = kt0 + j * 8;
          const float2 rx = ld2(rrow[h] + off, k + 1 < N, pair);
          const float2 ry =
              ld2(rrow[h] + (int64_t)N * N + off, k + 1 < N, pair);
          mo[h][0] = fmaf(p1, rx.y, fmaf(p0, rx.x, mo[h][0]));
          mo[h][1] = fmaf(p1, ry.y, fmaf(p0, ry.x, mo[h][1]));
        }
      }
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nt = 0; nt < DT; ++nt) {
        if (nt >= dt) break;
        uint32_t vb[4];
        ldsm_x4_t(vb, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               ld + nt * 16 + (lane >> 4) * 8);
        mma16816(o[2 * nt], pa[kk], vb[0], vb[1]);
        mma16816(o[2 * nt + 1], pa[kk], vb[2], vb[3]);
      }
    __syncthreads();  // this buffer is refilled at tile t + 2
  }
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
  if (a.rel && tig == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qr[h] < N) {
        bf16* mp = at<bf16>(a.motion, w, head, qr[h]);
        mp[0] = __float2bfloat16_rn(mo[h][0] * inv[h]);
        mp[1] = __float2bfloat16_rn(mo[h][1] * inv[h]);
      }
  // stage the rounded rows in this warp's q rows, then write them out
#pragma unroll
  for (int j = 0; j < 2 * DT; ++j) {
    if (j >= 2 * dt) break;
    const int c = j * 8 + tig * 2;
    *reinterpret_cast<__nv_bfloat162*>(Qw + g * ld + c) =
        __floats2bfloat162_rn(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(Qw + (g + 8) * ld + c) =
        __floats2bfloat162_rn(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  if (r0 < nq)
    store_rows(Qw, ld, rows_of(a.out, w, head, q0), 0, 0, r0,
               min(16, nq - r0), 2 * hd, a.width, lane);
}

template <int DT>
cudaError_t launch_tiled(const AttnArgs& a, int heads, cudaStream_t st) {
  const int ld = (a.hd + 15) / 16 * 16 + 8;
  const int smem = 5 * TQ * ld * 2;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_mma_tiled_kernel<DT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  attn_mma_tiled_kernel<DT>
      <<<dim3(heads, a.BW, (a.N + TQ - 1) / TQ), 128, smem, st>>>(a);
  return cudaGetLastError();
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

// Widest piece (16, 8, 4 or 2 bytes) that every row of q, k, v and out
// starts on and that divides a head's row.
inline int piece_width(const AttnArgs& a) {
  const View* views[4] = {&a.q, &a.k, &a.v, &a.out};
  int w = 16;
  for (; w > 2; w /= 2) {
    bool ok = (2 * a.hd) % w == 0;
    for (const View* v : views)
      ok = ok && reinterpret_cast<uintptr_t>(v->ptr) % w == 0 &&
           (2 * v->sw) % w == 0 && (2 * v->sh) % w == 0 &&
           (2 * v->sn) % w == 0;
    if (ok) break;
  }
  return w;
}

}  // namespace mma_attn

// The window-attention launch: bf16 on the tensor cores
// (mma_attn::attn_mma_kernel), f32 as true f32 on the CUDA cores
// (attn_kernel, the parity mode: JAX computes f32 at HIGHEST precision,
// so TF32 products would not be the same function).
template <typename T>
cudaError_t launch_attn(AttnArgs a, int heads, cudaStream_t st) {
  if (a.BW < 1 || a.N < 1 || heads < 1 || a.hd < 1 ||
      a.hd > 32 * MAX_DIMS || (a.swap && a.BW % 2) ||
      (a.mask && (a.mask_windows < 1 || a.BW % a.mask_windows)) ||
      (a.rel && !a.motion.ptr) || (a.N + TILE_QB - 1) / TILE_QB > 65535)
    return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    a.width = mma_attn::piece_width(a);
    if (a.N <= 64) return mma_attn::launch_dt<4>(a, heads, st);
    if (a.N <= 144) return mma_attn::launch_dt<9>(a, heads, st);
    if (a.N <= SINGLE_PASS_KEYS) return mma_attn::launch_dt<10>(a, heads, st);
    if (a.hd <= 32) return mma_attn::launch_tiled<2>(a, heads, st);
    if (a.hd <= 48) return mma_attn::launch_tiled<3>(a, heads, st);
    if (a.hd <= 96) return mma_attn::launch_tiled<6>(a, heads, st);
    return mma_attn::launch_tiled<8>(a, heads, st);
  } else if (a.N > SINGLE_PASS_KEYS) {
    const int hdp = a.hd | 1;
    const int smem = sizeof(float) * (TILE_QB * hdp + 2 * TILE_KEYS * hdp +
                                      TILE_QB * TILE_KEYS);
    attn_tiled_kernel<T><<<dim3(heads, a.BW, (a.N + TILE_QB - 1) / TILE_QB),
                           ATT_WARPS * 32, smem, st>>>(a);
    return cudaGetLastError();
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
// then wproj's. bf16 takes C <= 1024 (ln_rows_kernel).
template <typename T>
int atm_block(int only, const void* x, const void* wqkv,
              const void* wproj, const void* bproj, const void* wmaps,
              const void* ln_g, const void* ln_b, const void* rel,
              const void* mask, int mask_windows, void* xn, void* qkv,
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
// holds (sw, sh, sn) for q, k, v, out and motion, in that order.
template <typename T>
int window_attention(const void* q, const void* k, const void* v,
                     const int64_t* strides, void* out, void* motion,
                     const void* rel, const void* mask, int mask_windows,
                     int BW, int N, int hd, int heads, float scale,
                     void* stream) {
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
                      const void* mask, int mask_windows, void* xn,           \
                      void* qkv, void* app, void* y, void* motion, int BW,    \
                      int N, int C, int heads, int swap, float scale,         \
                      void* stream) {                                         \
    return atm_block<T>(0, x, wqkv, wproj, bproj, wmaps, ln_g, ln_b, rel,     \
                        mask, mask_windows, xn, qkv, app, y, motion, BW, N,   \
                        C, heads, swap, scale, stream);                       \
  }                                                                           \
  extern "C" int LAUNCH_NAME(                                                 \
      int only, const void* x, const void* wqkv, const void* wproj,           \
      const void* bproj, const void* wmaps, const void* ln_g,                 \
      const void* ln_b, const void* rel, const void* mask, int mask_windows,  \
      void* xn, void* qkv, void* app, void* y, void* motion, int BW, int N,   \
      int C, int heads, int swap, float scale, void* stream) {                \
    return atm_block<T>(only, x, wqkv, wproj, bproj, wmaps, ln_g, ln_b, rel,  \
                        mask, mask_windows, xn, qkv, app, y, motion, BW, N,   \
                        C, heads, swap, scale, stream);                       \
  }

ATM_BLOCK_ENTRY(atm_block_f32, atm_block_launch_f32, float)
ATM_BLOCK_ENTRY(atm_block_bf16, atm_block_launch_bf16, bf16)

#define WINDOW_ATTENTION_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const int64_t* strides, void* out, void* motion,      \
                      const void* rel, const void* mask, int mask_windows,  \
                      int BW, int N, int hd, int heads, float scale,        \
                      void* stream) {                                       \
    return window_attention<T>(q, k, v, strides, out, motion, rel, mask,    \
                               mask_windows, BW, N, hd, heads, scale,       \
                               stream);                                     \
  }

WINDOW_ATTENTION_ENTRY(window_attention_f32, float)
WINDOW_ATTENTION_ENTRY(window_attention_bf16, bf16)

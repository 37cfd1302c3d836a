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
//      [BW*N, C] x [C, 3C] whose A-tile loader normalises each row on
//      the fly (row statistics computed per block) and whose first
//      column of blocks also stores xn for the residual. The swap is
//      not applied here: launch 2 reads k and v from the partner
//      window by index, so the swapped tensor never exists.
//   2. attention + motion moment, one block per (window, head), k and
//      v of the partner window in shared memory: bf16 on the tensor
//      cores, one warp per 16 query rows (`mma_attn`); f32 with k and v
//      as f32 (odd row stride), each warp walking query rows with
//      scalar FMAs (`attn_kernel`).
//   3. projection GEMM with bias and the residual in its epilogue.
// A whole global window in bf16 is 144 x 672 x 2 B = 193 KB, more than
// a block can hold beside q, k and v, which is why the TPU's one-pass
// form is split here.
//
// Bound: at the 1080p shapes the projections are ~85% of the flops
// (local/enhance: 2*BW*N*C*4C = 77 GFLOP per call; global 62 GFLOP) on
// ~0.2 GB of traffic, so every call is bound by operations, the global
// block and the local block alike. bf16 products run on the tensor
// cores through WMMA 16x16x16 fragments; f32 runs on the CUDA cores in
// true f32 (the JAX kernel computes f32 at HIGHEST precision, so TF32
// would not be the same function). Left for later: wgmma with TMA-fed
// shared-memory rings, one persistent launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

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

// ---- bf16: tensor-core GEMM through WMMA, 128x64 tile, 8 warps -----
namespace wm {
constexpr int BM = 128, BN = 64, BK = 32;
constexpr int LDS = BK + 8;  // bf16 row stride of the A/B tiles
constexpr int LDC = BN + 4;  // f32 row stride of the epilogue tile
constexpr int SMEM = BM * LDC * 4;  // epilogue tile; A/B tiles alias it
static_assert((BM + BN) * LDS * 2 <= SMEM, "tiles must fit the union");
}  // namespace wm

union Pack8 {  // 8 bf16 values as raw bits, one 16-byte access
  uint4 u;
  unsigned short h[8];
};

template <int MODE>
__global__ void __launch_bounds__(256) gemm_bf16_kernel(GemmArgs g) {
  using namespace nvcuda;
  using namespace wm;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ float s_mu[BM], s_rs[BM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem);
  const bf16* __restrict__ A = static_cast<const bf16*>(g.A);
  const bf16* __restrict__ W = static_cast<const bf16*>(g.W);
  bf16* out = static_cast<bf16*>(g.out);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = (warp & 3) * 32, wc = (warp >> 2) * 32;  // warp's tile
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = g.M, N = g.Nout, K = g.K;  // K % 8 == 0 (host check)
  if (MODE == 0) {
    row_stats<BM>(A, M, K, m0, s_mu, s_rs);
    __syncthreads();
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM rows x BK/8 chunks of 8 values (16 bytes)
    for (int c = tid; c < BM * (BK / 8); c += blockDim.x) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int m = m0 + r, k = k0 + kc;
      Pack8 p;
      p.u = make_uint4(0, 0, 0, 0);
      if (m < M && k < K) {
        p.u = *reinterpret_cast<const uint4*>(A + (int64_t)m * K + k);
        if (MODE == 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            p.h[i] = __bfloat16_as_ushort(__float2bfloat16_rn(
                (__bfloat162float(__ushort_as_bfloat16(p.h[i])) - s_mu[r]) *
                    s_rs[r] * g.ln_g[k + i] + g.ln_b[k + i]));
          if (blockIdx.y == 0)
            *reinterpret_cast<uint4*>(static_cast<bf16*>(g.xn_out) +
                                      (int64_t)m * K + k) = p.u;
        }
      }
      *reinterpret_cast<uint4*>(As + r * LDS + kc) = p.u;
    }
    for (int c = tid; c < BN * (BK / 8); c += blockDim.x) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int n = n0 + r, k = k0 + kc;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (n < N && k < K)
        u = *reinterpret_cast<const uint4*>(W + (int64_t)n * K + k);
      *reinterpret_cast<uint4*>(Bs + r * LDS + kc) = u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wr + 16 * i) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + (wc + 16 * j) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr + 16 * i) * LDC + wc + 16 * j,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += blockDim.x) {
    const int r = e / BN, c = e % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = Cs[r * LDC + c];
    if (MODE == 1)
      v = __bfloat162float(
              static_cast<const bf16*>(g.resid)[(int64_t)m * N + n]) +
          (v + __bfloat162float(static_cast<const bf16*>(g.bias)[n]));
    out[(int64_t)m * N + n] = __float2bfloat16_rn(v);
  }
}

// ---- attention + motion moment, one block per (window, head) -------
// Shared by K1 (launch 2 of the block) and the window-attention entry
// points K7 / K8, which read q, k and v at any strides.
constexpr int ATT_WARPS = 4;
constexpr int MAX_KEYS = 5;  // N <= 160 keys: 5 per lane
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
  if (a.BW < 1 || a.N < 1 || a.N > 32 * MAX_KEYS || heads < 1 || a.hd < 1 ||
      a.hd > 32 * MAX_DIMS || (a.swap && a.BW % 2) ||
      (a.mask && (a.mask_windows < 1 || a.BW % a.mask_windows)) ||
      (a.rel && !a.motion.ptr))
    return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    a.width = mma_attn::piece_width(a);
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

template <typename T, int MODE>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    dim3 grid((g.M + wm::BM - 1) / wm::BM, (g.Nout + wm::BN - 1) / wm::BN);
    gemm_bf16_kernel<MODE><<<grid, 256, 0, st>>>(g);
  } else {
    dim3 grid((g.M + 63) / 64, (g.Nout + 63) / 64);
    gemm_f32_kernel<MODE><<<grid, 256, 0, st>>>(g);
  }
  return cudaGetLastError();
}

template <typename T>
int atm_block(const void* x, const void* wqkv, const void* wproj,
              const void* bproj, const void* ln_g, const void* ln_b,
              const void* rel, const void* mask, int mask_windows, void* xn,
              void* qkv, void* app, void* y, void* motion, int BW, int N,
              int C, int heads, int swap, float scale, void* stream) {
  if (BW < 1 || N < 1 || N > 32 * MAX_KEYS || heads < 1 || C % heads ||
      C % 8 || C / heads > 32 * MAX_DIMS || (swap && BW % 2) ||
      (mask && (mask_windows < 1 || BW % mask_windows)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = BW * N;
  GemmArgs g1{x, wqkv, qkv, M, 3 * C, C,
              static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
              xn, nullptr, nullptr};
  cudaError_t err = launch_gemm<T, 0>(g1, st);
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
  err = launch_attn<T>(a, heads, st);
  if (err != cudaSuccess) return (int)err;

  GemmArgs g3{app, wproj, y, M, C, C, nullptr, nullptr, nullptr, bproj, xn};
  return (int)launch_gemm<T, 1>(g3, st);
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

extern "C" int atm_block_f32(const void* x, const void* wqkv,
                             const void* wproj, const void* bproj,
                             const void* ln_g, const void* ln_b,
                             const void* rel, const void* mask,
                             int mask_windows, void* xn, void* qkv, void* app,
                             void* y, void* motion, int BW, int N, int C,
                             int heads, int swap, float scale, void* stream) {
  return atm_block<float>(x, wqkv, wproj, bproj, ln_g, ln_b, rel, mask,
                          mask_windows, xn, qkv, app, y, motion, BW, N, C,
                          heads, swap, scale, stream);
}

extern "C" int atm_block_bf16(const void* x, const void* wqkv,
                              const void* wproj, const void* bproj,
                              const void* ln_g, const void* ln_b,
                              const void* rel, const void* mask,
                              int mask_windows, void* xn, void* qkv,
                              void* app, void* y, void* motion, int BW, int N,
                              int C, int heads, int swap, float scale,
                              void* stream) {
  return atm_block<bf16>(x, wqkv, wproj, bproj, ln_g, ln_b, rel, mask,
                         mask_windows, xn, qkv, app, y, motion, BW, N, C,
                         heads, swap, scale, stream);
}

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

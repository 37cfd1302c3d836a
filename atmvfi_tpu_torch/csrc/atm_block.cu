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
// q, k, v element is read once per (window, head), but the products run
// as scalar f32 FMAs on the CUDA cores, which bound the launch; left for
// later: the products on the tensor cores (the head dims 48, 84, 28 and
// 44 need padding to 16).
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
//   2. attention + motion moment, one block per (window, head): k and
//      v of the partner window sit in shared memory (f32, odd row
//      stride, no bank conflicts); each warp walks query rows, keeps
//      its scores in registers and reduces with shuffles.
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
// shared-memory rings, one persistent launch, flash-style attention on
// the tensor cores.
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

template <typename T>
cudaError_t launch_attn(const AttnArgs& a, int heads, cudaStream_t st) {
  if (a.BW < 1 || a.N < 1 || a.N > 32 * MAX_KEYS || heads < 1 || a.hd < 1 ||
      a.hd > 32 * MAX_DIMS || (a.swap && a.BW % 2) ||
      (a.mask && (a.mask_windows < 1 || a.BW % a.mask_windows)) ||
      (a.rel && !a.motion.ptr))
    return cudaErrorInvalidValue;
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

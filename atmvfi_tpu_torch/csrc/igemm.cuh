// Implicit-GEMM core shared by the conv kernels K3-K5 (conv3x3.cu), the
// deconv kernel K6 (deconv2x.cu) and the fused conv pair K12
// (conv_pair.cu), for sm_90a.
//
// One GEMM row per output pixel (conv) or input pixel (deconv), one
// GEMM column per output channel (conv) or per (parity, channel) pair
// (deconv). The reduction runs over taps x input channels: for each of
// the `taps` positions of the window (9 for a 3x3 conv, 1 for the
// deconv) and each BK-deep chunk of the concatenated input channels.
// The A tile (pixels x channels) is gathered straight from the NHWC
// sources: zero padding, image and batch edges and ragged channel
// counts are masked in the loader, so no padded copy of an input is
// ever made. An input may be the channel concatenation of up to
// MAX_SRC sources, each with its own pointer, channel count, pixel
// stride (a channel slice is read in place) and type; an f32 source in
// a bf16 GEMM is rounded to bf16 as it is loaded.
//
// A bf16 source whose pixel stride is a multiple of 8, whose pointer is
// 16-byte aligned and whose storage holds channels up to C rounded up
// to 8 in every pixel (`vec`, decided by the wrapper) is read with
// 16-byte vectors, the lanes at or past C zeroed in registers. The
// outputs of these kernels are such tensors: a wrapper gives an output
// whose channel count is not a multiple of 8 a pixel stride rounded up
// to 8, so the decoder's 389-, 197- and 101-channel maps are read as
// vectors by the next conv.
//
// Weights come packed by the wrapper as [taps][N][Kp] in the working
// type (Kp = channels rounded up to 8, zero beyond them), so the B tile
// loads are 16-byte vectors.
//
// bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32 sums).
// f32:  true f32 FMAs on the CUDA cores (never TF32), as the TPU
//       kernels run f32 at Precision.HIGHEST.
// Epilogue on the f32 sums: + bias, then PReLU max(y,0) + a*min(y,0)
// (f32, rounded operations, no contraction), then one rounding to the
// output type. A tile is double-buffered in shared memory with a
// register prefetch of the next tile, one barrier per reduction step.
//
// This is the simple form: no TMA, no wgmma, no persistent schedule.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_SRC = 6;

struct Src {
  const void* ptr;
  long long ps;  // pixel stride, elements
  int C;         // channels
  int coff;      // first channel of this source in the concatenation
  int f32;       // 1: float, 0: bf16
  int vec;       // bf16 and readable as 16-byte vectors (see above)
};

struct Problem {
  Src src[MAX_SRC];
  int nsrc;
  int Ctot;                  // concatenated input channels
  int B, H, W;               // input grid
  int Ho, Wo;                // GEMM rows are the B*Ho*Wo pixels
  int stride, pad, ksize;    // conv 3x3: (s, 1, 3); deconv: (1, 0, 1)
  const void* w;             // packed [ksize^2][N][Kp], working type
  int N;                     // GEMM columns
  int Kp;
  const float* bias;         // [Cout]
  const float* slope;        // [Cout] or null: no PReLU
  void* out;
  int Cout;
  long long ops;             // output pixel stride (>= Cout)
  int deconv;                // 1: scatter column n = p*Cout + c to parity p
};

__device__ __forceinline__ float load_elem(const Problem& p, long long pix,
                                           int c) {
#pragma unroll
  for (int s = 0; s < MAX_SRC; ++s) {
    if (s < p.nsrc) {
      const int lc = c - p.src[s].coff;
      if (lc >= 0 && lc < p.src[s].C) {
        const long long off = pix * p.src[s].ps + lc;
        return p.src[s].f32
                   ? static_cast<const float*>(p.src[s].ptr)[off]
                   : __bfloat162float(
                         static_cast<const __nv_bfloat16*>(p.src[s].ptr)[off]);
      }
    }
  }
  return 0.0f;
}

// Output pixel m of the GEMM as (b, oy, ox), and the input pixel of tap
// (ty, tx) under it (-1 outside the image: zero padding).
struct RowPos {
  int b, oy, ox;
  bool ok;
};

__device__ __forceinline__ RowPos row_pos(const Problem& p, int m, int M) {
  RowPos r;
  r.ok = m < M;
  const int mm = r.ok ? m : 0;
  const int hw = p.Ho * p.Wo;
  r.b = mm / hw;
  const int rem = mm - r.b * hw;
  r.oy = rem / p.Wo;
  r.ox = rem - r.oy * p.Wo;
  return r;
}

__device__ __forceinline__ long long tap_pixel(const Problem& p,
                                               const RowPos& r, int tap) {
  const int ty = tap / p.ksize;
  const int tx = tap - ty * p.ksize;
  const int iy = r.oy * p.stride + ty - p.pad;
  const int ix = r.ox * p.stride + tx - p.pad;
  if (!r.ok || iy < 0 || iy >= p.H || ix < 0 || ix >= p.W) return -1;
  return ((long long)r.b * p.H + iy) * p.W + ix;
}

// Bias and PReLU on the f32 sum of GEMM column n (rounded operations,
// no contraction: the plain version's order).
__device__ __forceinline__ float epilogue(const Problem& p, int n,
                                          float acc) {
  const int co = p.deconv ? n % p.Cout : n;
  float y = __fadd_rn(acc, p.bias[co]);
  if (p.slope)
    y = __fadd_rn(fmaxf(y, 0.0f), __fmul_rn(p.slope[co], fminf(y, 0.0f)));
  return y;
}

// Output element of GEMM entry (m, n): NHWC [B, Ho, Wo, Cout] for a
// conv; for the deconv, column n = (2*dy + dx) * Cout + co of input
// pixel m goes to pixel (2y+dy, 2x+dx) of [B, 2H, 2W, Cout].
__device__ __forceinline__ long long out_index(const Problem& p, int m,
                                               int n) {
  if (!p.deconv) return (long long)m * p.ops + n;
  const int par = n / p.Cout;
  const int co = n - par * p.Cout;
  const int hw = p.H * p.W;
  const int b = m / hw;
  const int rem = m - b * hw;
  const int iy = rem / p.W;
  const int ix = rem - iy * p.W;
  const int oy = 2 * iy + (par >> 1);
  const int ox = 2 * ix + (par & 1);
  return (((long long)b * 2 * p.H + oy) * 2 * p.W + ox) * p.ops + co;
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores: BM x BN block tile, BK-deep steps, 8 warps
// as 4 (rows) x 2 (columns), each warp 32 x BN/2 of m16n8k16 tiles,
// fragments read with ldmatrix. The epilogue stages the rounded tile in
// shared memory and writes it out along the channels (coalesced).
namespace tc {
constexpr int BM = 128, BK = 32, THREADS = 256, LDS = BK + 8;

// A-tile loaders
constexpr int LOAD_ANY = 0;   // any sources: per-element source lookup,
                              // vector loads for chunks inside a `vec`
                              // first source
constexpr int LOAD_BF16 = 1;  // one bf16 source: 16-bit loads
constexpr int LOAD_VEC = 2;   // one `vec` source: 16-byte vector loads

// 8 channels [c, c + 8) of pixel `pix` of a `vec` source; lanes at or
// past C are zero.
__device__ __forceinline__ uint4 load_vec8(const Src& s, long long pix,
                                           int c) {
  if (pix < 0 || c >= s.C) return make_uint4(0, 0, 0, 0);
  uint4 v = *reinterpret_cast<const uint4*>(
      static_cast<const __nv_bfloat16*>(s.ptr) + pix * s.ps + c);
  if (c + 8 > s.C) {
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = c + 2 * e;
      w[e] = k >= s.C ? 0u : (k + 1 >= s.C ? (w[e] & 0xffffu) : w[e]);
    }
  }
  return v;
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* ptr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One BK-deep step of the warp's 32 x BN/2 tile from shared memory.
template <int BN>
__device__ __forceinline__ void mma_step(const __nv_bfloat16 (*As)[LDS],
                                         const __nv_bfloat16 (*Bs)[LDS],
                                         float (&acc)[2][BN / 16][4], int wm,
                                         int wn, int lane) {
  constexpr int NT = BN / 16;  // n8 tiles per warp
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t a[2][4], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm_x4(a[mt], &As[wm * 32 + mt * 16 + (lane & 15)][ks + (lane >> 4) * 8]);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t r[4];
      ldsm_x4(r, &Bs[wn * (BN / 2) + nt * 8 + (lane >> 4) * 8 + (lane & 7)]
                    [ks + ((lane >> 3) & 1) * 8]);
      b[nt][0] = r[0];
      b[nt][1] = r[1];
      b[nt + 1][0] = r[2];
      b[nt + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
  }
}

// Epilogue: bias + PReLU in f32, one rounding, the tile staged in shared
// memory `smem` (free: the caller has passed its last main-loop barrier),
// then written out along the channels, each thread keeping one column.
template <int BN>
__device__ __forceinline__ void store_tile(const Problem& p,
                                           const float (&acc)[2][BN / 16][4],
                                           unsigned char* smem, int m0,
                                           int n0, int M) {
  constexpr int NT = BN / 16;
  __shared__ long long row_base[BM];  // output offset of column 0, or -1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3, wm = warp & 3, wn = warp >> 2;
  auto Ct = reinterpret_cast<__nv_bfloat16(*)[BN + 8]>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mt * 16 + g + 8 * h;
        const int col = wn * (BN / 2) + nt * 8 + tig * 2;
        const int n = n0 + col;
        const float y0 = n < p.N ? epilogue(p, n, acc[mt][nt][2 * h]) : 0.f;
        const float y1 =
            n + 1 < p.N ? epilogue(p, n + 1, acc[mt][nt][2 * h + 1]) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(&Ct[row][col]) =
            __floats2bfloat162_rn(y0, y1);
      }
  if (tid < BM) row_base[tid] = m0 + tid < M ? out_index(p, m0 + tid, 0) : -1;
  __syncthreads();
  const int c = tid % BN;
  const int n = n0 + c;
  if (n < p.N) {
    // offset of column n from column 0 of the same GEMM row
    const long long col_off = out_index(p, 0, n) - out_index(p, 0, 0);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    for (int r = tid / BN; r < BM; r += THREADS / BN) {
      const long long base = row_base[r];
      if (base >= 0) out[base + col_off] = Ct[r][c];
    }
  }
}

template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * (BM + BN) * LDS * 2 > BM * (BN + 8) * 2 ? 2 * (BM + BN) * LDS * 2
                                                     : BM * (BN + 8) * 2;
}

// The next step's A and B tiles are loaded into registers while the
// tensor cores work on the current one; two shared-memory buffers, one
// barrier per step.
template <int BN, int LOAD>
__global__ void __launch_bounds__(THREADS)
    igemm_bf16_kernel(const __grid_constant__ Problem p) {
  constexpr int NT = BN / 16;
  __shared__ __align__(16) unsigned char smem[smem_bytes<BN>()];
  auto As = reinterpret_cast<__nv_bfloat16(*)[BM][LDS]>(smem);
  auto Bs = reinterpret_cast<__nv_bfloat16(*)[BN][LDS]>(
      smem + 2 * BM * LDS * 2);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int M = p.B * p.Ho * p.Wo;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;

  // A loader: one pixel row, 16 channels (half of BK)
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 16;
  const RowPos rp = row_pos(p, m0 + a_row, M);
  // B loader: rows n, 8 channels each; BN * 4 vectors per step
  constexpr int B_VECS = BN * (BK / 8);
  constexpr int B_PER = (B_VECS + THREADS - 1) / THREADS;
  const int nkc = (p.Ctot + BK - 1) / BK;
  const int taps = p.ksize * p.ksize;
  const int steps = taps * nkc;
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(p.w);

  uint4 ra[2];
  uint4 rb[B_PER];

  auto load = [&](int step) {
    const int tap = step / nkc;
    const int c0 = (step - tap * nkc) * BK;
    const long long pix = tap_pixel(p, rp, tap);
    if (LOAD == LOAD_VEC ||
        (LOAD == LOAD_ANY && p.src[0].vec && c0 + BK <= p.src[0].C)) {
      ra[0] = load_vec8(p.src[0], pix, c0 + a_k);
      ra[1] = load_vec8(p.src[0], pix, c0 + a_k + 8);
    } else if (LOAD == LOAD_BF16) {
      const int c = c0 + a_k;
      const uint16_t* src = static_cast<const uint16_t*>(p.src[0].ptr) +
                            (pix >= 0 ? pix : 0) * p.src[0].ps + c;
      uint32_t* r = reinterpret_cast<uint32_t*>(ra);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t lo =
            (pix >= 0 && c + 2 * j < p.Ctot) ? src[2 * j] : 0u;
        const uint32_t hi =
            (pix >= 0 && c + 2 * j + 1 < p.Ctot) ? src[2 * j + 1] : 0u;
        r[j] = lo | (hi << 16);
      }
    } else {
      // walk the sources along the thread's 16 channels (each source has
      // at least one channel, so one step advances at most one source)
      const int c = c0 + a_k;
      int s = 0;
#pragma unroll
      for (int q = 1; q < MAX_SRC; ++q)
        if (q < p.nsrc && c >= p.src[q].coff) s = q;
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        v[j] = 0.0f;
        if (pix >= 0 && c + j < p.Ctot) {
          if (s + 1 < p.nsrc && c + j >= p.src[s + 1].coff) ++s;
          const long long off = pix * p.src[s].ps + (c + j - p.src[s].coff);
          v[j] = p.src[s].f32
                     ? static_cast<const float*>(p.src[s].ptr)[off]
                     : __bfloat162float(static_cast<const __nv_bfloat16*>(
                           p.src[s].ptr)[off]);
        }
      }
      uint32_t* r = reinterpret_cast<uint32_t*>(ra);
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] = pack2(v[2 * j], v[2 * j + 1]);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int v = tid + i * THREADS;
      const int n = v >> 2;
      const int k = c0 + (v & 3) * 8;
      if (v < B_VECS && n0 + n < p.N && k < p.Kp)
        rb[i] = *reinterpret_cast<const uint4*>(
            wp + ((long long)tap * p.N + n0 + n) * p.Kp + k);
      else
        rb[i] = make_uint4(0, 0, 0, 0);
    }
  };
  auto stash = [&](int buf) {
    *reinterpret_cast<uint4*>(&As[buf][a_row][a_k]) = ra[0];
    *reinterpret_cast<uint4*>(&As[buf][a_row][a_k + 8]) = ra[1];
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int v = tid + i * THREADS;
      if (v < B_VECS)
        *reinterpret_cast<uint4*>(&Bs[buf][v >> 2][(v & 3) * 8]) = rb[i];
    }
  };

  float acc[2][NT][4] = {};
  load(0);
  stash(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load(step + 1);
    mma_step<BN>(As[buf], Bs[buf], acc, wm, wn, lane);
    if (step + 1 < steps) stash(buf ^ 1);
    __syncthreads();
  }
  store_tile<BN>(p, acc, smem, m0, n0, M);
}

}  // namespace tc

// ---------------------------------------------------------------------
// f32 on the CUDA cores: 64 x 64 block tile, 16-deep steps, 4 x 4
// outputs per thread.
namespace fma32 {
constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    igemm_f32_kernel(const __grid_constant__ Problem p) {
  __shared__ __align__(16) float As[2][BK][BM + 4];
  __shared__ __align__(16) float Bs[2][BK][BN + 4];
  const int tid = threadIdx.x;
  const int M = p.B * p.Ho * p.Wo;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int ld_row = tid >> 2;       // A: pixel; B: column
  const int ld_k = (tid & 3) * 4;    // 4 channels
  const RowPos rp = row_pos(p, m0 + ld_row, M);
  const int nkc = (p.Ctot + BK - 1) / BK;
  const int steps = p.ksize * p.ksize * nkc;
  const float* wp = static_cast<const float*>(p.w);
  const int tx = tid & 15, ty = tid >> 4;

  float ra[4];
  float4 rb;
  auto load = [&](int step) {
    const int tap = step / nkc;
    const int c0 = (step - tap * nkc) * BK;
    const long long pix = tap_pixel(p, rp, tap);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ra[j] = pix >= 0 ? load_elem(p, pix, c0 + ld_k + j) : 0.0f;
    const int k = c0 + ld_k;
    if (n0 + ld_row < p.N && k < p.Kp)
      rb = *reinterpret_cast<const float4*>(
          wp + ((long long)tap * p.N + n0 + ld_row) * p.Kp + k);
    else
      rb = make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) As[buf][ld_k + j][ld_row] = ra[j];
    Bs[buf][ld_k + 0][ld_row] = rb.x;
    Bs[buf][ld_k + 1][ld_row] = rb.y;
    Bs[buf][ld_k + 2][ld_row] = rb.z;
    Bs[buf][ld_k + 3][ld_row] = rb.w;
  };

  float acc[4][4] = {};
  load(0);
  stash(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load(step + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (step + 1 < steps) stash(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.N)
        static_cast<float*>(p.out)[out_index(p, m, n)] =
            epilogue(p, n, acc[i][j]);
    }
  }
}
}  // namespace fma32

// Launch one GEMM on `stream`; bf16 picks the column tile from N and the
// vector loader when the single source allows it. Returns a CUDA error
// code (0 on success).
inline int launch_igemm(const Problem& p, bool bf16, void* stream) {
  const long long M = (long long)p.B * p.Ho * p.Wo;
  if (M <= 0 || p.N <= 0 || p.Ctot <= 0 || p.Kp < p.Ctot || p.Kp % 8 ||
      p.ops < p.Cout)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    const long long blocks = ((M + fma32::BM - 1) / fma32::BM) *
                             ((p.N + fma32::BN - 1) / fma32::BN);
    fma32::igemm_f32_kernel<<<(unsigned)blocks, fma32::THREADS, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  for (int s = 0; s < p.nsrc; ++s)
    if (p.src[s].vec &&
        (p.src[s].f32 || p.src[s].ps % 8 ||
         reinterpret_cast<uintptr_t>(p.src[s].ptr) % 16))
      return (int)cudaErrorInvalidValue;
  const int mode = p.nsrc > 1 || p.src[0].f32 ? tc::LOAD_ANY
                   : p.src[0].vec             ? tc::LOAD_VEC
                                              : tc::LOAD_BF16;
  const int bn = p.N <= 32 ? 32 : (p.N <= 64 ? 64 : 128);
  const long long blocks = ((M + tc::BM - 1) / tc::BM) *
                           ((p.N + bn - 1) / bn);
  const unsigned grid = (unsigned)blocks;
#define IGEMM_LAUNCH(BN_)                                                  \
  if (mode == tc::LOAD_VEC)                                                \
    tc::igemm_bf16_kernel<BN_, tc::LOAD_VEC>                               \
        <<<grid, tc::THREADS, 0, st>>>(p);                                 \
  else if (mode == tc::LOAD_BF16)                                          \
    tc::igemm_bf16_kernel<BN_, tc::LOAD_BF16>                              \
        <<<grid, tc::THREADS, 0, st>>>(p);                                 \
  else                                                                     \
    tc::igemm_bf16_kernel<BN_, tc::LOAD_ANY>                               \
        <<<grid, tc::THREADS, 0, st>>>(p);
  if (bn == 32) {
    IGEMM_LAUNCH(32)
  } else if (bn == 64) {
    IGEMM_LAUNCH(64)
  } else {
    IGEMM_LAUNCH(128)
  }
#undef IGEMM_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

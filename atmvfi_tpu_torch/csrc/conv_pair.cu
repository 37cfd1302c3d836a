// Kernel K12: a fused pair of stride-1 3x3 convolutions, NHWC, sm_90a:
//
//   out = conv_b(round_T(PReLU_a(conv_a(x) + bias_a))) + bias_b
//         (+ PReLU_b), zero padding 1 for both convs.
//
// Replaces `atmvfi_tpu/ops/conv_pallas.py::conv3x3_pair_hcw`
// (`_kernel_pair`): the intermediate never reaches device memory. A
// block owns an 8 x 16 tile of output pixels of one image. Stage A
// computes the intermediate over that tile plus a 1-pixel halo (10 x 18
// pixels, all Cmid channels) with the implicit-GEMM core of K3
// (igemm.cuh: the problem description, tap gather, epilogue and the
// ldmatrix / mma.sync m16n8k16 step, its tile loads as functions below),
// applies bias and PReLU in f32, rounds once to bf16 and keeps the tile
// in shared memory. A halo pixel outside the image (or across a batch
// edge) is stored as zero: it is conv_b's padding, not conv_a evaluated
// there. Stage B is the second GEMM, whose A fragments are read with
// ldmatrix straight from that tile at each tap's offset, so it needs no
// A copy at all; its epilogue stages the rounded output tile in shared
// memory and writes it along the channels at the caller's pixel stride
// (C rounded up to 8, as K3 writes it).
//
// Shared memory: the intermediate is 180 pixels x Cmid rounded up to 32
// channels (+8 for conflict-free ldmatrix rows): 153 KB at the
// 389-channel decoder site, plus 40 KB of stage buffers, one block per
// SM. Bound: operations (the 389->389 pair at 272x480 is 0.71 TFLOP of
// useful products against ~0.2 GB of input and output). Cost of the
// fusion: stage A computes 180 rows for 128 outputs (the halo, 1.4x the
// conv_a products; the second 128-row chunk skips its empty m16 tiles)
// in exchange for the intermediate's device-memory round trip.
//
// f32 (the parity mode) runs true f32 FMAs on the CUDA cores: the block
// tile is th x 16 outputs with th (8, 4, 2 or 1) chosen so the f32
// intermediate fits, one thread per (pixel, 8 channels) in each stage.
#include "igemm.cuh"

namespace {

// The igemm kernel's A / B tile loads and its mma step, as functions for
// the two GEMMs of this kernel. The igemm kernel keeps its own inline
// copies: calling these from it raised it from 125 to 126-138 registers
// and cost 4-25% at the conv sites of K3-K6 (H100 A/B against the inline
// form; at 138 registers one block fits an SM instead of two).
namespace tc {

// A loader: BK/2 = 16 channels [c0 + a_k, c0 + a_k + 16) of input pixel
// `pix` (-1: zero padding) of the single source as 16 bf16 values in two
// 16-byte registers: vector loads for a `vec` source, else gathered (an
// f32 source rounded).
__device__ __forceinline__ void load_a16(const Problem& p, long long pix,
                                         int c0, int a_k, uint4 (&ra)[2]) {
  if (p.src[0].vec) {
    ra[0] = load_vec8(p.src[0], pix, c0 + a_k);
    ra[1] = load_vec8(p.src[0], pix, c0 + a_k + 8);
    return;
  }
  const int c = c0 + a_k;
  float v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    v[j] = pix >= 0 && c + j < p.Ctot ? load_elem(p, pix, c + j) : 0.0f;
  uint32_t* r = reinterpret_cast<uint32_t*>(ra);
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = pack2(v[2 * j], v[2 * j + 1]);
}

// 16-byte weight vectors per thread for a BN x BK tile of B.
template <int BN>
__host__ __device__ constexpr int b_per() {
  return (BN * (BK / 8) + THREADS - 1) / THREADS;
}

// B loader: this thread's vectors of the BN x BK tile (n0, c0) of tap
// `tap` of weights packed [taps][N][Kp]; zero past N and Kp.
template <int BN>
__device__ __forceinline__ void load_b(const __nv_bfloat16* wp, int N,
                                       int Kp, int tap, int n0, int c0,
                                       uint4 (&rb)[b_per<BN>()]) {
  constexpr int B_VECS = BN * (BK / 8);
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < b_per<BN>(); ++i) {
    const int v = tid + i * THREADS;
    const int n = v >> 2;
    const int k = c0 + (v & 3) * 8;
    if (v < B_VECS && n0 + n < N && k < Kp)
      rb[i] = *reinterpret_cast<const uint4*>(
          wp + ((long long)tap * N + n0 + n) * Kp + k);
    else
      rb[i] = make_uint4(0, 0, 0, 0);
  }
}

// Store this thread's vectors of a B tile into shared memory.
template <int BN>
__device__ __forceinline__ void stash_b(__nv_bfloat16 (*Bs)[LDS],
                                        const uint4 (&rb)[b_per<BN>()]) {
  constexpr int B_VECS = BN * (BK / 8);
#pragma unroll
  for (int i = 0; i < b_per<BN>(); ++i) {
    const int v = threadIdx.x + i * THREADS;
    if (v < B_VECS)
      *reinterpret_cast<uint4*>(&Bs[v >> 2][(v & 3) * 8]) = rb[i];
  }
}

// igemm.cuh's mma_step with A rows at any addresses (a gathered tile):
// the lane's A row of m16 tile mt (row lane & 15 of the tile) starts at
// a_rows[mt]; only the first `mts` m16 tiles are computed.
template <int BN>
__device__ __forceinline__ void mma_step_rows(
    const __nv_bfloat16* const (&a_rows)[2], const __nv_bfloat16 (*Bs)[LDS],
    float (&acc)[2][BN / 16][4], int wn, int lane, int mts) {
  constexpr int NT = BN / 16;  // n8 tiles per warp
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t a[2][4], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if (mt < mts) ldsm_x4(a[mt], a_rows[mt] + ks + (lane >> 4) * 8);
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
      if (mt < mts)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
  }
}

}  // namespace tc

constexpr int TW = 16;       // output tile width (both types)
constexpr int MW = TW + 2;   // intermediate tile width
constexpr int TH_BF16 = 8;   // bf16 output tile height: 128 = BM pixels
constexpr int MPIX = (TH_BF16 + 2) * MW;  // bf16 intermediate pixels
constexpr int SMEM_MAX = 232448;

struct Pair {
  Problem a;  // conv_a: source, weights, bias, slope; N = Cmid
  Problem b;  // conv_b: weights, bias, slope, out; N = Cout
  int th;     // output tile height
  int tiles_y, tiles_x;
  int ms;     // row stride of the intermediate tile, elements
};

// Image pixel of intermediate-tile pixel mp (tile origin ty0, tx0), as a
// RowPos of conv_a; ok is false outside the image.
__device__ __forceinline__ RowPos mid_pos(const Problem& a, int b, int ty0,
                                          int tx0, int mp, int mpix) {
  RowPos r;
  r.b = b;
  r.oy = ty0 - 1 + mp / MW;
  r.ox = tx0 - 1 + mp % MW;
  r.ok = mp < mpix && r.oy >= 0 && r.oy < a.H && r.ox >= 0 && r.ox < a.W;
  return r;
}

__host__ __device__ constexpr int stage_bytes(int bna, int bnb) {
  const int a = 2 * (tc::BM + bna) * tc::LDS * 2;  // stage A: A + B tiles
  const int ct = tc::BM * (bnb + 8) * 2;           // stage B output tile
  const int b = 2 * bnb * tc::LDS * 2;             // stage B: B tiles
  return a > ct ? (a > b ? a : b) : (ct > b ? ct : b);
}

// ---- bf16: tensor cores ---------------------------------------------
template <int BNA, int BNB>
__global__ void __launch_bounds__(tc::THREADS)
    pair_bf16_kernel(const __grid_constant__ Pair q) {
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long row_base[BM];  // output offset of a tile row, or -1
  const Problem& pa = q.a;
  const Problem& pb = q.b;
  const int ms = q.ms;
  const int kb_mid = ms - 8;  // Cmid rounded up to BK
  __nv_bfloat16* mid = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* stage = smem + MPIX * ms * 2;
  auto As = reinterpret_cast<__nv_bfloat16(*)[BM][LDS]>(stage);
  auto BsA = reinterpret_cast<__nv_bfloat16(*)[BNA][LDS]>(
      stage + 2 * BM * LDS * 2);
  auto BsB = reinterpret_cast<__nv_bfloat16(*)[BNB][LDS]>(stage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;
  int t = blockIdx.x;
  const int tx0 = (t % q.tiles_x) * TW;
  t /= q.tiles_x;
  const int ty0 = (t % q.tiles_y) * TH_BF16;
  const int b = t / q.tiles_y;

  // ---- stage A: the intermediate tile, in chunks of BM pixels -------
  {
    constexpr int NT = BNA / 16;
    const int a_row = tid >> 1, a_k = (tid & 1) * 16;
    const int nkc = (pa.Ctot + BK - 1) / BK;
    const int steps = 9 * nkc;
    const __nv_bfloat16* wa = static_cast<const __nv_bfloat16*>(pa.w);
    for (int m0 = 0; m0 < MPIX; m0 += BM) {
      const RowPos rp = mid_pos(pa, b, ty0, tx0, m0 + a_row, MPIX);
      const int left = MPIX - (m0 + wm * 32);  // rows of this warp
      const int mts = left <= 0 ? 0 : (left <= 16 ? 1 : 2);
      for (int n0 = 0; n0 < kb_mid; n0 += BNA) {
        uint4 ra[2];
        uint4 rb[b_per<BNA>()];
        auto load = [&](int step) {
          const int tap = step / nkc;
          const int c0 = (step - tap * nkc) * BK;
          load_a16(pa, tap_pixel(pa, rp, tap), c0, a_k, ra);
          load_b<BNA>(wa, pa.N, pa.Kp, tap, n0, c0, rb);
        };
        auto stash = [&](int buf) {
          *reinterpret_cast<uint4*>(&As[buf][a_row][a_k]) = ra[0];
          *reinterpret_cast<uint4*>(&As[buf][a_row][a_k + 8]) = ra[1];
          stash_b<BNA>(BsA[buf], rb);
        };
        float acc[2][NT][4] = {};
        load(0);
        stash(0);
        __syncthreads();
        for (int step = 0; step < steps; ++step) {
          const int buf = step & 1;
          if (step + 1 < steps) load(step + 1);
          const __nv_bfloat16* const a_rows[2] = {
              &As[buf][wm * 32 + (lane & 15)][0],
              &As[buf][wm * 32 + 16 + (lane & 15)][0]};
          mma_step_rows<BNA>(a_rows, BsA[buf], acc, wn, lane, mts);
          if (step + 1 < steps) stash(buf ^ 1);
          __syncthreads();
        }
        // bias + PReLU, one rounding; zero outside the image and past Cmid
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int mp = m0 + wm * 32 + mt * 16 + g + 8 * h;
              const int n = n0 + wn * (BNA / 2) + nt * 8 + tig * 2;
              if (mp >= MPIX || n >= kb_mid) continue;
              const bool in = mid_pos(pa, b, ty0, tx0, mp, MPIX).ok;
              const float y0 =
                  in && n < pa.N ? epilogue(pa, n, acc[mt][nt][2 * h]) : 0.f;
              const float y1 = in && n + 1 < pa.N
                                   ? epilogue(pa, n + 1, acc[mt][nt][2 * h + 1])
                                   : 0.f;
              *reinterpret_cast<__nv_bfloat162*>(&mid[mp * ms + n]) =
                  __floats2bfloat162_rn(y0, y1);
            }
      }
    }
  }
  if (tid < BM) {
    const int oy = ty0 + tid / TW, ox = tx0 + tid % TW;
    row_base[tid] = oy < pb.H && ox < pb.W
                        ? (((long long)b * pb.H + oy) * pb.W + ox) * pb.ops
                        : -1;
  }
  __syncthreads();  // the intermediate tile is complete

  // ---- stage B: the output tile from the intermediate ---------------
  constexpr int NT = BNB / 16;
  const int nkb = kb_mid / BK;
  const int steps = 9 * nkb;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(pb.w);
  // this lane's output pixels (tile rows of 16) of its two m16 tiles
  const int o0 = wm * 32 + (lane & 15), o1 = o0 + 16;
  auto Ct = reinterpret_cast<__nv_bfloat16(*)[BNB + 8]>(stage);
  for (int n0 = 0; n0 < pb.N; n0 += BNB) {
    uint4 rb[b_per<BNB>()];
    float acc[2][NT][4] = {};
    load_b<BNB>(wb, pb.N, pb.Kp, 0, n0, 0, rb);
    stash_b<BNB>(BsB[0], rb);
    __syncthreads();
    for (int step = 0; step < steps; ++step) {
      const int buf = step & 1;
      const int tap = step / nkb;
      const int c0 = (step - tap * nkb) * BK;
      if (step + 1 < steps) {
        const int nt_ = (step + 1) / nkb;
        load_b<BNB>(wb, pb.N, pb.Kp, nt_, n0, (step + 1 - nt_ * nkb) * BK,
                    rb);
      }
      const int dy = tap / 3, dx = tap - dy * 3;
      const __nv_bfloat16* const a_rows[2] = {
          mid + ((o0 / TW + dy) * MW + o0 % TW + dx) * ms + c0,
          mid + ((o1 / TW + dy) * MW + o1 % TW + dx) * ms + c0};
      mma_step_rows<BNB>(a_rows, BsB[buf], acc, wn, lane, 2);
      if (step + 1 < steps) stash_b<BNB>(BsB[buf ^ 1], rb);
      __syncthreads();
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + mt * 16 + g + 8 * h;
          const int col = wn * (BNB / 2) + nt * 8 + tig * 2;
          const int n = n0 + col;
          const float y0 = n < pb.N ? epilogue(pb, n, acc[mt][nt][2 * h]) : 0.f;
          const float y1 =
              n + 1 < pb.N ? epilogue(pb, n + 1, acc[mt][nt][2 * h + 1]) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(&Ct[row][col]) =
              __floats2bfloat162_rn(y0, y1);
        }
    __syncthreads();
    const int c = tid % BNB;
    if (n0 + c < pb.N) {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(pb.out);
      for (int r = tid / BNB; r < BM; r += THREADS / BNB)
        if (row_base[r] >= 0) out[row_base[r] + n0 + c] = Ct[r][c];
    }
    __syncthreads();  // Ct aliases the next n-tile's B tiles
  }
}

// ---- f32: CUDA cores ------------------------------------------------
__global__ void __launch_bounds__(256)
    pair_f32_kernel(const __grid_constant__ Pair q) {
  extern __shared__ float midf[];  // [(th + 2) * MW][ms]
  const Problem& pa = q.a;
  const Problem& pb = q.b;
  const int th = q.th, ms = q.ms;
  const int mpix = (th + 2) * MW;
  int t = blockIdx.x;
  const int tx0 = (t % q.tiles_x) * TW;
  t /= q.tiles_x;
  const int ty0 = (t % q.tiles_y) * th;
  const int b = t / q.tiles_y;
  const float* wa = static_cast<const float*>(pa.w);
  const float* wb = static_cast<const float*>(pb.w);

  // stage A: one thread per (intermediate pixel, 8 channels)
  const int ga = (pa.N + 7) / 8;
  for (int e = threadIdx.x; e < mpix * ga; e += blockDim.x) {
    const int mp = e % mpix, n0 = (e / mpix) * 8;
    const RowPos rp = mid_pos(pa, b, ty0, tx0, mp, mpix);
    float acc[8] = {};
    for (int tap = 0; tap < 9 && rp.ok; ++tap) {
      const long long pix = tap_pixel(pa, rp, tap);
      if (pix < 0) continue;
      const float* w = wa + ((long long)tap * pa.N + n0) * pa.Kp;
      for (int c = 0; c < pa.Ctot; ++c) {
        const float v = load_elem(pa, pix, c);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (n0 + j < pa.N) acc[j] = fmaf(v, w[j * pa.Kp + c], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (n0 + j < pa.N)
        midf[mp * ms + n0 + j] = rp.ok ? epilogue(pa, n0 + j, acc[j]) : 0.f;
  }
  __syncthreads();

  // stage B: one thread per (output pixel, 8 channels)
  const int gb = (pb.N + 7) / 8;
  float* out = static_cast<float*>(pb.out);
  for (int e = threadIdx.x; e < th * TW * gb; e += blockDim.x) {
    const int op = e % (th * TW), n0 = (e / (th * TW)) * 8;
    const int r = op / TW, c = op % TW;
    const int oy = ty0 + r, ox = tx0 + c;
    if (oy >= pb.H || ox >= pb.W) continue;
    float acc[8] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const float* m = midf + ((r + tap / 3) * MW + c + tap % 3) * ms;
      const float* w = wb + ((long long)tap * pb.N + n0) * pb.Kp;
      for (int k = 0; k < pa.N; ++k) {
        const float v = m[k];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (n0 + j < pb.N) acc[j] = fmaf(v, w[j * pb.Kp + k], acc[j]);
      }
    }
    const long long base = (((long long)b * pb.H + oy) * pb.W + ox) * pb.ops;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (n0 + j < pb.N) out[base + n0 + j] = epilogue(pb, n0 + j, acc[j]);
  }
}

template <int BNA, int BNB>
int launch_bf16(const Pair& q, int blocks, cudaStream_t st) {
  const int smem = MPIX * q.ms * 2 + stage_bytes(BNA, BNB);
  if (smem > SMEM_MAX - (int)sizeof(long long) * tc::BM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pair_bf16_kernel<BNA, BNB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  pair_bf16_kernel<BNA, BNB><<<blocks, tc::THREADS, smem, st>>>(q);
  return (int)cudaGetLastError();
}

int pair_launch(bool bf16, const int64_t* desc, int B, int H, int W,
                const void* wa, int Kpa, const float* bias_a,
                const float* slope_a, int Cmid, const void* wb, int Kpb,
                const float* bias_b, const float* slope_b, void* out,
                int Cout, long long out_ps, void* stream) {
  const int cin = (int)desc[2];
  if (B < 1 || H < 1 || W < 1 || cin < 1 || desc[1] < cin || Cmid < 1 ||
      Cout < 1 || Kpa < cin || Kpa % 8 || Kpb < Cmid || Kpb % 8 ||
      out_ps < Cout || !bias_a || !bias_b)
    return (int)cudaErrorInvalidValue;
  Pair q = {};
  Problem& a = q.a;
  a.src[0].ptr = reinterpret_cast<const void*>(desc[0]);
  a.src[0].ps = desc[1];
  a.src[0].C = cin;
  a.src[0].f32 = (int)desc[3];
  a.src[0].vec = (int)desc[4];
  a.nsrc = 1;
  a.Ctot = cin;
  a.B = B;
  a.H = a.Ho = H;
  a.W = a.Wo = W;
  a.stride = 1;
  a.pad = 1;
  a.ksize = 3;
  a.w = wa;
  a.N = a.Cout = Cmid;
  a.Kp = Kpa;
  a.bias = bias_a;
  a.slope = slope_a;
  Problem& p = q.b;
  p = a;
  p.nsrc = 0;
  p.w = wb;
  p.N = p.Cout = Cout;
  p.Kp = Kpb;
  p.bias = bias_b;
  p.slope = slope_b;
  p.out = out;
  p.ops = out_ps;
  q.tiles_x = (W + TW - 1) / TW;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (a.src[0].vec &&
        (a.src[0].f32 || a.src[0].ps % 8 ||
         reinterpret_cast<uintptr_t>(a.src[0].ptr) % 16))
      return (int)cudaErrorInvalidValue;
    q.th = TH_BF16;
    q.tiles_y = (H + TH_BF16 - 1) / TH_BF16;
    q.ms = (Cmid + tc::BK - 1) / tc::BK * tc::BK + 8;
    const int blocks = B * q.tiles_y * q.tiles_x;
    const bool wide_a = Cmid > 64, wide_b = Cout > 32;
    if (wide_a)
      return wide_b ? launch_bf16<128, 128>(q, blocks, st)
                    : launch_bf16<128, 32>(q, blocks, st);
    return wide_b ? launch_bf16<64, 128>(q, blocks, st)
                  : launch_bf16<64, 32>(q, blocks, st);
  }
  q.ms = Cmid | 1;  // odd: conflict-free reads across pixels
  for (q.th = 8; q.th >= 1; q.th /= 2)
    if ((q.th + 2) * MW * q.ms * 4 <= 200 * 1024) break;
  if (q.th < 1) return (int)cudaErrorInvalidValue;
  q.tiles_y = (H + q.th - 1) / q.th;
  const int smem = (q.th + 2) * MW * q.ms * 4;
  cudaError_t err = cudaFuncSetAttribute(
      pair_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  pair_f32_kernel<<<B * q.tiles_y * q.tiles_x, 256, smem, st>>>(q);
  return (int)cudaGetLastError();
}

}  // namespace

#define PAIR_ENTRY(NAME, BF16)                                                \
  extern "C" int NAME(const int64_t* desc, int B, int H, int W,              \
                      const void* wa, int Kpa, const float* bias_a,          \
                      const float* slope_a, int Cmid, const void* wb,        \
                      int Kpb, const float* bias_b, const float* slope_b,    \
                      void* out, int Cout, long long out_ps, void* stream) { \
    return pair_launch(BF16, desc, B, H, W, wa, Kpa, bias_a, slope_a, Cmid,  \
                       wb, Kpb, bias_b, slope_b, out, Cout, out_ps, stream); \
  }

PAIR_ENTRY(conv3x3_pair_f32, false)
PAIR_ENTRY(conv3x3_pair_bf16, true)

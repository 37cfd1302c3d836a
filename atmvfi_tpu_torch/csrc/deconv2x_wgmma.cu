// Kernel K6, bf16: ConvTranspose k=2 s=2 + bias (+ per-channel PReLU),
// NHWC, as one GEMM on Hopper's wgmma with TMA loads, sm_90a.
//
// Replaces atmvfi_tpu/ops/deconv_pallas.py::deconv2x_hcw (:160, kernel
// `_kernel` :102, call :205) for bf16 maps a TMA tensor map can read
// (pixel stride a multiple of 8, 16-byte aligned, >= 32 channels: every
// site of the main path, whose producers hand the deconvs such maps);
// f32 (the parity mode) and other layouts run the mma.sync implicit GEMM
// of deconv2x.cu:
//   out[b, 2y+dy, 2x+dx, o] = sum_i x[b, y, x, i] * W[i, o, dy, dx] + b[o].
//
// GEMM: M = input pixels B*H*W, K = Cin, N = 4 Cout8 columns ordered
// (dy, dx, o), Cout8 = Cout rounded up to 8 with zero weights in the pad.
// An 8-column piece of a tile then lies in one parity (dy, dx) and lands
// on 16 contiguous bytes of output pixel (2y+dy, 2x+dx) (pixel stride
// Cout8), and the two dx of one input pixel are neighbouring output
// pixels: a tile row stores runs of up to 2 Cout8 channels.
//
// Bound: bytes at five of the six base sites (the output is 4x the
// input's pixels; 197 -> 101 at 544x960 writes 422 MB), operations at
// the 773 -> 389 one (78.5 GFLOP). The mma.sync form read A by 2-byte
// gathers where the pixel stride was odd (773, 389, 197 at stride 773,
// 389, 197) and could not feed Hopper's tensor cores. Here:
//  * A by TMA: a 2-D map over [B*H*W pixels, Cin] at the input's pixel
//    stride, box [64 channels, 128 pixels], 128-byte swizzled, zero fill
//    past Cin (the ragged last chunk issues only the k16 slices that hold
//    channels) and past the last pixel. A is read once per column tile.
//  * B by TMA from the packed weight [4 Cout8][Kp] (cached per weight by
//    the wrapper, with its map), box [64, BNW].
//  * the k-chunk loop of K1's GEMM (hopper.cuh: ss_produce / ss_consume):
//    one producer thread keeps a ring of stages full, two consumer
//    warpgroups issue wgmma m64nBNWk16 with both operands in shared
//    memory and f32 sums in registers.
//  * tile 128 x BNW, BNW 128 (two blocks an SM, so one block's epilogue
//    runs under the other's products) or 224 (one block an SM, fewer
//    padded columns at N = 1568 / 800 / 416): the fewest padded columns,
//    ties to the wider (deconv_plan).
//  * epilogue: + bias, then PReLU max(y,0) + a*min(y,0) in rounded f32
//    operations, one rounding to bf16 (the plain version's order), pad
//    channels written as zeros; rows staged by stmatrix and stored as
//    16-byte pieces at their output pixel, whose offsets (per tile row
//    and per 8-column piece) are tabled in shared memory while the first
//    chunks load. The output is written once, in whole 16-byte pieces.
#include <cuda_bf16.h>
#include <string.h>

#include "hopper.cuh"

namespace {
namespace dc {
using namespace hopper;

constexpr int BM = 128;         // input pixels a tile
constexpr int CONSUMERS = 2;    // warpgroups
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of a block
constexpr int SMEM_HALF = 113 * 1024;  // ... of each of two blocks on an SM
constexpr int MAX_STAGES = 4;

struct Args {
  int M, N, K, nkc, n_chunks, stages;
  int H, W, cout, cout8;
  long long ops;  // output pixel stride
  const float* bias;
  const float* slope;  // null: no PReLU
  __nv_bfloat16* out;
};

// shared memory after the ring: per tile row its output offset, per
// 8-column piece its offset within the row's output, per column bias and
// slope, then the ring's mbarriers
template <int BNW>
struct Tables {
  static constexpr int P = BNW / 8;
  static constexpr int BYTES = BM * 8 + P * 8 + 2 * BNW * 4;
};

template <int BNW>
__global__ void __launch_bounds__(THREADS, BNW > 128 ? 1 : 2)
    deconv2x_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                          const __grid_constant__ CUtensorMap bmap,
                          const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int A_BYTES = BM * 128, STAGE = (BM + BNW) * 128;
  constexpr int P = Tables<BNW>::P;
  long long* rowoff = reinterpret_cast<long long*>(ring + a.stages * STAGE);
  long long* coloff = rowoff + BM;
  float* cbias = reinterpret_cast<float*>(coloff + P);
  float* cslope = cbias + BNW;
  uint64_t* full = reinterpret_cast<uint64_t*>(cslope + BNW);
  uint64_t* empty = full + a.stages;
  const int nc = blockIdx.x % a.n_chunks;
  const int m0 = (blockIdx.x / a.n_chunks) * BM, n0 = nc * BNW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {  // producer
    if (lane == 0)
      ss_produce<A_BYTES, STAGE>(&amap, &bmap, ring, full, empty, a.nkc,
                                 a.stages, m0, n0, [] {});
    return;
  }

  // the epilogue's tables, while the first chunks load
  const long long W2 = 2LL * a.W;
  for (int i = threadIdx.x; i < BM; i += 128 * CONSUMERS) {
    const int m = m0 + i;
    if (m >= a.M) continue;
    const int x = m % a.W, t = m / a.W;
    const int y = t % a.H, b = t / a.H;
    rowoff[i] = (((long long)b * 2 * a.H + 2 * y) * W2 + 2 * x) * a.ops;
  }
  for (int i = threadIdx.x; i < P; i += 128 * CONSUMERS) {
    const int n = n0 + 8 * i, par = n / a.cout8;
    coloff[i] = ((par >> 1) * W2 + (par & 1)) * a.ops + (n - par * a.cout8);
  }
  for (int i = threadIdx.x; i < BNW; i += 128 * CONSUMERS) {
    const int n = n0 + i, o = n % a.cout8;
    const bool real = n < a.N && o < a.cout;
    cbias[i] = real ? a.bias[o] : 0.0f;
    cslope[i] = real && a.slope ? a.slope[o] : 0.0f;
  }

  const int cg = warp / 4;
  float acc[BNW / 2];
#pragma unroll
  for (int i = 0; i < BNW / 2; ++i) acc[i] = 0.0f;
  ss_consume<BNW, A_BYTES, STAGE>(acc, ring, full, empty, a.nkc, a.stages,
                                  a.K, cg);
  // both warpgroups are off the ring, and the tables are written
  named_barrier(1, 128 * CONSUMERS);

  // sum (row lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e) of the warp's
  // 16 rows is acc[4 j + 2 h + e]; rounded pairs go by stmatrix into the
  // warp's staging rows, then out as 16-byte pieces
  constexpr int SROW = BNW + 8;
  const int q = lane & 3;
  const int wrow = 64 * cg + 16 * (warp & 3);
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(ring) +
                       warp * 16 * SROW;
  uint32_t pk[P][2];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int c = 8 * j + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float yv = __fadd_rn(acc[4 * j + 2 * h + e], cbias[c + e]);
        if (a.slope)
          yv = __fadd_rn(fmaxf(yv, 0.0f),
                         __fmul_rn(cslope[c + e], fminf(yv, 0.0f)));
        v[e] = yv;
      }
      pk[j][h] = pack_bf16x2(v[0], v[1]);
    }
  }
  // matrices (j, h = 0), (j, 1), (j + 1, 0), (j + 1, 1); lane i addresses
  // row i % 8 (+ 8 for odd i / 8) of column group j + i / 16
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
  const uint32_t sbase = smem_u32(stg + lr * SROW + lc);
#pragma unroll
  for (int j = 0; j < P; j += 2)
    stsm_x4(sbase + 16 * j, pk[j][0], pk[j][1], pk[j + 1][0], pk[j + 1][1]);
  __syncwarp();
#pragma unroll 4
  for (int i = lane; i < 16 * P; i += 32) {
    const int rr = i / P, cp = i % P;
    if (m0 + wrow + rr < a.M && n0 + 8 * cp < a.N)
      *reinterpret_cast<uint4*>(a.out + rowoff[wrow + rr] + coloff[cp]) =
          *reinterpret_cast<const uint4*>(stg + rr * SROW + 8 * cp);
  }
}

// Tile width and ring depth for N columns; false for a shape the kernel
// does not take.
struct Plan {
  int bnw, stages, smem;
};

inline bool plan(int N, int bnw, Plan* p) {
  if (N < 8 || N % 8) return false;
  const int cands[2] = {128, 224};
  if (bnw == 0) bnw = least_padded(N, cands);
  if (bnw != 128 && bnw != 224) return false;
  const int stage = (BM + bnw) * 128;
  const int fixed =
      1024 + (bnw == 224 ? Tables<224>::BYTES : Tables<128>::BYTES) +
      2 * MAX_STAGES * 8;
  // two blocks an SM at 128 columns, one at 224
  int stages = ((bnw > 128 ? SMEM_MAX : SMEM_HALF) - fixed) / stage;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  *p = Plan{bnw, stages, fixed + stages * stage};
  // the epilogue stages 8 warps' rows in the ring
  return stages >= 2 && stages * stage >= 8 * 16 * (bnw + 8) * 2;
}

template <int BNW>
int launch(const CUtensorMap& amap, const CUtensorMap& bmap, const Args& a,
           int smem, long long blocks, cudaStream_t st) {
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      deconv2x_wgmma_kernel<BNW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  deconv2x_wgmma_kernel<BNW><<<(int)blocks, THREADS, smem, st>>>(amap, bmap,
                                                                 a);
  return (int)cudaGetLastError();
}

}  // namespace dc
}  // namespace

// The weight's tensor map for the packed bf16 weight w [N = 4 Cout8][Kp]
// (rows (dy, dx, o), Kp % 8 == 0): writes the 128-byte CUtensorMap to
// map_out and the column tile it was made for to bnw_out (bnw 0: the
// plan's; 128 or 224 to ask for one).
extern "C" int deconv2x_wgmma_weight_map(const void* w, int N, int Kp,
                                         int bnw, void* map_out,
                                         int* bnw_out) {
  dc::Plan pl;
  if (Kp < 8 || Kp % 8 || reinterpret_cast<uintptr_t>(w) % 16 ||
      !dc::plan(N, bnw, &pl))
    return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap map;
  const int rc = hopper::encode_rows(&map, w, N, Kp, pl.bnw);
  if (rc) return rc;
  memcpy(map_out, &map, sizeof(map));
  *bnw_out = pl.bnw;
  return 0;
}

// K6 bf16 on wgmma: x [B, H, W, Cin] bf16 at pixel stride ps (a multiple
// of 8; x 16-byte aligned), the weight map from deconv2x_wgmma_weight_map
// (host memory, 128 bytes) for column tile bnw, f32 bias and slope (null:
// no PReLU), out [B, 2H, 2W, Cout] bf16 at pixel stride out_ps (a
// multiple of 8, >= Cout rounded up to 8; 16-byte aligned).
extern "C" int deconv2x_wgmma_bf16(const void* x, long long ps, int B, int H,
                                   int W, int Cin, const void* wmap, int bnw,
                                   const float* bias, const float* slope,
                                   void* out, int Cout, long long out_ps,
                                   void* stream) {
  const int cout8 = (Cout + 7) / 8 * 8;
  dc::Plan pl;
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || ps < Cin ||
      ps % 8 || reinterpret_cast<uintptr_t>(x) % 16 || out_ps < cout8 ||
      out_ps % 8 || reinterpret_cast<uintptr_t>(out) % 16 || !bias ||
      (long long)B * H * W >= (1LL << 31) || !dc::plan(4 * cout8, bnw, &pl) ||
      pl.bnw != bnw)
    return (int)cudaErrorInvalidValue;
  const int M = B * H * W;
  alignas(64) CUtensorMap amap, bmap;
  if (hopper::encode_rows(&amap, x, M, Cin, dc::BM, ps))
    return (int)cudaErrorInvalidValue;
  memcpy(&bmap, wmap, sizeof(bmap));
  dc::Args a{};
  a.M = M;
  a.N = 4 * cout8;
  a.K = Cin;
  a.nkc = (Cin + 63) / 64;
  a.n_chunks = (a.N + bnw - 1) / bnw;
  a.stages = pl.stages;
  a.H = H;
  a.W = W;
  a.cout = Cout;
  a.cout8 = cout8;
  a.ops = out_ps;
  a.bias = bias;
  a.slope = slope;
  a.out = static_cast<__nv_bfloat16*>(out);
  const long long blocks = (long long)(M + dc::BM - 1) / dc::BM * a.n_chunks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bnw == 224 ? dc::launch<224>(amap, bmap, a, pl.smem, blocks, st)
                    : dc::launch<128>(amap, bmap, a, pl.smem, blocks, st);
}

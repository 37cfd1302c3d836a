// Kernel K12: a fused pair of stride-1 3x3 convolutions, NHWC, sm_90a:
//
//   out = conv_b(round_T(PReLU_a(conv_a(x) + bias_a))) + bias_b
//         (+ PReLU_b), zero padding 1 for both convs.
//
// Replaces `atmvfi_tpu/ops/conv_pallas.py::conv3x3_pair_hcw`
// (`_kernel_pair`): the intermediate never reaches device memory. A
// block owns an 8 x 16 tile of output pixels of one image. Stage A
// computes the intermediate over that tile plus a 1-pixel halo (10 x 18
// = 180 pixels, all Cmid channels) as one implicit GEMM pass per block
// of Cmid columns: 12 m16 tiles, 3 for each of 4 row warps, so the
// input is gathered once per Cmid block and no warp idles. It applies
// bias and PReLU in f32, rounds once to bf16 and keeps the tile in
// shared memory. A halo pixel outside the image (or across a batch
// edge) is stored as zero: it is conv_b's padding, not conv_a evaluated
// there. Stage B is the second GEMM, whose A fragments are read with
// ldmatrix straight from that tile at each tap's offset; its epilogue
// stages the rounded output tile in shared memory and writes it in
// 16-byte pieces along the channels at the caller's pixel stride (C
// rounded up to 8, as K3 writes it).
//
// Loads: a cp.async ring holds the A gathers and B tiles of stage A and
// the B tiles of stage B; one barrier per BK = 32 step. A gather of a
// pixel outside the image, or of channels past Cin, is a cp.async with a
// short source: the hardware fills the rest with zeros. Warps: 4 row
// warps (3 m16 tiles each in stage A, 2 in stage B) times WN column
// warps of NT n8 tiles. Up to Cmid 160 the intermediate is small enough
// for two blocks of 8 warps per SM (WN 2, 2-stage ring; column blocks of
// 64 or 112, whichever wastes fewer columns); above it one block of 16
// warps (WN 4, 128 registers) runs column blocks of 224 (2 passes at
// 389 channels, 1 at 197) on a 3-stage ring where it fits, else 2;
// above Cmid 416, where even 2 stages of that ring do not fit, 8 warps
// run column blocks of 112.
//
// Shared memory: the intermediate is 180 pixels x Cmid rounded up to 32
// channels (+8 for conflict-free ldmatrix rows): 153 KB at the
// 389-channel decoder site beside a 63 KB ring (one block per SM), 49 KB
// at 101 channels beside a 47 KB ring (two).
// Bound: operations (the 389->389 pair at 272x480 is 0.71 TFLOP of
// useful products against ~0.2 GB of input and output). Cost of the
// fusion: stage A computes 192 rows for 128 outputs (the halo, 1.5x the
// conv_a products) in exchange for the intermediate's device-memory
// round trip.
//
// f32 (the parity mode) runs true f32 FMAs on the CUDA cores: the block
// tile is th x 16 outputs with th (8, 4, 2 or 1) chosen so the f32
// intermediate fits, one thread per (pixel, 8 channels) in each stage.
#include "igemm.cuh"

namespace {

// mma.sync helpers of this kernel beside igemm.cuh's (which keeps its
// loaders inline: calling shared loader functions from the igemm kernel
// raised it from 125 to 126-138 registers and cost 4-25% at the conv
// sites of K3-K6, H100 A/B against the inline form).
namespace tc {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(ptr)));
}

// 16-byte cp.async of which the first `src_bytes` come from `src` and
// the rest are zero (src_bytes 0: all zero, nothing is read).
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n");
}
// Wait until the oldest pending group of a ring of `stages` has landed.
__device__ __forceinline__ void cp_wait_ring(int stages) {
  if (stages == 3)
    asm volatile("cp.async.wait_group 1;\n");
  else
    asm volatile("cp.async.wait_group 0;\n");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n");
}

// B fragments of NT n8 tiles (rows nbase + 8 nt of a [n][LDS] tile) for
// the k16 slice at ks.
template <int NT>
__device__ __forceinline__ void load_bfrag(uint32_t (&b)[NT][2],
                                           const __nv_bfloat16* Bs, int nbase,
                                           int ks, int lane) {
#pragma unroll
  for (int nt = 0; nt + 1 < NT; nt += 2) {
    uint32_t r[4];
    ldsm_x4(r, Bs + (nbase + nt * 8 + (lane >> 4) * 8 + (lane & 7)) * LDS +
                   ks + ((lane >> 3) & 1) * 8);
    b[nt][0] = r[0];
    b[nt][1] = r[1];
    b[nt + 1][0] = r[2];
    b[nt + 1][1] = r[3];
  }
  if (NT & 1) {
    uint32_t r[2];
    ldsm_x2(r, Bs + (nbase + (NT - 1) * 8 + (lane & 7)) * LDS + ks +
                   ((lane >> 3) & 1) * 8);
    b[NT - 1][0] = r[0];
    b[NT - 1][1] = r[1];
  }
}

// cp.async of the rows x BK tile (n0, c0) of tap `tap` of weights packed
// [taps][N][Kp] into Bs [rows][LDS]; zero past N and Kp.
template <int T>  // threads of the block
__device__ __forceinline__ void issue_b(const __nv_bfloat16* wp, int N,
                                        int Kp, int tap, int n0, int c0,
                                        int rows, __nv_bfloat16* Bs) {
  for (int v = threadIdx.x; v < rows * (BK / 8); v += T) {
    const int n = v >> 2, k = c0 + (v & 3) * 8;
    const bool ok = n0 + n < N && k < Kp;
    cp16(Bs + n * LDS + (v & 3) * 8,
         ok ? wp + ((long long)tap * N + n0 + n) * Kp + k : wp, ok ? 16 : 0);
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
  int ms;       // row stride of the intermediate tile, elements
  int stages;   // bf16: cp.async ring depth (2 or 3)
  int out_vec;  // bf16: output written in 16-byte pieces
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

// Ring slot sizes in elements: stage A holds the 180-row A gather (the
// ldmatrix of m16 tile 11 reads rows 180-191 from the B tile behind it;
// those rows are never stored) and a 16 NTA-row B tile; stage B a
// 16 NTB-row B tile; the output tile aliases the ring.
__host__ __device__ constexpr int slot_elems(int bna, int bnb) {
  return (MPIX + bna) * tc::LDS > bnb * tc::LDS ? (MPIX + bna) * tc::LDS
                                                : bnb * tc::LDS;
}
__host__ __device__ constexpr int ct_elems(int bnb) {
  return tc::BM * (bnb + 8);
}

// ---- bf16: tensor cores ---------------------------------------------
// NTA / NTB: n8 tiles a warp in stage A / B; MINB: blocks per SM to fit;
// WN: column warps (2 or 4)
template <int NTA, int NTB, int MINB, int WN>
__global__ void __launch_bounds__(128 * WN, MINB)
    pair_bf16_kernel(const __grid_constant__ Pair q) {
  using namespace tc;
  constexpr int T = 128 * WN;  // threads: 4 row warps x WN column warps
  constexpr int BNA = 8 * WN * NTA, BNB = 8 * WN * NTB;
  constexpr int SLOT = slot_elems(BNA, BNB);
  constexpr int NPA = (MPIX * (BK / 8) + T - 1) / T;  // A pieces a thread
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long row_base[BM];  // output offset of a tile row, or -1
  const Problem& pa = q.a;
  const Problem& pb = q.b;
  const int ms = q.ms, S = q.stages;
  const int kb_mid = ms - 8;  // Cmid rounded up to BK
  __nv_bfloat16* mid = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = mid + MPIX * ms;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;
  int t = blockIdx.x;
  const int tx0 = (t % q.tiles_x) * TW;
  t /= q.tiles_x;
  const int ty0 = (t % q.tiles_y) * TH_BF16;
  const int b = t / q.tiles_y;
  const int Cin = pa.Ctot, Cmid = pa.N, Cout = pb.N;

  // channels [Cmid rounded up to 2, kb_mid) of the intermediate are zero
  const int cz = (Cmid + 1) & ~1, nz = kb_mid - cz;
  for (int e = tid; e < MPIX * nz; e += T) {
    const int mp = e / nz;
    mid[mp * ms + cz + e - mp * nz] = __float2bfloat16_rn(0.0f);
  }

  // ---- stage A: the intermediate tile, one pass per BNA columns -----
  {
    // this thread's A pieces: 8 channels at kc of rows (tid >> 2) + T/4 i
    const int kc = (tid & 3) * 8;
    int oy[NPA], ox[NPA];
#pragma unroll
    for (int i = 0; i < NPA; ++i) {
      const int mp = (tid >> 2) + T / 4 * i;
      oy[i] = ty0 - 1 + mp / MW;
      ox[i] = tx0 - 1 + mp % MW;
    }
    const int nkc = (Cin + BK - 1) / BK;
    const int steps = 9 * nkc;
    const __nv_bfloat16* wa = static_cast<const __nv_bfloat16*>(pa.w);
    const Src& src = pa.src[0];
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(src.ptr);
    for (int n0 = 0; n0 < Cmid; n0 += BNA) {
      auto issue = [&](int step) {
        __nv_bfloat16* As = ring + (step % S) * SLOT;
        const int tap = step / nkc;
        const int c0 = (step - tap * nkc) * BK, c = c0 + kc;
        const int ty = tap / 3, tx = tap - ty * 3;
#pragma unroll
        for (int i = 0; i < NPA; ++i) {
          const int mp = (tid >> 2) + T / 4 * i;
          if (mp >= MPIX) continue;
          const int iy = oy[i] + ty - 1, ix = ox[i] + tx - 1;
          const bool ok = iy >= 0 && iy < pa.H && ix >= 0 && ix < pa.W;
          const long long pix = ((long long)b * pa.H + iy) * pa.W + ix;
          __nv_bfloat16* dst = As + mp * LDS + kc;
          if (src.vec) {
            const int nb = ok && c < Cin ? min(16, 2 * (Cin - c)) : 0;
            cp16(dst, nb ? xp + pix * src.ps + c : xp, nb);
          } else {  // gathered, an f32 source rounded
            float v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              v[j] = ok && c + j < Cin ? load_elem(pa, pix, c + j) : 0.0f;
            uint4 u;
            uint32_t* r = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
            for (int j = 0; j < 4; ++j) r[j] = pack2(v[2 * j], v[2 * j + 1]);
            *reinterpret_cast<uint4*>(dst) = u;
          }
        }
        issue_b<T>(wa, Cmid, pa.Kp, tap, n0, c0, BNA, As + MPIX * LDS);
      };
      float acc[3][NTA][4] = {};
      for (int s = 0; s < S - 1; ++s) {
        if (s < steps) issue(s);
        cp_commit();
      }
      for (int step = 0; step < steps; ++step) {
        cp_wait_ring(S);
        __syncthreads();  // this step's slot has landed; the oldest is free
        if (step + S - 1 < steps) issue(step + S - 1);
        cp_commit();
        const __nv_bfloat16* As = ring + (step % S) * SLOT;
        const __nv_bfloat16* Bs = As + MPIX * LDS;
#pragma unroll
        for (int ks = 0; ks < BK; ks += 16) {
          uint32_t af[3][4], bf[NTA][2];
#pragma unroll
          for (int mt = 0; mt < 3; ++mt)
            ldsm_x4(af[mt], As + (wm * 48 + mt * 16 + (lane & 15)) * LDS + ks +
                                (lane >> 4) * 8);
          load_bfrag<NTA>(bf, Bs, wn * 8 * NTA, ks, lane);
#pragma unroll
          for (int mt = 0; mt < 3; ++mt)
#pragma unroll
            for (int nt = 0; nt < NTA; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
        }
      }
      cp_wait_all();
      __syncthreads();  // the ring is free for the next pass
      // bias + PReLU, one rounding; zero outside the image and past Cmid
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTA; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int mp = wm * 48 + mt * 16 + g + 8 * h;
            const int n = n0 + wn * 8 * NTA + nt * 8 + tig * 2;
            if (mp >= MPIX || n >= Cmid) continue;
            const bool in = mid_pos(pa, b, ty0, tx0, mp, MPIX).ok;
            const float y0 = in ? epilogue(pa, n, acc[mt][nt][2 * h]) : 0.f;
            const float y1 = in && n + 1 < Cmid
                                 ? epilogue(pa, n + 1, acc[mt][nt][2 * h + 1])
                                 : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(&mid[mp * ms + n]) =
                __floats2bfloat162_rn(y0, y1);
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
  const int nkb = kb_mid / BK;
  const int steps = 9 * nkb;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(pb.w);
  // this lane's output pixels (tile rows of 16) of its two m16 tiles
  const int o0 = wm * 32 + (lane & 15), o1 = o0 + 16;
  auto Ct = reinterpret_cast<__nv_bfloat16(*)[BNB + 8]>(ring);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(pb.out);
  for (int n0 = 0; n0 < Cout; n0 += BNB) {
    auto issue = [&](int step) {
      const int tap = step / nkb;
      issue_b<T>(wb, Cout, pb.Kp, tap, n0, (step - tap * nkb) * BK, BNB,
              ring + (step % S) * SLOT);
    };
    float acc[2][NTB][4] = {};
    for (int s = 0; s < S - 1; ++s) {
      if (s < steps) issue(s);
      cp_commit();
    }
    for (int step = 0; step < steps; ++step) {
      cp_wait_ring(S);
      __syncthreads();
      if (step + S - 1 < steps) issue(step + S - 1);
      cp_commit();
      const int tap = step / nkb;
      const int c0 = (step - tap * nkb) * BK;
      const int dy = tap / 3, dx = tap - dy * 3;
      const __nv_bfloat16* a0 =
          mid + ((o0 / TW + dy) * MW + o0 % TW + dx) * ms + c0;
      const __nv_bfloat16* a1 =
          mid + ((o1 / TW + dy) * MW + o1 % TW + dx) * ms + c0;
      const __nv_bfloat16* Bs = ring + (step % S) * SLOT;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t af[2][4], bf[NTB][2];
        ldsm_x4(af[0], a0 + ks + (lane >> 4) * 8);
        ldsm_x4(af[1], a1 + ks + (lane >> 4) * 8);
        load_bfrag<NTB>(bf, Bs, wn * 8 * NTB, ks, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NTB; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
      }
    }
    cp_wait_all();
    __syncthreads();  // the ring becomes the output tile
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + mt * 16 + g + 8 * h;
          const int col = wn * 8 * NTB + nt * 8 + tig * 2;
          const int n = n0 + col;
          const float y0 = n < Cout ? epilogue(pb, n, acc[mt][nt][2 * h]) : 0.f;
          const float y1 =
              n + 1 < Cout ? epilogue(pb, n + 1, acc[mt][nt][2 * h + 1]) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(&Ct[row][col]) =
              __floats2bfloat162_rn(y0, y1);
        }
    __syncthreads();
    // 8 channels a piece; with out_vec the lanes past Cout (zeros) land
    // in the pixel's own padding (pixel stride a multiple of 8)
    for (int e = tid; e < BM * (BNB / 8); e += T) {
      const int r = e / (BNB / 8), c = (e - r * (BNB / 8)) * 8;
      const int n = n0 + c;
      if (row_base[r] < 0 || n >= Cout) continue;
      if (q.out_vec) {
        *reinterpret_cast<uint4*>(out + row_base[r] + n) =
            *reinterpret_cast<const uint4*>(&Ct[r][c]);
      } else {
        for (int j = 0; j < 8 && n + j < Cout; ++j)
          out[row_base[r] + n + j] = Ct[r][c + j];
      }
    }
    __syncthreads();  // Ct aliases the next pass's ring
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

// Shared memory of the bf16 kernel: the intermediate and a ring of
// `stages` slots (the output tile aliases the ring); bna / bnb: the
// column blocks of stages A and B.
inline int pair_smem(int bna, int bnb, int ms, int stages) {
  const int ring = stages * slot_elems(bna, bnb), ct = ct_elems(bnb);
  return 2 * (MPIX * ms + (ring > ct ? ring : ct));
}
template <int NTA, int NTB, int MINB, int WN>
int launch_bf16(Pair& q, int blocks, cudaStream_t st) {
  const int smem = pair_smem(8 * WN * NTA, 8 * WN * NTB, q.ms, q.stages);
  if (smem > SMEM_MAX - (int)sizeof(long long) * tc::BM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pair_bf16_kernel<NTA, NTB, MINB, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  pair_bf16_kernel<NTA, NTB, MINB, WN><<<blocks, 128 * WN, smem, st>>>(q);
  return (int)cudaGetLastError();
}

// n8 tiles per warp of a column block of two column warps: 4 or 7,
// whichever leaves fewer idle columns over `n` columns.
inline int pick_nt(int n) {
  const int c4 = (n + 63) / 64 * 4, c7 = (n + 111) / 112 * 7;
  return c7 < c4 ? 7 : 4;
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
    q.out_vec = out_ps % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int blocks = B * q.tiles_y * q.tiles_x;
    // Up to Cmid 160 two blocks of 8 warps share an SM (2-stage ring,
    // column blocks of 64 or 112); above it one block of 16 warps runs
    // column blocks of 224 (the fastest of the tile shapes tried on an
    // H100 at the 389- and 197-channel sites).
    const int limit = SMEM_MAX - (int)sizeof(long long) * tc::BM;
    if (Cmid <= 160) {
      const int nta = pick_nt(Cmid), ntb = Cout <= 16 ? 1 : nta;
      q.stages = 2;
      if (nta == 4)
        return ntb == 1 ? launch_bf16<4, 1, 2, 2>(q, blocks, st)
                        : launch_bf16<4, 4, 2, 2>(q, blocks, st);
      return ntb == 1 ? launch_bf16<7, 1, 2, 2>(q, blocks, st)
                      : launch_bf16<7, 7, 2, 2>(q, blocks, st);
    }
    const int bnb = Cout <= 32 ? 32 : 224;
    q.stages = pair_smem(224, bnb, q.ms, 3) <= limit ? 3 : 2;
    if (pair_smem(224, bnb, q.ms, 2) > limit)  // Cmid > 416: 112 columns
      return Cout <= 16 ? launch_bf16<7, 1, 1, 2>(q, blocks, st)
                        : launch_bf16<7, 7, 1, 2>(q, blocks, st);
    return bnb == 32 ? launch_bf16<7, 1, 1, 4>(q, blocks, st)
                     : launch_bf16<7, 7, 1, 4>(q, blocks, st);
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

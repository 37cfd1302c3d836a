// Kernels K3, K4 and K5, bf16: 3x3 convolution, stride 1 (K3, K5) or 2
// (K4), + bias (+ per-channel PReLU), NHWC, as an implicit GEMM on
// Hopper's wgmma with TMA loads, sm_90a. One kernel, the stride and the
// source mode template parameters, and a second body for K5's lone
// image (FOLD, below).
//
// Replaces `atmvfi_tpu/ops/conv_pallas.py::conv3x3_hcw` (:284, kernel
// `_kernel` :148) and `conv3x3s2_hcw` (:953, kernel `_kernel_s2` :792)
// for bf16 maps of at least 32 channels; f32 (the parity mode) and
// narrower maps stay on the mma.sync implicit GEMM of igemm.cuh
// (conv3x3.cu): at the encoder's 24 channels this kernel's 64-channel
// rows are mostly zero fill, and it was slower than the implicit GEMM
// in an on-chip trial, while at 48 channels it takes half the implicit
// GEMM's time at stride 1 and 2 (PERF.md).
//
// K5 replaces `conv3x3_hcw_planes` (:543, kernel `_kernel_planes` :363,
// call :613): the conv over the channel concat of up to six sources,
// which is never built, where every source can take a tensor map (bf16
// maps of >= 32 channels as K3's; f32 3-channel images whose rows of 3 W
// floats are 16-byte multiples). MULTI walks (source, chunk) in place of
// K3's chunks of one source: a bf16 source's 64-channel chunks come as
// K3's halo boxes through its own map; the f32 images (up to five: the
// refinement's im0, I_t_0, im1, I_t_1, I_t) come as one chunk, each image
// a box of its 10 halo rows x 56 floats (3 x 18 halo columns from column
// 3 (x0 - 1) - 1, 16-byte aligned; edges and padding from the map's zero
// fill), rounded to bf16 by the consumers into one [180 pixel, 16
// channel] tile (15 channels and a zero) that ldmatrix reads per tap as
// one k16 slice. The weight is packed in that order (bf16 sources, each
// from a multiple of 8, then the images' channels). FOLD (the encoder's
// first conv, one f32 image, Cout <= 64): its 27 taps x channels fold
// into K = 32, so a tile is one im2col tile [128 pixels, 32] made from
// the image box and two k16 wgmma slices against a weight [Cout, 64]
// kept in shared memory; a block walks tiles with the next image box in
// flight, as the site is bound by bytes (60 of them a pixel).
//
// GEMM: M = output pixels, N = Cout, K = 9 taps x Cin. A block computes
// an 8-row x 16-column output rectangle (128 pixels) for BN channels.
// At stride 2 its input halo is 17 x 33 pixels (561 rows of 128 bytes,
// 70 KB a chunk, one buffer; see Halo), and a tap's A rows step over
// every other halo pixel.
//
// Bound: operations at the wide sites (local head 776 -> 576 at
// 136x240: 0.25 TFLOP, 0.25 ms at 989 TFLOP/s, against 0.09 GB moved).
// The mma.sync form (igemm.cuh) reached 115-190 TFLOP/s there: mma.sync
// cannot feed Hopper's tensor cores at their rate, and its 256 threads
// spent registers and instructions gathering A with per-element
// padding, edge and channel masks. This kernel:
//  * A by TMA, no gather arithmetic: for each 64-channel chunk, the
//    10 x 18-pixel halo of the rectangle is one 4-D tiled box [64 ch,
//    18 cols, 10 rows, 1 image] at (c0, x0 - 1, y0 - 1, b), loaded once
//    for all nine taps. The tensor map's out-of-bounds zero fill
//    supplies the zero padding and image edges (negative coordinates
//    included), the ragged channels (its channel extent is C, its pixel
//    stride the map's: 389 channels at stride 392) and the ragged column
//    tile of W = 120. (A first form loaded a [64, 16, 8, 1] box per tap
//    straight into wgmma's layout: 9 x 128 rows where the halo has 180,
//    6.4x the A bytes, and the sites with few channels were bound by
//    that traffic in L2; PERF.md, PR 6.)
//  * A from registers: tap (dy, dx) of a consumer warp's 16 GEMM rows
//    (output row ty of the rectangle) is halo rows (ty + dy) * 18 + x +
//    dx, which ldmatrix reads at their 128-byte-swizzled addresses into
//    the m16n8k16 A fragment that wgmma takes from registers.
//  * B by TMA from the packed weights [9][Cout][Kp] (3-D map, box
//    [64, BN, 1]), zero-filled past Cout and Kp, one box per (chunk,
//    tap) into a ring. The packed weight and its map are cached per
//    weight by the wrapper (ops/conv_cuda.py).
//  * 128-byte swizzle (BK = 64 bf16 = one 128-byte row per pixel), so
//    ldmatrix and wgmma read the tiles without bank conflicts.
//  * wgmma.mma_async m64nBNk16 (A registers, B shared memory, f32 sums
//    in registers): two consumer warpgroups of 64 rows make the 128-row
//    tile; BN follows Cout (see pick_bn). The last channel chunk issues
//    only the k16 slices that hold channels (389 channels: 400 of 448).
//  * warp specialisation: one producer thread issues the TMA loads (the
//    halo pair and the B ring) with full/empty mbarriers; a consumer
//    releases a B buffer once the wgmma reading it has completed and a
//    halo once its fragments are in registers. At BN 200 setmaxnreg
//    moves registers from the producer warpgroup (down to 40) to the
//    consumers (up to 232) for the accumulators (see Shape).
//  * one tile a block; up to BN 104 two blocks share an SM, so one
//    block's epilogue overlaps the other's products. A persistent form
//    (each block walking tiles, the ring running on across them) was
//    slower over the main path's sites in an on-chip sweep (PERF.md,
//    PR 6).
//  * epilogue on the f32 sums: + bias, then PReLU max(y,0) + a*min(y,0)
//    in rounded f32 operations, one rounding to bf16 (igemm.cuh's
//    order), stored as bf16 pairs into the port's layout: pixel stride
//    out_ps >= Cout (Cout rounded up to 8 when it is not a multiple).
#include <cuda_bf16.h>
#include <string.h>

#include "hopper.cuh"

namespace {
namespace wg {
using namespace hopper;

constexpr int BK = 64, CONSUMERS = 2;
enum Mode { SINGLE = 0, MULTI = 1 };  // K3 / K4: one source; K5
constexpr int MAX_MAPS = 6;           // K5's sources
constexpr int MAX_CHUNKS = 32;        // K5's (source, 64-channel) chunks

// K5's f32 3-channel images: a box is 10 halo rows of IMG_COLS floats;
// boxes lie IMG_PITCH bytes apart in a halo buffer, then the bf16 tile
// [180 halo pixels, 16 channels] (32-byte rows) at IMG_TILE.
constexpr int IMG_COLS = 56, IMG_BOX = IMG_COLS * 10 * 4, IMG_PITCH = 2304;
constexpr int MAX_IMGS = 5, IMG_TILE = MAX_IMGS * IMG_PITCH;
// The input halo of an 8 x 16 output rectangle: 10 x 18 pixels at
// stride 1, 17 x 33 at stride 2 (one box [64 ch, cols, rows, 1 image]
// per channel chunk). Stride 1 double-buffers it (24 KB a buffer); at
// stride 2 one buffer (72 KB) leaves room for the B ring beside a second
// block on the SM, and the main path's stride-2 sites have 1-8 chunks.
template <int STRIDE>
struct Halo {
  static constexpr int COLS = 15 * STRIDE + 3, ROWS = 7 * STRIDE + 3;
  static constexpr int TX = BK * COLS * ROWS * 2;  // bytes of one box
  static constexpr int BYTES = (TX + 1023) / 1024 * 1024;
  static constexpr int BUFS = STRIDE == 1 ? 2 : 1;
};

// Per column tile: up to BN 104 two blocks share an SM (one producer
// warp beside the two consumer warpgroups, at most 112 registers, smem
// in 110 KB), so one block's epilogue overlaps the other's products. At
// BN 200 one block holds the SM, and its 100 accumulators a thread need
// setmaxnreg, which moves registers between warpgroups -- so the
// producer is a whole warpgroup whose three idle warps donate theirs
// (with a lone producer warp the consumers' increase never completed).
template <int BN, int STRIDE>
struct Shape {
  using HL = Halo<STRIDE>;
  static constexpr bool WIDE = BN > 104;
  static constexpr int THREADS = 128 * CONSUMERS + (WIDE ? 128 : 32);
  static constexpr int BLOCKS_PER_SM = WIDE ? 1 : 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int BUDGET =
      (WIDE ? 200 : 110) * 1024 - HL::BUFS * HL::BYTES;
  static constexpr int STAGES = BUDGET / B_BYTES < 6 ? BUDGET / B_BYTES : 6;
  static_assert(STAGES >= 2, "the B ring needs two stages");
  // halo buffers + B ring + barriers + slack to align to 1024 bytes
  static constexpr int SMEM = HL::BUFS * HL::BYTES + STAGES * B_BYTES +
                              (2 * STAGES + 2 * HL::BUFS) * 8 + 1024;
};

static_assert(IMG_TILE + 180 * 32 <= Halo<1>::BYTES,
              "K5's image boxes and tile fit a stride-1 halo buffer");

// The FOLD body: a buffer holds the image box and the im2col tile
// [128 pixels, 32 = 9 taps x 3 channels + 5 zeros] (64-byte rows) at
// IMG_PITCH; two buffers, the weight [BN, 64] once, three blocks an SM.
template <int BN>
struct Fold {
  static constexpr int THREADS = 128 * CONSUMERS + 32, BLOCKS_PER_SM = 3;
  static constexpr int BUF = (IMG_PITCH + 128 * 64 + 1023) / 1024 * 1024;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int SMEM = 2 * BUF + B_BYTES + 5 * 8 + 1024;
};

// A chunk of K5's loop: bf16 source map `map` from channel ch (a halo
// box), or the image chunk (ch < 0); the weight's k from k; ks k16
// slices.
struct Chunk {
  int map, ch, k, ks;
};

struct Params {
  int B, H, W, Cin, Cout;  // images; the output's rows, columns
  int tiles_x, tiles_y, n_tiles, nkc;
  const float* bias;
  const float* slope;  // null: no PReLU
  __nv_bfloat16* out;
  long long ops;       // output pixel stride
  int nimg, img0;      // K5: f32 images, maps img0 ..
  Chunk chunk[MAX_CHUNKS];  // K5 (MULTI): the chunks in order
};

// The sources' tensor maps: one for K3 / K4, up to MAX_MAPS for K5.
template <int N>
struct AMaps {
  CUtensorMap m[N];
};

// m64nNk16, bf16 x bf16 -> f32: A from registers (each warp's 16 rows in
// the mma.m16n8k16 A fragment layout), B K-major from shared memory, the
// sums accumulated into d (scale-d = 1).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n104(float (&d)[52],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n200(float (&d)[100],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %105, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99"
      "}, {%100, %101, %102, %103}, %104, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (BN == 16) wgmma_rs_n16(d, a, b);
  else if constexpr (BN == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (BN == 104) wgmma_rs_n104(d, a, b);
  else if constexpr (BN == 128) wgmma_rs_n128(d, a, b);
  else if constexpr (BN == 200) wgmma_rs_n200(d, a, b);
  else wgmma_rs_n256(d, a, b);
}


// Epilogue of a consumer warp: rows of its warpgroup are pixels 64 cg +
// 16 (warp % 4) + lane / 4 (+ 8) of the 8 x 16 rectangle at (y0, x0) of
// image b; columns n0 + 8 j + 2 (lane % 4) (+ 1). + bias, PReLU, one
// rounding, bf16 pairs into the port's layout (pixel stride p.ops).
template <int BN>
__device__ __forceinline__ void store_rows(const float (&acc)[BN / 2],
                                           const Params& p, int b, int y0,
                                           int x0, int n0, int cg, int warp,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * cg + 16 * (warp & 3) + (lane >> 2) + 8 * h;
    const int y = y0 + r / 16, x = x0 + (r & 15);
    if (y >= p.H || x >= p.W) continue;
    __nv_bfloat16* o = p.out + (((long long)b * p.H + y) * p.W + x) * p.ops;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= p.Cout) continue;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n + e < p.Cout ? n + e : n;
        float yv = __fadd_rn(acc[4 * j + 2 * h + e], p.bias[c]);
        if (p.slope)
          yv = __fadd_rn(fmaxf(yv, 0.0f),
                         __fmul_rn(p.slope[c], fminf(yv, 0.0f)));
        v[e] = yv;
      }
      if (n + 1 < p.Cout)
        *reinterpret_cast<__nv_bfloat162*>(o + n) =
            __floats2bfloat162_rn(v[0], v[1]);
      else
        o[n] = __float2bfloat16_rn(v[0]);
    }
  }
}

// K5's image chunk, by the 256 consumer threads: the nimg f32 boxes at
// buf (IMG_PITCH apart) -> the bf16 tile [180 halo pixels, 16 channels]
// at buf + IMG_TILE, channel k = 3 i + c of image i (k >= 3 nimg zero),
// 32-byte rows whose 16-byte halves swap on every fourth row (ldmatrix
// reads eight rows without a bank conflict).
__device__ __forceinline__ void images_to_tile(unsigned char* buf,
                                               int nimg) {
  const float* st = reinterpret_cast<const float*>(buf);
  uint32_t* tile = reinterpret_cast<uint32_t*>(buf + IMG_TILE);
  const int kp = threadIdx.x & 7;  // channels 2 kp, 2 kp + 1
  int off[2];
  bool real[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int k = 2 * kp + e, i = k / 3;
    real[e] = k < 3 * nimg;
    off[e] = i * (IMG_PITCH / 4) + 1 + (k - 3 * i);
  }
  for (int t = threadIdx.x; t < 180 * 8; t += 128 * CONSUMERS) {
    const int hp = t >> 3, hy = hp / 18, hx = hp - 18 * hy;
    const int base = hy * IMG_COLS + 3 * hx;
    const float v0 = real[0] ? st[base + off[0]] : 0.0f;
    const float v1 = real[1] ? st[base + off[1]] : 0.0f;
    tile[hp * 8 + (((kp >> 2) ^ ((hp >> 2) & 1)) << 2) + (kp & 3)] =
        pack_bf16x2(v0, v1);
  }
}

// One 128 x BN output tile a block. Blocks run BN-column tiles fastest,
// so the blocks sharing an A tile run together; then 16-column, 8-row
// rectangles, then images. MULTI (K5, stride 1) walks p.chunk.
template <int BN, int STRIDE, int MODE>
__global__ void __launch_bounds__(Shape<BN, STRIDE>::THREADS,
                                  Shape<BN, STRIDE>::BLOCKS_PER_SM)
    conv3x3_wgmma_kernel(
        const __grid_constant__ AMaps<MODE == MULTI ? MAX_MAPS : 1> am,
        const __grid_constant__ CUtensorMap bmap,
        const __grid_constant__ Params p) {
  using S = Shape<BN, STRIDE>;
  using HL = Halo<STRIDE>;
  static_assert(MODE == SINGLE || STRIDE == 1, "K5 runs at stride 1");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* halo = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* bring = halo + HL::BUFS * HL::BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(bring + S::STAGES * S::B_BYTES);
  uint64_t* empty = full + S::STAGES;
  uint64_t* a_full = empty + S::STAGES;
  uint64_t* a_empty = a_full + HL::BUFS;

  int t = blockIdx.x;
  const int n0 = (t % p.n_tiles) * BN;
  t /= p.n_tiles;
  const int x0 = (t % p.tiles_x) * 16;
  t /= p.tiles_x;
  const int y0 = (t % p.tiles_y) * 8;
  const int b = t / p.tiles_y;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    for (int h = 0; h < HL::BUFS; ++h) {
      mbar_init(&a_full[h], 1);
      mbar_init(&a_empty[h], 4 * CONSUMERS);  // every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {
    // producer: one thread keeps the halo pair and the B ring full
    if constexpr (S::WIDE)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * CONSUMERS) {
      int g = 0;
      for (int c = 0; c < p.nkc; ++c) {
        const int hb = c % HL::BUFS;
        unsigned char* dst = halo + hb * HL::BYTES;
        mbar_wait(&a_empty[hb], ((c / HL::BUFS) & 1) ^ 1);
        int kb = c * BK;
        if constexpr (MODE == MULTI) {
          const Chunk ck = p.chunk[c];
          kb = ck.k;
          if (ck.ch >= 0) {
            mbar_expect_tx(&a_full[hb], HL::TX);
            tma_load_4d(dst, &am.m[ck.map], &a_full[hb], ck.ch, x0 - 1,
                        y0 - 1, b);
          } else {
            mbar_expect_tx(&a_full[hb], p.nimg * IMG_BOX);
            for (int i = 0; i < p.nimg; ++i)
              tma_load_3d(dst + i * IMG_PITCH, &am.m[p.img0 + i],
                          &a_full[hb], 3 * x0 - 4, y0 - 1, b);
          }
        } else {
          mbar_expect_tx(&a_full[hb], HL::TX);
          tma_load_4d(dst, &am.m[0], &a_full[hb], c * BK, STRIDE * x0 - 1,
                      STRIDE * y0 - 1, b);
        }
        for (int tap = 0; tap < 9; ++tap, ++g) {
          const int s = g % S::STAGES;
          mbar_wait(&empty[s], ((g / S::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], S::B_BYTES);
          tma_load_3d(bring + s * S::B_BYTES, &bmap, &full[s], kb, n0, tap);
        }
      }
    }
  } else {
    if constexpr (S::WIDE)  // 100 f32 accumulators a thread at BN 200
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cg = warp / 4;  // consumer warpgroup: tile rows 64 cg ..
    const int lane = threadIdx.x & 31;
    // a warp's 16 GEMM rows are output row ty of the tile; its A rows for
    // tap (dy, dx) are halo rows (STRIDE ty + dy) * COLS + STRIDE x + dx,
    // read with ldmatrix at their 128-byte-swizzled addresses (one row
    // address a lane, so stride 2 steps over every other halo pixel)
    const int ty = 4 * cg + (warp & 3);
    const int lrow = lane & 15, lk = lane >> 4;
    // k16 slices of the last channel chunk that hold channels; the rest
    // are zero fill on both sides and are skipped
    const int tail = (p.Cin - (p.nkc - 1) * BK + 15) / 16;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    int g = 0;
    for (int c = 0; c < p.nkc; ++c) {
      const int hb = c % HL::BUFS;
      int ks = c == p.nkc - 1 ? tail : BK / 16;
      bool img = false;  // K5's image chunk: one k16 slice from the tile
      if constexpr (MODE == MULTI) {
        ks = p.chunk[c].ks;
        img = p.chunk[c].ch < 0;
      }
      mbar_wait(&a_full[hb], (c / HL::BUFS) & 1);
      const uint32_t hbase = smem_u32(halo + hb * HL::BYTES);
      if (img) {
        images_to_tile(halo + hb * HL::BYTES, p.nimg);
        named_barrier(1, 128 * CONSUMERS);
      }
      for (int tap = 0; tap < 9; ++tap, ++g) {
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
        const int hr = (STRIDE * ty + dy) * HL::COLS + STRIDE * lrow + dx;
        uint32_t a[BK / 16][4];
        if (img) {
          ldsm_x4(a[0], hbase + IMG_TILE + hr * 32 +
                            ((lk ^ ((hr >> 2) & 1)) << 4));
        } else {
#pragma unroll
          for (int k = 0; k < BK / 16; ++k)
            if (k < ks)
              ldsm_x4(a[k],
                      hbase + hr * 128 + (((2 * k + lk) ^ (hr & 7)) << 4));
        }
        if (tap == 8) {  // the chunk's halo is in registers: hand it back
          // the ldmatrix reads (generic proxy) before the TMA that
          // refills the buffer (async proxy); without the fence the
          // single stride-2 buffer, refilled at once, was read after
          // its refill now and then (repeated launches differed at one
          // site; PERF.md)
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(&a_empty[hb]);
        }
        const int s = g % S::STAGES;
        mbar_wait(&full[s], (g / S::STAGES) & 1);
        const uint64_t db = sw128_desc(bring + s * S::B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          if (k < ks) wgmma_rs<BN>(acc, a[k], db + 2 * k);
        wgmma_commit();
        wgmma_wait<0>();
        if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
      }
    }
    store_rows<BN>(acc, p, b, y0, x0, n0, cg, warp, lane);
  }
}

// FOLD: K5 over one f32 3-channel image, Cout <= BN (one column tile).
// A block walks tiles blockIdx.x, + gridDim.x, ...; the producer thread
// loads the weight once and each tile's image box (10 rows x 56 floats)
// into one of two buffers; the consumers round the box into the im2col
// tile [128 pixels, 32], column k = 3 (3 dy + dx) + c for tap (dy, dx)
// and channel c (k >= 27 zero), 64-byte rows with their 16-byte pieces
// swizzled by (row / 2) % 4, and run two k16 slices of wgmma against the
// weight [BN, 64] (columns k, zero past 27).
template <int BN>
__global__ void __launch_bounds__(Fold<BN>::THREADS, Fold<BN>::BLOCKS_PER_SM)
    conv3x3_fold_kernel(const __grid_constant__ CUtensorMap imap,
                        const __grid_constant__ CUtensorMap bmap,
                        const __grid_constant__ Params p) {
  using F = Fold<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* buf = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* wsm = buf + 2 * F::BUF;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(wsm + F::B_BYTES);
  uint64_t* a_full = w_full + 1;
  uint64_t* a_empty = a_full + 2;
  const int tiles = p.tiles_x * p.tiles_y * p.B;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    mbar_init(w_full, 1);
    for (int h = 0; h < 2; ++h) {
      mbar_init(&a_full[h], 1);
      mbar_init(&a_empty[h], 4 * CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {
    if (threadIdx.x == 128 * CONSUMERS) {
      mbar_expect_tx(w_full, F::B_BYTES);
      tma_load_3d(wsm, &bmap, w_full, 0, 0, 0);
      int i = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const int hb = i & 1;
        mbar_wait(&a_empty[hb], ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(&a_full[hb], IMG_BOX);
        const int x0 = (t % p.tiles_x) * 16, u = t / p.tiles_x;
        tma_load_3d(buf + hb * F::BUF, &imap, &a_full[hb], 3 * x0 - 4,
                    (u % p.tiles_y) * 8 - 1, u / p.tiles_y);
      }
    }
    return;
  }

  const int cg = warp / 4, lane = threadIdx.x & 31;
  const int r = 16 * (4 * cg + (warp & 3)) + (lane & 15), lk = lane >> 4;
  // this thread's two tile columns 2 kp, 2 kp + 1 and their offsets in
  // the image box from the pixel's own
  const int kp = threadIdx.x & 15;
  int off[2];
  bool real[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int k = 2 * kp + e, tap = k / 3;
    real[e] = k < 27;
    off[e] = (tap / 3) * IMG_COLS + 3 * (tap % 3) + 1 + (k - 3 * tap);
  }
  mbar_wait(w_full, 0);
  const uint64_t db = sw128_desc(wsm);
  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int hb = i & 1;
    unsigned char* bb = buf + hb * F::BUF;
    mbar_wait(&a_full[hb], (i >> 1) & 1);
    const float* st = reinterpret_cast<const float*>(bb);
    uint32_t* tile = reinterpret_cast<uint32_t*>(bb + IMG_PITCH);
    for (int e = threadIdx.x; e < 128 * 16; e += 128 * CONSUMERS) {
      const int rr = e >> 4;
      const int base = (rr >> 4) * IMG_COLS + 3 * (rr & 15);
      const float v0 = real[0] ? st[base + off[0]] : 0.0f;
      const float v1 = real[1] ? st[base + off[1]] : 0.0f;
      tile[rr * 16 + (((kp >> 2) ^ ((rr >> 1) & 3)) << 2) + (kp & 3)] =
          pack_bf16x2(v0, v1);
    }
    named_barrier(1, 128 * CONSUMERS);
    const uint32_t tb = smem_u32(bb + IMG_PITCH);
    uint32_t a[2][4];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      ldsm_x4(a[k], tb + r * 64 + (((2 * k + lk) ^ ((r >> 1) & 3)) << 4));
    fence_proxy_async();  // as in the halo kernel
    __syncwarp();
    if (lane == 0) mbar_arrive(&a_empty[hb]);
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
    wgmma_fence();
    wgmma_rs<BN>(acc, a[0], db);
    wgmma_rs<BN>(acc, a[1], db + 2);
    wgmma_commit();
    wgmma_wait<0>();
    const int x0 = (t % p.tiles_x) * 16, u = t / p.tiles_x;
    store_rows<BN>(acc, p, u / p.tiles_y, (u % p.tiles_y) * 8, x0, 0, cg,
                   warp, lane);
  }
}

// ---------------------------------------------------------------------
// host side

// BN for Cout. Stride 1: the least padded work, counting a tile
// narrower than 128 columns as slower by 128 / BN (below that a wgmma
// does too few products per A fragment to run at the tensor cores'
// rate); ties go to the narrower tile. (With a 128-column tile among
// these the main path's sites took longer in all in an on-chip sweep;
// PERF.md.) Stride 2: a chunk's halo is 561 rows of 128 bytes
// against 9 BN rows of weights, and each column tile reloads both, so
// the tile with the fewest bytes into shared memory a chunk, n_tiles x
// (561 + 9 BN) rows, exact 128- and 256-column tiles included
// (PERF.md); ties go to the narrower tile.
int pick_bn(int cout, int stride) {
  const int cands[6] = {16, 64, 104, 128, 200, 256};
  int best = 0;
  long long best_cost = -1;
  for (int bn : cands) {
    if (stride == 1 && (bn == 128 || bn == 256)) continue;
    const long long tiles = (cout + bn - 1) / bn;
    const long long cost =
        stride == 1 ? tiles * bn * 128 / (bn < 128 ? bn : 128)
                    : tiles * (Halo<2>::COLS * Halo<2>::ROWS + 9 * bn);
    if (best_cost < 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

template <int BN, int STRIDE, int MODE, typename Maps>
int launch_bn(const Maps& am, const CUtensorMap& bmap, const Params& p,
              int tiles, cudaStream_t st) {
  using S = Shape<BN, STRIDE>;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<BN, STRIDE, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  conv3x3_wgmma_kernel<BN, STRIDE, MODE><<<tiles, S::THREADS, S::SMEM, st>>>(
      am, bmap, p);
  return (int)cudaGetLastError();
}

// The column tiles of each stride (pick_bn): 128 and 256 at stride 2.
template <int STRIDE, int MODE, typename Maps>
int launch_stride(const Maps& am, const CUtensorMap& bmap, const Params& p,
                  int bn, int tiles, cudaStream_t st) {
  switch (bn) {
    case 16: return launch_bn<16, STRIDE, MODE>(am, bmap, p, tiles, st);
    case 64: return launch_bn<64, STRIDE, MODE>(am, bmap, p, tiles, st);
    case 104: return launch_bn<104, STRIDE, MODE>(am, bmap, p, tiles, st);
    case 200: return launch_bn<200, STRIDE, MODE>(am, bmap, p, tiles, st);
  }
  if constexpr (STRIDE == 2) {
    if (bn == 128) return launch_bn<128, 2, MODE>(am, bmap, p, tiles, st);
    if (bn == 256) return launch_bn<256, 2, MODE>(am, bmap, p, tiles, st);
  }
  return (int)cudaErrorInvalidValue;
}

// FOLD: as many blocks as fit the card at once, or one a tile.
template <int BN>
int launch_fold(const CUtensorMap& imap, const CUtensorMap& bmap,
                const Params& p, int tiles, cudaStream_t st) {
  using F = Fold<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_fold_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F::SMEM);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv3x3_fold_kernel<BN>, F::THREADS, F::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(tiles < fit ? tiles : fit);
  conv3x3_fold_kernel<BN><<<blocks, F::THREADS, F::SMEM, st>>>(imap, bmap,
                                                              p);
  return (int)cudaGetLastError();
}

template <int STRIDE>
int smem_bytes(int bn) {
  switch (bn) {
    case 16: return Shape<16, STRIDE>::SMEM;
    case 64: return Shape<64, STRIDE>::SMEM;
    case 104: return Shape<104, STRIDE>::SMEM;
    case 200: return Shape<200, STRIDE>::SMEM;
  }
  if constexpr (STRIDE == 2) {
    if (bn == 128) return Shape<128, 2>::SMEM;
    if (bn == 256) return Shape<256, 2>::SMEM;
  }
  return 0;
}

// f32 map over an image's rows of 3 W floats (row stride 12 W bytes, a
// multiple of 16; base 16-byte aligned), box [56 floats, 10 rows, 1].
int encode_image(CUtensorMap* map, const void* base, int B, int H, int W) {
  const cuuint64_t dims[3] = {(cuuint64_t)3 * W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)12 * W,
                                 (cuuint64_t)12 * W * H};
  const cuuint32_t box[3] = {IMG_COLS, 10, 1};
  return hopper::encode_as(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                           CU_TENSOR_MAP_SWIZZLE_NONE, 3, base, dims,
                           strides, box);
}

// Params of a stride-1 or -2 conv to an output of Cout channels at pixel
// stride out_ps, column tile bn.
Params params_for(int B, int H, int W, int Cin, int stride, int bn,
                  const float* bias, const float* slope, void* out, int Cout,
                  long long out_ps) {
  Params p{};
  p.B = B;
  p.H = (H - 1) / stride + 1;  // the output's rows and columns
  p.W = (W - 1) / stride + 1;
  p.Cin = Cin;
  p.Cout = Cout;
  p.tiles_x = (p.W + 15) / 16;
  p.tiles_y = (p.H + 7) / 8;
  p.n_tiles = (Cout + bn - 1) / bn;
  p.nkc = (Cin + BK - 1) / BK;
  p.bias = bias;
  p.slope = slope;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ops = out_ps;
  return p;
}

bool out_ok(int B, int H, int W, int Cout, const void* out, long long out_ps,
            const float* bias) {
  return B >= 1 && H >= 1 && W >= 1 && Cout >= 1 && out_ps >= Cout &&
         out_ps % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0 &&
         bias && (long long)B * H * W < (1LL << 31);
}

}  // namespace wg
}  // namespace

// Dynamic shared memory of the instantiation for column tile bn and
// stride 1 or 2 (0 for one it does not have).
extern "C" int conv3x3_wgmma_smem_bytes(int bn, int stride) {
  return stride == 1 ? wg::smem_bytes<1>(bn)
                     : stride == 2 ? wg::smem_bytes<2>(bn) : 0;
}

// The weight's tensor map for packed bf16 weights w [taps][Cout][Kp]
// (Kp % 8 == 0; taps 9, or 1 for K5's FOLD) in a conv of the given
// stride: writes the 128-byte CUtensorMap to map_out and the column tile
// BN it was made for to bn_out.
extern "C" int conv3x3_wgmma_weight_map(const void* w, int Kp, int Cout,
                                        int stride, int taps, void* map_out,
                                        int* bn_out) {
  if (Kp < 8 || Kp % 8 || Cout < 1 || reinterpret_cast<uintptr_t>(w) % 16 ||
      (stride != 1 && stride != 2) || (taps != 9 && taps != 1))
    return (int)cudaErrorInvalidValue;
  const int bn = wg::pick_bn(Cout, stride);
  const cuuint64_t dims[3] = {(cuuint64_t)Kp, (cuuint64_t)Cout,
                              (cuuint64_t)taps};
  const cuuint64_t strides[2] = {(cuuint64_t)Kp * 2,
                                 (cuuint64_t)Kp * 2 * Cout};
  const cuuint32_t box[3] = {wg::BK, (cuuint32_t)bn, 1};
  alignas(64) CUtensorMap map;
  const int rc = hopper::encode(&map, 3, w, dims, strides, box);
  if (rc) return rc;
  memcpy(map_out, &map, sizeof(map));
  *bn_out = bn;
  return 0;
}

// K3 (stride 1) and K4 (stride 2, out ceil(H/2) x ceil(W/2)) bf16 on
// wgmma: x [B, H, W, Cin] bf16 at pixel stride ps (a multiple of 8; x
// 16-byte aligned), the weight map from conv3x3_wgmma_weight_map (host
// memory, 128 bytes) for column tile bn, f32 bias and slope (null: no
// PReLU), out [B, Ho, Wo, Cout] bf16 at pixel stride out_ps.
extern "C" int conv3x3_wgmma_bf16(const void* x, long long ps, int B, int H,
                                  int W, int Cin, int stride,
                                  const void* wmap, int bn,
                                  const float* bias, const float* slope,
                                  void* out, int Cout, long long out_ps,
                                  void* stream) {
  if (!wg::out_ok(B, H, W, Cout, out, out_ps, bias) || Cin < 1 || ps < Cin ||
      ps % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      (stride != 1 && stride != 2) || bn != wg::pick_bn(Cout, stride))
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ps * 2, (cuuint64_t)ps * 2 * W,
                                 (cuuint64_t)ps * 2 * W * H};
  const cuuint32_t box[4] = {
      wg::BK,
      (cuuint32_t)(stride == 1 ? wg::Halo<1>::COLS : wg::Halo<2>::COLS),
      (cuuint32_t)(stride == 1 ? wg::Halo<1>::ROWS : wg::Halo<2>::ROWS), 1};
  alignas(64) wg::AMaps<1> am;
  alignas(64) CUtensorMap bmap;
  const int rc = hopper::encode(&am.m[0], 4, x, dims, strides, box);
  if (rc) return rc;
  memcpy(&bmap, wmap, sizeof(bmap));
  const wg::Params p = wg::params_for(B, H, W, Cin, stride, bn, bias, slope,
                                      out, Cout, out_ps);
  const long long tiles = (long long)B * p.tiles_y * p.tiles_x * p.n_tiles;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return stride == 1
             ? wg::launch_stride<1, wg::SINGLE>(am, bmap, p, bn, (int)tiles,
                                                st)
             : wg::launch_stride<2, wg::SINGLE>(am, bmap, p, bn, (int)tiles,
                                                st);
}

// K5 bf16 on wgmma: the stride-1 conv over the channel concat of nsrc
// sources, desc 5 int64 each (pointer, pixel stride, channels, is_f32,
// unused), all [B, H, W]. A bf16 source: pixel stride a multiple of 8,
// 16-byte aligned. An f32 source: 3 channels at pixel stride 3, 16-byte
// aligned, 12 W a multiple of 16; at most five. The weight map (from
// conv3x3_wgmma_weight_map, column tile bn) is the weight packed in the
// kernel's order: the bf16 sources in turn, each from a multiple of 8,
// then the images' channels (9 taps); with fold (one f32 source alone,
// Cout <= bn) the [1][Cout][64] fold of its 27 taps x channels. out
// [B, H, W, Cout] bf16 at pixel stride out_ps.
extern "C" int conv3x3_multi_wgmma_bf16(const int64_t* desc, int nsrc, int B,
                                        int H, int W, const void* wmap,
                                        int bn, int fold, const float* bias,
                                        const float* slope, void* out,
                                        int Cout, long long out_ps,
                                        void* stream) {
  if (!wg::out_ok(B, H, W, Cout, out, out_ps, bias) || nsrc < 1 ||
      nsrc > wg::MAX_MAPS || bn != wg::pick_bn(Cout, 1) || (12LL * W) % 16)
    return (int)cudaErrorInvalidValue;
  alignas(64) wg::AMaps<wg::MAX_MAPS> am;
  alignas(64) CUtensorMap bmap;
  memcpy(&bmap, wmap, sizeof(bmap));
  wg::Params p = wg::params_for(B, H, W, 0, 1, bn, bias, slope, out, Cout,
                                out_ps);
  int nmap = 0, nchunk = 0, k = 0, cin = 0;
  // the bf16 sources, then the images
  for (int pass = 0; pass < 2; ++pass)
    for (int s = 0; s < nsrc; ++s) {
      const void* ptr = reinterpret_cast<const void*>(desc[5 * s]);
      const long long ps = desc[5 * s + 1];
      const int C = (int)desc[5 * s + 2], f32 = (int)desc[5 * s + 3];
      if (f32 != pass) continue;
      if (reinterpret_cast<uintptr_t>(ptr) % 16 || C < 1 || ps < C)
        return (int)cudaErrorInvalidValue;
      if (pass == 1) {
        if (C != 3 || ps != 3 || p.nimg == wg::MAX_IMGS)
          return (int)cudaErrorInvalidValue;
        if (p.nimg++ == 0) p.img0 = nmap;
        if (wg::encode_image(&am.m[nmap++], ptr, B, H, W))
          return (int)cudaErrorInvalidValue;
        continue;
      }
      if (ps % 8) return (int)cudaErrorInvalidValue;
      const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W,
                                  (cuuint64_t)H, (cuuint64_t)B};
      const cuuint64_t strides[3] = {(cuuint64_t)ps * 2,
                                     (cuuint64_t)ps * 2 * W,
                                     (cuuint64_t)ps * 2 * W * H};
      const cuuint32_t box[4] = {wg::BK, wg::Halo<1>::COLS,
                                 wg::Halo<1>::ROWS, 1};
      if (hopper::encode(&am.m[nmap], 4, ptr, dims, strides, box))
        return (int)cudaErrorInvalidValue;
      for (int c0 = 0; c0 < C; c0 += wg::BK) {
        if (nchunk == wg::MAX_CHUNKS) return (int)cudaErrorInvalidValue;
        const int n = C - c0 < wg::BK ? C - c0 : wg::BK;
        p.chunk[nchunk++] = wg::Chunk{nmap, c0, k + c0, (n + 15) / 16};
      }
      ++nmap;
      k += (C + 7) / 8 * 8;
      cin += C;
    }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fold) {
    if (nmap != 1 || p.nimg != 1 || Cout > bn) return (int)cudaErrorInvalidValue;
    p.Cin = 3;
    const long long tiles = (long long)B * p.tiles_y * p.tiles_x;
    if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    if (bn == 16)
      return wg::launch_fold<16>(am.m[0], bmap, p, (int)tiles, st);
    if (bn == 64)
      return wg::launch_fold<64>(am.m[0], bmap, p, (int)tiles, st);
    return (int)cudaErrorInvalidValue;
  }
  if (p.nimg) {
    if (nchunk == wg::MAX_CHUNKS) return (int)cudaErrorInvalidValue;
    p.chunk[nchunk++] = wg::Chunk{p.img0, -1, k, 1};
    cin += 3 * p.nimg;
  }
  p.Cin = cin;
  p.nkc = nchunk;
  const long long tiles = (long long)B * p.tiles_y * p.tiles_x * p.n_tiles;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return wg::launch_stride<1, wg::MULTI>(am, bmap, p, bn, (int)tiles, st);
}

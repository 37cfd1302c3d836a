// Kernels K3 and K4, bf16: 3x3 convolution, stride 1 (K3) or 2 (K4), +
// bias (+ per-channel PReLU), NHWC, as an implicit GEMM on Hopper's
// wgmma with TMA loads, sm_90a. One kernel, the stride a template
// parameter.
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

struct Params {
  int H, W, Cin, Cout;
  int tiles_x, tiles_y, n_tiles, nkc;
  const float* bias;
  const float* slope;  // null: no PReLU
  __nv_bfloat16* out;
  long long ops;       // output pixel stride
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

// One 128 x BN output tile a block. Blocks run BN-column tiles fastest,
// so the blocks sharing an A tile run together; then 16-column, 8-row
// rectangles, then images.
template <int BN, int STRIDE>
__global__ void __launch_bounds__(Shape<BN, STRIDE>::THREADS,
                                  Shape<BN, STRIDE>::BLOCKS_PER_SM)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                         const __grid_constant__ CUtensorMap bmap,
                         const __grid_constant__ Params p) {
  using S = Shape<BN, STRIDE>;
  using HL = Halo<STRIDE>;
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
        mbar_wait(&a_empty[hb], ((c / HL::BUFS) & 1) ^ 1);
        mbar_expect_tx(&a_full[hb], HL::TX);
        tma_load_4d(halo + hb * HL::BYTES, &amap, &a_full[hb], c * BK,
                    STRIDE * x0 - 1, STRIDE * y0 - 1, b);
        for (int tap = 0; tap < 9; ++tap, ++g) {
          const int s = g % S::STAGES;
          mbar_wait(&empty[s], ((g / S::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], S::B_BYTES);
          tma_load_3d(bring + s * S::B_BYTES, &bmap, &full[s], c * BK, n0,
                      tap);
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
      const int ks = c == p.nkc - 1 ? tail : BK / 16;
      mbar_wait(&a_full[hb], (c / HL::BUFS) & 1);
      const uint32_t hbase = smem_u32(halo + hb * HL::BYTES);
      for (int tap = 0; tap < 9; ++tap, ++g) {
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
        const int hr = (STRIDE * ty + dy) * HL::COLS + STRIDE * lrow + dx;
        uint32_t a[BK / 16][4];
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          if (k < ks)
            ldsm_x4(a[k], hbase + hr * 128 + (((2 * k + lk) ^ (hr & 7)) << 4));
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

    // epilogue: rows of this warpgroup are pixels 64 cg + 16 (warp % 4)
    // + lane / 4 (+ 8); columns n0 + 8 j + 2 (lane % 4) (+ 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * cg + 16 * (warp & 3) + (lane >> 2) + 8 * h;
      const int y = y0 + r / 16, x = x0 + (r & 15);
      if (y >= p.H || x >= p.W) continue;
      __nv_bfloat16* o =
          p.out + (((long long)b * p.H + y) * p.W + x) * p.ops;
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

template <int BN, int STRIDE>
int launch_bn(const CUtensorMap& amap, const CUtensorMap& bmap,
              const Params& p, int tiles, cudaStream_t st) {
  using S = Shape<BN, STRIDE>;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<BN, STRIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  conv3x3_wgmma_kernel<BN, STRIDE><<<tiles, S::THREADS, S::SMEM, st>>>(
      amap, bmap, p);
  return (int)cudaGetLastError();
}

// The column tiles of each stride (pick_bn): 128 and 256 at stride 2.
template <int STRIDE>
int launch_stride(const CUtensorMap& amap, const CUtensorMap& bmap,
                  const Params& p, int bn, int tiles, cudaStream_t st) {
  switch (bn) {
    case 16: return launch_bn<16, STRIDE>(amap, bmap, p, tiles, st);
    case 64: return launch_bn<64, STRIDE>(amap, bmap, p, tiles, st);
    case 104: return launch_bn<104, STRIDE>(amap, bmap, p, tiles, st);
    case 200: return launch_bn<200, STRIDE>(amap, bmap, p, tiles, st);
  }
  if constexpr (STRIDE == 2) {
    if (bn == 128) return launch_bn<128, 2>(amap, bmap, p, tiles, st);
    if (bn == 256) return launch_bn<256, 2>(amap, bmap, p, tiles, st);
  }
  return (int)cudaErrorInvalidValue;
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

}  // namespace wg
}  // namespace

// Dynamic shared memory of the instantiation for column tile bn and
// stride 1 or 2 (0 for one it does not have).
extern "C" int conv3x3_wgmma_smem_bytes(int bn, int stride) {
  return stride == 1 ? wg::smem_bytes<1>(bn)
                     : stride == 2 ? wg::smem_bytes<2>(bn) : 0;
}

// The weight's tensor map for packed bf16 weights w [9][Cout][Kp]
// (Kp % 8 == 0) in a conv of the given stride: writes the 128-byte
// CUtensorMap to map_out and the column tile BN it was made for to
// bn_out.
extern "C" int conv3x3_wgmma_weight_map(const void* w, int Kp, int Cout,
                                        int stride, void* map_out,
                                        int* bn_out) {
  if (Kp < 8 || Kp % 8 || Cout < 1 || reinterpret_cast<uintptr_t>(w) % 16 ||
      (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  const int bn = wg::pick_bn(Cout, stride);
  const cuuint64_t dims[3] = {(cuuint64_t)Kp, (cuuint64_t)Cout, 9};
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
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || ps < Cin ||
      ps % 8 || reinterpret_cast<uintptr_t>(x) % 16 || out_ps < Cout ||
      out_ps % 2 || reinterpret_cast<uintptr_t>(out) % 4 || !bias ||
      (stride != 1 && stride != 2) || bn != wg::pick_bn(Cout, stride) ||
      (long long)B * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ps * 2, (cuuint64_t)ps * 2 * W,
                                 (cuuint64_t)ps * 2 * W * H};
  const cuuint32_t box[4] = {
      wg::BK,
      (cuuint32_t)(stride == 1 ? wg::Halo<1>::COLS : wg::Halo<2>::COLS),
      (cuuint32_t)(stride == 1 ? wg::Halo<1>::ROWS : wg::Halo<2>::ROWS), 1};
  alignas(64) CUtensorMap amap, bmap;
  const int rc = hopper::encode(&amap, 4, x, dims, strides, box);
  if (rc) return rc;
  memcpy(&bmap, wmap, sizeof(bmap));
  wg::Params p;
  p.H = (H - 1) / stride + 1;  // the output's rows and columns
  p.W = (W - 1) / stride + 1;
  p.Cin = Cin;
  p.Cout = Cout;
  p.tiles_x = (p.W + 15) / 16;
  p.tiles_y = (p.H + 7) / 8;
  p.n_tiles = (Cout + bn - 1) / bn;
  p.nkc = (Cin + wg::BK - 1) / wg::BK;
  p.bias = bias;
  p.slope = slope;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ops = out_ps;
  const long long tiles = (long long)B * p.tiles_y * p.tiles_x * p.n_tiles;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return stride == 1 ? wg::launch_stride<1>(amap, bmap, p, bn, (int)tiles, st)
                     : wg::launch_stride<2>(amap, bmap, p, bn, (int)tiles, st);
}

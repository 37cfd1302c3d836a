// Kernels K2, K9 and K10: bilinear backward warp, NHWC, for sm_90a.
//
// Replaces the TPU tile-slab warp `atmvfi_tpu/ops/warp_pallas.py::
// flow_warp_tiled` (v3 kernel `_kernel_v3`, and the pair form
// `warp_pair_op`). out[b,i,j,:] samples img at (j + fx, i + fy) with
// four bilinear taps, align_corners, zeros padding per tap: a tap
// outside the image contributes exactly 0 and nothing is clamped
// (`atmvfi_tpu/ops/warp.py:73-75`).
//
// On the TPU the gather had to be rebuilt from slab DMAs, lane gathers
// and an exactness fallback. A GPU thread reads any address, so there
// is no slab, no fallback and no unchecked flavour.
//
// Taps and weights are f32 and summed in the plain version's order with
// explicitly rounded operations (no FMA contraction), so an f32 result
// is bit-equal to `ops/warp.py::flow_warp` on the same card; bf16
// features are accumulated in f32 and rounded once.
//
// The pair form warps two images by two flows in one launch
// (blockIdx.y selects the image).
//
// Bound: bytes (the taps mostly hit L1/L2; each output is written
// once). The first form (one thread per (pixel, channel)) redid the
// pixel's tap arithmetic -- a flow load, a 64-bit division, four bounds
// checks and four weights -- for every channel and made only 2-byte
// loads: 11x its byte bound at 384 bf16 channels, slower than
// `grid_sample`. Now:
//  * wide form (C > 4, the 1/8 feature maps): a block takes a group of
//    pixels; one thread per pixel computes its taps (source offsets and
//    weights) once into shared memory, then the threads covering the
//    pixel's channels read them back. A thread covers one 16-byte chunk
//    (8 bf16 or 4 f32 channels) per tap row and writes one 16-byte
//    chunk. The chunk width follows the pixel stride and the pointers'
//    alignment; a ragged C or an unaligned slice takes 1-channel chunks.
//    The thread -> (pixel, chunk) split is computed once per thread,
//    outside the pixel loop: no division per element.
//  * narrow form (C <= 4, the f32 image pyramid): each thread takes 4
//    pixels on maps of at least 132 such blocks (their flows read as
//    float2, all loads issued before the sums; 1 pixel on smaller maps,
//    so that every SM gets work), and the block's output goes through
//    shared memory so that it is written as contiguous 16-byte pieces.
// Every channel keeps the plain version's rounded operations in its
// order, so f32 stays bit-equal.
//
// Kernel K10 (`warp_pair_srcfull_f32`) replaces the TPU's slab-row warp
// pair of the row-sharded serving schedule, `planar_warp_pair_srcfull`:
// K2 whose output rows are a slab [row0, row0 + H_out) of a full source
// of H_src rows. The pixel index decomposes over H_out; the taps are
// validated against, and addressed in, the H_src-row source. K10 folds
// row0 into the flow first, y = i + (fy + row0), as the TPU op does
// (`warp_pallas.py:1423-1426`), so its rows are not bit-equal to the
// full-frame warp's. The single form `flow_warp_rows_*` (the NHWC
// feature row warp of `ops/warp.py::flow_warp_rows`) adds row0 to the
// row index instead, y = (i + row0) + fy, which is bit-equal to the
// full-frame warp's rows. On the TPU the slab op needs per-tile slab
// extents, an exactness cond and an XLA fallback because its sources
// are VMEM slabs; here a thread reads any row of the full source, so
// none of that exists.
//
// Kernel K9 (`warp_blend_f32`) replaces the TPU's fused dual warp +
// occlusion blend `flow_warp_blend_tiled` (`_kernel_blend`):
// I_t = occ * warp(img0, flow0) + (1 - occ) * warp(img1, flow1) on f32
// NHWC images (C <= 4). The two warped frames never reach device
// memory: it reads each image's taps, both flows and occ, and writes I_t
// once: 56 of the 104 bytes per pixel (C = 3) that the pair warp plus
// the separate blend move. Bound: bytes. It is the narrow form with the
// blend as its epilogue: 4 pixels a thread on maps that fill the card (1
// on smaller ones), the flows (float2) and occ loaded coalesced for all
// of them first, the block's blended pixels staged in shared memory and
// written as contiguous 16-byte pieces. What remains is the gathers'
// (2.1x its bound on a smooth 1088x1920 flow field, 3.6x on random
// per-pixel flows): 16-byte loads of a tap row's 6 floats, 32-bit tap
// offsets and 64 x 16-pixel tiles (for L1 reuse of tap rows across
// output rows) each moved it by 7 % or less on random flows and not at
// all, or the wrong way, on smooth ones, so the gathers stay scalar.
// The blend uses the plain version's rounded operations in its order
// (occ*w0, 1-occ, (1-occ)*w1, the sum; no FMA contraction), so I_t is
// bit-equal to the K2 pair followed by the eager blend.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
  return __float2bfloat16_rn(v);
}

struct Taps {
  int64_t off[4];  // element offset of the tap's pixel, -1 when invalid
  float w[4];
};

// Output rows [row0, row0 + H_out) of a warp whose source has H_src rows
// (the full-frame warp: H_out = H_src, row0 = 0). fold: add row0 to the
// flow's y first (K10) instead of to the row index.
struct Rows {
  int H_out, H_src, row0, fold;
};

// Tap offsets (pixel index * pixel stride) and weights of output pixel
// p = (b, i, j) with flow (fx, fy); mirrors the arithmetic of
// ops/warp.py::_sample_xy operation for operation.
__device__ __forceinline__ Taps make_taps(float2 f, int p, Rows r, int W,
                                          int64_t ps) {
  const int hw = r.H_out * W;
  const int b = p / hw;
  const int q = p - b * hw;
  const int i = q / W;
  const int j = q - i * W;
  const float x = __fadd_rn((float)j, f.x);
  const float y = r.fold ? __fadd_rn((float)i, __fadd_rn(f.y, (float)r.row0))
                         : __fadd_rn(__fadd_rn((float)i, (float)r.row0), f.y);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx1 = __fsub_rn(x, x0);
  const float wy1 = __fsub_rn(y, y0);
  const float wx0 = __fsub_rn(1.0f, wx1);
  const float wy0 = __fsub_rn(1.0f, wy1);
  const int H = r.H_src;
  // clamp to [-2, W] / [-2, H]: keeps every validity decision and
  // bounds the integer conversion for huge flows
  const int xi = (int)fminf(fmaxf(x0, -2.0f), (float)W);
  const int yi = (int)fminf(fmaxf(y0, -2.0f), (float)H);
  Taps t;
  t.w[0] = __fmul_rn(wx0, wy0);
  t.w[1] = __fmul_rn(wx1, wy0);
  t.w[2] = __fmul_rn(wx0, wy1);
  t.w[3] = __fmul_rn(wx1, wy1);
  const int64_t src = (int64_t)b * H * W;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xx = xi + (k & 1);
    const int yy = yi + (k >> 1);
    const bool valid = xx >= 0 && xx <= W - 1 && yy >= 0 && yy <= H - 1;
    t.off[k] = valid ? (src + (int64_t)yy * W + xx) * ps : -1;
  }
  return t;
}

__device__ __forceinline__ float2 load_flow(const float* flow, int p) {
  return reinterpret_cast<const float2*>(flow)[p];
}

template <typename T>
__device__ __forceinline__ float tap_sum(const T* __restrict__ img,
                                         const Taps& t, int c) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // an invalid tap contributes 0 * w = +0, like the plain version
    const float v = t.off[k] >= 0 ? to_f(img[t.off[k] + c]) : 0.0f;
    const float term = __fmul_rn(v, t.w[k]);
    acc = k == 0 ? term : __fadd_rn(acc, term);
  }
  return acc;
}

struct WarpArgs {
  const void* img[2];
  const float* flow[2];
  void* out[2];
};

// Narrow form (C <= 4): PPT pixels a thread (4 on maps large enough to
// fill the card with such blocks, else 1), the block's pixels staged in
// shared memory and written out as contiguous 16-byte pieces.
constexpr int NARROW_THREADS = 256;

template <typename T, int PPT>
__global__ void __launch_bounds__(NARROW_THREADS)
    warp_narrow_kernel(WarpArgs a, int n, Rows r, int W, int C,
                       int64_t ps) {
  constexpr int PIX = NARROW_THREADS * PPT;
  __shared__ __align__(16) T tile[PIX * 4];
  const int s = blockIdx.y;
  const T* __restrict__ img = static_cast<const T*>(a.img[s]);
  const float* __restrict__ flow = a.flow[s];
  T* __restrict__ out = static_cast<T*>(a.out[s]);
  for (int base = blockIdx.x * PIX; base < n; base += gridDim.x * PIX) {
    Taps t[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = base + k * NARROW_THREADS + threadIdx.x;
      t[k] = make_taps(p < n ? load_flow(flow, p) : make_float2(0.f, 0.f),
                       p < n ? p : 0, r, W, ps);
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int lp = k * NARROW_THREADS + threadIdx.x;
      for (int c = 0; c < C; ++c)
        tile[lp * C + c] = from_f<T>(tap_sum(img, t[k], c));
    }
    __syncthreads();
    const int nel = min(PIX, n - base) * C;
    // 16-byte aligned: base is a multiple of 256 pixels, out of 16
    T* dst = out + (int64_t)base * C;
    constexpr int V = 16 / sizeof(T);
    const int nvec = nel / V;
    for (int v = threadIdx.x; v < nvec; v += NARROW_THREADS)
      reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(tile)[v];
    for (int e = nvec * V + threadIdx.x; e < nel; e += NARROW_THREADS)
      dst[e] = tile[e];
    __syncthreads();
  }
}

// Wide form (C > 4): VEC channels a chunk (16 bytes, or 1 for ragged or
// unaligned maps); a block takes `ppb` pixels at a time, `tpp` threads
// per pixel, the taps computed once per pixel into shared memory.
constexpr int WIDE_THREADS = 256;

template <typename T, int VEC>
__device__ __forceinline__ void warp_chunk(const T* __restrict__ img,
                                           T* __restrict__ out,
                                           const int64_t* off,
                                           const float* w, int c) {
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __align__(16) T v[VEC];
    if (off[k] >= 0) {
      if constexpr (VEC * sizeof(T) == 16)
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(img + off[k] + c);
      else
        v[0] = img[off[k] + c];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      // an invalid tap contributes 0 * w = +0, like the plain version
      const float term = __fmul_rn(off[k] >= 0 ? to_f(v[e]) : 0.0f, w[k]);
      acc[e] = k == 0 ? term : __fadd_rn(acc[e], term);
    }
  }
  __align__(16) T o[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) o[e] = from_f<T>(acc[e]);
  if constexpr (VEC * sizeof(T) == 16)
    *reinterpret_cast<uint4*>(out + c) = *reinterpret_cast<uint4*>(o);
  else
    out[c] = o[0];
}

template <typename T, int VEC>
__global__ void __launch_bounds__(WIDE_THREADS)
    warp_wide_kernel(WarpArgs a, int n, Rows r, int W, int C, int64_t ps,
                     int tpp, int ppb) {
  __shared__ int64_t s_off[WIDE_THREADS][4];
  __shared__ float s_w[WIDE_THREADS][4];
  const int s = blockIdx.y;
  const T* __restrict__ img = static_cast<const T*>(a.img[s]);
  const float* __restrict__ flow = a.flow[s];
  T* __restrict__ out = static_cast<T*>(a.out[s]);
  const int nch = C / VEC;
  const int slot = threadIdx.x / tpp;  // once per thread
  const int lane = threadIdx.x - slot * tpp;
  for (int base = blockIdx.x * ppb; base < n; base += gridDim.x * ppb) {
    if (threadIdx.x < ppb && base + threadIdx.x < n) {
      const int p = base + threadIdx.x;
      const Taps t = make_taps(load_flow(flow, p), p, r, W, ps);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s_off[threadIdx.x][k] = t.off[k];
        s_w[threadIdx.x][k] = t.w[k];
      }
    }
    __syncthreads();
    const int p = base + slot;
    if (slot < ppb && p < n) {
      int64_t off[4];
      float w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        off[k] = s_off[slot][k];
        w[k] = s_w[slot][k];
      }
      T* o = out + (int64_t)p * C;
      for (int ch = lane; ch < nch; ch += tpp)
        warp_chunk<T, VEC>(img, o, off, w, ch * VEC);
    }
    __syncthreads();
  }
}

// K9: the narrow form with the occlusion blend as its epilogue. PPT
// pixels a thread; both flows (float2) and occ are loaded coalesced for
// all of them first, then pixel by pixel the taps of both sources, their
// gathers, the blend into the block's shared-memory tile, and the tile
// out as contiguous 16-byte pieces.
struct BlendArgs {
  const float* img0;
  const float* img1;
  const float* flow0;
  const float* flow1;
  const float* occ;
  float* out;
};

template <int PPT, int C>
__global__ void __launch_bounds__(NARROW_THREADS)
    warp_blend_kernel(BlendArgs a, int n, int H, int W, int64_t ps) {
  constexpr int PIX = NARROW_THREADS * PPT;
  __shared__ __align__(16) float tile[PIX * C];
  const Rows rows = {H, H, 0, 0};
  for (int base = blockIdx.x * PIX; base < n; base += gridDim.x * PIX) {
    float2 f0[PPT], f1[PPT];
    float o[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = base + k * NARROW_THREADS + threadIdx.x;
      const bool in = p < n;
      f0[k] = in ? load_flow(a.flow0, p) : make_float2(0.f, 0.f);
      f1[k] = in ? load_flow(a.flow1, p) : make_float2(0.f, 0.f);
      o[k] = in ? a.occ[p] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = base + k * NARROW_THREADS + threadIdx.x;
      const int q = p < n ? p : 0;
      const Taps t0 = make_taps(f0[k], q, rows, W, ps);
      const Taps t1 = make_taps(f1[k], q, rows, W, ps);
      const float r = __fsub_rn(1.0f, o[k]);
      float* dst = tile + (k * NARROW_THREADS + threadIdx.x) * C;
#pragma unroll
      for (int c = 0; c < C; ++c)
        dst[c] = __fadd_rn(__fmul_rn(o[k], tap_sum(a.img0, t0, c)),
                           __fmul_rn(r, tap_sum(a.img1, t1, c)));
    }
    __syncthreads();
    const int nel = min(PIX, n - base) * C;
    // 16-byte aligned: base is a multiple of 256 pixels, out of 16
    float* dst = a.out + (int64_t)base * C;
    const int nvec = nel / 4;
    for (int v = threadIdx.x; v < nvec; v += NARROW_THREADS)
      reinterpret_cast<float4*>(dst)[v] =
          reinterpret_cast<const float4*>(tile)[v];
    for (int e = nvec * 4 + threadIdx.x; e < nel; e += NARROW_THREADS)
      dst[e] = tile[e];
    __syncthreads();
  }
}

int grid_blocks(int64_t work, int per_block) {
  const int64_t blocks = (work + per_block - 1) / per_block;
  return (int)(blocks < 65535LL * 16 ? blocks : 65535LL * 16);  // grid-stride
}

template <typename T>
int launch(const void* img0, const void* img1, const void* flow0,
           const void* flow1, void* out0, void* out1, int n_img, int B,
           Rows r, int W, int C, int64_t ps, void* stream) {
  const int64_t n64 = (int64_t)B * r.H_out * W;
  if (n_img < 1 || n_img > 2 || B < 1 || r.H_out < 1 || r.H_src < 1 ||
      W < 1 || C < 1 || ps < C || n64 >= (1LL << 31) ||
      (int64_t)B * r.H_src * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int n = (int)n64;
  WarpArgs a;
  a.img[0] = img0;
  a.img[1] = img1;
  a.flow[0] = static_cast<const float*>(flow0);
  a.flow[1] = static_cast<const float*>(flow1);
  a.out[0] = out0;
  a.out[1] = out1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < n_img; ++k)  // float2 flow loads
    if (reinterpret_cast<uintptr_t>(a.flow[k]) % 8)
      return (int)cudaErrorMisalignedAddress;
  if (C <= 4) {
    for (int k = 0; k < n_img; ++k)  // 16-byte stores of the staged tile
      if (reinterpret_cast<uintptr_t>(a.out[k]) % 16)
        return (int)cudaErrorMisalignedAddress;
    if (n >= 132 * 4 * NARROW_THREADS) {  // >= one 4-pixel block per SM
      dim3 grid(grid_blocks(n, 4 * NARROW_THREADS), n_img);
      warp_narrow_kernel<T, 4><<<grid, NARROW_THREADS, 0, st>>>(a, n, r, W,
                                                                 C, ps);
    } else {
      dim3 grid(grid_blocks(n, NARROW_THREADS), n_img);
      warp_narrow_kernel<T, 1><<<grid, NARROW_THREADS, 0, st>>>(a, n, r, W,
                                                                 C, ps);
    }
    return (int)cudaGetLastError();
  }
  // 16-byte chunks when C, the pixel stride and the pointers allow
  constexpr int V = 16 / sizeof(T);
  bool vec = C % V == 0 && ps % V == 0;
  for (int k = 0; k < n_img; ++k)
    vec = vec && reinterpret_cast<uintptr_t>(a.img[k]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.out[k]) % 16 == 0;
  const int nch = vec ? C / V : C;
  const int tpp = nch < WIDE_THREADS ? nch : WIDE_THREADS;
  const int ppb = WIDE_THREADS / tpp;
  dim3 grid(grid_blocks(n, ppb), n_img);
  if (vec)
    warp_wide_kernel<T, V><<<grid, ppb * tpp, 0, st>>>(a, n, r, W, C, ps,
                                                       tpp, ppb);
  else
    warp_wide_kernel<T, 1><<<grid, ppb * tpp, 0, st>>>(a, n, r, W, C, ps,
                                                       tpp, ppb);
  return (int)cudaGetLastError();
}

template <int C>
void launch_blend(const BlendArgs& a, int n, int H, int W, int64_t ps,
                  cudaStream_t st) {
  if (n >= 132 * 4 * NARROW_THREADS) {  // >= one 4-pixel block per SM
    warp_blend_kernel<4, C><<<grid_blocks(n, 4 * NARROW_THREADS),
                              NARROW_THREADS, 0, st>>>(a, n, H, W, ps);
  } else {
    warp_blend_kernel<1, C><<<grid_blocks(n, NARROW_THREADS),
                              NARROW_THREADS, 0, st>>>(a, n, H, W, ps);
  }
}

}  // namespace

extern "C" int warp_f32(const void* img0, const void* img1,
                        const void* flow0, const void* flow1, void* out0,
                        void* out1, int n_img, int B, int H, int W, int C,
                        int64_t ps, void* stream) {
  return launch<float>(img0, img1, flow0, flow1, out0, out1, n_img, B,
                       Rows{H, H, 0, 0}, W, C, ps, stream);
}

extern "C" int warp_bf16(const void* img0, const void* img1,
                         const void* flow0, const void* flow1, void* out0,
                         void* out1, int n_img, int B, int H, int W, int C,
                         int64_t ps, void* stream) {
  return launch<__nv_bfloat16>(img0, img1, flow0, flow1, out0, out1, n_img,
                               B, Rows{H, H, 0, 0}, W, C, ps, stream);
}

// K10: the pair warp of two full f32 sources [1, H_src, W, C] onto slab
// rows [row0, row0 + H_out), row0 folded into the flows' y.
extern "C" int warp_pair_srcfull_f32(const void* img0, const void* img1,
                                     const void* flow0, const void* flow1,
                                     void* out0, void* out1, int H_out,
                                     int H_src, int W, int C, int64_t ps,
                                     int row0, void* stream) {
  return launch<float>(img0, img1, flow0, flow1, out0, out1, 2, 1,
                       Rows{H_out, H_src, row0, 1}, W, C, ps, stream);
}

// The single row warp: [B, H_src, W, C] sources onto output rows
// [row0, row0 + H_out), row0 added to the row index.
extern "C" int flow_warp_rows_f32(const void* img, const void* flow,
                                  void* out, int B, int H_out, int H_src,
                                  int W, int C, int64_t ps, int row0,
                                  void* stream) {
  return launch<float>(img, img, flow, flow, out, out, 1, B,
                       Rows{H_out, H_src, row0, 0}, W, C, ps, stream);
}

extern "C" int flow_warp_rows_bf16(const void* img, const void* flow,
                                   void* out, int B, int H_out, int H_src,
                                   int W, int C, int64_t ps, int row0,
                                   void* stream) {
  return launch<__nv_bfloat16>(img, img, flow, flow, out, out, 1, B,
                               Rows{H_out, H_src, row0, 0}, W, C, ps,
                               stream);
}


extern "C" int warp_blend_f32(const void* img0, const void* img1,
                              const void* flow0, const void* flow1,
                              const void* occ, void* out, int B, int H, int W,
                              int C, int64_t ps, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || C > 4 || ps < C ||
      (int64_t)B * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(flow0) % 8 ||
      reinterpret_cast<uintptr_t>(flow1) % 8 ||
      reinterpret_cast<uintptr_t>(out) % 16)  // float2 loads, float4 stores
    return (int)cudaErrorMisalignedAddress;
  const BlendArgs a = {
      static_cast<const float*>(img0), static_cast<const float*>(img1),
      static_cast<const float*>(flow0), static_cast<const float*>(flow1),
      static_cast<const float*>(occ), static_cast<float*>(out)};
  const int n = B * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: launch_blend<1>(a, n, H, W, ps, st); break;
    case 2: launch_blend<2>(a, n, H, W, ps, st); break;
    case 3: launch_blend<3>(a, n, H, W, ps, st); break;
    default: launch_blend<4>(a, n, H, W, ps, st); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

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
// is no slab, no fallback and no unchecked flavour: one thread per
// output pixel for C <= 4 (the images), one thread per (pixel,
// channel) with the channel fastest for wide feature maps, so the four
// tap reads of a warp coalesce along the channels.
//
// Bound: bytes. Each output value needs its four taps (mostly L1/L2
// hits for smooth flows), the flow and one write; the arithmetic is a
// few dozen flops per pixel, far below the card's ratio. Taps and
// weights are f32 and summed in the plain version's order with
// explicitly rounded operations (no FMA contraction), so an f32 result
// is bit-equal to `ops/warp.py::flow_warp` on the same card; bf16
// features are accumulated in f32 and rounded once.
//
// The pair form warps two images by two flows in one launch
// (blockIdx.y selects the image). Later work: vector loads.
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
// NHWC images, one thread per pixel. The two warped frames never reach
// device memory: it reads each image's taps, both flows and occ, and
// writes I_t once: 56 of the 104 bytes per pixel (C = 3) that the pair
// warp plus the separate blend move. Bound: bytes. The blend uses the plain
// version's rounded operations in its order (occ*w0, 1-occ, (1-occ)*w1,
// the sum; no FMA contraction), so I_t is bit-equal to the K2 pair
// followed by the eager blend.
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
  int64_t idx[4];  // source pixel index per tap, -1 when invalid
  float w[4];
};

// Output rows [row0, row0 + H_out) of a warp whose source has H_src rows
// (the full-frame warp: H_out = H_src, row0 = 0). fold: add row0 to the
// flow's y first (K10) instead of to the row index.
struct Rows {
  int H_out, H_src, row0, fold;
};

// Tap indices and weights of output pixel (b, i, j); mirrors the
// arithmetic of ops/warp.py::_sample_xy operation for operation.
__device__ __forceinline__ Taps make_taps(const float* __restrict__ flow,
                                          int64_t p, Rows r, int W) {
  const int64_t hw = (int64_t)r.H_out * W;
  const int64_t b = p / hw;
  const int64_t q = p - b * hw;
  const int i = (int)(q / W);
  const int j = (int)(q - (int64_t)i * W);
  const float fy = flow[2 * p + 1];
  const float x = __fadd_rn((float)j, flow[2 * p]);
  const float y = r.fold ? __fadd_rn((float)i, __fadd_rn(fy, (float)r.row0))
                         : __fadd_rn(__fadd_rn((float)i, (float)r.row0), fy);
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
  const int dxs[4] = {0, 1, 0, 1};
  const int dys[4] = {0, 0, 1, 1};
  t.w[0] = __fmul_rn(wx0, wy0);
  t.w[1] = __fmul_rn(wx1, wy0);
  t.w[2] = __fmul_rn(wx0, wy1);
  t.w[3] = __fmul_rn(wx1, wy1);
  const int64_t src = b * ((int64_t)H * W);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xx = xi + dxs[k];
    const int yy = yi + dys[k];
    const bool valid = xx >= 0 && xx <= W - 1 && yy >= 0 && yy <= H - 1;
    t.idx[k] = valid ? src + (int64_t)yy * W + xx : -1;
  }
  return t;
}

template <typename T>
__device__ __forceinline__ float tap_sum(const T* __restrict__ img,
                                         const Taps& t, int64_t ps,
                                         int c) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // an invalid tap contributes 0 * w = +0, like the plain version
    const float v = t.idx[k] >= 0 ? to_f(img[t.idx[k] * ps + c]) : 0.0f;
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

// One thread per output pixel; loops over C (<= 4) channels.
template <typename T>
__global__ void warp_narrow_kernel(WarpArgs a, int B, Rows r, int W, int C,
                                   int64_t ps) {
  const int s = blockIdx.y;
  const int64_t n = (int64_t)B * r.H_out * W;
  const T* img = static_cast<const T*>(a.img[s]);
  T* out = static_cast<T*>(a.out[s]);
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * blockDim.x) {
    const Taps t = make_taps(a.flow[s], p, r, W);
    for (int c = 0; c < C; ++c) out[p * C + c] = from_f<T>(tap_sum(img, t, ps, c));
  }
}

// One thread per (pixel, channel), channel fastest.
template <typename T>
__global__ void warp_wide_kernel(WarpArgs a, int B, Rows r, int W, int C,
                                 int64_t ps) {
  const int s = blockIdx.y;
  const int64_t n = (int64_t)B * r.H_out * W * C;
  const T* img = static_cast<const T*>(a.img[s]);
  T* out = static_cast<T*>(a.out[s]);
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t p = e / C;
    const int c = (int)(e - p * C);
    const Taps t = make_taps(a.flow[s], p, r, W);
    out[e] = from_f<T>(tap_sum(img, t, ps, c));
  }
}

__global__ void warp_blend_kernel(const float* __restrict__ img0,
                                  const float* __restrict__ img1,
                                  const float* __restrict__ flow0,
                                  const float* __restrict__ flow1,
                                  const float* __restrict__ occ,
                                  float* __restrict__ out, int B, int H,
                                  int W, int C, int64_t ps) {
  const int64_t n = (int64_t)B * H * W;
  const Rows rows = {H, H, 0, 0};
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * blockDim.x) {
    const Taps t0 = make_taps(flow0, p, rows, W);
    const Taps t1 = make_taps(flow1, p, rows, W);
    const float o = occ[p];
    const float r = __fsub_rn(1.0f, o);
    for (int c = 0; c < C; ++c)
      out[p * C + c] = __fadd_rn(__fmul_rn(o, tap_sum(img0, t0, ps, c)),
                                 __fmul_rn(r, tap_sum(img1, t1, ps, c)));
  }
}

int64_t grid_blocks(int64_t work, int threads) {
  const int64_t blocks = (work + threads - 1) / threads;
  return blocks < 65535LL * 16 ? blocks : 65535LL * 16;  // grid-stride loop
}

template <typename T>
int launch(const void* img0, const void* img1, const void* flow0,
           const void* flow1, void* out0, void* out1, int n_img, int B,
           Rows r, int W, int C, int64_t ps, void* stream) {
  if (n_img < 1 || n_img > 2 || B < 1 || r.H_out < 1 || r.H_src < 1 ||
      W < 1 || C < 1 || ps < C)
    return (int)cudaErrorInvalidValue;
  WarpArgs a;
  a.img[0] = img0;
  a.img[1] = img1;
  a.flow[0] = static_cast<const float*>(flow0);
  a.flow[1] = static_cast<const float*>(flow1);
  a.out[0] = out0;
  a.out[1] = out1;
  const int threads = 256;
  const int64_t work = (int64_t)B * r.H_out * W * (C <= 4 ? 1 : C);
  dim3 grid((unsigned)grid_blocks(work, threads), (unsigned)n_img);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 4)
    warp_narrow_kernel<T><<<grid, threads, 0, st>>>(a, B, r, W, C, ps);
  else
    warp_wide_kernel<T><<<grid, threads, 0, st>>>(a, B, r, W, C, ps);
  return (int)cudaGetLastError();
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
  if (B < 1 || H < 1 || W < 1 || C < 1 || ps < C)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  warp_blend_kernel<<<(unsigned)grid_blocks((int64_t)B * H * W, threads),
                      threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img0), static_cast<const float*>(img1),
      static_cast<const float*>(flow0), static_cast<const float*>(flow1),
      static_cast<const float*>(occ), static_cast<float*>(out), B, H, W, C,
      ps);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

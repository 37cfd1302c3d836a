// Kernels K2 and K9: bilinear backward warp, NHWC, for sm_90a.
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

// Tap indices and weights of output pixel (b, i, j); mirrors the
// arithmetic of ops/warp.py::_sample_xy operation for operation.
__device__ __forceinline__ Taps make_taps(const float* __restrict__ flow,
                                          int64_t p, int H, int W) {
  const int64_t hw = (int64_t)H * W;
  const int64_t b = p / hw;
  const int64_t r = p - b * hw;
  const int i = (int)(r / W);
  const int j = (int)(r - (int64_t)i * W);
  const float x = __fadd_rn((float)j, flow[2 * p]);
  const float y = __fadd_rn((float)i, flow[2 * p + 1]);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx1 = __fsub_rn(x, x0);
  const float wy1 = __fsub_rn(y, y0);
  const float wx0 = __fsub_rn(1.0f, wx1);
  const float wy0 = __fsub_rn(1.0f, wy1);
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
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xx = xi + dxs[k];
    const int yy = yi + dys[k];
    const bool valid = xx >= 0 && xx <= W - 1 && yy >= 0 && yy <= H - 1;
    t.idx[k] = valid ? b * hw + (int64_t)yy * W + xx : -1;
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
__global__ void warp_narrow_kernel(WarpArgs a, int B, int H, int W, int C,
                                   int64_t ps) {
  const int s = blockIdx.y;
  const int64_t n = (int64_t)B * H * W;
  const T* img = static_cast<const T*>(a.img[s]);
  T* out = static_cast<T*>(a.out[s]);
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * blockDim.x) {
    const Taps t = make_taps(a.flow[s], p, H, W);
    for (int c = 0; c < C; ++c) out[p * C + c] = from_f<T>(tap_sum(img, t, ps, c));
  }
}

// One thread per (pixel, channel), channel fastest.
template <typename T>
__global__ void warp_wide_kernel(WarpArgs a, int B, int H, int W, int C,
                                 int64_t ps) {
  const int s = blockIdx.y;
  const int64_t n = (int64_t)B * H * W * C;
  const T* img = static_cast<const T*>(a.img[s]);
  T* out = static_cast<T*>(a.out[s]);
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t p = e / C;
    const int c = (int)(e - p * C);
    const Taps t = make_taps(a.flow[s], p, H, W);
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
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * blockDim.x) {
    const Taps t0 = make_taps(flow0, p, H, W);
    const Taps t1 = make_taps(flow1, p, H, W);
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
           int H, int W, int C, int64_t ps, void* stream) {
  if (n_img < 1 || n_img > 2 || B < 1 || H < 1 || W < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  WarpArgs a;
  a.img[0] = img0;
  a.img[1] = img1;
  a.flow[0] = static_cast<const float*>(flow0);
  a.flow[1] = static_cast<const float*>(flow1);
  a.out[0] = out0;
  a.out[1] = out1;
  const int threads = 256;
  const int64_t work = (int64_t)B * H * W * (C <= 4 ? 1 : C);
  dim3 grid((unsigned)grid_blocks(work, threads), (unsigned)n_img);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 4)
    warp_narrow_kernel<T><<<grid, threads, 0, st>>>(a, B, H, W, C, ps);
  else
    warp_wide_kernel<T><<<grid, threads, 0, st>>>(a, B, H, W, C, ps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int warp_f32(const void* img0, const void* img1,
                        const void* flow0, const void* flow1, void* out0,
                        void* out1, int n_img, int B, int H, int W, int C,
                        int64_t ps, void* stream) {
  return launch<float>(img0, img1, flow0, flow1, out0, out1, n_img, B, H, W,
                       C, ps, stream);
}

extern "C" int warp_bf16(const void* img0, const void* img1,
                         const void* flow0, const void* flow1, void* out0,
                         void* out1, int n_img, int B, int H, int W, int C,
                         int64_t ps, void* stream) {
  return launch<__nv_bfloat16>(img0, img1, flow0, flow1, out0, out1, n_img,
                               B, H, W, C, ps, stream);
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

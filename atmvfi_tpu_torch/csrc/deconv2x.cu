// Kernel K6: ConvTranspose k=2 s=2 + bias (+ per-channel PReLU), NHWC,
// for sm_90a.
//
// Replaces atmvfi_tpu/ops/deconv_pallas.py::deconv2x_hcw (`_kernel`):
//   out[b, 2y+dy, 2x+dx, o] = sum_i x[b, y, x, i] * W[i, o, dy, dx] + b[o].
// The TPU kernel runs four parity GEMMs on HCW slabs and writes even and
// odd columns as two half-width outputs that XLA then interleaves. Here
// it is ONE GEMM [pixels, Cin] x [Cin, 4*Cout] on the shared
// implicit-GEMM core (igemm.cuh, one tap), whose epilogue writes column
// n = (2*dy + dx) * Cout + o straight to pixel (2y+dy, 2x+dx) after the
// f32 bias and PReLU: no interleave pass, no padded copy of the input.
//
// Bound: operations for the wide decoder deconvs (773 -> 389 at 1/8),
// bytes for the full-resolution one (197 -> 101 writes 0.4 GB in bf16).
// bf16 on the tensor cores with f32 sums, f32 as true f32 FMAs.
#include "igemm.cuh"

namespace {

int deconv_launch(bool bf16, const void* x, long long ps, int C, int x_f32,
                  int x_vec, int B, int H, int W, const void* w, int Kp,
                  const float* bias, const float* slope, void* out, int Cout,
                  long long out_ps, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || ps < C || Cout < 1)
    return (int)cudaErrorInvalidValue;
  Problem p = {};
  p.src[0].ptr = x;
  p.src[0].ps = ps;
  p.src[0].C = C;
  p.src[0].f32 = x_f32;
  p.src[0].vec = x_vec;
  p.src[0].coff = 0;
  p.nsrc = 1;
  p.Ctot = C;
  p.B = B;
  p.H = H;
  p.W = W;
  p.Ho = H;
  p.Wo = W;
  p.stride = 1;
  p.pad = 0;
  p.ksize = 1;
  p.w = w;
  p.N = 4 * Cout;
  p.Kp = Kp;
  p.bias = bias;
  p.slope = slope;
  p.out = out;
  p.Cout = Cout;
  p.ops = out_ps;
  p.deconv = 1;
  return launch_igemm(p, bf16, stream);
}

}  // namespace

// x: pointer, pixel stride, channels, is_f32, vec (see igemm.cuh); the
// output is [B, 2H, 2W] pixels at pixel stride out_ps >= Cout.
extern "C" int deconv2x_f32(const void* x, long long ps, int C, int x_f32,
                            int x_vec, int B, int H, int W, const void* w,
                            int Kp, const float* bias, const float* slope,
                            void* out, int Cout, long long out_ps,
                            void* stream) {
  return deconv_launch(false, x, ps, C, x_f32, x_vec, B, H, W, w, Kp, bias,
                       slope, out, Cout, out_ps, stream);
}

extern "C" int deconv2x_bf16(const void* x, long long ps, int C, int x_f32,
                             int x_vec, int B, int H, int W, const void* w,
                             int Kp, const float* bias, const float* slope,
                             void* out, int Cout, long long out_ps,
                             void* stream) {
  return deconv_launch(true, x, ps, C, x_f32, x_vec, B, H, W, w, Kp, bias,
                       slope, out, Cout, out_ps, stream);
}

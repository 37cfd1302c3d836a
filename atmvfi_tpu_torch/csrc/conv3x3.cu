// Kernels K3, K4 and K5: 3x3 convolution + bias (+ per-channel PReLU),
// NHWC, for sm_90a. One implicit-GEMM kernel (igemm.cuh) behind three
// entry points, one per TPU kernel it replaces:
//
//   conv3x3_*        K3  atmvfi_tpu/ops/conv_pallas.py::conv3x3_hcw
//                        (`_kernel`): stride 1, 'same' zero padding.
//   conv3x3s2_*      K4  conv3x3s2_hcw (`_kernel_s2`): stride 2, pad 1,
//                        output ceil(H/2) x ceil(W/2).
//   conv3x3_multi_*  K5  conv3x3_hcw_planes (`_kernel_planes`): the conv
//                        over the channel concatenation of up to six
//                        sources (decoder feature || image planes, or the
//                        raw frames alone) without building the concat.
//
// The TPU kernels work on HCW [B*H, Cpad, W] slabs with a 128-lane halo
// DMA'd into VMEM and channels padded to the sublane tile; that layout
// is a TPU tiling artifact. Here activations stay NHWC, each block
// gathers its pixels x channels tile per tap straight from the sources,
// and masks padding, image and batch edges and ragged channel counts
// (3, 101, 389, ...) in the loader: no padded or transposed copy.
//
// Bound: operations for the wide layers (a 389->389 conv at 272x480 is
// 0.36 TFLOP against 0.2 GB moved), bytes for the narrow full-resolution
// ones (24->24 at 2x1088x1920). bf16 runs on the tensor cores with f32
// sums; f32 runs true f32 FMAs. Bias and PReLU are applied to the f32
// sums and the result is rounded once, the order of the TPU kernels
// (conv_pallas.py:269-281).
#include "igemm.cuh"

namespace {

// desc: 5 int64 per source (pointer, pixel stride, channels, is_f32,
// vec); the sources share B, H, W and are concatenated along channels.
// The output is [B, Ho, Wo] pixels at pixel stride out_ps >= Cout.
int conv_launch(bool bf16, const int64_t* desc, int nsrc, int B, int H,
                int W, int stride, const void* w, int Kp, const float* bias,
                const float* slope, void* out, int Cout, long long out_ps,
                void* stream) {
  if (nsrc < 1 || nsrc > MAX_SRC || B < 1 || H < 1 || W < 1 || Cout < 1 ||
      (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  Problem p = {};
  int coff = 0;
  for (int s = 0; s < nsrc; ++s) {
    p.src[s].ptr = reinterpret_cast<const void*>(desc[5 * s]);
    p.src[s].ps = desc[5 * s + 1];
    p.src[s].C = (int)desc[5 * s + 2];
    p.src[s].f32 = (int)desc[5 * s + 3];
    p.src[s].vec = (int)desc[5 * s + 4];
    p.src[s].coff = coff;
    if (p.src[s].C < 1 || p.src[s].ps < p.src[s].C)
      return (int)cudaErrorInvalidValue;
    coff += p.src[s].C;
  }
  p.nsrc = nsrc;
  p.Ctot = coff;
  p.B = B;
  p.H = H;
  p.W = W;
  p.stride = stride;
  p.pad = 1;
  p.ksize = 3;
  p.Ho = (H - 1) / stride + 1;
  p.Wo = (W - 1) / stride + 1;
  p.w = w;
  p.N = Cout;
  p.Kp = Kp;
  p.bias = bias;
  p.slope = slope;
  p.out = out;
  p.Cout = Cout;
  p.ops = out_ps;
  p.deconv = 0;
  return launch_igemm(p, bf16, stream);
}

}  // namespace

#define CONV_ENTRY(NAME, BF16, CHECK)                                        \
  extern "C" int NAME(const int64_t* desc, int nsrc, int B, int H, int W,   \
                      int stride, const void* w, int Kp, const float* bias, \
                      const float* slope, void* out, int Cout,              \
                      long long out_ps, void* stream) {                     \
    if (!(CHECK)) return (int)cudaErrorInvalidValue;                        \
    return conv_launch(BF16, desc, nsrc, B, H, W, stride, w, Kp, bias,      \
                       slope, out, Cout, out_ps, stream);                   \
  }

CONV_ENTRY(conv3x3_f32, false, nsrc == 1 && stride == 1)
CONV_ENTRY(conv3x3_bf16, true, nsrc == 1 && stride == 1)
CONV_ENTRY(conv3x3s2_f32, false, nsrc == 1 && stride == 2)
CONV_ENTRY(conv3x3s2_bf16, true, nsrc == 1 && stride == 2)
CONV_ENTRY(conv3x3_multi_f32, false, stride == 1)
CONV_ENTRY(conv3x3_multi_bf16, true, stride == 1)

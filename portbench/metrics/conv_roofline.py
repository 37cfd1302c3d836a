"""conv_roofline: the convolutions' share of their roofline in the traced
window, in %. The numerator sums, over every convolution and transposed
convolution of the reference forward at the cell's padded shape and
batch (`counts/`), the larger of its FLOPs at the chip's peak for its
dtype and its bytes (activations read and written once, weights once a
batch) at the HBM rate, times the frames traced. The denominator is
the device time of the conv kernels in the trace, by the names below:
the port's K3-K6 and K12 and cuDNN's convolutions."""
import re

CONV_KERNELS = re.compile(
    r"pair_bf16_kernel|pair_f32_kernel|conv3x3_wgmma_kernel|"
    r"conv3x3_fold_kernel|deconv2x_wgmma_kernel|igemm_|"
    r"conv(?!ert)|cudnn|fprop|implicit_gemm|nchw|nhwc", re.IGNORECASE)


def read(run):
    s, c, p = run.trace, run.counts, run.peaks
    if s is None or c is None or p is None or not run.traced_frames:
        return None
    dev_s = sum(d for name, _, d in s["device"] if CONV_KERNELS.search(name))
    if dev_s <= 0:
        return None
    B = run.traffic["batch"]
    bound = 0.0
    for flops, act, weight, dtype, calls in c["convs"]:
        rate = p["tflops_bf16"] if dtype == "bf16" else p["tflops_f32"]
        bound += calls * max(B * flops / (rate * 1e12),
                             (B * act + weight) / (p["hbm_gbps"] * 1e9))
    per_frame = bound / (B * c["pairs"])
    return 100.0 * per_frame * run.traced_frames / dev_s

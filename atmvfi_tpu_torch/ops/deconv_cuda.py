"""Kernel K6 wrapper: ConvTranspose k2 s2 + bias (+ PReLU)
(`csrc/deconv2x_wgmma.cu`, `csrc/deconv2x.cu`).

Replaces `atmvfi_tpu/ops/deconv_pallas.py::deconv2x_hcw_op`. For CPU
tensors the wrapper runs the plain version `ops.conv.deconv2x` (its
output in the card's layout); for CUDA tensors it launches a kernel or
raises, differentiably through the plain version's VJP when grad is on
(`ops._autograd`). A bf16 map that a TMA tensor map can read (the K3
wgmma route's rule, `ops.conv_cuda._wgmma_eligible`: >= 32 channels,
pixel stride a multiple of 8, 16-byte aligned; every deconv of the
main path) runs the wgmma + TMA GEMM (`deconv2x_wgmma.cu`); f32 (the
parity mode) and other layouts the mma.sync implicit GEMM
(`deconv2x.cu`). `deconv2x.calls` counts the calls on any device,
`deconv2x.launches` the kernel launches, `deconv2x.wgmma_launches` those
on the wgmma kernel.

x is NHWC (f32 or bf16, any pixel stride with contiguous channels) and
is computed in its own type. `weight` is the f32 nn.ConvTranspose2d
parameter [Cin, Cout, 2, 2], packed into the working type and kept per
weight (`ops.conv_cuda.cached_pack`): for the implicit GEMM as [4 *
Cout, Kp] with row (2 * dy + dx) * Cout + o; for the wgmma kernel as
[4 * Cout8, Kp] with row (2 * dy + dx) * Cout8 + o (`wgmma_pack`), Cout8
= Cout rounded up to 8. The output is a new [B, 2H, 2W, Cout] tensor
whose pixel stride is Cout8 (see `ops.conv_cuda`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from atmvfi_tpu_torch.ops import _autograd, _build
from atmvfi_tpu_torch.ops.conv import deconv2x as deconv2x_plain
from atmvfi_tpu_torch.ops.conv_cuda import (
    _DTYPES,
    _vec,
    _wgmma_eligible,
    cached_pack,
    card_layout,
    empty_nhwc,
    pack_weight,
    pixel_stride,
    vec_readable,
)


def _check(x, weight):
    """x's channels and weight's Cout, after checking both."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"deconv kernel takes f32/bf16, got {x.dtype}")
    cin = x.shape[3]
    if weight.dim() != 4 or tuple(weight.shape[::2]) != (cin, 2) \
            or weight.shape[3] != 2:
        raise ValueError(f"weight must be [{cin}, Cout, 2, 2], got "
                         f"{tuple(weight.shape)}")
    if weight.device != x.device:
        raise ValueError("weight and input on different devices")
    return cin, weight.shape[1]


def wgmma_pack(weight: torch.Tensor, dtype=torch.bfloat16):
    """(the wgmma kernel's weight [4 * Cout8, Kp], Kp): row (2 * dy + dx)
    * Cout8 + o holds weight[:, o, dy, dx] for o < Cout and zeros for the
    pad rows up to Cout8; columns past Cin up to Kp (Cin rounded up to 8)
    are zeros. weight: [Cin, Cout, 2, 2]."""
    cin, cout = weight.shape[:2]
    cout8, kp = -(-cout // 8) * 8, -(-cin // 8) * 8
    pack = torch.zeros(2, 2, cout8, kp, dtype=dtype, device=weight.device)
    pack[:, :, :cout, :cin] = weight.detach().permute(2, 3, 1, 0)
    return pack.reshape(4 * cout8, kp), kp


def _launch_wgmma(x, weight, bias, slope, tile: int = 0):
    """The wgmma kernel; `tile` 128 or 224 asks for that column tile in
    place of the kernel's plan (to time both)."""
    cin, cout = _check(x, weight)
    B, H, W, _ = x.shape

    def make():
        w, kp = wgmma_pack(weight)
        tmap = ctypes.create_string_buffer(128)
        bnw = ctypes.c_int(0)
        with torch.cuda.device(x.device):
            rc = _build.load_library().deconv2x_wgmma_weight_map(
                w.data_ptr(), w.shape[0], kp, tile, tmap, ctypes.byref(bnw))
        _build.check(rc, "deconv2x wgmma weight map")
        return w, tmap, bnw.value

    # the pack stays referenced until the launch: a weight that requires
    # grad gets a pack of its own per call, which no cache entry holds
    pack, tmap, bnw = cached_pack(weight, f"deconv2x wgmma {tile}",
                                  torch.bfloat16, make)
    b = _vec(bias, cout, "bias", x.device)
    a = _vec(slope, cout, "slope", x.device)
    out = empty_nhwc(B, 2 * H, 2 * W, cout, torch.bfloat16, x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.deconv2x_wgmma_bf16(
            x.data_ptr(), pixel_stride(x), B, H, W, cin, tmap, bnw,
            b.data_ptr(), 0 if a is None else a.data_ptr(), out.data_ptr(),
            cout, out.stride(2), stream)
    _build.check(rc, "deconv2x wgmma kernel launch")
    return out


def _launch(x, weight, bias, slope):
    cin, cout = _check(x, weight)
    ps = pixel_stride(x)
    B, H, W, _ = x.shape
    w, kp = cached_pack(weight, "deconv2x", x.dtype, lambda: pack_weight(
        (2, 2, cout), weight.detach().permute(2, 3, 1, 0), cin, x.dtype))
    b = _vec(bias, cout, "bias", x.device)
    a = _vec(slope, cout, "slope", x.device)
    out = empty_nhwc(B, 2 * H, 2 * W, cout, x.dtype, x.device)
    fn = getattr(_build.load_library(), f"deconv2x_{_DTYPES[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), ps, cin, int(x.dtype == torch.float32),
                int(vec_readable(x, ps)), B, H, W, w.data_ptr(), kp,
                b.data_ptr(), 0 if a is None else a.data_ptr(),
                out.data_ptr(), cout, out.stride(2), stream)
    _build.check(rc, "deconv2x kernel launch")
    return out


@_autograd.kernel_wrapper(deconv2x_plain)
def deconv2x(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6: ConvTranspose(k=2, s=2) + bias (+ PReLU) in x's type."""
    deconv2x.calls += 1
    if x.device.type == "cpu":
        return card_layout(deconv2x_plain(x, weight, bias, slope))
    if x.device.type != "cuda":
        raise ValueError(f"no deconv kernel for device {x.device}")
    wgmma = _wgmma_eligible(x)
    out = _autograd.launch(_launch_wgmma if wgmma else _launch,
                           deconv2x_plain, x, weight, bias, slope)
    deconv2x.launches += 1
    deconv2x.wgmma_launches += int(wgmma)
    return out


deconv2x.calls = 0
deconv2x.launches = 0
deconv2x.wgmma_launches = 0

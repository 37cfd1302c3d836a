"""Kernel K6 wrapper: ConvTranspose k2 s2 + bias (+ PReLU)
(`csrc/deconv2x.cu`).

Replaces `atmvfi_tpu/ops/deconv_pallas.py::deconv2x_hcw_op`. For CPU
tensors the wrapper runs the plain version `ops.conv.deconv2x`; for
CUDA tensors it launches the kernel or raises, differentiably through
the plain version's VJP when grad is on (`ops._autograd`).
`deconv2x.calls` counts the calls on any device, `deconv2x.launches` the
kernel launches.

x is NHWC (f32 or bf16, any pixel stride with contiguous channels) and
is computed in its own type. `weight` is the f32 nn.ConvTranspose2d
parameter [Cin, Cout, 2, 2], packed into the working type as
[4 * Cout, Kp] with row (2 * dy + dx) * Cout + o and kept per weight
(`ops.conv_cuda.cached_pack`). The output is a
new [B, 2H, 2W, Cout] tensor, on the card with its pixel stride rounded
up to 8 (see `ops.conv_cuda`).
"""
from __future__ import annotations

from typing import Optional

import torch

from atmvfi_tpu_torch.ops import _autograd, _build
from atmvfi_tpu_torch.ops.conv import deconv2x as deconv2x_plain
from atmvfi_tpu_torch.ops.conv_cuda import (
    _DTYPES,
    _vec,
    cached_pack,
    empty_nhwc,
    pack_weight,
    pixel_stride,
    vec_readable,
)


def _launch(x, weight, bias, slope):
    if x.dtype not in _DTYPES:
        raise TypeError(f"deconv kernel takes f32/bf16, got {x.dtype}")
    ps = pixel_stride(x)
    B, H, W, cin = x.shape
    if weight.dim() != 4 or tuple(weight.shape[::2]) != (cin, 2) \
            or weight.shape[3] != 2:
        raise ValueError(f"weight must be [{cin}, Cout, 2, 2], got "
                         f"{tuple(weight.shape)}")
    if weight.device != x.device:
        raise ValueError("weight and input on different devices")
    cout = weight.shape[1]
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


def deconv2x(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6: ConvTranspose(k=2, s=2) + bias (+ PReLU) in x's type."""
    deconv2x.calls += 1
    if x.device.type == "cpu":
        return deconv2x_plain(x, weight, bias, slope)
    if x.device.type != "cuda":
        raise ValueError(f"no deconv kernel for device {x.device}")
    out = _autograd.launch(_launch, deconv2x_plain, x, weight, bias, slope)
    deconv2x.launches += 1
    return out


deconv2x.calls = 0
deconv2x.launches = 0

"""Plain versions of the conv kernels K3-K6 and K12 (NHWC).

Counterparts of the XLA compositions beside the TPU kernels
(`atmvfi_tpu/ops/conv_pallas.py::_xla_equiv*`,
`deconv_pallas.py::_xla_equiv`), but with the kernels' rounding order
(`conv_pallas.py:269-281`, `deconv_pallas.py:114-118`): inputs and
weights are rounded to the working type, products are summed in f32,
bias and PReLU max(y, 0) + a * min(y, 0) are applied in f32, and the
result is rounded once to the working type. In f32 this is a true f32
conv. (The XLA compositions round a bf16 conv output before the bias,
which is not the kernels' order.)

The kernel wrappers (`ops.conv_cuda`, `ops.deconv_cuda`) run these for
CPU tensors; `chip_smoke.py` holds each kernel against them on the card
(with TF32 off).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def _epilogue(y: torch.Tensor, bias: torch.Tensor,
              slope: Optional[torch.Tensor], dtype: torch.dtype):
    """f32 NHWC sums -> + bias, PReLU, one rounding to `dtype`."""
    y = y + bias.float()
    if slope is not None:
        y = y.clamp_min(0) + slope.float() * y.clamp_max(0)
    return y.to(dtype)


def conv3x3(sources: Sequence[torch.Tensor], weight: torch.Tensor,
            bias: torch.Tensor, slope: Optional[torch.Tensor] = None,
            stride: int = 1, dtype: Optional[torch.dtype] = None):
    """3x3 conv, zero pad 1, over the channel concat of `sources`.

    sources: NHWC tensors of one B, H, W (f32 or bf16, any pixel
    stride); weight: OIHW [Cout, sum C, 3, 3]; bias, slope: [Cout].
    Returns [B, ceil(H/stride), ceil(W/stride), Cout] in `dtype` (the
    first source's type when None)."""
    dt = sources[0].dtype if dtype is None else dtype
    x = torch.cat([s.to(dt).float() for s in sources], -1)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(dt).float(), None,
                 stride, 1)
    return _epilogue(y.permute(0, 2, 3, 1), bias, slope, dt)


def conv3x3_pair(x: torch.Tensor, wa: torch.Tensor, ba: torch.Tensor,
                 sa: Optional[torch.Tensor], wb: torch.Tensor,
                 bb: torch.Tensor, sb: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None):
    """K12's function: conv_b(round(PReLU_a(conv_a(x) + ba))) + bb
    (+ PReLU_b), two stride-1 convs with the intermediate rounded to
    `dtype` (x's type when None)."""
    dt = x.dtype if dtype is None else dtype
    mid = conv3x3([x], wa, ba, sa, 1, dt)
    return conv3x3([mid], wb, bb, sb, 1, dt)


def deconv2x(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             slope: Optional[torch.Tensor] = None,
             dtype: Optional[torch.dtype] = None):
    """ConvTranspose k=2 s=2: out[b, 2h+dy, 2w+dx, o] =
    sum_i x[b, h, w, i] * weight[i, o, dy, dx] + bias[o] (+ PReLU).

    weight: [Cin, Cout, 2, 2] (nn.ConvTranspose2d). Returns
    [B, 2H, 2W, Cout] in `dtype` (x's type when None)."""
    dt = x.dtype if dtype is None else dtype
    y = F.conv_transpose2d(x.to(dt).float().permute(0, 3, 1, 2),
                           weight.to(dt).float(), None, stride=2)
    return _epilogue(y.permute(0, 2, 3, 1), bias, slope, dt)

"""Model building blocks (NHWC activations, PyTorch modules).

Counterpart of `atmvfi_tpu/models/layers.py`. Module and parameter
names are the reference model's state_dict names, so a reference
checkpoint (or a JAX one through `convert.params_from_jax`) loads with
`strict=True`. Parameters stay f32; each module casts its input and
weights to its working `dtype` at use, as the JAX modules do.

Activations are NHWC tensors. The layers that the JAX package runs
through its conv kernels on the `conv_impl="auto"` path run the port's
kernels, each as one call with bias and PReLU fused: `ConvPReLU` (K3 at
stride 1, K4 at stride 2, K5 over several sources), `PlainConv3x3` (K3
without PReLU) and `Deconv2x` (K6). The other convolutions (strided and
dilated fusion convs, 1x1 heads, depthwise MLP convs), which the JAX
package leaves to XLA, stay `Conv2d`: cuDNN on an NCHW view of the NHWC
tensor (`permute(0, 3, 1, 2)`, channels_last in memory, no copy).

The two transformer blocks run the JAX package's "block" mode through
kernel K1 (`ops.attention_cuda.atm_block`: ATMFormer with the frame
swap and the motion moment, RefineBottleneck as self-attention), or with
`packed=True` its "packed" mode: norm1 rounded to the working type, the
q / kv (or qkv) projections, the attention + motion kernel K7
(`ops.attention_cuda.window_attention`) on the projections' column
blocks, the output projection, and the residual onto norm1(x).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from atmvfi_tpu_torch import ops
from atmvfi_tpu_torch.ops.attention import layer_norm_f32
from atmvfi_tpu_torch.ops.attention_cuda import atm_block, window_attention
from atmvfi_tpu_torch.ops.conv_cuda import (
    conv3x3,
    conv3x3_multi,
    conv3x3_s2,
    padded_map,
)
from atmvfi_tpu_torch.ops.deconv_cuda import deconv2x

LN_EPS = 1e-5


# ---- seeded initialisers (the JAX package's init statistics) ---------
def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)


def normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


def trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """Normal(0, std) truncated to +-2 std, by redrawing outliers."""
    with torch.no_grad():
        v = torch.randn(t.shape, generator=gen)
        bad = v.abs() > 2
        while bool(bad.any()):
            v[bad] = torch.randn(int(bad.sum()), generator=gen)
            bad = v.abs() > 2
        t.copy_(v * std)


# ---- convolutions ----------------------------------------------------
class Conv2d(nn.Module):
    """NHWC convolution with nn.Conv2d's parameters (weight OIHW, bias).

    init "torch": U(+-1/sqrt(fan_in)) weight and bias (reference conv
    helpers); "msra": N(0, sqrt(2/fan_out)) weight, zero bias (convs
    under the reference's `_init_weights`).
    """

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = None, dilation: int = 1, groups: int = 1,
                 dtype: torch.dtype = torch.float32, init: str = "torch"):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = kernel // 2 if padding is None else padding
        self.dtype, self.init = dtype, init
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.empty(cout))

    def reset_parameters(self, gen: torch.Generator):
        o, i, kh, kw = self.weight.shape
        if self.init == "msra":
            normal_(self.weight, math.sqrt(2.0 / (kh * kw * o / self.groups)),
                    gen)
            nn.init.zeros_(self.bias)
        else:
            bound = 1.0 / math.sqrt(i * kh * kw)
            uniform_(self.weight, bound, gen)
            uniform_(self.bias, bound, gen)

    def forward(self, x):  # [B, H, W, Cin] -> [B, H, W, Cout]
        dt = self.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                     self.bias.to(dt), self.stride, self.padding,
                     self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class PReLU(nn.Module):
    """Per-channel PReLU on NHWC: where(x >= 0, x, a * x), which equals
    the JAX package's max(x, 0) + a * min(x, 0) for every finite x. One
    F.prelu pass over the channels_last view (the max/min form costs
    four elementwise passes on the card). Outside autograd, on a channel
    view of a wider map whose pixel stride is a multiple of 8 (a conv
    kernel's output with C % 8 != 0), the pass runs over the whole map
    with the slope padded by zeros, so its output keeps that pixel stride
    and the next kernel (the decoder's deconv, K6) can read it by TMA;
    the C channels are the same values."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))

    def reset_parameters(self, gen: torch.Generator):
        nn.init.constant_(self.weight, 0.25)

    def forward(self, x):
        a = self.weight.to(x.dtype)
        C = x.shape[3]
        full = None
        if not (torch.is_grad_enabled()
                and (x.requires_grad or a.requires_grad)):
            full = padded_map(x)
        if full is not None:
            x, a = full, F.pad(a, (0, full.shape[3] - C))
        y = F.prelu(x.permute(0, 3, 1, 2), a)
        return y.permute(0, 2, 3, 1)[..., :C]


class ConvPReLU(nn.Sequential):
    """conv3x3 + PReLU (reference `conv` helper: `.0` conv, `.1` PReLU),
    run as one kernel call: K3 at stride 1, K4 at stride 2."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(Conv2d(cin, cout, 3, stride, 1, dtype=dtype),
                         PReLU(cout))

    def forward(self, x):
        conv = self[0]
        fn = conv3x3 if conv.stride == 1 else conv3x3_s2
        return fn(x.to(conv.dtype), conv.weight, conv.bias, self[1].weight)

    def forward_sources(self, sources):
        """K5: the stride-1 conv over the channel concat of `sources`
        (f32 or the working type), which is never built."""
        conv = self[0]
        return conv3x3_multi(sources, conv.weight, conv.bias, self[1].weight,
                             conv.dtype)


class PlainConv3x3(Conv2d):
    """Bare 3x3 stride-1 conv + bias (the JAX `PlainConv`), run by K3
    with the PReLU off."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, 3, dtype=dtype)

    def forward(self, x):
        return conv3x3(x.to(self.dtype), self.weight, self.bias)


class ConvTranspose2x(nn.Module):
    """Parameters of a ConvTranspose(k=2, s=2) (nn.ConvTranspose2d
    layout, weight [Cin, Cout, 2, 2]), run by `Deconv2x`:
    out[2h+dy, 2w+dx, o] = sum_i x[h, w, i] * weight[i, o, dy, dx] + b[o]."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.empty(cout))

    def reset_parameters(self, gen: torch.Generator):
        bound = 1.0 / math.sqrt(4 * self.weight.shape[0])
        uniform_(self.weight, bound, gen)
        uniform_(self.bias, bound, gen)


class Deconv2x(nn.Sequential):
    """ConvTranspose(k=2, s=2) + PReLU (reference `deconv` helper), run
    as one K6 call with the PReLU fused."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__(ConvTranspose2x(cin, cout, dtype), PReLU(cout))

    def forward(self, x):
        up = self[0]
        return deconv2x(x.to(up.dtype), up.weight, up.bias, self[1].weight)


class DWConv(nn.Module):
    """3x3 depthwise conv inside the transformer MLP (`.dwconv`)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, 1, 1, groups=dim, dtype=dtype,
                             init="msra")

    def forward(self, x):
        return self.dwconv(x)


# ---- dense layers ----------------------------------------------------
class Linear(nn.Module):
    """nn.Linear parameters ([out, in]); trunc-normal(0.02) init."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def reset_parameters(self, gen: torch.Generator):
        trunc_normal_(self.weight, 0.02, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """LayerNorm over channels with f32 statistics, output in `dtype`."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, gen: torch.Generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return layer_norm_f32(x, self.weight, self.bias, LN_EPS).to(self.dtype)


class Mlp(nn.Module):
    """fc1 -> depthwise conv -> GELU(erf) -> fc2."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.dwconv = DWConv(hidden, dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):  # [B, H, W, C]
        return self.fc2(F.gelu(self.dwconv(self.fc1(x))))


# ---- window attention ------------------------------------------------
# The cached tensors are made outside inference mode: one made by a
# serving forward (under `inference_mode`) could not be saved for backward
# by a later forward with grad on the same device.
@functools.lru_cache(maxsize=32)
def _device_mask(h: int, w: int, window: int, shift: int,
                 device: torch.device) -> Optional[torch.Tensor]:
    """The [nW, N, N] f32 mask of one (resolution, window, shift), kept on
    its device so a forward pays no host-to-device copy for it."""
    with torch.inference_mode(False):
        return ops.attn_mask_for(h, w, window, shift, device)


@functools.lru_cache(maxsize=8)
def _device_rel(window: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return ops.relative_coords(window, device)


def clear_caches() -> None:
    """Drop the window masks and coordinates kept on devices; the next
    forward rebuilds them bit-identically. A forward on fake tensors
    (a count of its work) calls this before and after, so that no fake
    tensor stays in them."""
    _device_mask.cache_clear()
    _device_rel.cache_clear()


class AttentionToMotion(nn.Module):
    """Cross-frame window attention emitting appearance + motion.

    Holds q / kv / proj and the per-direction motion MLP (`mlp.0`,
    `mlp.2`: Linear(h, h/2) -> GELU -> Linear(h/2, 1)). `forward` (K1)
    takes the unnormalised windows and the parent's norm1, and returns
    norm1(x) + proj(attn) and the motion seed [BW, N, 2];
    `forward_packed` (K7) takes norm1(x) and the partner windows' copy
    and returns proj(attn) and the motion seed.
    """

    def __init__(self, dim: int, window_size: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size, self.num_heads, self.dtype = window_size, num_heads, dtype
        self.q = Linear(dim, dim, bias=False, dtype=dtype)
        self.kv = Linear(dim, 2 * dim, bias=False, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.mlp = nn.Sequential(Linear(num_heads, num_heads // 2, dtype=dtype),
                                 nn.GELU(),
                                 Linear(num_heads // 2, 1, dtype=dtype))

    def forward(self, x_win, mask, norm1: LayerNorm):
        C = x_win.shape[-1]
        h = self.num_heads
        rel = _device_rel(self.window_size, x_win.device)
        y, motion = atm_block(
            x_win.to(self.dtype).contiguous(), self.q.weight, self.kv.weight,
            self.proj.weight, self.proj.bias, norm1.weight, norm1.bias,
            (C // h) ** -0.5, rel, mask, h, True)
        return y, self._motion(motion)

    def forward_packed(self, x_norm, x_rev, mask):
        """Packed route on normalised windows: (proj(attn), motion)."""
        C = x_norm.shape[-1]
        h = self.num_heads
        out, motion = window_attention(
            self.q(x_norm), self.kv(x_rev), (C // h) ** -0.5,
            _device_rel(self.window_size, x_norm.device), mask, h)
        return self.proj(out), self._motion(motion)

    def _motion(self, motion):
        """Per-head motion [BW, N, 2h] -> motion MLP -> [BW, N, 2]."""
        BW, N, _ = motion.shape
        motion = motion.to(self.dtype).reshape(BW, N, self.num_heads, 2)
        m = self.mlp(motion.permute(0, 3, 1, 2))  # [BW, 2, N, 1]
        return m[..., 0].transpose(1, 2)  # [BW, N, 2] (dx, dy)


class WindowAttention(nn.Module):
    """Plain self window attention (`qkv`, `proj`)."""

    def __init__(self, dim: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = Linear(dim, 3 * dim, bias=False, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x_win, mask, norm1: LayerNorm):
        C = x_win.shape[-1]
        w = self.qkv.weight
        y, _ = atm_block(
            x_win.to(self.dtype).contiguous(), w[:C], w[C:],
            self.proj.weight, self.proj.bias, norm1.weight, norm1.bias,
            (C // self.num_heads) ** -0.5, None, mask, self.num_heads, False)
        return y

    def forward_packed(self, x_norm, mask):
        """Packed route on normalised windows: proj(attn)."""
        C = x_norm.shape[-1]
        qkv = self.qkv(x_norm)
        out, _ = window_attention(qkv[..., :C], qkv[..., C:],
                                  (C // self.num_heads) ** -0.5, None, mask,
                                  self.num_heads)
        return self.proj(out)


class _SwinShell(nn.Module):
    """Center pad, cyclic shift and window partition around a block."""

    def __init__(self, dim: int, window_size: int, shift_size: int,
                 mlp_ratio: float, dtype: torch.dtype, packed: bool):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.packed = packed
        self.norm1 = LayerNorm(dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def _prologue(self, x):
        _, H, W, _ = x.shape
        ws, ss = self.window_size, self.shift_size
        mask = _device_mask(H, W, ws, ss, x.device)
        x_pad = ops.center_pad(x, ws)
        if ss:
            x_pad = torch.roll(x_pad, (-ss, -ss), (1, 2))
        return ops.window_partition(x_pad, ws), mask, x_pad.shape[1:3]

    def _epilogue(self, windows, Hp: int, Wp: int, H: int, W: int):
        back = ops.window_reverse(windows, self.window_size, Hp, Wp)
        if self.shift_size:
            back = torch.roll(back, (self.shift_size, self.shift_size), (1, 2))
        return ops.center_depad(back, H, W, self.window_size)

    def _mlp_residual(self, x):
        return x + self.mlp(self.norm2(x))


class ATMFormer(_SwinShell):
    """Swin-style block around AttentionToMotion. [2B, H, W, C] with the
    two frames stacked on the batch axis -> (tokens, motion [2B, H, W, 2]).
    The partner of window i is window (i + BW/2) mod BW: the same window
    of the other frame."""

    def __init__(self, dim: int, window_size: int = 8, shift_size: int = 0,
                 num_heads: int = 8, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, packed: bool = False):
        super().__init__(dim, window_size, shift_size, mlp_ratio, dtype,
                         packed)
        self.attn = AttentionToMotion(dim, window_size, num_heads, dtype)

    def forward(self, x):
        _, H, W, _ = x.shape
        x_win, mask, (Hp, Wp) = self._prologue(x)
        if self.packed:
            x_norm = self.norm1(x_win)
            x_rev = torch.roll(x_norm, -(x_norm.shape[0] // 2), 0)
            app, motion = self.attn.forward_packed(x_norm, x_rev, mask)
            y = x_norm + app
        else:
            y, motion = self.attn(x_win, mask, self.norm1)
        x_out = self._epilogue(y, Hp, Wp, H, W)
        motion_out = self._epilogue(motion, Hp, Wp, H, W)
        return self._mlp_residual(x_out), motion_out


class RefineBottleneck(_SwinShell):
    """Swin block around plain WindowAttention."""

    def __init__(self, dim: int, window_size: int = 8, shift_size: int = 0,
                 num_heads: int = 8, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, packed: bool = False):
        super().__init__(dim, window_size, shift_size, mlp_ratio, dtype,
                         packed)
        self.attn = WindowAttention(dim, num_heads, dtype)

    def forward(self, x):
        _, H, W, _ = x.shape
        x_win, mask, (Hp, Wp) = self._prologue(x)
        if self.packed:
            x_norm = self.norm1(x_win)
            y = x_norm + self.attn.forward_packed(x_norm, mask)
        else:
            y = self.attn(x_win, mask, self.norm1)
        return self._mlp_residual(self._epilogue(y, Hp, Wp, H, W))


def reset_parameters(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded init of every submodule that defines `reset_parameters`."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters") \
                and not isinstance(m, nn.GELU):
            m.reset_parameters(gen)

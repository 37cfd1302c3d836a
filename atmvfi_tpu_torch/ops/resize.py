"""Bilinear resize with `align_corners=True` semantics.

Counterpart of `atmvfi_tpu/ops/resize.py` (its CPU/GPU form): each
axis is a two-tap lerp at source coordinate ``i * (in - 1) / (out - 1)``,
coefficients computed in float64 and stored f32, accumulation in f32.
NHWC layout: [..., H, W, C].
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def _axis_coeffs(in_size: int, out_size: int):
    if out_size == 1:
        src = np.zeros((1,), np.float64)
    else:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (
            out_size - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    w1 = (src - i0).astype(np.float32)
    return i0, i1, w1


def _resize_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    if not x.is_floating_point():
        raise TypeError(f"resize_bilinear needs float input, got {x.dtype}")
    axis = axis % x.ndim
    in_size = x.shape[axis]
    if out_size == in_size:
        return x
    i0, i1, w1 = _axis_coeffs(in_size, out_size)
    dev = x.device
    a = torch.index_select(x, axis, torch.from_numpy(i0).to(dev))
    b = torch.index_select(x, axis, torch.from_numpy(i1).to(dev))
    wshape = [1] * x.ndim
    wshape[axis] = out_size
    w = torch.from_numpy(w1).to(dev).reshape(wshape)
    y = a.float() * (1.0 - w) + b.float() * w
    return y.to(x.dtype)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize [..., H, W, C] to [..., out_h, out_w, C], align_corners."""
    x = _resize_axis(x, x.ndim - 3, out_h)
    return _resize_axis(x, x.ndim - 2, out_w)


def resize_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """`F.interpolate(scale_factor=scale)` sizes: out = floor(in * scale)."""
    h, w = x.shape[-3], x.shape[-2]
    return resize_bilinear(x, int(h * scale), int(w * scale))


def downsample_2x(x: torch.Tensor) -> torch.Tensor:
    return resize_scale(x, 0.5)


def upsample_flow(flow: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Upsample a flow field [..., H, W, 2] and scale its magnitude."""
    h, w = flow.shape[-3], flow.shape[-2]
    return resize_bilinear(flow, h * factor, w * factor) * factor

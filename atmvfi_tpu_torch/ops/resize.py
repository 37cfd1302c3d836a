"""Bilinear resize with `align_corners=True` semantics.

Counterpart of `atmvfi_tpu/ops/resize.py` (its CPU/GPU form): each
axis is a two-tap lerp at source coordinate ``i * (in - 1) / (out - 1)``,
coefficients computed in float64 and stored f32, accumulation in f32.
NHWC layout: [..., H, W, C]. `upsample_flow_rows` computes only a band
of output rows of the x2 flow-upsample chain (the row-sharded serving
schedule, `parallel.spatial`).
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


@functools.lru_cache(maxsize=128)
def _device_coeffs(in_size: int, out_size: int, dev: torch.device):
    """`_axis_coeffs` as tensors on `dev`, copied there once: a copy from
    host memory waits for the work queued on the card, so one a call
    would hold the host at every resize (and run the shards of a mesh on
    distinct cards one after another). Made outside inference mode, so
    that a training forward may save them for its backward."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(c).to(dev)
                     for c in _axis_coeffs(in_size, out_size))


def clear_caches() -> None:
    """Drop the resize coefficients kept on devices; the next resize
    rebuilds them bit-identically. A forward on fake tensors (a count of
    its work) calls this before and after, so that no fake tensor stays
    in them."""
    _device_coeffs.cache_clear()


def _resize_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    if not x.is_floating_point():
        raise TypeError(f"resize_bilinear needs float input, got {x.dtype}")
    axis = axis % x.ndim
    in_size = x.shape[axis]
    if out_size == in_size:
        return x
    i0, i1, w1 = _device_coeffs(in_size, out_size, x.device)
    a = torch.index_select(x, axis, i0)
    b = torch.index_select(x, axis, i1)
    wshape = [1] * x.ndim
    wshape[axis] = out_size
    w = w1.reshape(wshape)
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


def _resize_h_rows(x: torch.Tensor, out_size: int, row0: int, out_len: int,
                   in_row0: int = 0, in_size: int = None) -> torch.Tensor:
    """Rows [row0, row0 + out_len) of the H-axis align-corners resize to
    `out_size`, from x's rows, which hold the rows [in_row0, in_row0 +
    x.shape[-3]) of a full input of `in_size` rows. The source row is
    the exact integer divmod of r * (in - 1) by (out - 1) and the weight
    its remainder / (out - 1) in f32 (`atmvfi_tpu/ops/resize.py::
    _resize_h_rows`, its non-TPU branch), so a row agrees with the
    static resize to the f32 rounding of the weight. The band the
    output reads must lie inside x: ValueError otherwise."""
    in_have = x.shape[-3]
    if in_size is None:
        in_size = in_have
    dev = x.device
    rows = torch.arange(row0, row0 + out_len, dtype=torch.int64)
    if out_size == 1:
        i0 = torch.zeros(out_len, dtype=torch.int64)
        w = torch.zeros(out_len, dtype=torch.float32)
    else:
        num = rows * (in_size - 1)
        den = out_size - 1
        q = num // den
        i0 = q.clamp(0, in_size - 1)
        w = (num - q * den).to(torch.float32) / float(den)
    i1 = (i0 + 1).clamp(0, in_size - 1)
    # the second tap counts where its weight is not 0; where it is, the
    # row past the band is read at weight 0 from the band's last row
    lo = int(i0.min()) - in_row0
    hi = int(torch.where(w > 0, i1, i0).max()) - in_row0
    if lo < 0 or hi > in_have - 1:
        raise ValueError(f"rows [{row0}, {row0 + out_len}) of the resize to "
                         f"{out_size} read input rows [{lo + in_row0}, "
                         f"{hi + in_row0}], outside the band [{in_row0}, "
                         f"{in_row0 + in_have})")
    axis = x.ndim - 3
    a = torch.index_select(x, axis, (i0 - in_row0).to(dev))
    b = torch.index_select(x, axis,
                           (i1 - in_row0).clamp(max=in_have - 1).to(dev))
    wshape = [1] * x.ndim
    wshape[axis] = out_len
    wb = w.to(dev).reshape(wshape)
    y = a.float() * (1.0 - wb) + b.float() * wb
    return y.to(x.dtype)


def upsample_flow_rows(flow: torch.Tensor, levels: int, row0: int,
                       out_len: int) -> torch.Tensor:
    """Rows [row0, row0 + out_len) of `upsample_flow(., 2)` applied
    `levels` times to the full coarse flow [..., h, w, 2], computed at
    the rows needed only: each intermediate level keeps a band of +-2
    rows around what the next level reads (`atmvfi_tpu/ops/resize.py::
    upsample_flow_rows`). row0 and out_len are full-resolution rows. A
    band that does not fit its level raises (`_resize_h_rows`)."""
    h, w = flow.shape[-3], flow.shape[-2]
    sizes = [h * 2 ** k for k in range(levels + 1)]
    lens = [out_len]
    for _ in range(levels - 1):
        lens.insert(0, lens[0] // 2 + 4)
    cur, cur_row0, cur_size = flow, 0, h
    for k in range(levels):
        out_size, ln = sizes[k + 1], lens[k]
        if k == levels - 1:
            r0 = row0
        else:  # centre the band over the rows the next level reads
            r0 = min(max(row0 // 2 ** (levels - 1 - k) - 2, 0), out_size - ln)
        cur = _resize_h_rows(cur, out_size, r0, ln, cur_row0, cur_size)
        cur = _resize_axis(cur, cur.ndim - 2, w * 2 ** (k + 1)) * 2.0
        cur_row0, cur_size = r0, out_size
    return cur

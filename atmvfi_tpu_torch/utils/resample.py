"""Pillow's 8-bit resampling, exactly, in numpy.

`pillow_resize(img, out_w, out_h, "box" | "bilinear")` equals
`Image.fromarray(img).resize((out_w, out_h), Image.BOX | Image.BILINEAR)`
for a uint8 [H, W, C] image, so the evaluation protocols (BOX) and the
Vimeo training set at `scale_factor > 1` (BILINEAR) need no Pillow:
Resample.c's `precompute_coeffs` and `normalize_coeffs_8bpc`, the
horizontal pass rounded to uint8, then the vertical one; an axis whose
size does not change is not resampled.
"""
from __future__ import annotations

import functools
import math

import numpy as np

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit resampling

# filter: (support, weight of a tap at distance x, in units of filterscale)
_FILTERS = {
    "box": (0.5, lambda x: ((x > -0.5) & (x <= 0.5)).astype(np.float64)),
    "bilinear": (1.0, lambda x: np.maximum(1.0 - np.abs(x), 0.0)),
}


@functools.lru_cache(maxsize=32)
def _weights(in_size: int, out_size: int, resample: str):
    """(first input index, fixed-point weights [out, ksize]) along one
    axis: output pixel xx takes the input pixels within the filter's
    support of its centre (xx + 0.5) * scale, weighted by the filter,
    normalised to sum 1, then rounded to 22-bit fixed point."""
    base, fn = _FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int32)
    kk = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax, dtype=np.float64)
        w = fn((x + xmin - center + 0.5) * (1.0 / filterscale))
        ww = 0.0
        for v in w:  # Pillow's running sum, in its order
            ww += v
        if ww != 0:
            w = w / ww
        first[xx] = xmin
        kk[xx, :xmax] = np.where(w < 0, -0.5 + w * (1 << _PRECISION_BITS),
                                 0.5 + w * (1 << _PRECISION_BITS)
                                 ).astype(np.int32)
    return first, kk


def _resample_axis(img: np.ndarray, axis: int, out_size: int,
                   resample: str) -> np.ndarray:
    """One 8-bit pass along `axis` of uint8 img, in Pillow's 32-bit
    integer arithmetic (weights sum to 2^22, so no sum leaves int32)."""
    first, kk = _weights(img.shape[axis], out_size, resample)
    src = np.moveaxis(img, axis, 0).astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int32)
    extra = (1,) * (src.ndim - 1)
    for j in range(kk.shape[1]):
        idx = np.minimum(first + j, src.shape[0] - 1)
        acc += src[idx] * kk[:, j].reshape((-1,) + extra)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def pillow_resize(img: np.ndarray, out_w: int, out_h: int,
                  resample: str) -> np.ndarray:
    """Pillow's `resize((out_w, out_h), BOX | BILINEAR)` of a uint8
    [H, W, C] image, exactly."""
    if img.shape[1] != out_w:
        img = _resample_axis(img, 1, out_w, resample)
    if img.shape[0] != out_h:
        img = _resample_axis(img, 0, out_h, resample)
    return img

"""Window partition / reverse, center padding and attention masks.

Counterpart of `atmvfi_tpu/ops/window.py`. Features are [B, H, W, C];
windows are [B * nH * nW, wh * ww, C]. The masks depend only on
(resolution, window, shift) and are built once in numpy, then cached.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MASK_NEG = -100.0  # additive mask value of the reference model


def to_2tuple(v):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v)


def window_partition(x: torch.Tensor, window_size) -> torch.Tensor:
    """[B, H, W, C] -> [B*nH*nW, wh*ww, C] (contiguous)."""
    wh, ww = to_2tuple(window_size)
    B, H, W, C = x.shape
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, C)


def window_reverse(windows: torch.Tensor, window_size, H: int, W: int):
    """[B*nH*nW, wh*ww, C] -> [B, H, W, C]."""
    wh, ww = to_2tuple(window_size)
    nwB, N, C = windows.shape
    B = nwB // ((H // wh) * (W // ww))
    x = windows.reshape(B, H // wh, W // ww, wh, ww, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def pad_amounts(h: int, w: int, window_size) -> Tuple[int, int]:
    wh, ww = to_2tuple(window_size)
    return math.ceil(h / wh) * wh - h, math.ceil(w / ww) * ww - w


def center_pad(x: torch.Tensor, window_size) -> torch.Tensor:
    """Zero-pad H, W of [B, H, W, C] to a window multiple, centered."""
    _, h, w, _ = x.shape
    pad_h, pad_w = pad_amounts(h, w, window_size)
    if pad_h == 0 and pad_w == 0:
        return x
    # F.pad lists the last dim first: (C), W, H
    return F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                     pad_h // 2, pad_h - pad_h // 2))


def center_depad(x: torch.Tensor, h: int, w: int, window_size):
    pad_h, pad_w = pad_amounts(h, w, window_size)
    if pad_h == 0 and pad_w == 0:
        return x
    return x[:, pad_h // 2: pad_h // 2 + h, pad_w // 2: pad_w // 2 + w, :]


def _np_window_partition(x: np.ndarray, wh: int, ww: int) -> np.ndarray:
    B, H, W, C = x.shape
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, C)


def _region_mask(labels: np.ndarray, wh: int, ww: int) -> np.ndarray:
    """Pairwise same-region additive mask from a [1, H, W, 1] label map."""
    win = _np_window_partition(labels, wh, ww)[..., 0]  # [nW, N]
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, np.float32(MASK_NEG), np.float32(0.0))


@functools.lru_cache(maxsize=64)
def _pad_mask_np(h: int, w: int, wh: int, ww: int) -> Optional[np.ndarray]:
    """Mask of the nine center-pad regions, or None without padding."""
    pad_h = math.ceil(h / wh) * wh - h
    pad_w = math.ceil(w / ww) * ww - w
    if pad_h == 0 and pad_w == 0:
        return None
    labels = np.zeros((1, h + pad_h, w + pad_w, 1), np.float32)
    h_sl = (slice(0, pad_h // 2), slice(pad_h // 2, h + pad_h // 2),
            slice(h + pad_h // 2, None))
    w_sl = (slice(0, pad_w // 2), slice(pad_w // 2, w + pad_w // 2),
            slice(w + pad_w // 2, None))
    cnt = 0
    for hs in h_sl:
        for ws in w_sl:
            labels[:, hs, ws, :] = cnt
            cnt += 1
    return _region_mask(labels, wh, ww)


@functools.lru_cache(maxsize=64)
def _shift_mask_np(h: int, w: int, wh: int, ww: int, sh: int,
                   sw: int) -> Optional[np.ndarray]:
    """Shifted-window mask on the padded canvas, merged with the pad mask."""
    pad_h = math.ceil(h / wh) * wh - h
    pad_w = math.ceil(w / ww) * ww - w
    if sh == 0 and sw == 0:
        return _pad_mask_np(h, w, wh, ww)
    labels = np.zeros((1, h + pad_h, w + pad_w, 1), np.float32)
    h_sl = (slice(0, -wh), slice(-wh, -sh), slice(-sh, None))
    w_sl = (slice(0, -ww), slice(-ww, -sw), slice(-sw, None))
    cnt = 0
    for hs in h_sl:
        for ws in w_sl:
            labels[:, hs, ws, :] = cnt
            cnt += 1
    mask = _region_mask(labels, wh, ww)
    pad_mask = _pad_mask_np(h, w, wh, ww)
    if pad_mask is not None:
        mask = np.where(pad_mask != 0, np.float32(MASK_NEG), mask)
    return mask


@functools.lru_cache(maxsize=16)
def _relative_coords_np(window_size: int) -> np.ndarray:
    """[2, N, N] with rel[d, q, k] = coord_d(k) - coord_d(q); d=0 is x."""
    n = window_size
    xs, ys = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    coords = np.stack([xs.reshape(-1), ys.reshape(-1)], 0).astype(np.float32)
    return coords[:, None, :] - coords[:, :, None]


def relative_coords(window_size: int, device=None) -> torch.Tensor:
    return torch.from_numpy(_relative_coords_np(window_size)).to(device)


def attn_mask_for(h: int, w: int, window_size, shift_size,
                  device=None) -> Optional[torch.Tensor]:
    """Additive f32 mask [nW, N, N] for (resolution, window, shift), or
    None when neither padding nor shifting needs one."""
    wh, ww = to_2tuple(window_size)
    sh, sw = to_2tuple(shift_size)
    m = _shift_mask_np(h, w, wh, ww, sh, sw)
    return None if m is None else torch.from_numpy(m).to(device)

"""Optical-flow colour visualisation (Baker et al. colour wheel): the
port's copy of `atmvfi_tpu/utils/flow_viz.py`, the Middlebury colour
wheel encoding (numpy only)."""
from __future__ import annotations

import numpy as np


def _make_colorwheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(0, RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(0, YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(0, GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(0, BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = _make_colorwheel()


def flow_to_color(flow: np.ndarray,
                  clip_flow: float | None = None) -> np.ndarray:
    """float [H, W, 2] (u, v) -> uint8 RGB [H, W, 3]."""
    flow = np.asarray(flow, np.float32)
    assert flow.ndim == 3 and flow.shape[2] == 2
    u, v = flow[..., 0], flow[..., 1]
    if clip_flow is not None:
        u = np.clip(u, 0, clip_flow)
        v = np.clip(v, 0, clip_flow)
    rad = np.sqrt(u**2 + v**2)
    rad_max = max(rad.max(), 1e-5)
    u = u / rad_max
    v = v / rad_max
    rad = rad / rad_max

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for ch in range(3):
        col0 = _WHEEL[k0, ch] / 255.0
        col1 = _WHEEL[k1, ch] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)  # saturate towards white with low radius
        img[..., ch] = np.floor(255 * col)
    return img

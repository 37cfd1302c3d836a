"""Backward (bilinear) warp: the plain PyTorch version.

Counterpart of `atmvfi_tpu/ops/warp.py`: sample `feature` at
``pixel grid + flow`` with bilinear taps, ``align_corners=True`` and
zeros padding, where each of the four taps that falls outside the
image contributes exactly 0 and nothing is clamped. Written as the
explicit 4-tap gather (not `F.grid_sample`, whose normalisation round
trip is not exact in f32). Tap coordinates and weights are f32; the
taps are summed in f32 in the order (x0,y0), (x1,y0), (x0,y1), (x1,y1)
and the result is rounded once to the feature's dtype.

This is also the plain version of kernel K2 (`ops.warp_cuda`), which
computes the same arithmetic in the same order, `flow_warp_blend` the
plain version of K9, and `warp_pair_srcfull` / `flow_warp_rows` those of
the row-offset forms (K10 and the single row warp), which warp a full
source onto output rows [row0, row0 + h) of the row-sharded serving
schedule (`parallel.spatial`).
"""
from __future__ import annotations

import torch


def coords_grid(b: int, h: int, w: int, device=None) -> torch.Tensor:
    """[B, H, W, 2] (x, y) pixel grid, f32."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys], -1).expand(b, h, w, 2)


def _sample_xy(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Sample img [B, H, W, C] at per-component coords x, y [B, Ho, Wo]."""
    B, H, W, C = img.shape
    _, Ho, Wo = x.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    # clamping the corner to [-2, W] keeps every validity decision (a
    # tap at -2 or W is invalid either way) and bounds the int cast
    x0i = x0.clamp(-2, W).long()
    y0i = y0.clamp(-2, H).long()
    flat_img = img.reshape(B, H * W, C)
    out = None
    for dx, dy, w in ((0, 0, wx0 * wy0), (1, 0, wx1 * wy0),
                      (0, 1, wx0 * wy1), (1, 1, wx1 * wy1)):
        xi = x0i + dx
        yi = y0i + dy
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, -1, 1)
        vals = torch.gather(flat_img, 1, idx.expand(B, Ho * Wo, C)).float()
        wv = torch.where(valid, w, torch.zeros_like(w)).reshape(B, -1, 1)
        t = vals * wv
        out = t if out is None else out + t
    return out.reshape(B, Ho, Wo, C).to(img.dtype)


def flow_warp(feature: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp `feature` [B, H, W, C] by `flow` [B, H, W, 2] (x, y)."""
    b, h, w, _ = feature.shape
    dev = feature.device
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    x = xs + flow[..., 0].float()
    y = ys + flow[..., 1].float()
    return _sample_xy(feature, x, y)


def flow_warp_blend(im0: torch.Tensor, im1: torch.Tensor, flow0: torch.Tensor,
                    flow1: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """occ * warp(im0, flow0) + (1 - occ) * warp(im1, flow1): the two
    warps, then the occlusion blend (occ [B, H, W, 1])."""
    return occ * flow_warp(im0, flow0) + (1 - occ) * flow_warp(im1, flow1)


def _rows_xy(flow: torch.Tensor, row0: int, fold: bool):
    """Sample coords of output rows [row0, row0 + h) for flows [B, h, W,
    2]: x = j + fx; y = i + (fy + row0) when `fold` (K10, as the TPU op
    folds the row offset into the flow), else y = (i + row0) + fy."""
    _, h, w, _ = flow.shape
    dev = flow.device
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    fy = flow[..., 1].float()
    off = torch.tensor(float(row0), dtype=torch.float32, device=dev)
    y = ys + (fy + off) if fold else (ys + off) + fy
    return xs + flow[..., 0].float(), y


def warp_pair_srcfull(im0_full: torch.Tensor, im1_full: torch.Tensor,
                      flow0: torch.Tensor, flow1: torch.Tensor, row0: int):
    """Plain K10: full f32 sources [1, H_full, W, C] warped onto output
    rows [row0, row0 + H_out) by the flows of those rows [1, H_out, W,
    2]; row0 is folded into the flows' y (`atmvfi_tpu/ops/warp_pallas.py::
    planar_warp_pair_srcfull`, NHWC). Two [1, H_out, W, C] f32."""
    return (_sample_xy(im0_full, *_rows_xy(flow0, row0, True)),
            _sample_xy(im1_full, *_rows_xy(flow1, row0, True)))


def flow_warp_rows(feature: torch.Tensor, flow_rows: torch.Tensor,
                   row0: int) -> torch.Tensor:
    """Backward-warp the full `feature` [B, H, W, C] onto output rows
    [row0, row0 + h) by their flows `flow_rows` [B, h, W, 2]: row for
    row equal to flow_warp(feature, flow)[:, row0:row0 + h]."""
    return _sample_xy(feature, *_rows_xy(flow_rows, row0, False))

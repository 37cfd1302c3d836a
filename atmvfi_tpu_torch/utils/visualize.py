"""Prediction / flow montages (`atmvfi_tpu/utils/visualize.py`): a grid
of [input frames | prediction | ground truth | flows | occlusion] saved
as one PNG per sample, the flows through the Middlebury colour wheel
(`utils.flow_viz`). Panels are labelled where Pillow is installed and
left bare where it is not; the PNG itself needs no Pillow."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from atmvfi_tpu_torch.utils.flow_viz import flow_to_color
from atmvfi_tpu_torch.utils.images import write_image


def _to_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def _label(img: np.ndarray, text: str) -> np.ndarray:
    try:
        from PIL import Image, ImageDraw

        pil = Image.fromarray(img)
        ImageDraw.Draw(pil).text((4, 4), text, fill=(255, 64, 64))
        return np.asarray(pil)
    except Exception:
        return img


def montage(panels, cols: Optional[int] = None) -> np.ndarray:
    """Stack equally-sized [H, W, 3] uint8 panels into a grid image."""
    n = len(panels)
    cols = cols or min(n, 4)
    rows = (n + cols - 1) // cols
    h, w = panels[0].shape[:2]
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, p in enumerate(panels):
        r, c = divmod(i, cols)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = p
    return canvas


def save_prediction(im0, im1, pred, label, out_dir: str, index: int,
                    psnr: Optional[float] = None,
                    flow0=None, flow1=None, occ=None) -> str:
    """Write one montage PNG; returns its path.

    im0 / im1 / pred / label: [H, W, 3] float [0, 1] or NHWC with B = 1;
    flow0 / flow1: [H, W, 2] (optional); occ: [H, W, 1] (optional)."""
    def squeeze(x):
        x = np.asarray(x)
        return x[0] if x.ndim == 4 else x

    panels = [
        _label(_to_u8(squeeze(im0)), "frame 0"),
        _label(_to_u8(squeeze(pred)),
               f"pred{'' if psnr is None else f' psnr={psnr:.2f}'}"),
        _label(_to_u8(squeeze(label)), "ground truth"),
        _label(_to_u8(squeeze(im1)), "frame 1"),
    ]
    if flow0 is not None:
        panels.append(_label(flow_to_color(squeeze(flow0)), "flow 0"))
    if flow1 is not None:
        panels.append(_label(flow_to_color(squeeze(flow1)), "flow 1"))
    if occ is not None:
        o = np.repeat(squeeze(occ), 3, axis=-1)
        panels.append(_label(_to_u8(o), "occlusion"))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"sample_{index:05d}.png")
    write_image(path, montage(panels))
    return path


def hconcat_videos_frames(frames_a, frames_b):
    """Side-by-side comparison frames."""
    out = []
    for a, b in zip(frames_a, frames_b):
        h = min(a.shape[0], b.shape[0])
        out.append(np.concatenate([a[:h], b[:h]], axis=1))
    return out

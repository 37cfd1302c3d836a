"""The synthetic video that every traffic mix draws its frames from.

`make_pool(traffic, seed, device)` makes `traffic["pool"]` consecutive
uint8 RGB frames [H, W, 3] on the device, from a `torch.Generator` there,
and returns them as one host array [pool, H, W, 3]:

* a textured background (three octaves of smooth noise and a fine
  grain, each channel its own) that translates by a whole number of
  pixels a frame, at a velocity drawn from the seed within
  +-`video.max_speed`;
* a textured patch of a quarter of the frame's height and width that
  moves at its own velocity (+-`video.patch_speed`), stopping at the
  frame's edges;
* sensor noise, N(0, `video.noise_levels`^2) levels a pixel.

So consecutive frames differ by motion, and every seed gives frames of
the same sizes. The program receives only these frames.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _texture(g, h, w, device):
    """[3, h, w] smooth-to-fine noise in [0, 1]."""
    out = torch.zeros(1, 3, h, w, device=device)
    for div, amp in ((64, 0.5), (16, 0.3), (4, 0.15)):
        base = torch.rand(1, 3, max(h // div, 2) + 2, max(w // div, 2) + 2,
                          generator=g, device=device)
        out += amp * F.interpolate(base, size=(h, w), mode="bicubic",
                                   align_corners=False)
    out += 0.05 * torch.rand(1, 3, h, w, generator=g, device=device)
    out = (out - out.amin()) / (out.amax() - out.amin())
    return out[0]


def _speed(g, vmax, device):
    return [int(v) for v in torch.randint(-vmax, vmax + 1, (2,), generator=g,
                                          device=device)]


def make_pool(traffic: dict, seed: int, device) -> np.ndarray:
    H, W, P = traffic["height"], traffic["width"], traffic["pool"]
    v = traffic["video"]
    g = torch.Generator(device=device).manual_seed(int(seed))
    m = v["max_speed"] * P
    canvas = _texture(g, H + 2 * m, W + 2 * m, device)
    ph, pw = H // 4, W // 4
    patch = _texture(g, ph, pw, device)
    bx, by = _speed(g, v["max_speed"], device)
    px, py = _speed(g, v["patch_speed"], device)
    y0 = int(torch.randint(0, H - ph, (1,), generator=g, device=device))
    x0 = int(torch.randint(0, W - pw, (1,), generator=g, device=device))
    frames = torch.empty(P, H, W, 3, dtype=torch.uint8, device=device)
    for k in range(P):
        oy, ox = m + k * by, m + k * bx
        f = canvas[:, oy:oy + H, ox:ox + W].clone()
        ty = min(max(y0 + k * py, 0), H - ph)
        tx = min(max(x0 + k * px, 0), W - pw)
        f[:, ty:ty + ph, tx:tx + pw] = patch
        f += (v["noise_levels"] / 255.0) * torch.randn(
            3, H, W, generator=g, device=device)
        frames[k] = torch.round(f.clamp(0, 1) * 255).to(torch.uint8) \
            .permute(1, 2, 0)
    return frames.cpu().numpy()

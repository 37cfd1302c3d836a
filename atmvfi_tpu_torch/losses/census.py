"""Census (ternary) transform loss (`atmvfi_tpu/losses/census.py`).

7x7 census transform on the grey image (zero pad 3, as shifted
slices), soft-normalised, soft Hamming distance between the two
transforms, masked to the interior (1-px border off). NHWC.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_PATCH = 7


def _rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]
    return 0.2989 * r + 0.5870 * g + 0.1140 * b


def _census_transform(gray: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 1] -> [B, H, W, 49] soft-normalised neighbourhood
    differences."""
    _, h, w, _ = gray.shape
    pad = _PATCH // 2
    padded = F.pad(gray, (0, 0, pad, pad, pad, pad))
    patches = torch.stack([padded[:, dy:dy + h, dx:dx + w, 0]
                           for dy in range(_PATCH) for dx in range(_PATCH)],
                          -1)
    transf = patches - gray
    return transf / torch.sqrt(0.81 + transf ** 2)


def _soft_hamming(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    dist = (t1 - t2) ** 2
    return torch.mean(dist / (0.1 + dist), -1, keepdim=True)


def _valid_mask(shape, padding: int, dtype, device) -> torch.Tensor:
    b, h, w, _ = shape
    m = torch.zeros((b, h, w, 1), dtype=dtype, device=device)
    m[:, padding:h - padding, padding:w - padding] = 1
    return m


def census_loss(img0: torch.Tensor, img1: torch.Tensor, reduce: str = "mean"):
    """NHWC [B, H, W, 3] in [0, 1]; the mean, or the map for another
    `reduce`."""
    t0 = _census_transform(_rgb_to_gray(img0))
    t1 = _census_transform(_rgb_to_gray(img1))
    loss = _soft_hamming(t0, t1) * _valid_mask(img0.shape, 1, img0.dtype,
                                               img0.device)
    if reduce == "mean":
        return torch.mean(loss)
    return loss

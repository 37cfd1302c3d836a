"""4-direction Sobel edge-magnitude L1 loss (`atmvfi_tpu/losses/
sobel.py`): the JAX package's 3x3 kernels (x, y, 45 and 135 degrees)
on the Y channel with zero pad 1, as shifted slices (no `F.conv2d`, so
no TF32 on the card). NHWC; `gt` carries no gradient."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_GX = np.array([[2.0, 0.0, -2.0], [4.0, 0.0, -4.0], [2.0, 0.0, -2.0]])
_GY = np.array([[2.0, 4.0, 2.0], [0.0, 0.0, 0.0], [-2.0, -4.0, -2.0]])
_G45 = np.array([[0.0, -2.0, -4.0], [2.0, 0.0, -2.0], [4.0, 2.0, 0.0]])
_G135 = np.array([[-4.0, -2.0, 0.0], [-2.0, 0.0, 2.0], [0.0, 2.0, 4.0]])
_KERNELS = (_GX, _GY, _G45, _G135)


def _rgb_to_y(img: torch.Tensor) -> torch.Tensor:
    return (0.299 * img[..., 0:1] + 0.587 * img[..., 1:2]
            + 0.114 * img[..., 2:3])


def _sobel_mag(y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """[B, H, W, 1] -> sqrt(sum of the 4 squared responses + eps)."""
    H, W = y.shape[1], y.shape[2]
    p = F.pad(y, (0, 0, 1, 1, 1, 1))
    sq = 0
    for k in _KERNELS:
        g = 0
        for dy in range(3):
            for dx in range(3):
                if k[dy, dx]:
                    g = g + p[:, dy:dy + H, dx:dx + W] * float(k[dy, dx])
        sq = sq + g * g
    return torch.sqrt(sq + eps)


def sobel_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """L1 between the Sobel magnitudes of the Y channels."""
    gt = gt.detach()
    return torch.mean(torch.abs(_sobel_mag(_rgb_to_y(pred))
                                - _sobel_mag(_rgb_to_y(gt))))

"""Laplacian-pyramid L1 loss (`atmvfi_tpu/losses/laplacian.py`).

Each level: a depthwise 5x5 binomial blur (the separable 1-4-6-4-1 / 16
kernel, reflect pad 2) decimated by 2, then zero-stuffed back up and
blurred with gain 4; the level is the image minus that. The blur is
shifted slices summed in the JAX package's order (no `F.conv2d`, so no
TF32 on the card). NHWC.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_K1D = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of numpy's (and jnp.pad's) "reflect" padding of an axis of
    n by `pad` a side, which also takes pad >= n (the reflection
    repeats), where F.pad refuses: the pyramid's coarse levels of small
    crops."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


def _conv_gauss(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Depthwise 5x5 Gaussian with reflect pad 2, H then W."""
    k = [v * gain ** 0.5 for v in _K1D]  # exact in f32 and bf16
    if x.shape[1] > 2 and x.shape[2] > 2:
        x = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="reflect"
                  ).permute(0, 2, 3, 1)
    else:
        x = x.index_select(1, _reflect_index(x.shape[1], 2, x.device))
        x = x.index_select(2, _reflect_index(x.shape[2], 2, x.device))
    H, W = x.shape[1] - 4, x.shape[2] - 4
    xs = 0
    for i in range(5):
        xs = xs + x[:, i:i + H] * k[i]
    out = 0
    for i in range(5):
        out = out + xs[:, :, i:i + W] * k[i]
    return out


def _downsample(x):
    return x[:, ::2, ::2, :]


def _upsample(x):
    b, h, w, c = x.shape
    up = x.new_zeros(b, h, 2, w, 2, c)
    up[:, :, 0, :, 0, :] = x
    return _conv_gauss(up.reshape(b, 2 * h, 2 * w, c), gain=4.0)


def laplacian_pyramid(img: torch.Tensor, max_levels: int = 3):
    current = img
    pyr = []
    for _ in range(max_levels):
        down = _downsample(_conv_gauss(current))
        pyr.append(current - _upsample(down))
        current = down
    return pyr


def lap_loss(pred: torch.Tensor, target: torch.Tensor,
             max_levels: int = 5) -> torch.Tensor:
    """Sum of the per-level mean |difference|."""
    pa = laplacian_pyramid(pred, max_levels)
    pb = laplacian_pyramid(target, max_levels)
    return sum(torch.mean(torch.abs(a - b)) for a, b in zip(pa, pb))

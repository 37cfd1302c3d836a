"""PSNR / SSIM metrics with the reference's protocols, in PyTorch.

The port's counterpart of `atmvfi_tpu/evalkit/metrics.py`:

  * `ssim_matlab`: the 3D variant that treats an RGB image as a volume
    (11x11x11 Gaussian, sigma 1.5, replicate pad 5 on C, H and W); the
    number reported on Vimeo90K, UCF101 and SNU-FILM.
  * `ssim`: per-channel 2D SSIM.
  * `msssim`: 5-scale multi-scale SSIM, with the reference's product
    quirk.
  * `psnr`: -10 log10(MSE) on [0, 1] images.
  * `ie`: interpolation error on the rounded uint8 scale.

Every function takes NHWC tensors (f32, [0, 1] unless stated) on any
device and returns a 0-d tensor there. The Gaussian filter is separable
and runs as JAX's does: the 11 shifted slices of the padded image, each
times its tap, summed in f32 in tap order. Nothing here calls a
convolution: on the card cuDNN would run it in TF32 by default and move
SSIM by about 1e-4.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _gaussian_1d(window_size: int, sigma: float = 1.5) -> np.ndarray:
    g = np.array([math.exp(-((x - window_size // 2) ** 2)
                           / float(2 * sigma ** 2))
                  for x in range(window_size)], dtype=np.float64)
    return (g / g.sum()).astype(np.float32)


def _filter_axis(x: torch.Tensor, axis: int,
                 window: np.ndarray) -> torch.Tensor:
    """Valid-mode 1-D correlation along `axis` (the kernel is
    symmetric): the shifted slices times their taps, summed in order."""
    n = window.shape[0]
    k = torch.from_numpy(window).to(x.device, x.dtype)
    m = x.shape[axis] - (n - 1)
    out = None
    for i in range(n):
        term = x.narrow(axis, i, m) * k[i]
        out = term if out is None else out + term
    return out


def _pad_replicate(x: torch.Tensor, axes, amount: int) -> torch.Tensor:
    for a in axes:
        n = x.shape[a]
        idx = torch.arange(-amount, n + amount, device=x.device)
        x = x.index_select(a, idx.clamp(0, n - 1))
    return x


def _ssim_terms(img1, img2, filt, C1, C2):
    mu1 = filt(img1)
    mu2 = filt(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = filt(img1 * img1) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu1_mu2
    v1 = 2.0 * sigma12 + C2
    v2 = sigma1_sq + sigma2_sq + C2
    ssim_map = ((2 * mu1_mu2 + C1) * v1) / ((mu1_sq + mu2_sq + C1) * v2)
    cs = torch.mean(v1 / v2)
    return ssim_map, cs


def _val_range(img1: torch.Tensor, val_range):
    """The dynamic range L: `val_range` if given, else the reference's
    guess from img1 (255 above a max of 128, a floor of -1 below a min
    of -0.5), as a 0-d tensor on img1's device."""
    if val_range is not None:
        return float(val_range)
    one = torch.ones((), device=img1.device)
    max_val = torch.where(img1.max() > 128, 255.0 * one, one)
    min_val = torch.where(img1.min() < -0.5, -one, 0.0 * one)
    return max_val - min_val


def ssim_matlab(img1: torch.Tensor, img2: torch.Tensor,
                window_size: int = 11, val_range=None, full: bool = False):
    """3D-volume SSIM over (C, H, W) of NHWC [B, H, W, C] images:
    replicate pad 5 on C, H and W, the Gaussian over the volume."""
    _, H, W, _ = img1.shape
    L = _val_range(img1, val_range)
    g = _gaussian_1d(min(window_size, H, W))

    def filt(x):
        x = _pad_replicate(x, (1, 2, 3), 5)  # 5 whatever the window
        x = _filter_axis(x, 1, g)  # H
        x = _filter_axis(x, 2, g)  # W
        return _filter_axis(x, 3, g)  # C, the volume axis

    ssim_map, cs = _ssim_terms(img1, img2, filt, (0.01 * L) ** 2,
                               (0.03 * L) ** 2)
    ret = torch.mean(ssim_map)
    return (ret, cs) if full else ret


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         val_range=None, full: bool = False, size_average: bool = True):
    """Per-channel 2D SSIM of NHWC images."""
    _, H, W, _ = img1.shape
    L = _val_range(img1, val_range)
    g = _gaussian_1d(min(window_size, H, W))

    def filt(x):
        x = _pad_replicate(x, (1, 2), 5)
        return _filter_axis(_filter_axis(x, 1, g), 2, g)

    ssim_map, cs = _ssim_terms(img1, img2, filt, (0.01 * L) ** 2,
                               (0.03 * L) ** 2)
    ret = (torch.mean(ssim_map) if size_average
           else torch.mean(ssim_map, dim=(1, 2, 3)))
    return (ret, cs) if full else ret


_MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333],
                           np.float32)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, valid (NHWC), summed in the window's
    row-major order as JAX's reduce_window sums it."""
    _, H, W, _ = x.shape
    x = x[:, :H // 2 * 2, :W // 2 * 2]
    return (((x[:, 0::2, 0::2] + x[:, 0::2, 1::2]) + x[:, 1::2, 0::2])
            + x[:, 1::2, 1::2]) / 4.0


def msssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
           val_range=None, normalize: bool = False):
    """Multi-scale SSIM of NHWC images."""
    mssim, mcs = [], []
    for _ in range(len(_MSSSIM_WEIGHTS)):
        s, cs = ssim(img1, img2, window_size=window_size,
                     val_range=val_range, full=True)
        mssim.append(s)
        mcs.append(cs)
        img1, img2 = _avg_pool2(img1), _avg_pool2(img2)
    mssim = torch.stack(mssim)
    mcs = torch.stack(mcs)
    if normalize:
        mssim = (mssim + 1) / 2
        mcs = (mcs + 1) / 2
    w = torch.from_numpy(_MSSSIM_WEIGHTS).to(mcs.device)
    pow1 = mcs ** w
    pow2 = mssim ** w
    # reference quirk (pytorch_msssim.py:163): the broadcast multiplies
    # pow2[-1] into every pow1 term before the product
    return torch.prod(pow1[:-1] * pow2[-1])


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """-10 log10(MSE); images in [0, 1]."""
    return -10.0 * torch.log10(torch.mean((gt - pred) ** 2))


def ie(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Interpolation error on the rounded uint8 scale."""
    return torch.mean(torch.abs(torch.round(pred * 255.0)
                                - torch.round(gt * 255.0)))

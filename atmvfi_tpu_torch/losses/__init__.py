"""Loss functions of the training path (NHWC tensors).

The port's copy of `atmvfi_tpu/losses/`: Charbonnier, the Laplacian
pyramid loss, census, Sobel, the VGG16 perceptual / style loss and the
pose loss. Every loss is elementwise work, shifted slices and
reductions, except the VGG16 features (`F.conv2d` and the Gram
`torch.matmul`), which the JAX package also computes outside any
kernel of its own.
"""
import torch

from atmvfi_tpu_torch.losses.census import census_loss
from atmvfi_tpu_torch.losses.laplacian import lap_loss, laplacian_pyramid
from atmvfi_tpu_torch.losses.pose import PoseLoss
from atmvfi_tpu_torch.losses.sobel import sobel_loss
from atmvfi_tpu_torch.losses.vgg import VGGPerceptualLoss


def charbonnier_loss(pred, label, eps: float = 1e-6):
    """L1 with Charbonnier smoothing (`atmvfi_tpu/losses/__init__.py`)."""
    return torch.mean(torch.sqrt((pred - label) ** 2 + eps))


__all__ = [
    "census_loss",
    "charbonnier_loss",
    "lap_loss",
    "laplacian_pyramid",
    "PoseLoss",
    "sobel_loss",
    "VGGPerceptualLoss",
]

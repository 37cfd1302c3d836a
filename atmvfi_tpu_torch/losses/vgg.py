"""VGG16 perceptual + Gram-style loss (`atmvfi_tpu/losses/vgg.py`).

VGG16's features up to relu4_3, with weights from an `.npz` in the JAX
package's layout (`{conv}.kernel` HWIO, `{conv}.bias`; its
`export_vgg16_npz` writes one on a machine with torchvision). The
loss ImageNet-normalises both images, runs the four blocks (3x3 convs
+ ReLU, 2x2 max pool), and sums L1 over the four block taps
(perceptual) and the MSE of their Gram matrices (style). The convs are
`F.conv2d` and the Gram products `torch.matmul`, as in the JAX package,
which runs them outside its own kernels; on the card cuDNN takes TF32
for the convs unless `torch.backends.cudnn.allow_tf32` is off.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# VGG16 conv plan up to relu4_3: (name, out_ch); 'M' = 2x2 max pool
VGG16_PLAN: Tuple = (
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512),
)
_BLOCK_ENDS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3")

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def load_vgg16_features(npz_path: str):
    """An exported .npz -> [(weight OIHW, bias)] in plan order (f32 CPU
    tensors)."""
    with np.load(npz_path) as data:
        return [(torch.from_numpy(np.ascontiguousarray(
                    data[f"{p[0]}.kernel"].transpose(3, 2, 0, 1))),
                 torch.from_numpy(np.asarray(data[f"{p[0]}.bias"])))
                for p in VGG16_PLAN if p != "M"]


def _vgg_features(x: torch.Tensor, weights) -> List[torch.Tensor]:
    """NHWC x -> the 4 block activations (relu1_2, relu2_2, relu3_3,
    relu4_3), NHWC."""
    taps = []
    x = x.permute(0, 3, 1, 2)
    wi = 0
    for p in VGG16_PLAN:
        if p == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        w, b = weights[wi]
        wi += 1
        x = F.relu(F.conv2d(x, w.to(x.dtype), b.to(x.dtype), padding=1))
        if p[0] in _BLOCK_ENDS:
            taps.append(x.permute(0, 2, 3, 1))
    return taps


class VGGPerceptualLoss(nn.Module):
    """(pred, target) -> (perceptual loss, style loss); the weights are
    buffers (frozen), so `.to(device)` moves them."""

    def __init__(self, npz_path: str, do_normalize: bool = True,
                 use_perceptual_loss: bool = True,
                 use_style_loss: bool = True):
        super().__init__()
        for i, (w, b) in enumerate(load_vgg16_features(npz_path)):
            self.register_buffer(f"w{i}", w)
            self.register_buffer(f"b{i}", b)
        self.n_convs = i + 1
        self.do_normalize = do_normalize
        self.use_perceptual_loss = use_perceptual_loss
        self.use_style_loss = use_style_loss

    @property
    def weights(self):
        return [(getattr(self, f"w{i}"), getattr(self, f"b{i}"))
                for i in range(self.n_convs)]

    def forward(self, pred: torch.Tensor, target: torch.Tensor):
        target = target.detach()
        if self.do_normalize:
            mean = torch.tensor(_IMAGENET_MEAN, dtype=pred.dtype,
                                device=pred.device)
            std = torch.tensor(_IMAGENET_STD, dtype=pred.dtype,
                               device=pred.device)
            pred = (pred - mean) / std
            target = (target - mean) / std
        weights = self.weights
        fx = _vgg_features(pred, weights)
        fy = _vgg_features(target, weights)
        perceptual = 0.0
        style = 0.0
        for x, y in zip(fx, fy):
            if self.use_perceptual_loss:
                perceptual = perceptual + torch.mean(torch.abs(x - y))
            if self.use_style_loss:
                b, h, w, c = x.shape
                ax = x.reshape(b, h * w, c)
                ay = y.reshape(b, h * w, c)
                gx = torch.matmul(ax.transpose(1, 2), ax)
                gy = torch.matmul(ay.transpose(1, 2), ay)
                style = style + torch.mean((gx - gy) ** 2)
        return perceptual, style

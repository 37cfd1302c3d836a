"""Cross-scale feature fusion.

Counterpart of `atmvfi_tpu/models/fusion.py`: the finer pyramid scales
are brought to the coarsest with strided (and dilated) convs,
concatenated with it along channels, projected 1x1 and layer-normed.
NHWC in and out.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from atmvfi_tpu_torch.models.layers import Conv2d, LayerNorm


class CrossScaleFeatureFusion(nn.Module):
    def __init__(self, in_dims: Tuple[int, ...], fused_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_dims = tuple(in_dims)
        layers = []
        n = len(in_dims)
        for i in range(n - 1):
            feats = in_dims[-2 - i]
            for j in range(2 ** i):
                layers.append(Conv2d(feats, feats, 3, stride=2 ** (i + 1),
                                     padding=1 + j, dilation=1 + j,
                                     dtype=dtype, init="msra"))
        self.layers = nn.ModuleList(layers)
        cat_dim = in_dims[-1] + sum(in_dims[-2 - i] * 2 ** i
                                    for i in range(n - 1))
        self.proj = Conv2d(cat_dim, fused_dim, 1, dtype=dtype, init="msra")
        self.norm = LayerNorm(fused_dim, dtype)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        assert len(xs) == len(self.in_dims)
        ys = []
        k = 0
        for i in range(len(self.in_dims) - 1):
            for _ in range(2 ** i):
                ys.append(self.layers[k](xs[-2 - i]))
                k += 1
        ys.append(xs[-1].to(ys[-1].dtype))
        return self.norm(self.proj(torch.cat(ys, -1)))

"""Divisible-by-N replicate padding for arbitrary input sizes.

Counterpart of `atmvfi_tpu/infer/padder.py`: pads H and W of NHWC
tensors up to the next multiple of `divisor` with edge replication,
split floor-first (top/left), and undoes it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


class InputPadder:
    def __init__(self, dims, divisor: int = 16):
        self.ht, self.wd = dims[-3], dims[-2]  # dims: an NHWC shape
        pad_ht = (((self.ht // divisor) + 1) * divisor - self.ht) % divisor
        pad_wd = (((self.wd // divisor) + 1) * divisor - self.wd) % divisor
        self._pad = (pad_wd // 2, pad_wd - pad_wd // 2,
                     pad_ht // 2, pad_ht - pad_ht // 2)

    def pad(self, *inputs: torch.Tensor):
        outs = [
            F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate")
            .permute(0, 2, 3, 1).contiguous()
            for x in inputs
        ]
        return outs[0] if len(outs) == 1 else outs

    def unpad(self, *inputs: torch.Tensor):
        l, r, t, b = self._pad
        outs = [x[..., t: x.shape[-3] - b, l: x.shape[-2] - r, :]
                for x in inputs]
        return outs[0] if len(outs) == 1 else outs

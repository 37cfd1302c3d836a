"""Model configuration presets (base / lite).

Counterpart of `atmvfi_tpu/models/config.py` without the TPU route
fields: on the card the port always runs its kernels, and on the CPU
their plain versions. `dtype` is the working type of the conv and
attention towers; images, flows, occlusion, warps and blends stay f32.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ATMVFIConfig:
    name: str = "base"
    hidden_dims: Tuple[int, ...] = (24, 48, 96, 192)  # encoder pyramid
    pyramid_level: int = 4
    num_heads: int = 8
    mlp_ratio: float = 4.0
    local_window: int = 8
    global_window: int = 12
    enhance_window: int = 8
    local_mlp_hidden_ratio: float = 0.75  # of fused_dim * 2
    global_mlp_hidden: int = 768
    last_feat_extra: int = 96  # last_feat_dim = hidden_dims[-1] + extra
    refine_hidden: int = 64
    dtype: torch.dtype = torch.float32

    @property
    def fused_dim(self) -> int:
        """Local-branch token width after cross-scale fusion."""
        d = self.hidden_dims
        return d[-1] + d[-2] + 2 * d[-3]

    @property
    def last_feat_dim(self) -> int:
        return self.hidden_dims[-1] + self.last_feat_extra

    @property
    def global_dim(self) -> int:
        """Global-branch token width."""
        return self.last_feat_dim + self.hidden_dims[-1] + 2 * self.hidden_dims[-2]

    @property
    def motion_out_dim(self) -> int:
        return 5  # flow0 (2) + flow1 (2) + occlusion logit (1)

    @property
    def decoder_dims(self) -> Tuple[int, int, int]:
        """Widths of the three coarse-to-fine decoder stages."""
        fd = 2 * self.fused_dim
        return fd // 2, fd // 4, fd // 8

    def with_dtype(self, dtype: torch.dtype) -> "ATMVFIConfig":
        return dataclasses.replace(self, dtype=dtype)


BASE = ATMVFIConfig()

LITE = ATMVFIConfig(
    name="lite",
    hidden_dims=(16, 32, 64, 96),
    mlp_ratio=2.0,
    local_mlp_hidden_ratio=0.5,
    global_mlp_hidden=352,
    last_feat_extra=32,
    refine_hidden=32,
)


def get_config(name: str, dtype: torch.dtype = torch.float32) -> ATMVFIConfig:
    return {"base": BASE, "lite": LITE}[name].with_dtype(dtype)

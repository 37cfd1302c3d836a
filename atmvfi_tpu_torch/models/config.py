"""Model configuration presets (base / lite).

Counterpart of `atmvfi_tpu/models/config.py`. `dtype` is the working
type of the conv and attention towers; images, flows, occlusion, warps
and blends stay f32. On the card the port always runs its kernels, on
the CPU their plain versions.

The JAX route fields select the port's counterparts:

* `attention_impl`: "auto" and "pallas_block" run the fused block
  kernel K1; "pallas" and "xla" (one function) the packed route: LN,
  q / kv / qkv projections (cuBLAS), the attention + motion kernel K7,
  the output projection.
* `warp_impl`: "tiled_blend" and "tiled_blend_unchecked" run the fused
  dual warp + occlusion blend K9 for I_t at every blend site; every
  other value ("auto", "xla", the tiled variants) is the same bilinear
  warp, which K2 computes.
* `hcw_fuse_pairs`: each decoder conv pair and the refine head run as
  one fused conv-pair kernel K12.
* `compose_full_res_warps` (set with `warp_impl="tiled_unchecked"` by
  `fast()`, the serving profile): skip the full-resolution pre-align
  warp and add the upsampled global flow to the scale-0 flows instead.

The JAX package's TPU gates (the window-count gate, tile multiples,
`W >= 384`, `pair_run_fits`) choose TPU layouts, not results: each
kernel here computes the same function at every shape, so the selected
route runs at every site.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

ATTENTION_IMPLS = ("auto", "pallas_block", "pallas", "xla")
WARP_IMPLS = ("auto", "xla", "tiled", "tiled_chw", "tiled_unchecked",
              "tiled_v2", "tiled_v2_unchecked", "tiled_v3",
              "tiled_v3_unchecked", "tiled_nhwc", "tiled_blend",
              "tiled_blend_unchecked")


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
    attention_impl: str = "auto"
    warp_impl: str = "auto"
    compose_full_res_warps: bool = False
    hcw_fuse_pairs: bool = False

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r} is not "
                             f"one of {ATTENTION_IMPLS}")
        if self.warp_impl not in WARP_IMPLS:
            raise ValueError(f"warp_impl {self.warp_impl!r} is not one of "
                             f"{WARP_IMPLS}")

    def fast(self) -> "ATMVFIConfig":
        """Serving profile: the unchecked warp route and composed
        full-resolution warps (one resampling of the full-size frames
        instead of two; an approximation of the default forward)."""
        return dataclasses.replace(self, warp_impl="tiled_unchecked",
                                   compose_full_res_warps=True)

    @property
    def packed_attention(self) -> bool:
        """Attention route: packed (K7) or the fused block (K1)."""
        return self.attention_impl in ("pallas", "xla")

    @property
    def fused_blend(self) -> bool:
        """Blend route: I_t from the fused warp + blend kernel (K9)."""
        return self.warp_impl.startswith("tiled_blend")

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

    def with_windows(self, local: int = None, global_: int = None,
                     enhance: int = None) -> "ATMVFIConfig":
        """The same model with other attention window sizes (the ones
        given; None keeps a field). Parameter shapes do not depend on
        the windows, so the same weights load into either network. The
        card takes any window size: windows above 12 x 12 tokens run the
        attention kernels' key-tiled forms (`ops.attention_cuda`)."""
        kw = {}
        if local is not None:
            kw["local_window"] = local
        if global_ is not None:
            kw["global_window"] = global_
        if enhance is not None:
            kw["enhance_window"] = enhance
        return dataclasses.replace(self, **kw)


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

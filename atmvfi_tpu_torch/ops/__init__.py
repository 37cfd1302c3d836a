"""Tensor ops of the port (NHWC), plain versions and kernel wrappers.

`warp_cuda.flow_warp` / `flow_warp_pair` (kernel K2) and
`attention_cuda.atm_block` (kernel K1) run their CUDA kernels for CUDA
tensors and their plain versions (`warp.flow_warp`,
`attention.atm_block_reference`) for CPU tensors.
"""
from atmvfi_tpu_torch.ops.resize import (
    downsample_2x,
    resize_bilinear,
    resize_scale,
    upsample_flow,
)
from atmvfi_tpu_torch.ops.window import (
    attn_mask_for,
    center_depad,
    center_pad,
    pad_amounts,
    relative_coords,
    window_partition,
    window_reverse,
)

__all__ = [
    "attn_mask_for",
    "center_depad",
    "center_pad",
    "downsample_2x",
    "pad_amounts",
    "relative_coords",
    "resize_bilinear",
    "resize_scale",
    "upsample_flow",
    "window_partition",
    "window_reverse",
]

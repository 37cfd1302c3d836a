"""Tensor ops of the port (NHWC), plain versions and kernel wrappers.

`attention_cuda.atm_block` (kernel K1), `window_attention` /
`window_attention_heads` (K7 / K8), `warp_cuda.flow_warp` /
`flow_warp_pair` (K2), `flow_warp_blend` (K9), `warp_pair_srcfull` (K10)
/ `flow_warp_rows` (its single form), `conv_cuda.conv3x3` /
`conv3x3_s2` / `conv3x3_multi` (K3 / K4 / K5), `conv3x3_pair` (K12) and
`deconv_cuda.deconv2x` (K6) run their CUDA kernels for CUDA tensors and
their plain versions (`attention`, `warp`, `conv`) for CPU tensors.
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

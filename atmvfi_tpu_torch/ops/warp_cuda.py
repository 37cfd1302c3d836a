"""Kernel K2 and K9 wrappers: bilinear backward warp (`csrc/warp.cu`).

`flow_warp` and its pair form `flow_warp_pair` (K2) replace
`atmvfi_tpu/ops/warp_pallas.py::flow_warp_tiled` (v3), its pair form
`warp_pair_op` and the other TPU tilings of the same warp (v1, v2,
nhwc: K11). `flow_warp_blend` (K9) replaces the fused dual warp +
occlusion blend `flow_warp_blend_tiled`. For CPU tensors each wrapper
runs its plain version (`ops.warp`); for CUDA tensors it launches the
kernel or raises. `<fn>.calls` counts the calls on any device,
`<fn>.launches` the kernel launches (one per call on the card).

Images are NHWC with the channel dim contiguous; the pixel stride may
be larger than C, so a channel slice of a wider map
(`feat[..., :fd1]`) is read in place. Flows are f32 [B, H, W, 2]
(x, y). Outputs are new contiguous tensors of the image's dtype.
"""
from __future__ import annotations

import torch

from atmvfi_tpu_torch.ops import _build
from atmvfi_tpu_torch.ops.warp import flow_warp as flow_warp_plain
from atmvfi_tpu_torch.ops.warp import flow_warp_blend as flow_warp_blend_plain

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check(img: torch.Tensor, flow: torch.Tensor) -> int:
    """Validate one (image, flow) operand pair; return the pixel stride."""
    if img.dtype not in _DTYPES:
        raise TypeError(f"warp kernel takes f32/bf16 images, got {img.dtype}")
    if flow.dtype != torch.float32:
        raise TypeError(f"warp kernel takes f32 flows, got {flow.dtype}")
    if img.dim() != 4 or flow.dim() != 4 or flow.shape[-1] != 2:
        raise ValueError(f"bad shapes {tuple(img.shape)} / {tuple(flow.shape)}")
    B, H, W, C = img.shape
    if tuple(flow.shape[:3]) != (B, H, W):
        raise ValueError(f"flow {tuple(flow.shape)} does not match image "
                         f"{tuple(img.shape)}")
    if not flow.is_contiguous():
        raise ValueError("warp kernel needs a contiguous flow")
    ps = img.stride(2)
    if img.stride(3) != 1 or img.stride(1) != W * ps or img.stride(0) != H * W * ps:
        raise ValueError("warp kernel needs NHWC pixels at one stride "
                         f"with contiguous channels, got {img.stride()}")
    if img.device != flow.device:
        raise ValueError("image and flow on different devices")
    return ps


def _launch(imgs, flows):
    ps = _check(imgs[0], flows[0])
    if len(imgs) == 2:
        if (imgs[1].shape != imgs[0].shape or imgs[1].dtype != imgs[0].dtype
                or flows[1].shape != flows[0].shape):
            raise ValueError("pair operands must match in shape and dtype")
        if _check(imgs[1], flows[1]) != ps:
            raise ValueError("pair images must share the pixel stride")
    B, H, W, C = imgs[0].shape
    outs = [torch.empty((B, H, W, C), dtype=i.dtype, device=i.device)
            for i in imgs]
    lib = _build.load_library()
    fn = getattr(lib, f"warp_{_DTYPES[imgs[0].dtype]}")
    second = 1 if len(imgs) == 2 else 0
    with torch.cuda.device(imgs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(imgs[0].data_ptr(), imgs[second].data_ptr(),
                flows[0].data_ptr(), flows[second].data_ptr(),
                outs[0].data_ptr(), outs[second].data_ptr(), len(imgs),
                B, H, W, C, ps, stream)
    _build.check(rc, "warp kernel launch")
    return outs


def flow_warp(feature: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp `feature` [B, H, W, C] by `flow` [B, H, W, 2]."""
    flow_warp.calls += 1
    if feature.device.type == "cpu":
        return flow_warp_plain(feature, flow)
    if feature.device.type != "cuda":
        raise ValueError(f"no warp for device {feature.device}")
    out = _launch([feature], [flow])[0]
    flow_warp.launches += 1
    return out


def flow_warp_pair(im0: torch.Tensor, im1: torch.Tensor, flow0: torch.Tensor,
                   flow1: torch.Tensor):
    """(warp(im0, flow0), warp(im1, flow1)) in one launch on the card."""
    flow_warp_pair.calls += 1
    if im0.device.type == "cpu":
        return flow_warp_plain(im0, flow0), flow_warp_plain(im1, flow1)
    if im0.device.type != "cuda":
        raise ValueError(f"no warp for device {im0.device}")
    out0, out1 = _launch([im0, im1], [flow0, flow1])
    flow_warp_pair.launches += 1
    return out0, out1


def flow_warp_blend(im0: torch.Tensor, im1: torch.Tensor, flow0: torch.Tensor,
                    flow1: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """K9: occ * warp(im0, flow0) + (1 - occ) * warp(im1, flow1) on f32
    images, flows and occlusion [B, H, W, 1]; one f32 output."""
    flow_warp_blend.calls += 1
    if im0.device.type == "cpu":
        return flow_warp_blend_plain(im0, im1, flow0, flow1, occ)
    if im0.device.type != "cuda":
        raise ValueError(f"no warp blend for device {im0.device}")
    if im0.dtype != torch.float32 or im1.dtype != torch.float32:
        raise TypeError("warp blend kernel takes f32 images")
    ps = _check(im0, flow0)
    if (im1.shape != im0.shape or flow1.shape != flow0.shape
            or _check(im1, flow1) != ps):
        raise ValueError("warp blend operands must match in shape and "
                         "pixel stride")
    B, H, W, C = im0.shape
    if (occ.dtype != torch.float32 or tuple(occ.shape) != (B, H, W, 1)
            or not occ.is_contiguous() or occ.device != im0.device):
        raise ValueError(f"occlusion must be contiguous f32 [{B}, {H}, {W}, "
                         f"1] on {im0.device}, got {tuple(occ.shape)}")
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=im0.device)
    lib = _build.load_library()
    with torch.cuda.device(im0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.warp_blend_f32(im0.data_ptr(), im1.data_ptr(),
                                flow0.data_ptr(), flow1.data_ptr(),
                                occ.data_ptr(), out.data_ptr(), B, H, W, C,
                                ps, stream)
    _build.check(rc, "warp blend kernel launch")
    flow_warp_blend.launches += 1
    return out


for _fn in (flow_warp, flow_warp_pair, flow_warp_blend):
    _fn.calls = 0
    _fn.launches = 0

"""Kernel K2, K9 and K10 wrappers: bilinear backward warp (`csrc/warp.cu`).

`flow_warp` and its pair form `flow_warp_pair` (K2) replace
`atmvfi_tpu/ops/warp_pallas.py::flow_warp_tiled` (v3), its pair form
`warp_pair_op` and the other TPU tilings of the same warp (v1, v2,
nhwc: K11). `flow_warp_blend` (K9) replaces the fused dual warp +
occlusion blend `flow_warp_blend_tiled`. `warp_pair_srcfull` (K10)
replaces the slab-row warp pair `planar_warp_pair_srcfull` of the
row-sharded serving schedule, and `flow_warp_rows` is its single form
on feature maps (`atmvfi_tpu/ops/warp.py::flow_warp_rows`, an XLA gather
on the TPU): K2's kernel with a row offset, full sources and the
caller's output rows. For CPU tensors each wrapper
runs its plain version (`ops.warp`); for CUDA tensors it launches the
kernel or raises; with grad enabled and an operand requiring grad the
launch is differentiable through the plain version's VJP
(`ops._autograd`), as the JAX ops' custom VJPs are. `<fn>.calls` counts
the calls on any device, `<fn>.launches` the kernel launches (one per
call on the card).

Images are NHWC with the channel dim contiguous; the pixel stride may
be larger than C, so a channel slice of a wider map
(`feat[..., :fd1]`) is read in place. Flows are f32 [B, H, W, 2]
(x, y). Outputs are new contiguous tensors of the image's dtype.
"""
from __future__ import annotations

import torch

from atmvfi_tpu_torch.ops import _autograd, _build
from atmvfi_tpu_torch.ops.warp import flow_warp as flow_warp_plain
from atmvfi_tpu_torch.ops.warp import flow_warp_blend as flow_warp_blend_plain
from atmvfi_tpu_torch.ops.warp import flow_warp_rows as flow_warp_rows_plain
from atmvfi_tpu_torch.ops.warp import warp_pair_srcfull as srcfull_plain

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check(img: torch.Tensor, flow: torch.Tensor, rows: bool = False) -> int:
    """Validate one (image, flow) operand pair; return the pixel stride.
    With `rows` the flow may cover fewer rows than the image (a warp
    onto a band of output rows)."""
    if img.dtype not in _DTYPES:
        raise TypeError(f"warp kernel takes f32/bf16 images, got {img.dtype}")
    if flow.dtype != torch.float32:
        raise TypeError(f"warp kernel takes f32 flows, got {flow.dtype}")
    if img.dim() != 4 or flow.dim() != 4 or flow.shape[-1] != 2:
        raise ValueError(f"bad shapes {tuple(img.shape)} / {tuple(flow.shape)}")
    B, H, W, C = img.shape
    fB, fH, fW = flow.shape[:3]
    if (fB, fW) != (B, W) or (fH != H and not rows):
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


def _launch_pair(im0, im1, flow0, flow1):
    return tuple(_launch([im0, im1], [flow0, flow1]))


def _pair_plain(im0, im1, flow0, flow1):
    return flow_warp_plain(im0, flow0), flow_warp_plain(im1, flow1)


@_autograd.kernel_wrapper(flow_warp_plain)
def flow_warp(feature: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp `feature` [B, H, W, C] by `flow` [B, H, W, 2]."""
    flow_warp.calls += 1
    if feature.device.type == "cpu":
        return flow_warp_plain(feature, flow)
    if feature.device.type != "cuda":
        raise ValueError(f"no warp for device {feature.device}")
    out = _autograd.launch(lambda f, fl: _launch([f], [fl])[0],
                           flow_warp_plain, feature, flow)
    flow_warp.launches += 1
    return out


@_autograd.kernel_wrapper(_pair_plain)
def flow_warp_pair(im0: torch.Tensor, im1: torch.Tensor, flow0: torch.Tensor,
                   flow1: torch.Tensor):
    """(warp(im0, flow0), warp(im1, flow1)) in one launch on the card."""
    flow_warp_pair.calls += 1
    if im0.device.type == "cpu":
        return _pair_plain(im0, im1, flow0, flow1)
    if im0.device.type != "cuda":
        raise ValueError(f"no warp for device {im0.device}")
    out0, out1 = _autograd.launch(_launch_pair, _pair_plain, im0, im1, flow0,
                                  flow1)
    flow_warp_pair.launches += 1
    return out0, out1


def _launch_blend(im0, im1, flow0, flow1, occ):
    if im0.dtype != torch.float32 or im1.dtype != torch.float32:
        raise TypeError("warp blend kernel takes f32 images")
    ps = _check(im0, flow0)
    if (im1.shape != im0.shape or flow1.shape != flow0.shape
            or _check(im1, flow1) != ps):
        raise ValueError("warp blend operands must match in shape and "
                         "pixel stride")
    B, H, W, C = im0.shape
    if C > 4:
        raise ValueError(f"warp blend kernel takes C <= 4 channels, got {C}")
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
    return out


@_autograd.kernel_wrapper(flow_warp_blend_plain)
def flow_warp_blend(im0: torch.Tensor, im1: torch.Tensor, flow0: torch.Tensor,
                    flow1: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """K9: occ * warp(im0, flow0) + (1 - occ) * warp(im1, flow1) on f32
    images of C <= 4 channels, flows and occlusion [B, H, W, 1]; one f32
    output."""
    flow_warp_blend.calls += 1
    if im0.device.type == "cpu":
        return flow_warp_blend_plain(im0, im1, flow0, flow1, occ)
    if im0.device.type != "cuda":
        raise ValueError(f"no warp blend for device {im0.device}")
    out = _autograd.launch(_launch_blend, flow_warp_blend_plain, im0, im1,
                           flow0, flow1, occ)
    flow_warp_blend.launches += 1
    return out


def _check_row0(row0: int, h_out: int) -> int:
    if isinstance(row0, torch.Tensor) or int(row0) != row0 or row0 < 0:
        raise TypeError(f"row0 must be a Python int >= 0, got {row0!r}")
    if h_out < 1:
        raise ValueError("no output rows")
    return int(row0)


def _launch_srcfull(im0_full, im1_full, flow0, flow1, row0):
    if im0_full.dtype != torch.float32 or im1_full.dtype != torch.float32:
        raise TypeError("K10 takes f32 sources")
    ps = _check(im0_full, flow0, rows=True)
    if (im1_full.shape != im0_full.shape or flow1.shape != flow0.shape
            or _check(im1_full, flow1, rows=True) != ps):
        raise ValueError("K10 operands must match in shape and pixel stride")
    if im0_full.shape[0] != 1:
        raise ValueError("K10 warps one frame pair (B == 1)")
    _, H_src, W, C = im0_full.shape
    H_out = flow0.shape[1]
    outs = [torch.empty((1, H_out, W, C), dtype=torch.float32,
                        device=im0_full.device) for _ in range(2)]
    lib = _build.load_library()
    with torch.cuda.device(im0_full.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.warp_pair_srcfull_f32(
            im0_full.data_ptr(), im1_full.data_ptr(), flow0.data_ptr(),
            flow1.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(), H_out,
            H_src, W, C, ps, row0, stream)
    _build.check(rc, "K10 warp_pair_srcfull launch")
    return outs[0], outs[1]


@_autograd.kernel_wrapper(srcfull_plain)
def warp_pair_srcfull(im0_full: torch.Tensor, im1_full: torch.Tensor,
                      flow0: torch.Tensor, flow1: torch.Tensor, row0: int):
    """K10: full f32 sources [1, H_full, W, C] warped onto output rows
    [row0, row0 + H_out) by the flows of those rows [1, H_out, W, 2],
    row0 folded into the flows' y; two [1, H_out, W, C] f32, one launch."""
    warp_pair_srcfull.calls += 1
    row0 = _check_row0(row0, flow0.shape[1])
    if im0_full.device.type == "cpu":
        return srcfull_plain(im0_full, im1_full, flow0, flow1, row0)
    if im0_full.device.type != "cuda":
        raise ValueError(f"no warp for device {im0_full.device}")
    outs = _autograd.launch(_launch_srcfull, srcfull_plain, im0_full,
                            im1_full, flow0, flow1, row0)
    warp_pair_srcfull.launches += 1
    return outs[0], outs[1]


def _launch_rows(feature, flow_rows, row0):
    ps = _check(feature, flow_rows, rows=True)
    B, H_src, W, C = feature.shape
    H_out = flow_rows.shape[1]
    out = torch.empty((B, H_out, W, C), dtype=feature.dtype,
                      device=feature.device)
    lib = _build.load_library()
    fn = getattr(lib, f"flow_warp_rows_{_DTYPES[feature.dtype]}")
    with torch.cuda.device(feature.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(feature.data_ptr(), flow_rows.data_ptr(), out.data_ptr(), B,
                H_out, H_src, W, C, ps, row0, stream)
    _build.check(rc, "flow_warp_rows launch")
    return out


@_autograd.kernel_wrapper(flow_warp_rows_plain)
def flow_warp_rows(feature: torch.Tensor, flow_rows: torch.Tensor,
                   row0: int) -> torch.Tensor:
    """The full `feature` [B, H, W, C] (f32 / bf16) warped onto output
    rows [row0, row0 + h) by their flows [B, h, W, 2]: row for row equal
    to flow_warp(feature, flow)[:, row0:row0 + h]."""
    flow_warp_rows.calls += 1
    row0 = _check_row0(row0, flow_rows.shape[1])
    if feature.device.type == "cpu":
        return flow_warp_rows_plain(feature, flow_rows, row0)
    if feature.device.type != "cuda":
        raise ValueError(f"no warp for device {feature.device}")
    out = _autograd.launch(_launch_rows, flow_warp_rows_plain, feature,
                           flow_rows, row0)
    flow_warp_rows.launches += 1
    return out


for _fn in (flow_warp, flow_warp_pair, flow_warp_blend, warp_pair_srcfull,
            flow_warp_rows):
    _fn.calls = 0
    _fn.launches = 0

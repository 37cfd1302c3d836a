"""Kernel K1, K7 and K8 wrappers (`csrc/atm_block.cu`).

* `atm_block` (K1) replaces `atmvfi_tpu/ops/attention_pallas.py::
  fused_atm_block`: the fused block core, three launches behind one
  call (see the source). Plain version `ops.attention.
  atm_block_reference`.
* `window_attention` (K7) replaces `fused_window_attention_packed`:
  attention + motion from packed q [BW, N, C] and kv [BW, N, 2C], which
  may be column blocks of a wider projection (any window and token
  stride, contiguous channels). Plain version `ops.attention.
  window_attention`.
* `window_attention_heads` (K8) replaces `fused_window_attention`: the
  same on head-major q, k, v [BW, h, N, d], through K7's kernel. Plain
  version `ops.attention.window_attention_heads`.

The attention launch (K7, K8 and K1's second launch) runs bf16 on the
tensor cores (`attn_mma_kernel`: mma.sync, head dims padded to 16 in
shared memory) and f32 as true f32 on the CUDA cores (`attn_kernel`,
the parity mode). A window of any size is taken: up to the library's
`attention_single_pass_keys()` keys (160: window 12) the kernels hold
the whole window; above it key-tiled forms with an online softmax run
(`<fn>.tiled_launches` counts each wrapper's launches of them). Those
read the mask and rel in a compact form where one exists: per-window
token labels (`ops.attention.region_labels`) and key coordinates
(`grid_coords`), derived and checked exactly once per mask / rel
tensor (`_compact`, cached with the tensor); any other mask or rel
runs their general form, which stages mask and rel tiles
(`<fn>.general_launches` counts those launches, from the operands each
launch passed).
Head dims are at most 128. For CPU tensors each wrapper runs its plain version;
for CUDA tensors it launches the kernel or raises, differentiably through
the plain version's VJP when grad is on (`ops._autograd`). `<fn>.calls` counts the calls on any
device, `<fn>.launches` the calls that launched the kernel.

K1's bf16 GEMM launches (q/kv after a LayerNorm pass, projection) run
on wgmma with TMA-fed shared-memory tiles (`csrc/atm_block.cu`,
namespace lg); the LayerNorm pass takes C <= 1024 (`MAX_BF16_C`).
Its weights are packed once per weight in x's dtype ([wq | wkv], wproj,
bproj; `_packs`, with the bf16 packs' tensor maps) and made anew after
an in-place update; the LayerNorm parameters, `rel` and `mask` are read
as f32. The mask is [M, N, N] with BW % M == 0: the
kernel reads mask[w % M], so the per-image window masks are never
tiled over the batch. Outputs and scratch are allocated here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from atmvfi_tpu_torch.ops import _autograd, _build
from atmvfi_tpu_torch.ops.attention import (
    atm_block_reference,
    grid_coords,
    region_labels,
    window_attention as window_attention_plain,
    window_attention_heads as window_attention_heads_plain,
)
from atmvfi_tpu_torch.ops.conv_cuda import cached_pack

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_HEAD_DIM = 128
MAX_BF16_C = 1024  # channels of a bf16 block (K1's LayerNorm pass)


def _f32(t: Optional[torch.Tensor], dev) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dev, torch.float32).contiguous()


def _mask_rel(mask, rel, BW: int, N: int, dev):
    """(mask f32 or None, its window count, rel f32 or None), checked."""
    rel_f, mask_f = _f32(rel, dev), _f32(mask, dev)
    mask_windows = 0
    if mask_f is not None:
        mask_windows = mask_f.shape[0]
        if tuple(mask_f.shape[1:]) != (N, N) or BW % mask_windows:
            raise ValueError(f"mask {tuple(mask_f.shape)} does not tile "
                             f"BW={BW} windows of N={N}")
    if rel_f is not None and tuple(rel_f.shape) != (2, N, N):
        raise ValueError(f"rel must be [2, {N}, {N}], got {tuple(rel_f.shape)}")
    return mask_f, mask_windows, rel_f


def _tiled(N: int) -> int:
    """1 when the attention launch runs its key-tiled form at N keys a
    window (the library's own threshold), else 0."""
    return int(N > _build.load_library().attention_single_pass_keys())


def _window_labels(mask_f) -> Optional[torch.Tensor]:
    """The kernels' label buffer of a region mask [M, N, N]: its labels
    [M, N] (`region_labels`), then M flags, 1 for a mask window whose
    labels differ (0: no key of it is masked); None for another mask."""
    labels = region_labels(mask_f)
    if labels is None:
        return None
    mixed = (labels != labels[:, :1]).any(1).to(torch.int32)
    return torch.cat([labels.reshape(-1), mixed])


def _compact(mask_f, rel_f, N: int):
    """(labels, coords, general): the compact forms of the f32 mask and
    rel that the key-tiled kernels read, each None where the launch at N
    keys is single-pass, the tensor is absent or not of that form; and
    whether the launch runs the general form (key-tiled, and a given mask
    or rel without its compact form). Derived and checked once per tensor
    (cached with it, made anew after an in-place update)."""
    if (mask_f is None and rel_f is None) or not _tiled(N):
        return None, None, False
    labels = None if mask_f is None else cached_pack(
        mask_f, "labels", torch.int32, lambda: _window_labels(mask_f))
    coords = None if rel_f is None else cached_pack(
        rel_f, "coords", torch.float32, lambda: grid_coords(rel_f))
    general = ((mask_f is not None and labels is None)
               or (rel_f is not None and coords is None))
    return labels, coords, general


def _count_tiled(fn, N: int, general: bool) -> None:
    """One launch of fn's kernel at N keys a window: key-tiled or not,
    and general or not (`_compact`)."""
    fn.tiled_launches += _tiled(N)
    fn.general_launches += general


def _packs(wq, wkv, wproj, bproj, dt):
    """([wq | wkv], wproj, bproj) in the working type, made once per
    weight (`conv_cuda.cached_pack`: anew after an in-place update of any
    of them). The enhancement block's wq and wkv are two row blocks of
    one qkv weight: its pack lives with that weight."""
    owner = wq if wq._base is None else wq._base
    wqkv = cached_pack(owner, "qkv", dt, lambda: torch.cat(
        [wq.detach(), wkv.detach()], 0).to(dt).contiguous(), deps=(wq, wkv))
    wp = cached_pack(wproj, "proj", dt,
                     lambda: wproj.detach().to(dt).contiguous())
    bp = cached_pack(bproj, "bias", dt,
                     lambda: bproj.detach().to(dt).contiguous())
    return wqkv, wp, bp


def _weight_map(w: torch.Tensor):
    """(w, the 128-byte tensor map of bf16 w [N, K] for K1's GEMM
    kernel)."""
    tmap = ctypes.create_string_buffer(128)
    with torch.cuda.device(w.device):
        rc = _build.load_library().atm_block_weight_map(
            w.data_ptr(), w.shape[0], w.shape[1], tmap)
    _build.check(rc, f"ATM block weight map for {tuple(w.shape)}")
    return w, tmap


def _weight_maps(wq, wkv, wproj, wqkv, wp):
    """The tensor maps of the bf16 packs wqkv and wp, back to back (256
    bytes), each cached with its pack. Raises for a shape the GEMM does
    not take."""
    owner = wq if wq._base is None else wq._base
    maps = [cached_pack(w, kind, torch.bfloat16, make, deps=deps)[1].raw
            for w, kind, make, deps in (
                (owner, "qkv map", lambda: _weight_map(wqkv), (wq, wkv)),
                (wproj, "proj map", lambda: _weight_map(wp), ()))]
    return ctypes.create_string_buffer(b"".join(maps), 256)


def _block_call(x, wq, wkv, wproj, bproj, ln_g, ln_b, scale, rel, mask,
                num_heads, swap_halves):
    """(entry arguments but the stream, y, motion, scratch) of one K1
    call: operands checked, weight packs cached, outputs and scratch
    (xn, qkv, app) allocated."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"ATM block kernel takes f32/bf16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"ATM block kernel needs contiguous [BW, N, C], "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    BW, N, C = x.shape
    h = num_heads
    if C % h or C % 8 or C // h > MAX_HEAD_DIM or (
            x.dtype == torch.bfloat16 and C > MAX_BF16_C):
        raise ValueError(f"unsupported block shape N={N} C={C} heads={h}")
    if swap_halves and BW % 2:
        raise ValueError(f"frame swap needs an even window count, got {BW}")
    if tuple(wq.shape) != (C, C) or tuple(wkv.shape) != (2 * C, C) \
            or tuple(wproj.shape) != (C, C) or tuple(bproj.shape) != (C,):
        raise ValueError("weights must be nn.Linear [out, in]: wq [C, C], "
                         "wkv [2C, C], wproj [C, C], bproj [C]")
    dev, dt = x.device, x.dtype
    wqkv, wp, bp = _packs(wq, wkv, wproj, bproj, dt)
    maps = (_weight_maps(wq, wkv, wproj, wqkv, wp) if dt == torch.bfloat16
            else None)
    g, b = _f32(ln_g, dev), _f32(ln_b, dev)
    mask_f, mask_windows, rel_f = _mask_rel(mask, rel, BW, N, dev)
    labels, coords, general = _compact(mask_f, rel_f, N)
    xn = torch.empty_like(x)
    qkv = torch.empty((BW, N, 3 * C), dtype=dt, device=dev)
    app = torch.empty_like(x)
    y = torch.empty_like(x)
    motion = (torch.empty((BW, N, 2 * h), dtype=dt, device=dev)
              if rel_f is not None else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    argv = (x.data_ptr(), wqkv.data_ptr(), wp.data_ptr(), bp.data_ptr(),
            maps, g.data_ptr(), b.data_ptr(), ptr(rel_f), ptr(mask_f),
            mask_windows, ptr(labels), ptr(coords), xn.data_ptr(),
            qkv.data_ptr(), app.data_ptr(), y.data_ptr(), ptr(motion), BW,
            N, C, h, int(swap_halves), float(scale))
    keep = (x, wqkv, wp, bp, maps, g, b, rel_f, mask_f, labels, coords)
    return argv, y, motion, dict(xn=xn, qkv=qkv, app=app, keep=keep,
                                 general=general)


def _launch_block(*args):
    argv, y, motion, scratch = _block_call(*args)
    x = args[0]
    fn = getattr(_build.load_library(), f"atm_block_{_DTYPES[x.dtype]}")
    with torch.cuda.device(x.device):
        rc = fn(*argv, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "ATM block kernel launch")
    _count_tiled(atm_block, x.shape[1], scratch["general"])
    return y, motion


def block_launches(*args):
    """K1's launches one at a time, for timing them apart: returns
    (run, buffers), where run(launch) issues launch 1 (LayerNorm + q/kv
    GEMM), 2 (attention) or 3 (projection GEMM) alone on the operands and
    scratch of one call (`atm_block`'s arguments), and buffers holds that
    scratch (xn, qkv, app) and the outputs (y, motion). A first run(0)
    fills the scratch."""
    argv, y, motion, scratch = _block_call(*args)
    x = args[0]
    fn = getattr(_build.load_library(),
                 f"atm_block_launch_{_DTYPES[x.dtype]}")

    def run(launch: int):
        with torch.cuda.device(x.device):
            rc = fn(launch, *argv,
                    torch.cuda.current_stream().cuda_stream)
        _build.check(rc, f"ATM block launch {launch}")

    return run, dict(scratch, y=y, motion=motion)


@_autograd.kernel_wrapper(atm_block_reference)
def atm_block(x, wq, wkv, wproj, bproj, ln_g, ln_b, scale: float,
              rel: Optional[torch.Tensor], mask: Optional[torch.Tensor],
              num_heads: int, swap_halves: bool):
    """Fused block core on packed windows; returns (y, motion | None)."""
    atm_block.calls += 1
    if x.device.type == "cpu":
        return atm_block_reference(x, wq, wkv, wproj, bproj, ln_g, ln_b,
                                   scale, rel, mask, num_heads, swap_halves)
    if x.device.type != "cuda":
        raise ValueError(f"no ATM block for device {x.device}")
    y, motion = _autograd.launch(_launch_block, atm_block_reference, x, wq,
                                 wkv, wproj, bproj, ln_g, ln_b, scale, rel,
                                 mask, num_heads, swap_halves)
    atm_block.launches += 1
    return y, motion


def _attention_launch(wrapper, views, out, motion, rel, mask, BW: int,
                      N: int, hd: int, heads: int, scale: float):
    """Launch the window-attention kernel for `wrapper` (K7 or K8, whose
    key-tiled counts it adds to). views: (pointer, (sw, sh, sn)) of q, k,
    v; out / motion: (tensor, strides), motion's tensor None without
    rel."""
    q = out[0]
    if q.dtype not in _DTYPES:
        raise TypeError(f"window attention takes f32/bf16, got {q.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"unsupported head_dim={hd} (at most "
                         f"{MAX_HEAD_DIM})")
    dev = q.device
    mask_f, mask_windows, rel_f = _mask_rel(mask, rel, BW, N, dev)
    labels, coords, general = _compact(mask_f, rel_f, N)
    if (rel_f is None) != (motion[0] is None):
        raise ValueError("motion is computed exactly when rel is given")
    strides = (ctypes.c_int64 * 15)(*[s for _, st in views for s in st],
                                    *out[1], *motion[1])
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = getattr(_build.load_library(), f"window_attention_{_DTYPES[q.dtype]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(views[0][0], views[1][0], views[2][0], strides,
                out[0].data_ptr(), ptr(motion[0]), ptr(rel_f), ptr(mask_f),
                mask_windows, ptr(labels), ptr(coords), BW, N, hd, heads,
                float(scale), stream)
    _build.check(rc, "window attention kernel launch")
    _count_tiled(wrapper, N, general)


def _on_card(t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version); raises off CPU and CUDA."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no window attention for device {t.device}")
    return True


def _launch_packed(q, kv, scale, rel, mask, num_heads):
    BW, N, C = q.shape
    h = num_heads
    if (tuple(kv.shape) != (BW, N, 2 * C) or kv.dtype != q.dtype
            or kv.device != q.device or C % h):
        raise ValueError(f"q {tuple(q.shape)} / kv {tuple(kv.shape)} "
                         f"({kv.dtype}) with {h} heads")
    if q.stride(2) != 1 or kv.stride(2) != 1:
        raise ValueError("window attention needs contiguous channels")
    hd = C // h
    kv_view = (kv.stride(0), hd, kv.stride(1))
    views = [(q.data_ptr(), (q.stride(0), hd, q.stride(1))),
             (kv.data_ptr(), kv_view),
             (kv.data_ptr() + C * kv.element_size(), kv_view)]
    out = torch.empty((BW, N, C), dtype=q.dtype, device=q.device)
    motion = (torch.empty((BW, N, 2 * h), dtype=q.dtype, device=q.device)
              if rel is not None else None)
    _attention_launch(window_attention, views, (out, (N * C, hd, C)),
                      (motion, (N * 2 * h, 2, 2 * h)), rel, mask, BW, N, hd,
                      h, scale)
    return out, motion


@_autograd.kernel_wrapper(window_attention_plain)
def window_attention(q, kv, scale: float, rel: Optional[torch.Tensor],
                     mask: Optional[torch.Tensor], num_heads: int):
    """K7: attention + motion on packed q [BW, N, C], kv [BW, N, 2C];
    returns (out [BW, N, C], motion [BW, N, 2h] | None) in q's type."""
    window_attention.calls += 1
    if not _on_card(q):
        return window_attention_plain(q, kv, scale, rel, mask, num_heads)
    out, motion = _autograd.launch(_launch_packed, window_attention_plain, q,
                                   kv, scale, rel, mask, num_heads)
    window_attention.launches += 1
    return out, motion


def _launch_heads(q, k, v, scale, rel, mask):
    BW, h, N, d = q.shape
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v must match in shape, type and device")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("window attention needs contiguous head channels")
    views = [(t.data_ptr(), t.stride()[:3]) for t in (q, k, v)]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    motion = (torch.empty((BW, h, N, 2), dtype=q.dtype, device=q.device)
              if rel is not None else None)
    _attention_launch(window_attention_heads, views,
                      (out, (h * N * d, N * d, d)),
                      (motion, (h * N * 2, N * 2, 2)), rel, mask, BW, N, d,
                      h, scale)
    return out, motion


@_autograd.kernel_wrapper(window_attention_heads_plain)
def window_attention_heads(q, k, v, scale: float,
                           rel: Optional[torch.Tensor],
                           mask: Optional[torch.Tensor]):
    """K8: attention + motion on head-major q, k, v [BW, h, N, d];
    returns (out [BW, h, N, d], motion [BW, h, N, 2] | None)."""
    window_attention_heads.calls += 1
    if not _on_card(q):
        return window_attention_heads_plain(q, k, v, scale, rel, mask)
    out, motion = _autograd.launch(_launch_heads,
                                   window_attention_heads_plain, q, k, v,
                                   scale, rel, mask)
    window_attention_heads.launches += 1
    return out, motion


for _fn in (atm_block, window_attention, window_attention_heads):
    _fn.calls = 0
    _fn.launches = 0
    _fn.tiled_launches = 0
    _fn.general_launches = 0

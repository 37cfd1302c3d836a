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
the parity mode). For CPU tensors each wrapper runs its plain version;
for CUDA tensors it launches the kernel or raises. `<fn>.calls` counts the calls on any
device, `<fn>.launches` the calls that launched the kernel.

Weights are cast to x's dtype (f32 or bf16), the LayerNorm parameters,
`rel` and `mask` to f32. The mask is [M, N, N] with BW % M == 0: the
kernel reads mask[w % M], so the per-image window masks are never
tiled over the batch. Outputs and scratch are allocated here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from atmvfi_tpu_torch.ops import _build
from atmvfi_tpu_torch.ops.attention import (
    atm_block_reference,
    window_attention as window_attention_plain,
    window_attention_heads as window_attention_heads_plain,
)

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_N = 160  # keys per window the kernel holds (5 per lane)
MAX_HEAD_DIM = 128


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
    if x.dtype not in _DTYPES:
        raise TypeError(f"ATM block kernel takes f32/bf16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"ATM block kernel needs contiguous [BW, N, C], "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    BW, N, C = x.shape
    h = num_heads
    if C % h or C % 8 or C // h > MAX_HEAD_DIM or N > MAX_N:
        raise ValueError(f"unsupported block shape N={N} C={C} heads={h}")
    if swap_halves and BW % 2:
        raise ValueError(f"frame swap needs an even window count, got {BW}")
    if tuple(wq.shape) != (C, C) or tuple(wkv.shape) != (2 * C, C) \
            or tuple(wproj.shape) != (C, C) or tuple(bproj.shape) != (C,):
        raise ValueError("weights must be nn.Linear [out, in]: wq [C, C], "
                         "wkv [2C, C], wproj [C, C], bproj [C]")
    dev, dt = x.device, x.dtype
    wqkv = torch.cat([wq, wkv], 0).to(dt).contiguous()
    wp = wproj.to(dt).contiguous()
    bp = bproj.to(dt).contiguous()
    g, b = _f32(ln_g, dev), _f32(ln_b, dev)
    mask_f, mask_windows, rel_f = _mask_rel(mask, rel, BW, N, dev)
    xn = torch.empty_like(x)
    qkv = torch.empty((BW, N, 3 * C), dtype=dt, device=dev)
    app = torch.empty_like(x)
    y = torch.empty_like(x)
    motion = (torch.empty((BW, N, 2 * h), dtype=dt, device=dev)
              if rel_f is not None else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = getattr(_build.load_library(), f"atm_block_{_DTYPES[dt]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), wqkv.data_ptr(), wp.data_ptr(), bp.data_ptr(),
                g.data_ptr(), b.data_ptr(), ptr(rel_f), ptr(mask_f),
                mask_windows, xn.data_ptr(), qkv.data_ptr(), app.data_ptr(),
                y.data_ptr(), ptr(motion), BW, N, C, h, int(swap_halves),
                float(scale), stream)
    _build.check(rc, "ATM block kernel launch")
    atm_block.launches += 1
    return y, motion


def _attention_launch(views, out, motion, rel, mask, BW: int, N: int,
                      hd: int, heads: int, scale: float):
    """Launch K7's kernel. views: (pointer, (sw, sh, sn)) of q, k, v;
    out / motion: (tensor, strides), motion's tensor None without rel."""
    q = out[0]
    if q.dtype not in _DTYPES:
        raise TypeError(f"window attention takes f32/bf16, got {q.dtype}")
    if N > MAX_N or hd > MAX_HEAD_DIM:
        raise ValueError(f"unsupported window N={N} head_dim={hd}")
    dev = q.device
    mask_f, mask_windows, rel_f = _mask_rel(mask, rel, BW, N, dev)
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
                mask_windows, BW, N, hd, heads, float(scale), stream)
    _build.check(rc, "window attention kernel launch")


def _on_card(t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version); raises off CPU and CUDA."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no window attention for device {t.device}")
    return True


def window_attention(q, kv, scale: float, rel: Optional[torch.Tensor],
                     mask: Optional[torch.Tensor], num_heads: int):
    """K7: attention + motion on packed q [BW, N, C], kv [BW, N, 2C];
    returns (out [BW, N, C], motion [BW, N, 2h] | None) in q's type."""
    window_attention.calls += 1
    if not _on_card(q):
        return window_attention_plain(q, kv, scale, rel, mask, num_heads)
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
    _attention_launch(views, (out, (N * C, hd, C)),
                      (motion, (N * 2 * h, 2, 2 * h)), rel, mask, BW, N, hd,
                      h, scale)
    window_attention.launches += 1
    return out, motion


def window_attention_heads(q, k, v, scale: float,
                           rel: Optional[torch.Tensor],
                           mask: Optional[torch.Tensor]):
    """K8: attention + motion on head-major q, k, v [BW, h, N, d];
    returns (out [BW, h, N, d], motion [BW, h, N, 2] | None)."""
    window_attention_heads.calls += 1
    if not _on_card(q):
        return window_attention_heads_plain(q, k, v, scale, rel, mask)
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
    _attention_launch(views, (out, (h * N * d, N * d, d)),
                      (motion, (h * N * 2, N * 2, 2)), rel, mask, BW, N, d,
                      h, scale)
    window_attention_heads.launches += 1
    return out, motion


for _fn in (atm_block, window_attention, window_attention_heads):
    _fn.calls = 0
    _fn.launches = 0

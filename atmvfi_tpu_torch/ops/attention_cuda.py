"""Kernel K1 wrapper: the fused ATM block core (`csrc/atm_block.cu`).

Replaces `atmvfi_tpu/ops/attention_pallas.py::fused_atm_block`. Same
arguments and results as the plain version
`ops.attention.atm_block_reference`, which runs for CPU tensors; for
CUDA tensors the wrapper launches the kernel (three launches behind one
call, see the source) or raises. `atm_block.launches` counts the calls
that launched it.

Weights are cast to x's dtype (f32 or bf16), the LayerNorm parameters,
`rel` and `mask` to f32. The mask is [M, N, N] with BW % M == 0: the
kernel reads mask[w % M], so the per-image window masks are never
tiled over the batch. Outputs and scratch are allocated here.
"""
from __future__ import annotations

from typing import Optional

import torch

from atmvfi_tpu_torch.ops import _build
from atmvfi_tpu_torch.ops.attention import atm_block_reference

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_N = 160  # keys per window the kernel holds (5 per lane)
MAX_HEAD_DIM = 128


def _f32(t: Optional[torch.Tensor], dev) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dev, torch.float32).contiguous()


def atm_block(x, wq, wkv, wproj, bproj, ln_g, ln_b, scale: float,
              rel: Optional[torch.Tensor], mask: Optional[torch.Tensor],
              num_heads: int, swap_halves: bool):
    """Fused block core on packed windows; returns (y, motion | None)."""
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
    rel_f, mask_f = _f32(rel, dev), _f32(mask, dev)
    mask_windows = 0
    if mask_f is not None:
        mask_windows = mask_f.shape[0]
        if tuple(mask_f.shape[1:]) != (N, N) or BW % mask_windows:
            raise ValueError(f"mask {tuple(mask_f.shape)} does not tile "
                             f"BW={BW} windows of N={N}")
    if rel_f is not None and tuple(rel_f.shape) != (2, N, N):
        raise ValueError(f"rel must be [2, {N}, {N}], got {tuple(rel_f.shape)}")
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


atm_block.launches = 0

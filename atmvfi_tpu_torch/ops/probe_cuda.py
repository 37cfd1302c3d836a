"""Row P's probes on the card: the gridded matmul and K2's spread gather.

* `grid_matmul` replaces the toy Pallas kernel of `tests/test_roofline.py:
  56`: out = a @ b in f32 with f32 sums, one block per 64-row tile
  (`csrc/grid_matmul.cu`). Its plain version `grid_matmul_plain` walks
  the same grid, one [64, K] @ [K, N] product a block, so the counted
  roofline (`utils.roofline.count_flops`) sees the grid: exactly
  2 * 2 * 64 * 64 * 64 = 1,048,576 tc FLOPs for [128, 64] @ [64, 64],
  on the CPU and on card tensors alike. For CPU tensors the wrapper runs
  the plain version; for CUDA tensors it launches the kernel or raises.
  `grid_matmul.calls` counts the calls, `.launches` the launches.
* `spread_gather_case` is the warp-v2 loop probes' question
  (`scripts/pallas_probe4.py`, p1-p6): the per-pixel gather of p6, whose
  output pixel (i, l) of an 8 x 128 tile reads row 9 + i + (l % 3) (a
  row spread of 3) and column (7 l + i) % 128 of a 64 x 128 f32 map,
  written as an integer flow for K2 (`warp_cuda.flow_warp` /
  `flow_warp_pair`). Every bilinear tap but one has weight 0, so the
  warp must equal numpy's x[row, col] exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from atmvfi_tpu_torch.ops import _autograd, _build

TILE = 64  # output rows a block (the Pallas kernel's block)


def grid_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b block by block over the kernel's grid of 64-row tiles."""
    return torch.cat([a[r:r + TILE] @ b for r in range(0, a.shape[0], TILE)],
                     0)


def _launch(a, b):
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"grid_matmul takes f32, got {a.dtype} / {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("grid_matmul needs contiguous operands")
    if a.device != b.device:
        raise ValueError("operands on different devices")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = _build.load_library().grid_matmul_f32(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "grid_matmul kernel launch")
    return out


@_autograd.kernel_wrapper(grid_matmul_plain)
def grid_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N], f32, one block per 64-row tile on the card."""
    grid_matmul.calls += 1
    if a.device.type == "cpu":
        return grid_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no grid_matmul for device {a.device}")
    out = _autograd.launch(_launch, grid_matmul_plain, a, b)
    grid_matmul.launches += 1
    return out


grid_matmul.calls = 0
grid_matmul.launches = 0


def spread_gather_case(H: int = 64, W: int = 128, seed: int = 0):
    """(x [1, H, W, 1] f32, flow [1, H, W, 2] f32, want [1, H, W, 1]):
    p6's gather over the whole map, output pixel (i, l) reading row
    (9 + i + l % 3) % H and column (7 l + i) % W of x, as an integer
    flow; want is numpy's x[row, col]. Values are bf16-exact, so the
    same case checks the bf16 warp."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((H, W)).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    i = np.arange(H)[:, None]
    col_l = np.arange(W)[None, :]
    row = (9 + i + col_l % 3) % H
    col = (7 * col_l + i) % W
    flow = np.stack([col - col_l, row - i], -1).astype(np.float32)
    return (x.reshape(1, H, W, 1), flow.reshape(1, H, W, 2),
            x[row, col].reshape(1, H, W, 1))

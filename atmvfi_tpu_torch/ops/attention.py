"""Window attention + motion moment: the plain PyTorch versions.

* `window_attention`: packed q [BW, N, C], kv [BW, N, 2C]; counterpart
  of `atmvfi_tpu/ops/attention_pallas.py::_packed_reference` and the
  plain version of kernel K7.
* `window_attention_heads`: head-major q, k, v [BW, h, N, d];
  counterpart of `reference_window_attention` and the plain version of
  K8 (K7's kernel at head-major strides).
* `atm_block_reference`: the fused block core; counterpart of
  `_block_reference` and the plain version of K1.

Per window and head: p = softmax(q k^T * scale + mask) in f32, out =
round_T(p) @ v, motion = (sum_k p * rel_x, sum_k p * rel_y) from the f32
p. `mask` is [M, N, N] with BW % M == 0 (window w uses mask[w % M]) or
None; `rel` is [2, N, N] or None (no motion).

The block core (`ops.attention_cuda.atm_block`), on packed windows
x [BW, N, C]:

    xn = LayerNorm(x)                     (f32 statistics, eps 1e-5)
    q = xn Wq^T, kv = xs Wkv^T            (xs = xn of the partner window
                                           (i + BW/2) mod BW when
                                           swap_halves, else xn)
    p = softmax(q k^T * scale + mask)     per head, in f32
    app = p v;  motion = sum_k p * rel    (motion from the f32 p)
    y = xn + app Wproj^T + bproj          (residual onto norm1(x))

Weights are in nn.Linear layout [out, in]; `wkv` stacks k over v.
Returns (y [BW, N, C], motion [BW, N, 2h] as (mx, my) per head, or
None), both in x.dtype.

The compact forms that the card's key-tiled kernels (windows above 12)
read instead of mask and rel: `region_labels` (one integer a token per
mask window, mask = MASK_NEG where two labels differ) and `grid_coords`
(rel[d, q, k] = c_d(k) - c_d(q)), each checked exactly against the
tensor it replaces.
"""
from __future__ import annotations

from typing import Optional

import torch

from atmvfi_tpu_torch.ops.window import MASK_NEG


def layer_norm_f32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with f32 statistics; returns f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def window_attention_heads(q, k, v, scale: float,
                           rel: Optional[torch.Tensor],
                           mask: Optional[torch.Tensor]):
    """Attention + motion on head-major q, k, v [BW, h, N, d]; returns
    (out [BW, h, N, d], motion [BW, h, N, 2] or None) in q.dtype."""
    BW, h, N, _ = q.shape
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        M = mask.shape[0]
        attn = (attn.reshape(BW // M, M, h, N, N)
                + mask.float()[None, :, None]).reshape(BW, h, N, N)
    p = torch.softmax(attn, dim=-1)  # f32
    out = torch.matmul(p.to(q.dtype), v)
    motion = None
    if rel is not None:
        motion = torch.einsum("bhqk,dqk->bhqd", p, rel.float()).to(q.dtype)
    return out, motion


def window_attention(q, kv, scale: float, rel: Optional[torch.Tensor],
                     mask: Optional[torch.Tensor], num_heads: int):
    """Attention + motion moment on packed q [BW, N, C], kv [BW, N, 2C];
    returns (out [BW, N, C], motion [BW, N, 2h] or None)."""
    BW, N, C = q.shape
    h = num_heads

    def heads(t):
        return t.reshape(BW, N, h, C // h).transpose(1, 2)

    out, motion = window_attention_heads(heads(q), heads(kv[..., :C]),
                                         heads(kv[..., C:]), scale, rel,
                                         mask)
    out = out.transpose(1, 2).reshape(BW, N, C)
    if motion is not None:
        motion = motion.transpose(1, 2).reshape(BW, N, 2 * h)
    return out, motion


def atm_block_reference(x, wq, wkv, wproj, bproj, ln_g, ln_b, scale: float,
                        rel: Optional[torch.Tensor],
                        mask: Optional[torch.Tensor], num_heads: int,
                        swap_halves: bool):
    """Plain fused-block core; see the module docstring."""
    BW, N, C = x.shape
    dt = x.dtype
    xn = layer_norm_f32(x, ln_g, ln_b).to(dt)
    xs = torch.roll(xn, -(BW // 2), 0) if swap_halves else xn
    q = (xn.reshape(-1, C) @ wq.to(dt).t()).reshape(BW, N, C)
    kv = (xs.reshape(-1, C) @ wkv.to(dt).t()).reshape(BW, N, 2 * C)
    app, motion = window_attention(q, kv, scale, rel, mask, num_heads)
    out = (app.reshape(-1, C) @ wproj.to(dt).t()).reshape(BW, N, C)
    out = out + bproj.to(dt)
    return (xn + out).to(dt), motion


def region_labels(mask: torch.Tensor) -> Optional[torch.Tensor]:
    """Labels [M, N] int32 with mask[w, q, k] = MASK_NEG where labels[w, q]
    != labels[w, k] and 0 elsewhere, exactly, for a mask [M, N, N]; None
    when the mask is not of that form. A token's label is its first
    unmasked key (the first of its region)."""
    labels = (mask == 0).to(torch.uint8).argmax(-1).to(torch.int32)
    same = labels[:, :, None] == labels[:, None, :]
    made = torch.where(same, 0.0, MASK_NEG).to(mask.dtype)
    return labels if torch.equal(made, mask) else None


def grid_coords(rel: torch.Tensor) -> Optional[torch.Tensor]:
    """Coordinates c [2, N] f32 with rel[d, q, k] = c[d, k] - c[d, q]
    exactly, for rel [2, N, N] (c = rel[:, 0]: the first token at 0);
    None when rel is not such a difference."""
    c = rel[:, 0].float().contiguous()
    made = (c[:, None, :] - c[:, :, None]).to(rel.dtype)
    return c if torch.equal(made, rel) else None

"""The bf16 contract of the window-attention launch (K1's attention
launch, K7, K8) at the shapes where its tensor-core kernel pads: the
port's plain `window_attention` in bf16 against the JAX package's
`fused_window_attention_packed` in interpret mode. The plain version is
the yardstick `chip_smoke.py` holds the kernel to on the card, so it
must round where JAX rounds: scores and softmax in f32, p rounded to
bf16 before `@ v` (f32 sums), motion from the f32 p, both outputs
rounded once to bf16."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from atmvfi_tpu.ops import attention_pallas as jap
from atmvfi_tpu_torch import ops
from atmvfi_tpu_torch.ops import attention as attn_plain

torch.set_num_threads(2)  # the test workers share the CPU

HEADS, BW, MASK_WINDOWS = 2, 4, 2


def _bf16_pair(a: np.ndarray):
    """The same bf16 values as a torch tensor and a jax array."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _beyond_one_rounding(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Elements further apart than one bf16 step of the output (at most
    2^-7 of the larger magnitude) plus 1e-3: f32 sums in another order
    may tip one rounding of the output, or of a p (a step of p < 0.5 is
    at most 2^-9, times |v| of a few), never more."""
    scale = np.maximum(np.abs(got), np.abs(want))
    return np.abs(got - want) > 2.0 ** -7 * scale + 1e-3


# (tokens N, window, head dim, mask and motion): head dims 84 and 44 at
# the global window (kernel pads them to 96 and 48), 28 at the local
# window without mask or motion (padded to 32)
@pytest.mark.parametrize("N,ws,hd,masked", [(144, 12, 84, True),
                                             (144, 12, 44, True),
                                             (64, 8, 28, False)])
def test_plain_bf16_window_attention_matches_pallas(N, ws, hd, masked):
    rng = np.random.default_rng(N + hd)
    C = HEADS * hd
    qkv_t, qkv_j = _bf16_pair(
        rng.standard_normal((BW, N, 3 * C)).astype(np.float32))
    scale = hd ** -0.5
    mask = rel = None
    if masked:  # 0 / -100, exact in bf16 (the Pallas op casts the mask)
        mask = np.zeros((MASK_WINDOWS, N, N), np.float32)
        mask[1, : N // 2, N // 2:] = -100.0
        mask[1, N // 2:, : N // 2] = -100.0
        rel = ops.relative_coords(ws).numpy()
    want, want_m = jap.fused_window_attention_packed(
        qkv_j[..., :C], qkv_j[..., C:], scale,
        None if rel is None else jnp.asarray(rel),
        None if mask is None else jnp.asarray(
            np.tile(mask, (BW // MASK_WINDOWS, 1, 1))),
        HEADS, 2, True)
    got, got_m = attn_plain.window_attention(
        qkv_t[..., :C], qkv_t[..., C:], scale,
        None if rel is None else torch.from_numpy(rel),
        None if mask is None else torch.from_numpy(mask), HEADS)
    assert got.dtype == torch.bfloat16 and got.shape == (BW, N, C)
    pairs = [(got, want)]
    if masked:
        assert got_m.dtype == torch.bfloat16
        assert got_m.shape == (BW, N, 2 * HEADS)
        pairs.append((got_m, want_m))
    else:
        assert got_m is None and want_m is None
    for g, w in pairs:
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        # bf16 outputs at most one rounding apart; a few dozen of ~1e5
        # elements differ at all (mean |d| ~2e-7), so the mean stays far
        # inside the 5e-3 that chip_smoke.py allows the kernel
        assert not _beyond_one_rounding(g, w).any()
        assert np.abs(g - w).mean() <= 1e-5

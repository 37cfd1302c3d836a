"""The compact mask and rel of the key-tiled attention kernels (windows
above 12, N > 160 keys): the per-window token labels and key coordinates
that the card's kernels read instead of the [M, N, N] mask and the
[2, N, N] rel, their exact check and the routing of anything else to the
general form, and a plain twin of the kernels' arithmetic on them (online
softmax over 64-key tiles, motion as sum_k p c(k) / l - c(q), p rounded
before the division) against the JAX package's packed window attention
(Pallas, interpret mode). The card holds the kernels themselves against
the port's plain window attention (chip_smoke.py, phase 11)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from atmvfi_tpu.ops import attention_pallas as jap
from atmvfi_tpu_torch import ops
from atmvfi_tpu_torch.ops import attention as attn_plain
from atmvfi_tpu_torch.ops import attention_cuda
from atmvfi_tpu_torch.ops.window import MASK_NEG

torch.set_num_threads(2)  # the test workers share the CPU

# token maps of the attention sites at 1080p (h, w, shifted): local and
# enhancement at 1/8 (the enhancement block unshifted), global at 1/16;
# the lite model's sites use the same maps
TOKEN_MAPS = [(136, 240, True), (68, 120, True), (136, 240, False)]


@pytest.mark.parametrize("ws", [13, 16, 24, 32])
def test_labels_and_coords_reproduce_the_model_masks(ws):
    """Every mask attn_mask_for makes at the base and lite token maps is
    exactly MASK_NEG where two labels differ, and the relative
    coordinates exactly c(k) - c(q)."""
    for h, w, shifted in TOKEN_MAPS:
        mask = ops.attn_mask_for(h, w, ws, ws // 2 if shifted else 0)
        assert mask is not None  # 1080p maps are padded at these windows
        labels = attn_plain.region_labels(mask)
        assert labels is not None and labels.dtype == torch.int32
        assert labels.shape == mask.shape[:2]
        made = torch.where(labels[:, :, None] != labels[:, None, :],
                           MASK_NEG, 0.0)
        assert torch.equal(made, mask)
    rel = ops.relative_coords(ws)
    coords = attn_plain.grid_coords(rel)
    assert coords is not None and coords.shape == (2, ws * ws)
    assert torch.equal(coords[:, None, :] - coords[:, :, None], rel)


def test_other_masks_and_rel_run_the_general_form(monkeypatch):
    """A mask that is no region mask and a rel that is no coordinate
    difference have no compact form, a launch on them takes the general
    form, and the wrappers count it so (the threshold stands in for the
    library's here)."""
    monkeypatch.setattr(attention_cuda, "_tiled", lambda N: int(N > 160))
    rng = np.random.default_rng(3)
    N = 169
    region = ops.attn_mask_for(20, 20, 13, 6)
    rel = ops.relative_coords(13)
    noise = torch.from_numpy(np.where(rng.random((4, N, N)) < 0.2, -100.0,
                                      0.0).astype(np.float32))
    other_value = region.clone()
    other_value[region != 0] = -50.0  # regions, but not MASK_NEG
    odd_rel = rel.clone()
    odd_rel[0, 3, 5] += 1.0
    assert attn_plain.region_labels(noise) is None
    assert attn_plain.region_labels(other_value) is None
    assert attn_plain.grid_coords(odd_rel) is None
    assert attn_plain.grid_coords(
        torch.from_numpy(rng.standard_normal((2, N, N)).astype(
            np.float32))) is None
    def general(m, r, n=N):
        return attention_cuda._compact(m, r, n)[2]

    assert not general(region, rel) and not general(None, None)
    assert general(noise, rel) and general(region, odd_rel)
    assert general(None, odd_rel)
    assert not general(noise, odd_rel, 144)  # single-pass
    fn = attention_cuda.window_attention
    before = fn.tiled_launches, fn.general_launches
    attention_cuda._count_tiled(fn, N, general(noise, rel))
    attention_cuda._count_tiled(fn, N, general(region, rel))
    attention_cuda._count_tiled(fn, 144, False)
    assert (fn.tiled_launches - before[0],
            fn.general_launches - before[1]) == (2, 1)


def test_compact_forms_are_cached_with_their_tensor(monkeypatch):
    """Derived once per mask / rel tensor, anew after an in-place update."""
    monkeypatch.setattr(attention_cuda, "_tiled", lambda N: int(N > 160))
    mask = ops.attn_mask_for(24, 24, 16, 8).clone()
    rel = ops.relative_coords(16).clone()
    labels, coords, _ = attention_cuda._compact(mask, rel, 256)
    again = attention_cuda._compact(mask, rel, 256)
    assert again[0] is labels and again[1] is coords
    mask[0, 0, 1] = -7.0  # no longer a region mask
    assert attention_cuda._compact(mask, rel, 256)[0] is None
    assert attention_cuda._compact(mask, rel, 144) == (None, None, False)


def compact_twin(q, kv, scale, coords, labels, num_heads):
    """The key-tiled kernels' arithmetic on packed q [BW, N, C], kv
    [BW, N, 2C]: scores and an online softmax in f32 over tiles of 64
    keys (MASK_NEG where `labels` [M, N] of window w % M differ), out =
    sum_k round_T(p) v / l and motion = sum_k p c(k) / l - c(q) with p =
    exp(s - running max), the f32 p rounded to the working type T before
    it multiplies v and before the division by l. Returns (out [BW, N,
    C], motion [BW, N, 2h]) in q.dtype."""
    BW, N, C = q.shape
    h, dt = num_heads, q.dtype
    d = C // h

    def heads(t):
        return t.reshape(BW, N, h, d).transpose(1, 2).float()

    qh, kh, vh = heads(q), heads(kv[..., :C]), heads(kv[..., C:])
    lab = labels[torch.arange(BW) % labels.shape[0]][:, None]  # [BW, 1, N]
    m = torch.full((BW, h, N, 1), -torch.inf)
    l = torch.zeros(BW, h, N, 1)
    o = torch.zeros(BW, h, N, d)
    mo = torch.zeros(BW, h, N, 2)
    for k0 in range(0, N, 64):
        ks = slice(k0, k0 + 64)
        s = torch.matmul(qh, kh[:, :, ks].transpose(-1, -2)) * scale
        s = s + torch.where(lab[..., :, None] != lab[..., None, ks],
                            MASK_NEG, 0.0)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp(m - mn), torch.exp(s - mn)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + torch.matmul(p.to(dt).float(), vh[:, :, ks])
        mo = mo * corr + torch.matmul(p, coords[:, ks].t())
        m = mn
    out = (o / l).to(dt).transpose(1, 2).reshape(BW, N, C)
    motion = (mo / l - coords.t()).to(dt).transpose(1, 2)
    return out, motion.reshape(BW, N, 2 * h)


# (window, head dim): N = 169 (not a multiple of 16 or of the 64-key
# tile) at the lite global head dim, N = 256 at the base local one
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ws,hd", [(13, 44), (16, 48)])
def test_compact_twin_matches_pallas(ws, hd, dtype):
    """The twin on labels and coordinates against JAX's packed window
    attention on the mask and rel they come from: 2 images x 4 windows of
    a token map padded and shifted into 3 regions a window or more, 2
    heads, f32 max |d| <= 1e-5, bf16 mean |d| <= 5e-3 (out and motion)."""
    heads, N = 2, ws * ws
    C = heads * hd
    mask = ops.attn_mask_for(2 * ws - 5, 2 * ws - 3, ws, ws // 2)
    rel = ops.relative_coords(ws)
    M = mask.shape[0]
    BW = 2 * M
    rng = np.random.default_rng(ws + hd)
    qkv = rng.standard_normal((BW, N, 3 * C)).astype(np.float32)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    qkv_t = torch.from_numpy(qkv).to(tdt)
    qkv_j = jnp.asarray(qkv_t.float().numpy()).astype(jdt)
    scale = hd ** -0.5
    labels = attn_plain.region_labels(mask)
    coords = attn_plain.grid_coords(rel)
    assert labels is not None and coords is not None
    assert len(torch.unique(labels[-1])) >= 3  # pad and shift regions
    got, got_m = compact_twin(qkv_t[..., :C], qkv_t[..., C:], scale, coords,
                              labels, heads)
    want, want_m = jap.fused_window_attention_packed(
        qkv_j[..., :C], qkv_j[..., C:], scale, jnp.asarray(rel.numpy()),
        jnp.asarray(np.tile(mask.numpy(), (BW // M, 1, 1))), heads, 2, True)
    assert got.dtype == tdt and got.shape == (BW, N, C)
    assert got_m.dtype == tdt and got_m.shape == (BW, N, 2 * heads)
    for g, w in ((got, want), (got_m, want_m)):
        d = np.abs(g.float().numpy() - np.asarray(w.astype(jnp.float32)))
        if dtype == "f32":
            assert d.max() <= 1e-5
        else:
            assert d.mean() <= 5e-3

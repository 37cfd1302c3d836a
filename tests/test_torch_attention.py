"""The port's plain ATM block (K1's plain version) and its two
transformer blocks against the JAX package on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from atmvfi_tpu import ops as jops
from atmvfi_tpu.models import layers as jlayers
from atmvfi_tpu.ops.attention_pallas import _block_reference, fused_atm_block
from atmvfi_tpu_torch.convert import params_from_jax
from atmvfi_tpu_torch.models import layers as tlayers
from atmvfi_tpu_torch.ops import attention_cuda
from atmvfi_tpu_torch.ops.attention import atm_block_reference

torch.set_num_threads(2)  # the test workers share the CPU

TOL = 2e-5  # f32 everywhere; JAX at HIGHEST matmul precision


def _block_inputs(seed, with_mask, with_motion):
    BW, N, C = 12, 64, 64
    rng = np.random.default_rng(seed)
    a = dict(
        x=rng.standard_normal((BW, N, C)),
        wq=rng.standard_normal((C, C)) * 0.05,
        wkv=rng.standard_normal((C, 2 * C)) * 0.05,
        wp=rng.standard_normal((C, C)) * 0.05,
        bp=rng.standard_normal((C,)) * 0.05,
        g=1 + 0.1 * rng.standard_normal((C,)),
        b=0.1 * rng.standard_normal((C,)),
    )
    a = {k: v.astype(np.float32) for k, v in a.items()}
    a["rel"] = np.asarray(jops.relative_coords(8)) if with_motion else None
    a["mask"] = ((-100.0 * (rng.random((BW, N, N)) < 0.3)).astype(np.float32)
                 if with_mask else None)
    return a


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("with_mask,with_motion", [(False, False),
                                                   (True, True)])
def test_plain_block_matches_jax_kernel_and_reference(swap, with_mask,
                                                      with_motion):
    a = _block_inputs(3 + swap, with_mask, with_motion)
    h, C = 8, a["x"].shape[-1]
    scale = (C // h) ** -0.5
    j = {k: None if v is None else jnp.asarray(v) for k, v in a.items()}
    with jax.default_matmul_precision("highest"):
        yk, mk = fused_atm_block(j["x"], j["wq"], j["wkv"], j["wp"], j["bp"],
                                 j["g"], j["b"], scale, j["rel"], j["mask"],
                                 h, swap, 8, True)
        yr, mr = _block_reference(j["x"], j["wq"], j["wkv"], j["wp"],
                                  j["bp"], j["g"], j["b"], scale, j["rel"],
                                  j["mask"], h, swap)
    t = {k: None if v is None else torch.from_numpy(np.array(v))
         for k, v in a.items()}
    # the port takes nn.Linear weights [out, in]; the wrapper takes the
    # plain version for CPU tensors
    y, m = attention_cuda.atm_block(
        t["x"], t["wq"].t(), t["wkv"].t(), t["wp"].t(), t["bp"], t["g"],
        t["b"], scale, t["rel"], t["mask"], h, swap)
    assert attention_cuda.atm_block.launches == 0
    for want in (yk, yr):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    if with_motion:
        for want in (mk, mr):
            np.testing.assert_allclose(m.numpy(), np.asarray(want), atol=TOL,
                                       rtol=TOL)
    else:
        assert m is None


def test_plain_block_takes_per_image_masks():
    """A [nW, N, N] mask indexed by window % nW equals its tiled form."""
    a = _block_inputs(7, True, True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    small = t["mask"][:3]
    args = (t["x"], t["wq"].t(), t["wkv"].t(), t["wp"].t(), t["bp"], t["g"],
            t["b"], 0.35, t["rel"])
    y1, m1 = atm_block_reference(*args, small, 8, True)
    y2, m2 = atm_block_reference(*args, small.repeat(4, 1, 1), 8, True)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(m1, m2, rtol=0, atol=0)


def _port_block_state(params, prefix):
    """Exported JAX block params -> the port block's state_dict."""
    flat = {f"{prefix}_0/" + "/".join(k): np.asarray(v)
            for k, v in flatten_dict(params).items()}
    sd = params_from_jax(flat)
    cut = len(prefix) + 3  # "<prefix>.0."
    return {k[cut:]: v for k, v in sd.items()}


@pytest.mark.parametrize("kind", ["atmformer", "refine"])
def test_transformer_blocks_match_jax(kind):
    """ATMFormer (shift 4, padded 12x20 map, two frames) and
    RefineBottleneck against the flax modules with exported weights;
    tolerance 1e-5 (f32)."""
    dim, ws, shift = 64, 8, 4
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 20, dim)).astype(np.float32)
    if kind == "atmformer":
        jmod = jlayers.ATMFormer(window_size=ws, shift_size=shift, dim=dim,
                                 mlp_ratio=2.0, attn_impl="xla")
        tmod = tlayers.ATMFormer(dim, ws, shift, 8, 2.0)
        prefix = "local_motion_atmformer"
    else:
        jmod = jlayers.RefineBottleneck(window_size=ws, shift_size=shift,
                                        dim=dim, mlp_ratio=2.0,
                                        attn_impl="xla")
        tmod = tlayers.RefineBottleneck(dim, ws, shift, 8, 2.0)
        prefix = "feat_enhance_transformer"
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # non-trivial LayerNorm affines and motion-MLP biases
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * jnp.asarray(
            np.random.default_rng(len(str(p))).standard_normal(v.shape),
            v.dtype) if "bias" in str(p) or "scale" in str(p) else v,
        params)
    tmod.load_state_dict(_port_block_state(params, prefix), strict=True)
    with jax.default_matmul_precision("highest"):
        want = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    if kind == "atmformer":
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_block_wrapper_rejects_devices_without_a_route():
    x = torch.zeros(4, 64, 64, device="meta")
    w = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="no ATM block for device"):
        attention_cuda.atm_block(x, w, torch.zeros(128, 64), w,
                                 torch.zeros(64), torch.ones(64),
                                 torch.zeros(64), 0.35, None, None, 8, True)


def test_bf16_block_takes_at_most_the_layernorm_pass_width():
    """K1's bf16 LayerNorm pass holds C <= MAX_BF16_C channels a row: the
    wrapper's checks refuse a wider bf16 block before any launch, and
    take the same width in f32 (the f32 GEMM has no such limit)."""
    C, N, heads = attention_cuda.MAX_BF16_C + 8, 4, 12
    assert C // heads <= attention_cuda.MAX_HEAD_DIM
    w = torch.zeros(C, C)
    args = (w, torch.zeros(2 * C, C), w, torch.zeros(C), torch.ones(C),
            torch.zeros(C), 0.35, None, None, heads, True)
    with pytest.raises(ValueError, match="unsupported block shape"):
        attention_cuda._block_call(
            torch.zeros(2, N, C, dtype=torch.bfloat16), *args)
    argv, y, motion, _ = attention_cuda._block_call(
        torch.zeros(2, N, C), *args)
    assert y.shape == (2, N, C) and motion is None and argv[4] is None


def test_block_weight_packs_are_cached_per_weight():
    """K1's [wq | wkv], wproj and bproj packs are made once per weight: a
    repeat call returns the same packs; an in-place update of wkv (which
    the q/kv pack is also made from) makes a new q/kv pack only; the
    enhancement block's wq and wkv, row blocks of one qkv weight taken
    anew each call, share that weight's pack until it changes."""
    C, bf16 = 16, torch.bfloat16
    g = torch.Generator().manual_seed(3)
    wq, wkv, wp, bp = (torch.randn(*s, generator=g)
                       for s in ((C, C), (2 * C, C), (C, C), (C,)))
    first = attention_cuda._packs(wq, wkv, wp, bp, bf16)
    assert all(a is b for a, b in
               zip(attention_cuda._packs(wq, wkv, wp, bp, bf16), first))
    assert torch.equal(first[0], torch.cat([wq, wkv]).to(bf16))
    assert first[2].dtype == bf16 and torch.equal(first[2], bp.to(bf16))
    with torch.no_grad():
        wkv.mul_(2)
    again = attention_cuda._packs(wq, wkv, wp, bp, bf16)
    assert again[0] is not first[0] and again[1] is first[1]
    assert torch.equal(again[0][C:], wkv.to(bf16))
    assert attention_cuda._packs(wq, wkv, wp, bp, torch.float32)[0] \
        is not again[0]
    qkv = torch.randn(3 * C, C, generator=g)
    one = attention_cuda._packs(qkv[:C], qkv[C:], wp, bp, bf16)[0]
    assert attention_cuda._packs(qkv[:C], qkv[C:], wp, bp, bf16)[0] is one
    with torch.no_grad():
        qkv.add_(1)
    two = attention_cuda._packs(qkv[:C], qkv[C:], wp, bp, bf16)[0]
    assert two is not one and torch.equal(two, qkv.to(bf16))


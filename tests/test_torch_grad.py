"""Gradients through the port's kernel wrappers on the CPU.

On the card every wrapper launches its kernel through
`ops._autograd.launch`, whose backward is the VJP of the wrapper's plain
version (what each JAX op's custom VJP does with its XLA reference).
Here the plain version stands in for the launch: the autograd path's
gradients equal plain autograd's, and they match `jax.vjp` of the JAX
ops (Pallas in interpret mode, f32, HIGHEST matmul precision) within
1e-5 of the gradient's scale. Also: the path is not taken under
inference mode, and the packed-weight cache of the conv wrappers.
`chip_smoke.py` runs the same checks on the card with the kernels."""
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from atmvfi_tpu.ops import conv_pallas as jcp
from atmvfi_tpu.ops.attention_pallas import fused_atm_block
from atmvfi_tpu.ops.warp_pallas import flow_warp_tiled
from atmvfi_tpu_torch.ops import _autograd, conv_cuda, warp_cuda
from atmvfi_tpu_torch.ops import attention as tattn
from atmvfi_tpu_torch.ops import conv as tconv
from atmvfi_tpu_torch.ops import warp as twarp
from test_torch_attention import _block_inputs
from test_torch_ops import _edge_flow

torch.set_num_threads(2)  # the test workers share the CPU


def _t(rng, *shape, scale=1.0, grad=True):
    x = torch.from_numpy((rng.standard_normal(shape) * scale)
                         .astype(np.float32))
    return x.requires_grad_(grad)


def _flow(rng, B, H, W):
    return torch.from_numpy(_edge_flow(rng, B, H, W)).requires_grad_(True)


# (plain version, its arguments) of every kernel wrapper, small f32
def _case(name, rng):
    if name == "flow_warp":
        return twarp.flow_warp, (_t(rng, 1, 6, 7, 5), _flow(rng, 1, 6, 7))
    if name == "flow_warp_pair":
        return warp_cuda._pair_plain, (
            _t(rng, 1, 6, 7, 3), _t(rng, 1, 6, 7, 3), _flow(rng, 1, 6, 7),
            _flow(rng, 1, 6, 7))
    if name == "flow_warp_blend":
        occ = torch.from_numpy(rng.random((1, 6, 7, 1), dtype=np.float32))
        return twarp.flow_warp_blend, (
            _t(rng, 1, 6, 7, 3), _t(rng, 1, 6, 7, 3), _flow(rng, 1, 6, 7),
            _flow(rng, 1, 6, 7), occ.requires_grad_(True))
    if name == "row warps":  # K10 and the single row warp, one plain call
        def both(im0, im1, f0, f1, feat, fr):
            return (*twarp.warp_pair_srcfull(im0, im1, f0, f1, 5),
                    twarp.flow_warp_rows(feat, fr, 3))
        return both, (_t(rng, 1, 12, 7, 3), _t(rng, 1, 12, 7, 3),
                      _flow(rng, 1, 4, 7), _flow(rng, 1, 4, 7),
                      _t(rng, 2, 10, 7, 6), _flow(rng, 2, 5, 7))
    if name == "conv3x3 and conv3x3_s2":
        def both(x, w, b, a):
            return (conv_cuda._conv3x3_plain1(x, w, b, a),
                    tconv.conv3x3([x], w, b, a, 2, torch.float32))
        return both, (_t(rng, 2, 7, 9, 5), _t(rng, 6, 5, 3, 3, scale=0.3),
                      _t(rng, 6, scale=0.1), _t(rng, 6, scale=0.3))
    if name == "conv3x3_multi":
        srcs = [_t(rng, 1, 7, 9, 4), _t(rng, 1, 7, 9, 3, grad=False)]
        return tconv.conv3x3, (srcs, _t(rng, 5, 7, 3, 3, scale=0.3),
                               _t(rng, 5, scale=0.1), None, 1, torch.float32)
    if name == "conv3x3_pair":
        return tconv.conv3x3_pair, (
            _t(rng, 1, 7, 9, 4), _t(rng, 6, 4, 3, 3, scale=0.3),
            _t(rng, 6, scale=0.1), _t(rng, 6, scale=0.3),
            _t(rng, 3, 6, 3, 3, scale=0.3), _t(rng, 3, scale=0.1), None)
    if name == "deconv2x":
        return tconv.deconv2x, (_t(rng, 1, 4, 5, 6),
                                _t(rng, 6, 4, 2, 2, scale=0.3),
                                _t(rng, 4, scale=0.1), _t(rng, 4, scale=0.3))
    if name == "atm_block":
        a = _block_inputs(1, True, True)
        t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
        for k in ("x", "wq", "wkv", "wp", "bp", "g", "b"):
            t[k].requires_grad_(True)
        return tattn.atm_block_reference, (
            t["x"], t["wq"].t(), t["wkv"].t(), t["wp"].t(), t["bp"], t["g"],
            t["b"], 0.35, t["rel"], t["mask"], 8, True)
    if name == "window_attention and window_attention_heads":
        a = _block_inputs(2, True, True)
        rel, mask = (torch.from_numpy(np.array(a[k]))
                     for k in ("rel", "mask"))

        def both(q, kv, qh, kh, vh):
            return (*tattn.window_attention(q, kv, 0.25, rel, mask, 4),
                    *tattn.window_attention_heads(qh, kh, vh, 0.25, rel,
                                                  mask))
        return both, (_t(rng, 12, 64, 32), _t(rng, 12, 64, 64),
                      *(_t(rng, 12, 4, 64, 8) for _ in range(3)))
    raise KeyError(name)


CASES = ["flow_warp", "flow_warp_pair", "flow_warp_blend", "row warps",
         "conv3x3 and conv3x3_s2", "conv3x3_multi", "conv3x3_pair",
         "deconv2x", "atm_block",
         "window_attention and window_attention_heads"]


def _leaves(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from (t for t in a if t.requires_grad)
        elif isinstance(a, torch.Tensor) and a.requires_grad:
            yield a


def _grads(outs, inputs, seed):
    outs = [o for o in (outs if isinstance(outs, tuple) else (outs,))
            if o is not None]
    rng = np.random.default_rng(seed)
    cts = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
           for o in outs]
    return torch.autograd.grad(outs, inputs, cts)


@pytest.mark.parametrize("name", CASES)
def test_autograd_path_equals_plain_autograd(name):
    """The path's backward recomputes the plain version on the saved
    inputs: gradients bit-equal to autograd through the plain version,
    one for every input that requires grad, and an output grad_fn."""
    plain, args = _case(name, np.random.default_rng(len(name)))
    inputs = list(_leaves(args))
    out = _autograd.launch(plain, plain, *args)
    first = out[0] if isinstance(out, tuple) else out
    assert first.grad_fn is not None
    got = _grads(out, inputs, 1)
    want = _grads(plain(*args), inputs, 1)
    assert len(got) == len(inputs) >= 2
    for g, w in zip(got, want):
        assert g is not None and torch.equal(g, w)


def _close(got: torch.Tensor, want, what: str):
    w = np.asarray(want, dtype=np.float32)
    g = got.detach().numpy()
    assert g.shape == w.shape, what
    err = np.abs(g - w).max()
    assert err <= 1e-5 * max(1.0, np.abs(w).max()), (what, err)


def test_warp_grads_match_jax_vjp_of_tiled_kernel():
    """flow_warp_tiled (v3 'win', interpret mode) and its custom VJP
    (the VJP of the XLA warp): d feature and d flow."""
    rng = np.random.default_rng(5)
    B, H, W, C = 1, 16, 128, 3
    feat = rng.random((B, H, W, C), dtype=np.float32)
    flow = _edge_flow(rng, B, H, W)
    ct = rng.standard_normal((B, H, W, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda f, fl: flow_warp_tiled(f, fl, interpret=True,
                                                   inner="win"),
                     jnp.asarray(feat), jnp.asarray(flow))
    want = vjp(jnp.asarray(ct))
    tf = torch.from_numpy(feat).requires_grad_(True)
    tfl = torch.from_numpy(flow).requires_grad_(True)
    out = _autograd.launch(twarp.flow_warp, twarp.flow_warp, tf, tfl)
    got = torch.autograd.grad(out, (tf, tfl), torch.from_numpy(ct))
    for g, w, what in zip(got, want, ("feature", "flow")):
        _close(g, w, what)


def test_conv_grads_match_jax_vjp_of_pallas_conv3x3():
    """conv3x3_hcw_op (interpret mode, custom VJP `_op_bwd`): d x,
    d weight (OIHW here, HWIO there), d bias, d slope."""
    rng = np.random.default_rng(3)
    B, H, W, cin, cout = 1, 16, 128, 13, 11
    x = rng.uniform(-1, 1, (B, H, W, cin)).astype(np.float32)
    k = rng.uniform(-0.1, 0.1, (3, 3, cin, cout)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
    a = rng.uniform(-0.3, 0.5, cout).astype(np.float32)
    ct = rng.standard_normal((B, H, W, cout)).astype(np.float32)

    def jfn(x_, k_, b_, a_):
        return jcp.hcw_to_nhwc(jcp.conv3x3_hcw_op(
            jcp.nhwc_to_hcw(x_), k_, b_, a_, H, True, True), B, cout)

    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(jfn, *map(jnp.asarray, (x, k, b, a)))
        want = vjp(jnp.asarray(ct))
    tx, tk, tb, ta = (torch.from_numpy(v).requires_grad_(True)
                      for v in (x, k, b, a))
    w_oihw = tk.permute(3, 2, 0, 1)
    out = _autograd.launch(conv_cuda._conv3x3_plain1,
                           conv_cuda._conv3x3_plain1, tx, w_oihw, tb, ta)
    got = torch.autograd.grad(out, (tx, tk, tb, ta), torch.from_numpy(ct))
    for g, w, what in zip(got, want, ("x", "weight", "bias", "slope")):
        _close(g, w, what)


def test_block_grads_match_jax_vjp_of_fused_atm_block():
    """fused_atm_block (interpret mode, custom VJP `_block_bwd_rule`),
    frame swap, mask and motion: d of the tokens, the four weights, the
    projection bias and the LayerNorm parameters."""
    a = _block_inputs(4, True, True)
    h, C = 8, a["x"].shape[-1]
    scale = (C // h) ** -0.5
    rng = np.random.default_rng(9)
    BW, N = a["x"].shape[:2]
    cts = [rng.standard_normal((BW, N, C)).astype(np.float32),
           rng.standard_normal((BW, N, 2 * h)).astype(np.float32)]
    names = ("x", "wq", "wkv", "wp", "bp", "g", "b")

    def jfn(*p):
        return fused_atm_block(*p, scale, jnp.asarray(a["rel"]),
                               jnp.asarray(a["mask"]), h, True, 8, True)

    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(jfn, *(jnp.asarray(a[k]) for k in names))
        want = vjp(tuple(map(jnp.asarray, cts)))
    t = {k: torch.from_numpy(a[k]).requires_grad_(True) for k in names}
    rel, mask = (torch.from_numpy(np.array(a[k])) 
                 for k in ("rel", "mask"))
    outs = _autograd.launch(
        tattn.atm_block_reference, tattn.atm_block_reference, t["x"],
        t["wq"].t(), t["wkv"].t(), t["wp"].t(), t["bp"], t["g"], t["b"],
        scale, rel, mask, h, True)
    got = torch.autograd.grad(outs, [t[k] for k in names],
                              [torch.from_numpy(c) for c in cts])
    for g, w, what in zip(got, want, names):
        _close(g, w, what)


def test_no_autograd_path_under_inference_mode():
    """Serving runs under inference_mode / no_grad: the kernel is called
    directly, its output has no grad_fn. Grad mode with an operand that
    requires grad takes the path; integer or grad-free operands do not.
    An inference tensor among the operands does not stop the path."""
    x = torch.ones(3, requires_grad=True)
    calls = []

    def kernel(t, ts):
        calls.append(1)
        return t.detach() * 2

    def plain(t, ts):
        return t * 2

    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            assert not _autograd.needs_grad(x, [x])
            assert _autograd.launch(kernel, plain, x, [x]).grad_fn is None
    assert _autograd.needs_grad(torch.zeros(2), [x])
    assert not _autograd.needs_grad(x.detach(), [torch.zeros(2)], 3, None)
    assert not _autograd.needs_grad(torch.zeros(2, dtype=torch.long))
    y = _autograd.launch(kernel, plain, x, [x])
    assert y.grad_fn is not None and len(calls) == 3
    y.sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 2.0))
    # an operand made under inference mode (a serving cache) rides along
    with torch.inference_mode():
        m = torch.full((3, 3), 3.0)
    x.grad = None
    _autograd.launch(lambda a, b: (a @ b).detach(), lambda a, b: a @ b,
                     x, m).sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 9.0))


def test_grad_forward_after_a_serving_forward():
    """A forward with grad after the pipeline's inference-mode forward on
    the same device (windows and size no other test uses, so the masks
    and relative coordinates are first made by the serving forward)."""
    import dataclasses

    from atmvfi_tpu_torch.infer import InterpolationPipeline
    from atmvfi_tpu_torch.models import get_config
    from test_torch_model import NARROW

    cfg = dataclasses.replace(get_config("lite"), **NARROW).with_windows(
        5, 7, 5)
    pipe = InterpolationPipeline(None, cfg, torch.float32, device="cpu")
    ims = [torch.rand(1, 48, 80, 3, generator=torch.Generator()
                      .manual_seed(k)) for k in range(2)]
    pipe.interpolate_device(*ims)
    out = pipe.net(*ims, global_motion=True)["I_t"]
    out.mean().backward()
    grads = [p.grad for p in pipe.net.parameters()]
    assert all(g is not None for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0


def test_packed_weight_cache_hits_and_misses():
    """The conv pack is made once per weight: a hit returns the same
    pack; an in-place update (`_version`) or a new tensor misses; the
    working type keys its own entry; an entry dies with its weight."""
    w = torch.randn(8, 5, 3, 3)
    bf16 = torch.bfloat16
    first = conv_cuda._pack3x3(w, 5, bf16, w.device)
    assert conv_cuda._pack3x3(w, 5, bf16, w.device) is first
    packed, kp = first
    assert kp == 8 and tuple(packed.shape) == (3, 3, 8, 8)
    assert torch.equal(packed[..., :5], w.permute(2, 3, 0, 1).to(bf16))
    with torch.no_grad():
        w.mul_(2)
    again = conv_cuda._pack3x3(w, 5, bf16, w.device)
    assert again is not first
    assert torch.equal(again[0][..., :5], w.permute(2, 3, 0, 1).to(bf16))
    assert conv_cuda._pack3x3(w, 5, torch.float32, w.device) is not again
    other = w.clone()
    assert conv_cuda._pack3x3(other, 5, bf16, w.device) is not again
    key = (id(other), "3x3", bf16)
    assert key in conv_cuda._packs
    del other
    gc.collect()
    assert key not in conv_cuda._packs

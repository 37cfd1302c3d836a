"""The port's opt-in routes of two-frame serving on the CPU: the plain
versions of K7 / K8 (window attention), K9 (fused warp + blend) and K12
(fused conv pair) against the JAX package's Pallas ops in interpret
mode, the warp routes that K2 serves (K11) against JAX's dispatch, the
whole narrow forward under the routes configuration and the serving
profile against JAX, and the wrapper calls per forward."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from atmvfi_tpu.models import Network as JNetwork
from atmvfi_tpu.models import get_config as jconfig
from atmvfi_tpu.ops import attention_pallas as jap
from atmvfi_tpu.ops import conv_pallas as jcp
from atmvfi_tpu.ops import warp_pallas as jwp
from atmvfi_tpu_torch import ops
from atmvfi_tpu_torch.convert import params_from_jax
from atmvfi_tpu_torch.models import ATMVFIConfig, Network, get_config
from atmvfi_tpu_torch.ops import (
    attention_cuda,
    conv_cuda,
    deconv_cuda,
    warp_cuda,
)
from test_torch_model import (
    NARROW,
    _jax_variables,
    _param_shapes,
    _random_params,
)

torch.set_num_threads(2)  # the test workers share the CPU

ROUTES = dict(attention_impl="pallas", warp_impl="tiled_blend",
              hcw_fuse_pairs=True)
JAX_XLA_CONVS = dict(conv_impl="xla", tail_planar="off")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- K7 / K8: window attention + motion --------------------------------
@pytest.mark.parametrize("with_motion", [True, False])
def test_k7_matches_pallas_packed_attention(with_motion):
    """Packed q / kv; with mask and motion (the ATMFormer call, mask read
    as mask[w % M]) and without either (RefineBottleneck, kv a column
    block of qkv). f32, max |d| <= 1e-5 (the same f32 products and
    softmax in another order)."""
    rng = np.random.default_rng(7 + with_motion)
    BW, N, C, h = 8, 64, 32, 4
    qkv = rng.standard_normal((BW, N, 3 * C)).astype(np.float32)
    scale = (C // h) ** -0.5
    mask = rel = None
    if with_motion:
        m = np.zeros((4, N, N), np.float32)
        m[1:, : N // 2, N // 2:] = -100.0
        mask, rel = m, ops.relative_coords(8).numpy()
    q, kv = qkv[..., :C], qkv[..., C:]
    want, want_m = jap.fused_window_attention_packed(
        jnp.asarray(q), jnp.asarray(kv), scale,
        None if rel is None else jnp.asarray(rel),
        None if mask is None else jnp.asarray(np.tile(mask, (2, 1, 1))),
        h, 2, True)
    t_qkv = _t(qkv)
    calls = attention_cuda.window_attention.calls
    got, got_m = attention_cuda.window_attention(
        t_qkv[..., :C], t_qkv[..., C:], scale,
        None if rel is None else _t(rel), None if mask is None else _t(mask),
        h)
    assert attention_cuda.window_attention.calls == calls + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    if with_motion:
        assert got_m.shape == (BW, N, 2 * h)
        np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                                   atol=1e-5, rtol=0)
    else:
        assert got_m is None


def test_k8_matches_pallas_head_major_attention():
    """Head-major q, k, v with mask and motion; f32 max |d| <= 1e-5."""
    rng = np.random.default_rng(8)
    BW, h, N, d = 4, 2, 64, 16
    q, k, v = (rng.standard_normal((BW, h, N, d)).astype(np.float32)
               for _ in range(3))
    mask = np.zeros((2, N, N), np.float32)
    mask[1, :, : N // 4] = -100.0
    rel = ops.relative_coords(8).numpy()
    want, want_m = jap.fused_window_attention(
        *(jnp.asarray(a) for a in (q, k, v)), d ** -0.5, jnp.asarray(rel),
        jnp.asarray(np.tile(mask, (2, 1, 1))), 2, True)
    got, got_m = attention_cuda.window_attention_heads(
        _t(q), _t(k), _t(v), d ** -0.5, _t(rel), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-5,
                               rtol=0)


# ---- K9: fused dual warp + occlusion blend ------------------------------
def _edge_flow(rng, B, H, W, mag):
    """Random flows, larger near the border so taps fall off each edge."""
    f = rng.uniform(-2, 2, (B, H, W, 2)).astype(np.float32)
    f[:, :, :4, 0] -= mag
    f[:, :, -4:, 0] += mag
    f[:, :4, :, 1] -= mag
    f[:, -4:, :, 1] += mag
    return f


def test_k9_matches_pallas_warp_blend():
    """1x64x384x3 with taps off every edge; f32 max |d| <= 1e-6 (the
    same rounded operations; the Pallas kernel blends the tap sums)."""
    rng = np.random.default_rng(9)
    B, H, W = 1, 64, 384
    im0, im1 = (rng.random((B, H, W, 3), dtype=np.float32) for _ in range(2))
    f0, f1 = (_edge_flow(rng, B, H, W, 3.0) for _ in range(2))
    occ = rng.random((B, H, W, 1), dtype=np.float32)
    want = jwp.flow_warp_blend_tiled(*(jnp.asarray(a) for a in
                                       (im0, im1, f0, f1, occ)),
                                     interpret=True)
    got = warp_cuda.flow_warp_blend(*(_t(a) for a in (im0, im1, f0, f1, occ)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# ---- K11: the other TPU warp routes are K2's function ------------------
@pytest.mark.parametrize("impl", ["tiled", "tiled_v2", "tiled_nhwc"])
def test_k11_warp_routes_match_jax_dispatch(impl):
    """The route selects K2 (not the blend kernel), whose plain version
    equals JAX's warp under that impl (interpret mode) at 1x64x256x3,
    the smallest shape its kernels take, within f32 max |d| 1e-6."""
    cfg = dataclasses.replace(get_config("lite"), warp_impl=impl)
    assert not cfg.fused_blend
    rng = np.random.default_rng(11)
    img = rng.random((1, 64, 256, 3), dtype=np.float32)
    flow = _edge_flow(rng, 1, 64, 256, 3.0)
    want = jwp.flow_warp_dispatch(jnp.asarray(img), jnp.asarray(flow), impl)
    got = warp_cuda.flow_warp(_t(img), _t(flow))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# ---- K12: fused conv pair -----------------------------------------------
@pytest.mark.parametrize("prelu_b", [True, False])
def test_k12_matches_pallas_conv_pair(prelu_b):
    """16x256, ragged channels 5 -> 11 -> 6, f32; max |d| <= 1e-5 (the
    same f32 products in another order)."""
    rng = np.random.default_rng(12 + prelu_b)
    B, H, W, cin, cmid, cout = 1, 16, 256, 5, 11, 6
    x = rng.uniform(-1, 1, (B, H, W, cin)).astype(np.float32)
    ka = rng.uniform(-0.3, 0.3, (3, 3, cin, cmid)).astype(np.float32)
    kb = rng.uniform(-0.3, 0.3, (3, 3, cmid, cout)).astype(np.float32)
    ba, bb = (rng.uniform(-0.1, 0.1, n).astype(np.float32)
              for n in (cmid, cout))
    sa, sb = (rng.uniform(-0.3, 0.5, n).astype(np.float32)
              for n in (cmid, cout))
    want = jcp.hcw_to_nhwc(jcp.conv3x3_pair_hcw_op(
        jcp.nhwc_to_hcw(jnp.asarray(x)), *(jnp.asarray(a) for a in
                                           (ka, ba, sa, kb, bb, sb)),
        H, True, prelu_b, True), B, cout)
    oihw = lambda k: _t(k).permute(3, 2, 0, 1)  # noqa: E731
    got = conv_cuda.conv3x3_pair(_t(x), oihw(ka), _t(ba), _t(sa), oihw(kb),
                                 _t(bb), _t(sb) if prelu_b else None)
    assert got.shape == (B, H, W, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# ---- the whole narrow forward under the routes -------------------------
@functools.lru_cache(maxsize=1)
def _narrow_shapes():
    """Parameter shapes of the narrow lite model (no route changes them;
    traced on the XLA routes, the cheapest to trace)."""
    return _param_shapes(dataclasses.replace(
        jconfig("lite"), **NARROW, attention_impl="xla", **JAX_XLA_CONVS))


def _narrow(routes, jax_routes, seed):
    jcfg = dataclasses.replace(jconfig("lite"), **NARROW, **jax_routes)
    flat = _random_params(_narrow_shapes(), seed=seed)
    net = Network(dataclasses.replace(get_config("lite"), **NARROW,
                                      **routes))
    net.load_state_dict(params_from_jax(flat), strict=True)
    return jcfg, _jax_variables(flat), net.eval()


@pytest.mark.parametrize("profile", ["routes", "fast"])
def test_narrow_forward_matches_jax(profile):
    """64x96, global motion on, f32. "routes": packed attention (JAX runs
    K7 in interpret mode), fused blends, fused conv pairs (JAX's XLA
    convs: the fusion does not change the function). "fast": composed
    full-resolution warps. Tolerances: I_t max |d| <= 1e-4, flows
    <= 1e-3 px."""
    if profile == "routes":
        routes, jroutes = ROUTES, dict(ROUTES, **JAX_XLA_CONVS)
    else:
        routes = dict(warp_impl="tiled_unchecked",
                      compose_full_res_warps=True)
        jroutes = dict(routes, attention_impl="xla", **JAX_XLA_CONVS)
    jcfg, variables, net = _narrow(routes, jroutes, seed=0)
    if profile == "fast":
        assert jcfg.fast() == jcfg and net.cfg.fast() == net.cfg
    rng = np.random.default_rng(21)
    im0, im1 = (rng.random((1, 64, 96, 3), dtype=np.float32)
                for _ in range(2))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(JNetwork(jcfg).apply)(variables, jnp.asarray(im0),
                                             jnp.asarray(im1))
    with torch.no_grad():
        got = net(_t(im0), _t(im1))
    assert np.abs(np.asarray(want["opt_flow_0"])).max() > 1.0
    np.testing.assert_allclose(got["I_t"].numpy(), np.asarray(want["I_t"]),
                               atol=1e-4, rtol=0)
    for k in ("opt_flow_0", "opt_flow_1"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=0)
    for g, w in zip(got["im_t_list"], want["im_t_list"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    if profile == "fast":  # the profile changes the result
        with torch.no_grad():
            net.cfg = dataclasses.replace(net.cfg, warp_impl="auto",
                                          compose_full_res_warps=False)
            exact = net(_t(im0), _t(im1))["I_t"]
        assert (exact - got["I_t"]).abs().max() > 1e-3


# ---- wrapper calls per forward ------------------------------------------
WRAPPERS = {
    "K1": attention_cuda.atm_block, "K7": attention_cuda.window_attention,
    "K2 pair": warp_cuda.flow_warp_pair, "K2 single": warp_cuda.flow_warp,
    "K9": warp_cuda.flow_warp_blend, "K3": conv_cuda.conv3x3,
    "K4": conv_cuda.conv3x3_s2, "K5": conv_cuda.conv3x3_multi,
    "K6": deconv_cuda.deconv2x, "K12": conv_cuda.conv3x3_pair,
}


@pytest.mark.parametrize("profile,counts", [
    # 6 transformer blocks; 9 pair warps (1/16, 1/8 and 3 decoder blends,
    # 4 pyramid pre-aligns) and 4 single (token pre-align, decoder
    # input); 22 K3, 7 K4, 2 K5, 6 K6
    ("default", dict(K1=6, **{"K2 pair": 9, "K2 single": 4}, K3=22, K4=7,
                     K5=2, K6=6)),
    # K7 for K1; K9 at the 5 blend sites beside their pair warps; 4 K12
    # (3 decoder pairs, refine head) for 8 K3
    ("routes", dict(K7=6, **{"K2 pair": 9, "K2 single": 4}, K9=5, K3=14,
                    K4=7, K5=2, K6=6, K12=4)),
    # no full-resolution pre-align pair
    ("fast", dict(K1=6, **{"K2 pair": 8, "K2 single": 4}, K3=22, K4=7, K5=2,
                  K6=6)),
])
def test_wrapper_calls_per_forward(profile, counts):
    cfg = dataclasses.replace(get_config("lite"), **NARROW)
    cfg = (cfg.fast() if profile == "fast" else
           dataclasses.replace(cfg, **ROUTES) if profile == "routes" else cfg)
    net = Network(cfg).eval()
    g = torch.Generator().manual_seed(1)
    ims = [torch.rand(1, 64, 96, 3, generator=g) for _ in range(2)]
    before = {k: (f.calls, f.launches) for k, f in WRAPPERS.items()}
    with torch.no_grad():
        net(*ims)
    got = {k: f.calls - before[k][0] for k, f in WRAPPERS.items()}
    assert got == {k: counts.get(k, 0) for k in WRAPPERS}
    # on the CPU every call ran the plain version
    assert all(f.launches == before[k][1] for k, f in WRAPPERS.items())


def test_route_values_resolve_and_unknown_ones_raise():
    cfg = get_config("base")
    assert not cfg.packed_attention and not cfg.fused_blend
    for impl in ("auto", "pallas_block"):
        assert not dataclasses.replace(cfg, attention_impl=impl).packed_attention
    for impl in ("pallas", "xla"):
        assert dataclasses.replace(cfg, attention_impl=impl).packed_attention
    assert dataclasses.replace(cfg, warp_impl="tiled_blend_unchecked").fused_blend
    fast = cfg.fast()
    assert fast.compose_full_res_warps and fast.warp_impl == "tiled_unchecked"
    with pytest.raises(ValueError, match="attention_impl"):
        ATMVFIConfig(attention_impl="flash")
    with pytest.raises(ValueError, match="warp_impl"):
        dataclasses.replace(cfg, warp_impl="tiled_v4")

"""The port's row-sharded and data-parallel serving schedules on the CPU:
`make_spatial_forward` against JAX's (2 and 4 shards on virtual CPU
devices) and against the port's own monolithic forward (shallow cut,
global motion off, the fast profile, the ensemble), the ensemble forward
against JAX, the batch split and the wrapper calls per shard. f32; JAX
at HIGHEST matmul precision. (The ops: test_torch_spatial_ops.py.)"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from atmvfi_tpu.models import Network as JNetwork
from atmvfi_tpu.models import get_config as jconfig
from atmvfi_tpu.parallel import make_mesh as jmake_mesh
from atmvfi_tpu.parallel import spatial as jspatial
from atmvfi_tpu_torch.convert import params_from_jax
from atmvfi_tpu_torch.infer import InterpolationPipeline
from atmvfi_tpu_torch.models import Network, get_config
from atmvfi_tpu_torch.ops import resize as tresize
from atmvfi_tpu_torch.ops import warp_cuda
from atmvfi_tpu_torch.parallel import (
    make_dp_forward,
    make_mesh,
    make_spatial_forward,
)
from test_torch_model import (
    NARROW,
    XLA_ROUTES,
    _jax_variables,
    _param_shapes,
    _random_params,
)

torch.set_num_threads(2)  # the test workers share the CPU

W = 64  # frame width of the forward tests


# ---- whole serving schedules --------------------------------------------
@pytest.fixture(scope="module")
def narrow():
    jcfg = dataclasses.replace(jconfig("lite"), **NARROW, **XLA_ROUTES)
    flat = _random_params(_param_shapes(jcfg), seed=0)
    cfg = dataclasses.replace(get_config("lite"), **NARROW)
    net = Network(cfg)
    net.load_state_dict(params_from_jax(flat), strict=True)
    return jcfg, _jax_variables(flat), net.eval(), flat


def _frames(H, seed, Wd=W):
    rng = np.random.default_rng(seed)
    return [rng.random((1, H, Wd, 3), dtype=np.float32) for _ in range(2)]


def _reset_counts():
    for fn in (warp_cuda.warp_pair_srcfull, warp_cuda.flow_warp_rows,
               warp_cuda.flow_warp_pair, warp_cuda.flow_warp):
        fn.calls = 0


@pytest.mark.parametrize("n,H,margin", [(2, 320, 64), (4, 1024, 96)])
def test_spatial_forward_matches_jax(narrow, n, H, margin):
    """Deep cut, global motion on. 2 shards at H 320, margin 64 (shard
    1's slab shifted inward: crop 128); 4 shards at H 1024, margin 96
    (the sharded attention middle's slab, 104 of 128 token rows, and its
    halo active). I_t max |d| <= 1e-4 against JAX's shard_map schedule
    on virtual CPU devices; per shard 2 K10 calls (pre-align, blend) and
    4 row warps (token pre-align, decoder input), no full-frame warp."""
    jcfg, variables, net, _ = narrow
    im0, im1 = _frames(H, n)
    jfwd = jspatial.make_spatial_forward(
        JNetwork(jcfg), jmake_mesh((1, n), jax.devices()[:n]), margin=margin)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jfwd)(variables, jnp.asarray(im0), jnp.asarray(im1))
    fwd = make_spatial_forward(net, make_mesh((1, n), ["cpu"] * n),
                               margin=margin)
    _reset_counts()
    got = fwd(torch.from_numpy(im0), torch.from_numpy(im1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert warp_cuda.warp_pair_srcfull.calls == 2 * n
    assert warp_cuda.flow_warp_rows.calls == 4 * n
    assert warp_cuda.flow_warp_pair.calls == warp_cuda.flow_warp.calls == 0


@pytest.mark.parametrize("case", ["shallow", "global_off", "fast_4",
                                  "ensemble"])
def test_spatial_forward_matches_monolithic(narrow, case):
    """The port's schedule against its own monolithic forward (held
    against JAX by test_torch_model.py), I_t max |d| <= 1e-4: the
    shallow cut; the deep cut without global motion (K10 blends only,
    2 row warps per shard); 4 shards under `fast()` (compose mode: the
    slab's unwarped rows, one K10 per shard); the ensemble (shallow cut,
    the multiscale estimate replicated)."""
    _, _, net, flat = narrow
    kw, n, H, margin, calls = {}, 2, 320, 64, (4, 0)
    if case == "shallow":
        kw = dict(deep=False)
    elif case == "global_off":
        kw, calls = dict(global_motion=False), (2, 4)
    elif case == "fast_4":
        net = Network(net.cfg.fast())
        net.load_state_dict(params_from_jax(flat), strict=True)
        net.eval()
        n, H, calls = 4, 640, (4, 16)
    else:
        kw = dict(ensemble_global_motion=True)
    im0, im1 = map(torch.from_numpy, _frames(H, 17))
    with torch.no_grad():
        want = net(im0, im1, global_motion=kw.get("global_motion", True),
                   ensemble_global_motion=case == "ensemble")["I_t"]
    fwd = make_spatial_forward(net, make_mesh((1, n), ["cpu"] * n),
                               margin=margin, **kw)
    _reset_counts()
    got = fwd(im0, im1)
    torch.testing.assert_close(got, want.clamp(0, 1), atol=1e-4, rtol=0)
    assert (warp_cuda.warp_pair_srcfull.calls,
            warp_cuda.flow_warp_rows.calls) == calls


def test_ensemble_forward_matches_jax(narrow):
    """Multiscale global-motion ensemble at 128x128: the same level wins
    the argmin on both sides (losses well apart), the chosen 1/16 flows
    agree, and I_t max |d| <= 1e-4."""
    jcfg, variables, net, _ = narrow
    im0, im1 = _frames(128, 23, 128)
    im1 = np.roll(im0, (3, -5), (1, 2)) * 0.7 + im1 * 0.3
    jnet = JNetwork(jcfg)

    def jax_side(v, a, b):  # one compile: I_t and the chosen flows
        f0, _ = jnet.apply(v, a, b,
                           method=JNetwork.multiscale_global_motion_ensemble)
        return jnet.apply(v, a, b, ensemble_global_motion=True)["I_t"], f0

    with jax.default_matmul_precision("highest"):
        want, jf0 = jax.jit(jax_side)(variables, jnp.asarray(im0),
                                      jnp.asarray(im1))
    t0, t1 = torch.from_numpy(im0), torch.from_numpy(im1)
    with torch.no_grad():
        got = net(t0, t1, ensemble_global_motion=True)["I_t"]
        f0, _ = net.multiscale_global_motion_ensemble(t0, t1)
        im = torch.cat([t0, t1], 0)
        losses = []
        for level in range(3):
            x, lv = net.shared_feat_extraction(im)
            g0, g1, _ = net.estimate_global_motion(x, lv)
            losses.append(float(net._global_alignmentness(g0, g1, t0, t1)))
            im = tresize.downsample_2x(im)
    best, second = sorted(losses)[:2]
    assert second - best > 1e-4 * best
    np.testing.assert_allclose(f0.numpy(), np.asarray(jf0), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_dp_forward_splits_the_batch(narrow):
    """A ("cpu", "cpu") data mesh: bit-equal to the monolithic forward of
    each pair, and within 1e-5 of the B = 2 forward (another batch size
    sums some f32 products in another order)."""
    _, _, net, _ = narrow
    rng = np.random.default_rng(31)
    im0, im1 = (torch.from_numpy(rng.random((2, 64, 96, 3),
                                            dtype=np.float32))
                for _ in range(2))
    got = make_dp_forward(net, make_mesh((2, 1), ["cpu", "cpu"]))(im0, im1)
    with torch.no_grad():
        pairs = torch.cat([net(im0[i:i + 1], im1[i:i + 1])["I_t"]
                           for i in range(2)], 0).clamp(0, 1)
        batch = net(im0, im1)["I_t"].clamp(0, 1)
    torch.testing.assert_close(got, pairs, atol=0, rtol=0)
    torch.testing.assert_close(got, batch, atol=1e-5, rtol=0)


def test_pipeline_mesh_matches_single_device(narrow):
    """`InterpolationPipeline(mesh=...)` on two CPU shards: uint8 frames
    in and out agree with the single-device pipeline to one grey level;
    mesh and flag errors raise at construction."""
    _, _, net, flat = narrow
    rng = np.random.default_rng(41)
    f0 = rng.integers(0, 256, (120, 70, 3), dtype=np.uint8)
    f1 = np.roll(f0, (2, -3), (0, 1))
    kw = dict(variant=net.cfg, dtype=torch.float32)
    sd = params_from_jax(flat)
    mesh = make_mesh((1, 2), ["cpu", "cpu"])
    one = InterpolationPipeline(sd, device="cpu", **kw).interpolate(f0, f1)
    pipe = InterpolationPipeline(sd, mesh=mesh, **kw)
    assert pipe.shard_devices == [torch.device("cpu")] * 2
    got = pipe.interpolate(f0, f1)
    assert got.shape == (120, 70, 3)
    assert np.abs(got.astype(int) - one.astype(int)).max() <= 1
    with pytest.raises(ValueError, match="pad_divisor"):
        InterpolationPipeline(sd, mesh=make_mesh((1, 3), ["cpu"] * 3), **kw)
    with pytest.raises(NotImplementedError, match="gspmd"):
        InterpolationPipeline(sd, mesh=mesh, spmd="gspmd", **kw)
    with pytest.raises(ValueError, match="global_motion"):
        InterpolationPipeline(sd, mesh=mesh, global_motion=False,
                              ensemble_global_motion=True, **kw)

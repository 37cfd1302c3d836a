"""The port's row-sharded serving on the CPU, its ops: the plain
versions of K10 (`warp_pair_srcfull`) and the single row warp
(`flow_warp_rows`) and the row-band flow upsample against the JAX
package, and the traffic counts of the schedules. f32; JAX at HIGHEST
matmul precision. The schedules: test_torch_spatial_schedule.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from atmvfi_tpu.ops import resize as jresize
from atmvfi_tpu.ops import warp as jwarp
from atmvfi_tpu.ops import warp_pallas as jwp
from atmvfi_tpu.parallel import spatial as jspatial
from atmvfi_tpu_torch.ops import resize as tresize
from atmvfi_tpu_torch.ops import warp as twarp
from atmvfi_tpu_torch.ops import warp_cuda
from atmvfi_tpu_torch.parallel import (
    spatial_ici_bytes,
    spatial_ici_bytes_deep,
)

torch.set_num_threads(2)  # the test workers share the CPU

def _flows(rng, H, W, mag=3.0):
    """Flows whose taps leave the image on every side, some far."""
    f = rng.standard_normal((1, H, W, 2)).astype(np.float32) * mag
    f[:, :, :3, 0] -= 4.5
    f[:, :, -3:, 0] += 4.25
    f[:, :3, :, 1] -= 4.75
    f[:, -3:, :, 1] += 3.5
    f[:, H // 2, W // 2] = (1e4, -1e4)
    return f


def _planar(x):  # [1, H, W, C] -> [C, H, W]
    return jnp.asarray(x[0].transpose(2, 0, 1))


# ---- K10 and the row warp: plain versions -------------------------------
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_plain_k10_matches_jax_srcfull_xla(where):
    """Full 3-channel sources, slab flows reaching out of the image and
    the row offset folded into fy: the JAX op's exact XLA path
    (`_srcfull_xla`), max |d| <= 1e-6."""
    rng = np.random.default_rng(len(where))
    H_full, H_out, Wd = 96, 32, 40
    row0 = {"first": 0, "mid": 40, "last": H_full - H_out}[where]
    ims = [rng.random((1, H_full, Wd, 3), dtype=np.float32) for _ in range(2)]
    fl = [_flows(rng, H_out, Wd) for _ in range(2)]
    want = jwp.planar_warp_pair_srcfull(
        _planar(ims[0]), _planar(ims[1]), jnp.asarray(fl[0]),
        jnp.asarray(fl[1]), jnp.int32(row0), impl="xla")
    got = twarp.warp_pair_srcfull(*map(torch.from_numpy, ims + fl), row0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].permute(2, 0, 1).numpy(),
                                   np.asarray(w), atol=1e-6, rtol=0)


def test_plain_k10_matches_jax_srcfull_tiled_kernel():
    """The TPU kernel itself: the slab path of `planar_warp_pair_srcfull`
    in interpret mode, in its v3 flavour (`impl="tiled_v3"`, what
    `warp_impl="auto"` runs on the TPU; the v1 flavour takes ~25 s to
    trace here), at H_full 64, H_out 16, W 384: max |d| <= 1e-6."""
    rng = np.random.default_rng(5)
    H_full, H_out, Wd, row0 = 64, 16, 384, 24
    ims = [rng.random((1, H_full, Wd, 3), dtype=np.float32) for _ in range(2)]
    fl = [_flows(rng, H_out, Wd, 2.0) for _ in range(2)]
    for f in fl:
        f[:, H_out // 2, Wd // 2] = (30.0, -30.0)  # inside the slab window
    want = jax.jit(lambda a, b, f0, f1, r: jwp.planar_warp_pair_srcfull(
        a, b, f0, f1, r, impl="tiled_v3", interpret=True))(
            _planar(ims[0]), _planar(ims[1]), jnp.asarray(fl[0]),
            jnp.asarray(fl[1]), jnp.int32(row0))
    got = warp_cuda.warp_pair_srcfull(*map(torch.from_numpy, ims + fl), row0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].permute(2, 0, 1).numpy(),
                                   np.asarray(w), atol=1e-6, rtol=0)


@pytest.mark.parametrize("C", [3, 40])
def test_flow_warp_rows_equals_jax(C):
    """Bit-equal to JAX's `flow_warp_rows` (row0 added to the row index,
    then fy), on its corner-block (C <= 32) and per-tap paths."""
    rng = np.random.default_rng(C)
    feat = rng.standard_normal((1, 48, 24, C)).astype(np.float32)
    fl = _flows(rng, 16, 24)
    want = jwarp.flow_warp_rows(jnp.asarray(feat), jnp.asarray(fl),
                                jnp.int32(20))
    got = warp_cuda.flow_warp_rows(torch.from_numpy(feat),
                                   torch.from_numpy(fl), 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flow_warp_rows_equals_full_warp_rows(dtype):
    """Row for row equal to the port's full-frame warp, on a channel
    slice read in place (the decoder-input warps)."""
    rng = np.random.default_rng(11)
    feat = torch.from_numpy(
        rng.standard_normal((1, 40, 24, 20)).astype(np.float32)).to(dtype)
    fl = torch.from_numpy(_flows(rng, 40, 24))
    full = warp_cuda.flow_warp(feat[..., :12], fl)
    for row0, h in ((0, 8), (17, 9), (32, 8)):
        got = warp_cuda.flow_warp_rows(
            feat[..., :12], fl[:, row0:row0 + h].contiguous(), row0)
        assert got.dtype == dtype
        torch.testing.assert_close(got, full[:, row0:row0 + h], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("row0", [0, 24, 56, 72])
def test_upsample_flow_rows_matches_jax(row0):
    """Rows of the x2 chain of the 1/8 global flow to full resolution
    (3 levels), as the deep schedule computes a slab's flows: <= 1e-6
    against JAX's (its non-TPU branch)."""
    rng = np.random.default_rng(row0)
    f = rng.standard_normal((1, 17, 6, 2)).astype(np.float32) * 4
    want = jresize.upsample_flow_rows(jnp.asarray(f), 3, jnp.int32(row0), 64)
    got = tresize.upsample_flow_rows(torch.from_numpy(f), 3, row0, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_upsample_flow_rows_raises_when_the_band_does_not_fit():
    """A band larger than its level (the JAX op clamps silently)."""
    f = torch.zeros(1, 4, 6, 2)
    with pytest.raises(ValueError, match="outside the band"):
        tresize._resize_h_rows(f[:, :2], 8, 4, 4, 0, 4)


# ---- traffic counts -----------------------------------------------------
@pytest.mark.parametrize("H,Wd,n", [(2176, 3840, 4), (1088, 1920, 2),
                                    (448, 256, 1)])
def test_ici_bytes_match_jax(H, Wd, n):
    assert spatial_ici_bytes(H, Wd, n) == jspatial.spatial_ici_bytes(H, Wd, n)
    for gm in (True, False):
        for sm in (True, False):
            args = (H, Wd, n, 576, 672)
            kw = dict(token_bytes=2, global_motion=gm, shard_middle=sm)
            assert spatial_ici_bytes_deep(*args, **kw) == \
                jspatial.spatial_ici_bytes_deep(*args, **kw)

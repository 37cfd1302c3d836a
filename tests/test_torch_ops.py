"""Port ops against the JAX package on the CPU: window ops and masks,
resize, and the plain backward warp (K2's plain version)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from atmvfi_tpu import ops as jops
from atmvfi_tpu.ops import warp as jwarp
from atmvfi_tpu_torch import ops as tops
from atmvfi_tpu_torch.ops import warp as twarp
from atmvfi_tpu_torch.ops import warp_cuda

torch.set_num_threads(2)  # the test workers share the CPU


@pytest.mark.parametrize("h,w,ws,shift", [
    (12, 20, 8, 0),   # center-pads both axes
    (12, 20, 8, 4),   # ... with a shift
    (16, 16, 8, 0),   # no pad, no shift: no mask at all
    (16, 16, 8, 4),
    (5, 7, 12, 6),    # global window larger than the map
])
def test_window_ops_and_masks_match_jax(h, w, ws, shift):
    rng = np.random.default_rng(h * 100 + w + shift)
    x = rng.standard_normal((2, h, w, 5)).astype(np.float32)
    jm = jops.attn_mask_for(h, w, ws, shift)
    tm = tops.attn_mask_for(h, w, ws, shift)
    assert (jm is None) == (tm is None)
    if jm is not None:  # exact
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jops.relative_coords(ws)),
                                  tops.relative_coords(ws).numpy())
    assert jops.pad_amounts(h, w, ws) == tops.pad_amounts(h, w, ws)
    jp = jops.center_pad(jnp.asarray(x), ws)
    tp = tops.center_pad(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    jw = jops.window_partition(jp, ws)
    tw = tops.window_partition(tp, ws)
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    back = tops.center_depad(
        tops.window_reverse(tw, ws, tp.shape[1], tp.shape[2]), h, w, ws)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 17, 23, 3), (8, 11)),    # downsample, odd sizes
    ((1, 8, 12, 2), (16, 24)),    # x2 upsample
    ((1, 5, 6, 4), (1, 9)),       # single-row output
])
def test_resize_matches_jax(shape, out_hw):
    # tolerance 1e-6: same align-corners coefficients, f32 lerp
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = jops.resize_bilinear(jnp.asarray(x), *out_hw)
    got = tops.resize_bilinear(torch.from_numpy(x), *out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(
        tops.downsample_2x(torch.from_numpy(x)).numpy(),
        np.asarray(jops.downsample_2x(jnp.asarray(x))), atol=1e-6)


def test_upsample_flow_matches_jax():
    f = np.random.default_rng(2).standard_normal((2, 6, 10, 2)).astype(
        np.float32) * 5
    for factor in (2, 4):
        np.testing.assert_allclose(
            tops.upsample_flow(torch.from_numpy(f), factor).numpy(),
            np.asarray(jops.upsample_flow(jnp.asarray(f), factor)), atol=1e-6)


def _edge_flow(rng, B, H, W):
    """Flows whose taps leave the image on every side (and some far)."""
    f = rng.standard_normal((B, H, W, 2)).astype(np.float32) * 3
    f[:, :, :3, 0] -= 4.5    # left edge, fractional
    f[:, :, -3:, 0] += 4.25  # right edge
    f[:, :3, :, 1] -= 4.75   # top
    f[:, -3:, :, 1] += 3.5   # bottom
    f[:, H // 2, W // 2] = (1e4, -1e4)  # far outside: all taps invalid
    f[:, 1, 1] = (-1.0, -1.0)  # exactly on the corner pixel
    return f


@pytest.mark.parametrize("C", [3, 64])
def test_plain_warp_matches_jax(C):
    # tolerance 1e-6: same f32 weights, taps summed in the same order
    rng = np.random.default_rng(C)
    B, H, W = 2, 19, 27
    feat = rng.random((B, H, W, C), dtype=np.float32)
    flow = _edge_flow(rng, B, H, W)
    want = np.asarray(jwarp.flow_warp(jnp.asarray(feat), jnp.asarray(flow)))
    got = twarp.flow_warp(torch.from_numpy(feat), torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # the kernel wrapper takes the plain version for CPU tensors
    got0, got1 = warp_cuda.flow_warp_pair(
        torch.from_numpy(feat), torch.from_numpy(feat[::-1].copy()),
        torch.from_numpy(flow), torch.from_numpy(flow))
    np.testing.assert_array_equal(got0.numpy(), got.numpy())
    assert warp_cuda.flow_warp_pair.launches == 0


def test_plain_warp_matches_tiled_pallas_kernel():
    """Against the TPU kernel itself (v3 'win' flavour, interpret mode,
    as tests/test_warp_pallas.py runs it): tolerance 1e-6."""
    from atmvfi_tpu.ops.warp_pallas import flow_warp_tiled

    rng = np.random.default_rng(5)
    B, H, W, C = 1, 64, 384, 3
    feat = rng.random((B, H, W, C), dtype=np.float32)
    flow = _edge_flow(rng, B, H, W)
    want = np.asarray(flow_warp_tiled(jnp.asarray(feat), jnp.asarray(flow),
                                      interpret=True, inner="win"))
    got = twarp.flow_warp(torch.from_numpy(feat), torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_warp_reads_channel_slices_in_place():
    """A channel slice (pixel stride > C) warps like its copy."""
    rng = np.random.default_rng(6)
    feat = torch.from_numpy(rng.random((1, 9, 11, 16), dtype=np.float32))
    flow = torch.from_numpy(_edge_flow(rng, 1, 9, 11))
    sl = feat[..., 4:12]
    assert sl.stride(2) == 16
    torch.testing.assert_close(warp_cuda.flow_warp(sl, flow),
                               twarp.flow_warp(sl.contiguous(), flow),
                               rtol=0, atol=0)


def test_coords_grid_matches_jax():
    got = twarp.coords_grid(2, 3, 4).numpy()
    assert got.shape == (2, 3, 4, 2)
    np.testing.assert_array_equal(got, np.asarray(jwarp.coords_grid(2, 3, 4)))

"""The conv kernels' plain versions (K3-K6, `ops.conv`) on the CPU,
through their wrappers, against the JAX package's Pallas ops run in
interpret mode. (Odd shapes against F.conv* and the forward's routing:
test_torch_conv_routing.py.)"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from atmvfi_tpu.ops import conv_pallas as jcp
from atmvfi_tpu.ops import deconv_pallas as jdp
from atmvfi_tpu_torch.ops import conv_cuda, deconv_cuda

torch.set_num_threads(2)  # the test workers share the CPU

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _params(rng, kshape, cout, fan_in):
    """Seeded weight (any layout), bias and PReLU slope (some negative)."""
    bound = 1.0 / np.sqrt(fan_in)
    k = rng.uniform(-bound, bound, kshape).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
    a = rng.uniform(-0.3, 0.5, cout).astype(np.float32)
    return k, b, a


def _assert_close(got: torch.Tensor, want, dt: str):
    """f32: max |d| <= 1e-5. bf16: within one bf16 ulp of |want| (the
    two sides sum the same products in another order, which can move the
    final rounding by one step), plus 1e-6 where |want| cancels to ~0."""
    g = got.float().numpy()
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape
    d = np.abs(g - w)
    if dt == "f32":
        assert d.max() <= 1e-5, d.max()
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (d <= ulp + 1e-6).all(), (d - ulp).max()


def _nhwc_to_hcw(x: np.ndarray, jdt):
    return jcp.nhwc_to_hcw(jnp.asarray(x).astype(jdt))


# ---- each kernel's plain version against its TPU kernel (interpret) ----
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k3_matches_pallas_conv3x3(dt):
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(3)
    B, H, W, cin, cout = 1, 16, 128, 13, 11
    x = rng.uniform(-1, 1, (B, H, W, cin)).astype(np.float32)
    k, b, a = _params(rng, (3, 3, cin, cout), cout, 9 * cin)
    want = jcp.hcw_to_nhwc(jcp.conv3x3_hcw_op(
        _nhwc_to_hcw(x, jdt), jnp.asarray(k), jnp.asarray(b), jnp.asarray(a),
        H, True, True), B, cout)
    got = conv_cuda.conv3x3(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(k).permute(3, 2, 0, 1),
                            torch.from_numpy(b), torch.from_numpy(a))
    assert got.dtype == tdt
    _assert_close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k4_matches_pallas_conv3x3s2(dt):
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(4)
    B, H, W, cin, cout = 1, 32, 256, 8, 16
    x = rng.uniform(-1, 1, (B, H, W, cin)).astype(np.float32)
    k, b, a = _params(rng, (3, 3, cin, cout), cout, 9 * cin)
    want = jcp.hcw_to_nhwc(jcp.conv3x3s2_hcw_op(
        _nhwc_to_hcw(x, jdt), jnp.asarray(k), jnp.asarray(b), jnp.asarray(a),
        H // 2, True, True), B, cout)
    got = conv_cuda.conv3x3_s2(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(k).permute(3, 2, 0, 1),
                               torch.from_numpy(b), torch.from_numpy(a))
    _assert_close(got, want, dt)


def _planes(imgs):
    """NHWC images -> the JAX planes stack [3 * n, B*H, W]."""
    return np.concatenate([i.transpose(3, 0, 1, 2).reshape(
        i.shape[3], -1, i.shape[2]) for i in imgs], 0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k5_matches_pallas_conv3x3_planes(dt):
    """[working-type feature || f32 image planes], as the refinement proj
    reads them: the f32 planes are rounded to the working type."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(5)
    B, H, W, cf, cout = 1, 16, 128, 5, 8
    feat = rng.uniform(-1, 1, (B, H, W, cf)).astype(np.float32)
    imgs = [rng.random((B, H, W, 3), dtype=np.float32) for _ in range(2)]
    k, b, a = _params(rng, (3, 3, cf + 6, cout), cout, 9 * (cf + 6))
    want = jcp.hcw_to_nhwc(jcp.conv3x3_hcw_planes_op(
        _nhwc_to_hcw(feat, jdt), jnp.asarray(_planes(imgs)), jnp.asarray(k),
        jnp.asarray(b), jnp.asarray(a), H, cf, True, True), B, cout)
    got = conv_cuda.conv3x3_multi(
        [torch.from_numpy(feat).to(tdt)] + [torch.from_numpy(i) for i in imgs],
        torch.from_numpy(k).permute(3, 2, 0, 1), torch.from_numpy(b),
        torch.from_numpy(a), tdt)
    assert got.dtype == tdt
    _assert_close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k5_matches_pallas_conv3x3_planes_only(dt):
    """The encoder's first conv: the f32 frames alone (JAX casts the
    planes to the working type; the port's kernel rounds as it loads)."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(6)
    B, H, W, cout = 2, 8, 128, 8
    frames = rng.random((B, H, W, 3), dtype=np.float32)
    k, b, a = _params(rng, (3, 3, 3, cout), cout, 27)
    want = jcp.hcw_to_nhwc(jcp.conv3x3_planes_only_op(
        jnp.asarray(_planes([frames])).astype(jdt), jnp.asarray(k),
        jnp.asarray(b), jnp.asarray(a), H, True, True), B, cout)
    got = conv_cuda.conv3x3_multi(
        [torch.from_numpy(frames)], torch.from_numpy(k).permute(3, 2, 0, 1),
        torch.from_numpy(b), torch.from_numpy(a), tdt)
    _assert_close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k6_matches_pallas_deconv2x(dt):
    """Held against the Pallas op, which reads K[dy, dx] unflipped (the
    XLA path flips the kernel for conv_transpose)."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(7)
    B, h, w, cin, cout = 1, 8, 128, 13, 6
    x = rng.uniform(-1, 1, (B, h, w, cin)).astype(np.float32)
    k, b, a = _params(rng, (2, 2, cin, cout), cout, 4 * cin)
    want = jcp.hcw_to_nhwc(jdp.deconv2x_hcw_op(
        _nhwc_to_hcw(x, jdt), jnp.asarray(k), jnp.asarray(b), jnp.asarray(a),
        True, True), B, cout)
    got = deconv_cuda.deconv2x(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(k).permute(2, 3, 0, 1),
                               torch.from_numpy(b), torch.from_numpy(a))
    _assert_close(got, want, dt)

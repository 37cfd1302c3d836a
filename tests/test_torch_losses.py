"""The port's losses (`atmvfi_tpu_torch/losses/`) against the JAX
package's on the CPU: f32, JAX at HIGHEST matmul precision, inputs from
numpy seeds. Values within 1e-6 relative; gradients with respect to the
prediction within 1e-5 of the gradient's largest magnitude (computed by
`jax.value_and_grad` on the JAX side)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from atmvfi_tpu import losses as jl
from atmvfi_tpu.losses import pose as jpose
from atmvfi_tpu.train.trainer import _max_pyr_levels as j_max_pyr_levels
from atmvfi_tpu_torch import losses as tl
from atmvfi_tpu_torch.losses import pose as tpose
from atmvfi_tpu_torch.train.trainer import _max_pyr_levels

torch.set_num_threads(2)  # the test workers share the CPU

VALUE_RTOL = 1e-6
GRAD_TOL = 1e-5  # of the gradient's max |.|


def _pair(seed, shape=(2, 64, 96, 3)):
    """A prediction and a nearby target in [0, 1]."""
    rng = np.random.default_rng(seed)
    pred = rng.random(shape, dtype=np.float32)
    noise = 0.2 * rng.standard_normal(shape).astype(np.float32)
    return pred, np.clip(pred + noise, 0, 1).astype(np.float32)


def _check(jfn, tfn, pred, target):
    """jfn / tfn: (pred, target) -> scalar, JAX / port. The value is
    JAX's function called as it is (op by op: under jit XLA fuses the
    reductions, which moves a mean of ~1e4 terms by ~1e-6 relative on
    its own); the gradient its jitted `value_and_grad`."""
    with jax.default_matmul_precision("highest"):
        want = jfn(jnp.asarray(pred), jnp.asarray(target))
        wgrad = jax.jit(jax.grad(jfn))(jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = tfn(p, torch.from_numpy(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=VALUE_RTOL,
                               atol=0)
    wgrad = np.asarray(wgrad)
    scale = np.abs(wgrad).max()
    assert scale > 0
    np.testing.assert_allclose(p.grad.numpy(), wgrad, atol=GRAD_TOL * scale,
                               rtol=0)


def test_charbonnier_loss_matches_jax():
    _check(jl.charbonnier_loss, tl.charbonnier_loss, *_pair(0))


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
def test_lap_loss_matches_jax(levels):
    _check(lambda p, t: jl.lap_loss(p, t, levels),
           lambda p, t: tl.lap_loss(p, t, levels), *_pair(levels))


def test_lap_loss_at_the_pyramid_guard():
    """The warping loss's guard: the coarse scales of a 64x96 crop (8x12
    at 1/8, 16x24 at 1/4) take fewer levels than asked for."""
    for hw in [(8, 12), (16, 24), (32, 48), (64, 96), (5, 9), (256, 256)]:
        assert _max_pyr_levels(hw) == j_max_pyr_levels(hw)
    assert _max_pyr_levels((8, 12)) == 1 and _max_pyr_levels((16, 24)) == 2
    for hw, asked in [((8, 12), 5), ((16, 24), 4)]:
        levels = min(asked, _max_pyr_levels(hw))
        _check(lambda p, t: jl.lap_loss(p, t, levels),
               lambda p, t: tl.lap_loss(p, t, levels),
               *_pair(hw[0], (2, *hw, 3)))


def test_sobel_loss_matches_jax():
    pred, gt = _pair(7)
    _check(jl.sobel_loss, tl.sobel_loss, pred, gt)
    # gt carries no gradient
    g = torch.from_numpy(gt).requires_grad_(True)
    tl.sobel_loss(torch.from_numpy(pred).requires_grad_(True), g).backward()
    assert g.grad is None


def test_census_loss_matches_jax():
    _check(jl.census_loss, tl.census_loss, *_pair(8))


def write_random_vgg(path, seed=0):
    """A VGG16 feature .npz (HWIO kernels, biases) with He-scaled random
    weights, in the layout `export_vgg16_npz` writes."""
    from atmvfi_tpu.losses.vgg import _VGG16_PLAN

    rng = np.random.default_rng(seed)
    arrays, cin = {}, 3
    for p in _VGG16_PLAN:
        if p == "M":
            continue
        name, cout = p
        std = np.sqrt(2.0 / (9 * cin))
        arrays[f"{name}.kernel"] = (std * rng.standard_normal(
            (3, 3, cin, cout))).astype(np.float32)
        arrays[f"{name}.bias"] = (0.01 * rng.standard_normal(cout)
                                  ).astype(np.float32)
        cin = cout
    np.savez(path, **arrays)
    return path


@pytest.mark.parametrize("term", ["perceptual", "style"])
def test_vgg_loss_matches_jax(tmp_path, term):
    """Random VGG16 weights (no real ones in the repo): the perceptual
    term (L1 on the four block taps) and the style term (MSE of their
    Gram matrices), each with its gradient.

    The perceptual gradient is compared in f64 on both sides (the value
    in f32). In f32 the two frameworks' relu4_3 features differ by
    ~1e-5, and at 24576 deep activations a ReLU pre-activation lies
    within that of 0: whether it passes a gradient is then rounding, not
    the loss (one such ReLU moved the f32 gradient by 3 % of its max,
    while the block's VJP from equal inputs agreed to 2e-6). The L1's
    every-element cotangent makes the perceptual term see it; the
    Gram's does not."""
    npz = write_random_vgg(str(tmp_path / "vgg.npz"))
    jloss = jl.VGGPerceptualLoss(npz)
    tloss = tl.VGGPerceptualLoss(npz)
    pred, target = _pair(11, (2, 32, 48, 3))
    if term == "style":
        _check(lambda p, t: jloss(p, t)[1], lambda p, t: tloss(p, t)[1],
               pred, target)
        return
    with jax.default_matmul_precision("highest"):
        want = jloss(jnp.asarray(pred), jnp.asarray(target))[0]
    got = tloss(torch.from_numpy(pred), torch.from_numpy(target))[0]
    np.testing.assert_allclose(got.item(), float(want), rtol=VALUE_RTOL)
    p64, t64 = pred.astype(np.float64), target.astype(np.float64)
    with jax.enable_x64(True):
        wgrad = np.asarray(jax.jit(jax.grad(lambda p, t: jloss(p, t)[0]))(
            jnp.asarray(p64), jnp.asarray(t64)))
    assert wgrad.dtype == np.float64
    p = torch.from_numpy(p64).requires_grad_(True)
    tloss.double()(p, torch.from_numpy(t64))[0].backward()
    np.testing.assert_allclose(p.grad.numpy(), wgrad, rtol=0,
                               atol=GRAD_TOL * np.abs(wgrad).max())


def _heatmaps(seed, n=3, k=17, h=16, w=12):
    rng = np.random.default_rng(seed)
    return (2.0 * rng.standard_normal((n, k, h, w))).astype(np.float32)


@pytest.mark.parametrize("mode", [1, 2])
def test_heatmap_losses_match_jax(mode):
    """Mode 1: masked per-pixel cross entropy (with `pose_mask`); mode 2:
    channelwise KL. The gradient flows into the prediction only."""
    pred, gt = _heatmaps(1), _heatmaps(2)
    jfn = jpose.heatmap_ce_loss if mode == 1 else jpose.heatmap_kl_loss
    tfn = tpose.heatmap_ce_loss if mode == 1 else tpose.heatmap_kl_loss
    np.testing.assert_array_equal(
        tpose.pose_mask(torch.from_numpy(gt)).numpy(),
        np.asarray(jpose.pose_mask(jnp.asarray(gt))))
    assert tpose.pose_mask(torch.from_numpy(gt)).sum() > 0
    _check(jfn, tfn, pred, gt)


def test_boxes_and_crops_match_jax():
    rng = np.random.default_rng(3)
    raw = np.array([[4.4, 3.6, 30.2, 40.7, 0.9, 0],     # kept, padded
                    [10, 5, 20, 12, 0.2, 0],            # low confidence
                    [0, 0, 40, 30, 0.8, 1],             # not a person
                    [-5, 20, 70, 45.5, 0.5, 0]], np.float32)  # clamped
    got = tpose.process_boxes(raw, 48, 64)
    want = jpose.process_boxes(raw, 48, 64)
    np.testing.assert_array_equal(got, want)
    assert len(got) == 2
    img = rng.random((2, 48, 64, 3), dtype=np.float32)
    boxes = [got, np.zeros((0, 6), np.int64)]
    t = tpose.prepare_crops(torch.from_numpy(img), boxes)
    j = jpose.prepare_crops(img, boxes)
    assert t.shape == j.shape == (2, 256, 192, 3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    assert tpose.prepare_crops(img, [np.zeros((0, 6), np.int64)] * 2) is None


def test_pose_loss_with_stub_networks_matches_jax():
    """Stub detector (fixed boxes) and pose network (4x4 mean pool and a
    fixed 3 -> 17 channel map). As in JAX, the crops are cut from the
    graph on the host, so the prediction gets no gradient."""
    rng = np.random.default_rng(5)
    mix = rng.standard_normal((3, 17)).astype(np.float32)
    raw = [np.array([[2, 3, 40, 44, 0.9, 0]], np.float32), None]

    def jpose_fn(c):
        m, h, w, _ = c.shape
        pooled = c.reshape(m, h // 4, 4, w // 4, 4, 3).mean((2, 4))
        return jnp.einsum("mhwc,ck->mkhw", pooled, jnp.asarray(mix))

    def tpose_fn(c):
        m, h, w, _ = c.shape
        pooled = c.reshape(m, h // 4, 4, w // 4, 4, 3).mean((2, 4))
        return torch.einsum("mhwc,ck->mkhw", pooled, torch.from_numpy(mix))

    pred, gt = _pair(6, (2, 48, 64, 3))
    for mode in (1, 2):
        want = jpose.PoseLoss(lambda _: raw, jpose_fn, mode=mode)(
            jnp.asarray(pred), jnp.asarray(gt))
        p = torch.from_numpy(pred).requires_grad_(True)
        got = tpose.PoseLoss(lambda _: raw, tpose_fn, mode=mode)(
            p, torch.from_numpy(gt))
        np.testing.assert_allclose(float(got), float(want), rtol=VALUE_RTOL)
        assert not got.requires_grad
    assert float(tpose.PoseLoss()(p, torch.from_numpy(gt))) == 0.0

"""The port's training path (`atmvfi_tpu_torch/train/`) against the JAX
package's on the CPU: the criterion, its loss terms, the warped and
interpolated image lists and every parameter gradient of a narrow lite
network (f32, 64x96, batch 2, JAX's params, JAX at HIGHEST precision);
the freeze masks; AdamW with the freeze, warmup, clipping and
accumulation against optax given the same gradients; the schedule; the
train-state round trip; the initialisation statistics."""
import dataclasses
import types
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.traverse_util import flatten_dict, unflatten_dict

from atmvfi_tpu.losses import VGGPerceptualLoss as JVGG
from atmvfi_tpu.models import Network as JNetwork
from atmvfi_tpu.models import get_config as jconfig
from atmvfi_tpu.train import phases as jphases
from atmvfi_tpu.train import trainer as jtrainer
from atmvfi_tpu.train.schedule import cosine_with_linear_warmup as jcosine
from atmvfi_tpu_torch.convert import map_flax_key, params_from_jax
from atmvfi_tpu_torch.losses import VGGPerceptualLoss
from atmvfi_tpu_torch.models import Network, get_config
from atmvfi_tpu_torch.ops import conv_cuda
from atmvfi_tpu_torch.train import trainer as port_trainer
from atmvfi_tpu_torch.train import (
    PHASE1,
    PHASE3,
    Trainer,
    TrainerConfig,
    cosine_with_linear_warmup,
    get_phase,
    make_criterion,
    trainable_mask,
)
from atmvfi_tpu_torch.train.checkpoints import (
    latest_step,
    restore_train_state,
    save_train_state,
)
from test_torch_losses import write_random_vgg
from test_torch_model import NARROW, XLA_ROUTES, _param_shapes, _random_params

torch.set_num_threads(2)  # the test workers share the CPU

LOSS_RTOL = 1e-5
IMAGE_ATOL = 1e-4
# of each parameter gradient's max |.|: phase 1, and phase 3 with every
# switch (see test_criterion_and_gradients_match_jax)
GRAD_TOL = {"phase1": 1e-4, "phase3_all_switches": 2e-4}
PARAM_ATOL = 1e-6

# phase 3 with every switch of the criterion on but the pose loss
ALL_SWITCHES = dict(use_l1_loss=True, use_lap_loss=True,
                    use_warping_loss=True, use_bidirect_warp_loss=True,
                    use_sobel_loss=True, use_perceptual_loss=True,
                    use_style_loss=True)


def _port_cfg():
    return dataclasses.replace(get_config("lite"), **NARROW)


def _trainer(phase, init_state_dict=None, **kw):
    """A CPU `Trainer` of the narrow lite network (f32): the trainer's
    model lookup is pointed at it while the trainer is made."""
    with mock.patch.object(port_trainer, "get_config",
                           lambda variant, dtype: _port_cfg()):
        return Trainer(TrainerConfig(phase, device="cpu", **kw),
                       init_state_dict=init_state_dict)


@pytest.fixture(scope="module")
def narrow():
    """(JAX config with the XLA routes, flat JAX params) of one seeded
    narrow lite model."""
    jcfg = dataclasses.replace(jconfig("lite"), **NARROW, **XLA_ROUTES)
    return jcfg, _random_params(_param_shapes(jcfg), seed=3)


def _jphase(phase):
    return jphases.PhaseConfig(**dataclasses.asdict(phase))


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _smooth_triplet(seed, B=2, H=64, W=96):
    """(im0, gt, im1): windows of one smooth image (an 11x15 random image
    upsampled bicubically), shifted by a few pixels."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.random((B, 3, 11, 15), dtype=np.float32))
    big = torch.nn.functional.interpolate(
        base, size=(H + 24, W + 24), mode="bicubic", align_corners=False
    ).clamp(0, 1).permute(0, 2, 3, 1).numpy()
    return tuple(np.ascontiguousarray(big[:, y:y + H, x:x + W])
                 for y, x in ((12, 12), (10, 13), (9, 15)))


@pytest.mark.parametrize("name", ["phase1", "phase3_all_switches"])
def test_criterion_and_gradients_match_jax(narrow, tmp_path, name):
    """Phase 1 (global motion off: lap + warping) and phase 3 (global
    motion on) with L1, lap, warping, census, Sobel and the VGG terms on
    random VGG weights, on smooth frames.

    Phase 3's gradient is ill-conditioned at the f32 level: its kinks
    (a bilinear warp's gradient with respect to the flow jumps across
    pixel cells, PReLU and ReLU at 0, the L1 terms' signs, the Sobel
    magnitude near 0) move JAX's own gradient by 1.4e-3 of a parameter's
    max under input noise of 1e-5, the size of the two frameworks'
    forward difference (1.8e-3 on white-noise frames). Its band is 2e-4;
    the worst parameter measured 1.02e-4 (down1's bias), the rest below
    7e-5. Phase 1 holds 1e-4."""
    jcfg, flat = narrow
    vgg = None
    if name == "phase1":
        phase = PHASE1
    else:
        phase = dataclasses.replace(PHASE3, **ALL_SWITCHES)
        vgg = write_random_vgg(str(tmp_path / "vgg.npz"))
    im0, gt, im1 = _smooth_triplet(len(name))
    gm = phase.global_motion

    crit = jtrainer.make_criterion(_jphase(phase),
                                   JVGG(vgg) if vgg else None)
    net = JNetwork(jcfg)

    def loss_fn(params, a, b, label):
        out = net.apply({"params": params}, a, b, global_motion=gm)
        loss, ld = crit(out, label)
        return loss, (ld, {k: out[k] for k in (
            "im_t_list", "im0_warped_list", "im1_warped_list")})

    with jax.default_matmul_precision("highest"):
        (want, (wld, wlists)), wgrads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                _tree(flat), *(jnp.asarray(x) for x in (im0, im1, gt)))

    tnet = Network(_port_cfg())
    tnet.load_state_dict(params_from_jax(flat), strict=True)
    out = tnet(torch.from_numpy(im0), torch.from_numpy(im1),
               global_motion=gm)
    loss, ld = make_criterion(phase, VGGPerceptualLoss(vgg) if vgg else None
                              )(out, torch.from_numpy(gt))
    loss.backward()

    assert set(ld) == set(wld)
    if name != "phase1":
        assert len(ld) == 7
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    for k in ld:
        np.testing.assert_allclose(ld[k].item(), float(wld[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for k, wl in wlists.items():
        assert len(out[k]) == len(wl) == (5 if gm else 4)
        for g, w in zip(out[k], wl):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       atol=IMAGE_ATOL, rtol=0, err_msg=k)
    want_grads = params_from_jax({"/".join(k): np.asarray(v) for k, v in
                                  flatten_dict(wgrads).items()})
    n_nonzero = 0
    for key, p in tnet.named_parameters():
        w = want_grads[key].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        scale = np.abs(w).max()
        n_nonzero += scale > 0
        np.testing.assert_allclose(g, w, atol=GRAD_TOL[name] * scale,
                                   rtol=0, err_msg=key)
    # phase 1 leaves the global branch without a gradient
    assert n_nonzero > (150 if gm else 100)


@pytest.mark.parametrize("phase", ["1", "2", "3", "4", "refiner_only"])
def test_trainable_sets_match_jax(narrow, phase):
    """Name by name through `map_flax_key`; the trainer freezes the
    same set (requires_grad off, no optimizer entry)."""
    jcfg, flat = narrow
    p = (dataclasses.replace(PHASE3, refiner_only=True)
         if phase == "refiner_only" else get_phase(phase))
    jmask = jphases.trainable_mask(_tree(flat), p.train_local,
                                   p.train_global, p.refiner_only)
    want = {map_flax_key(path)[0]: bool(v) for path, v in
            (("/".join(k), v) for k, v in flatten_dict(jmask).items())}
    got = trainable_mask(want, p.train_local, p.train_global, p.refiner_only)
    assert got == want
    assert 0 < sum(want.values()) < len(want) or phase in ("3", "4")
    trainer = _trainer(p)
    assert {n: t.requires_grad for n, t in
            trainer.net.named_parameters()} == want
    assert [id(t) for t in trainer.trainable] == [
        id(t) for n, t in trainer.net.named_parameters() if want[n]]


def _grads(shapes, rng):
    return {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1)
                ).astype(np.float32) for k, s in sorted(shapes.items())}


@pytest.mark.parametrize("accum,clip", [(2, None), (1, 0.05)])
def test_optimizer_matches_optax_given_the_same_gradients(narrow, accum,
                                                          clip):
    """Three updates of phase 1 (global branch frozen) from the warmup
    into the cosine's end (t_max 2, warmup 2): the port's AdamW step
    against the JAX trainer's own optax chain (`_make_optimizer`), with
    gradient accumulation (k = 2) or a global-norm clip."""
    jcfg, flat = narrow
    phase = dataclasses.replace(PHASE1, warmup_steps=2)
    spe = 2 * accum
    trainer = _trainer(phase, params_from_jax(flat), steps_per_epoch=spe,
                       num_epochs=1, grad_accum=accum, clip_grad_norm=clip)
    holder = types.SimpleNamespace(
        c=types.SimpleNamespace(clip_grad_norm=clip, grad_accum=accum),
        phase=_jphase(phase),
        schedule=jcosine(phase.init_lr, phase.last_lr, 2, 2))
    params = _tree(flat)
    tx = jtrainer.Trainer._make_optimizer(holder, params)
    state = tx.init(params)
    update = jax.jit(tx.update)
    shapes = {k: v.shape for k, v in flat.items()}
    rng = np.random.default_rng(accum)
    named = dict(trainer.net.named_parameters())
    for _ in range(3 * accum):
        g = _grads(shapes, rng)
        updates, state = update(_tree(g), state, params)
        params = optax.apply_updates(params, updates)
        for key, t in params_from_jax(g).items():
            if named[key].requires_grad:
                named[key].grad = t
        trainer.apply_gradients()
    assert trainer.updates == 3 and trainer.step == 3 * accum
    want = params_from_jax({"/".join(k): np.asarray(v) for k, v in
                            flatten_dict(params).items()})
    start = params_from_jax(flat)
    for key, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=key)
        if not p.requires_grad:
            assert torch.equal(p.detach(), start[key])
        else:
            assert not torch.equal(p.detach(), start[key])


def test_schedule_matches_jax():
    """At steps 0, 1, warmup - 1, warmup, t_max and past it."""
    for init, last, t_max, warmup in [(2e-4, 1e-4, 3000, 2000),
                                      (4e-5, 1e-5, 700, 500)]:
        ts = cosine_with_linear_warmup(init, last, t_max, warmup)
        js = jcosine(init, last, t_max, warmup)
        for s in (0, 1, warmup - 1, warmup, t_max, t_max + 7):
            np.testing.assert_allclose(ts(s), float(js(s)), rtol=1e-6,
                                       err_msg=str(s))
        assert ts(0) == pytest.approx(init / warmup, rel=1e-6)


def test_train_state_round_trip_gives_a_bit_equal_next_step(tmp_path):
    """Saved mid-window (one micro-step of k = 2 after an update) and
    restored into a trainer made from another seed: the next three
    micro-steps give the same parameters and optimizer state, bit for
    bit."""
    phase = dataclasses.replace(PHASE1, warmup_steps=3)
    rng = np.random.default_rng(0)
    batches = [tuple(rng.random((1, 32, 32, 3), dtype=np.float32)
                     for _ in range(3)) for _ in range(6)]

    def trainer(seed):
        return _trainer(phase, steps_per_epoch=10, grad_accum=2, seed=seed)

    a = trainer(0)
    for b in batches[:3]:
        a.train_step(*b)
    save_train_state(str(tmp_path), a.state_dict(), a.step)
    assert latest_step(str(tmp_path)) == 3
    for b in batches[3:]:
        a.train_step(*b)
    b_ = restore_train_state(str(tmp_path), 3, trainer(1))
    assert (b_.step, b_.updates, b_.micro_step) == (3, 1, 1)
    for b in batches[3:]:
        b_.train_step(*b)
    assert a.updates == b_.updates == 3
    for (k, p), q in zip(a.net.named_parameters(), b_.net.parameters()):
        assert torch.equal(p, q), k
    sa, sb = a.optimizer.state_dict()["state"], b_.optimizer.state_dict()[
        "state"]
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k])


@pytest.mark.parametrize("impl", ["foreach", "fused"])
def test_an_update_makes_the_weight_packs_anew(impl):
    """The kernels' weight packs are keyed on each weight's version
    counter (`conv_cuda.cached_pack`), which torch's fused AdamW does not
    bump. So a weight that requires grad is packed anew at every call
    outside inference mode: after an update by either implementation, a
    no_grad forward's pack holds the new weights. Under inference mode,
    and for a frozen weight, the pack is kept."""
    raw = torch.nn.Parameter(torch.ones(4))
    opt = torch.optim.AdamW([raw], fused=True)
    raw.grad = torch.ones(4)
    before = raw._version
    opt.step()
    assert raw._version == before  # the hazard the pack cache avoids

    trainer = _trainer(PHASE1)
    trainer.optimizer = torch.optim.AdamW(trainer.trainable, **{impl: True})
    w = trainer.net.feat_extracts[0][1][0].weight
    made = []

    def pack(t):
        return conv_cuda.cached_pack(t, "test", torch.float32,
                                     lambda: made.append(1) or t.clone())

    with torch.no_grad():
        first = pack(w)
    for p in trainer.trainable:
        p.grad = torch.ones_like(p)
    assert trainer.apply_gradients()
    with torch.no_grad():
        again = pack(w)
    assert len(made) == 2 and not torch.equal(again, first)
    torch.testing.assert_close(again, w.detach(), rtol=0, atol=0)
    with torch.inference_mode():
        kept = pack(w)
        assert pack(w) is kept and len(made) == 3
    frozen = w.detach().clone()
    assert pack(frozen) is pack(frozen) and len(made) == 4


def test_initialisation_matches_jax_statistics():
    """Each parameter of a seeded port lite network against JAX's
    `net.init` at the same shape: constants equal; otherwise mean and
    std within 5 standard errors and the two samples' distributions
    within the two-sample Kolmogorov-Smirnov bound at alpha = 1e-6
    (which also holds the uniform draws' bounds)."""
    jcfg = dataclasses.replace(jconfig("lite"), **XLA_ROUTES)
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    jparams = jax.jit(lambda a, b: JNetwork(jcfg).init(
        jax.random.PRNGKey(0), a, b))(dummy, dummy)["params"]
    want = params_from_jax({"/".join(k): np.asarray(v) for k, v in
                            flatten_dict(jparams).items()})
    net = Network(get_config("lite"), torch.Generator().manual_seed(1))
    got = dict(net.named_parameters())
    assert set(got) == set(want)
    for key, w in want.items():
        w = w.numpy().ravel().astype(np.float64)
        g = got[key].detach().numpy().ravel().astype(np.float64)
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=key)
            continue
        n, sd = w.size, w.std()
        assert abs(g.mean() - w.mean()) <= 5 * sd * np.sqrt(2 / n), key
        assert abs(g.std() - sd) <= 5 * sd * np.sqrt(2 / n) + 1e-3 * sd, key
        # two-sample KS statistic against c(1e-6) * sqrt(2 / n)
        both = np.sort(np.concatenate([g, w]))
        d = np.abs(np.searchsorted(np.sort(g), both, "right")
                   - np.searchsorted(np.sort(w), both, "right")).max() / n
        assert d <= 2.76 * np.sqrt(2 / n), (key, d)

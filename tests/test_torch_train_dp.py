"""Data-parallel training (`Trainer(config, mesh=...)`, the port's
`atmvfi_tpu_torch/train/trainer.py`) on the CPU: the port on two 'data'
shards against the JAX trainer on a two-device CPU mesh, and against
the port on one device at the full batch (phases 1 and 3, accumulation
and clipping); the (1, 1) mesh, the errors, the replicas, evaluation
and the train CLI's mesh rule. The narrow lite network (f32) of
`test_torch_train.py`, injected the same way."""
import dataclasses
import types
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import optax
from flax.traverse_util import flatten_dict

from atmvfi_tpu.parallel.mesh import make_mesh as jmake_mesh
from atmvfi_tpu.parallel.mesh import replicated
from atmvfi_tpu.train import trainer as jtrainer
from atmvfi_tpu_torch.cli import train as train_cli
from atmvfi_tpu_torch.convert import params_from_jax
from atmvfi_tpu_torch.losses import PoseLoss
from atmvfi_tpu_torch.parallel import make_mesh
from atmvfi_tpu_torch.train import PHASE1, PHASE3, Trainer, TrainerConfig
from atmvfi_tpu_torch.train import trainer as port_trainer
from test_torch_train import (
    GRAD_TOL,
    LOSS_RTOL,
    _jphase,
    _port_cfg,
    _smooth_triplet,
    _tree,
    narrow,  # noqa: F401 (the module fixture)
)

torch.set_num_threads(2)  # the test workers share the CPU

# two shards against one device at the full batch, of each tensor's max
# |.|: the reduced gradient (and the first moment, 0.1 g after one
# update) and the second moment (1e-3 g^2: twice g's relative error).
# At BATCH 4 each sample's forward is bit-equal in the full batch and
# in a shard of 2, so only the order of the sums differs: worst measured
# 8.8e-6 (first moment) and 1.7e-5 (second) over phases 1 and 3 and
# four data seeds. A batch of 1 takes other CPU conv algorithms (I_t
# 3.5e-6 apart), which the warps' cell crossings and the L1 terms' signs
# amplify up to 5e-3 of a gradient's max.
MOMENT_TOL = {"grad": 2e-5, "exp_avg": 2e-5, "exp_avg_sq": 4e-5}
BATCH = 4


def _make(phase, mesh=None, init=None, **kw):
    """A CPU `Trainer` of the narrow lite network on `mesh` (None: one
    device)."""
    with mock.patch.object(port_trainer, "get_config",
                           lambda variant, dtype: _port_cfg()):
        return Trainer(TrainerConfig(phase, device="cpu", **kw), mesh=mesh,
                       init_state_dict=init)


def _two_shards():
    return make_mesh((2, 1), ["cpu", "cpu"])


def _moment(trainer, key):
    """{name: Adam's `key` state} of the home replica's trainable
    parameters."""
    return {n: trainer.optimizer.state[p][key].clone()
            for n, p in trainer.net.named_parameters() if p.requires_grad}


def _assert_near(got, want, tol, what):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=tol * float(w.abs().max()),
                                   err_msg=f"{what} {k}")


def _assert_metrics_near(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


def _assert_replicas_equal(trainer):
    assert len(trainer.replicas) == 2
    for r in trainer.replicas[1:]:
        for (k, p), q in zip(trainer.net.named_parameters(), r.parameters()):
            assert torch.equal(p, q), k
            assert p.requires_grad == q.requires_grad, k
            assert q.grad is None, k


@pytest.fixture(scope="module")
def jax_two_devices(narrow):  # noqa: F811
    """The JAX trainer on jax.devices()[:2] (its state replicated, as
    `__graft_entry__.py` does): phase 1, one step of batch 2 at 64x96 ->
    (metrics, {port name: Adam's mu})."""
    jcfg, flat = narrow
    mesh = jmake_mesh((2, 1), jax.devices()[:2])
    with mock.patch.object(jtrainer, "get_config",
                           lambda variant, dtype=None: jcfg):
        tr = jtrainer.Trainer(
            jtrainer.TrainerConfig(_jphase(PHASE1), variant="lite",
                                   steps_per_epoch=4, num_epochs=1),
            mesh=mesh, init_variables={"params": _tree(flat)})
    tr.state = jax.device_put(tr.state, replicated(mesh))
    with jax.default_matmul_precision("highest"):
        metrics = tr.train_epoch([_smooth_triplet(1)])
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        tr.state.opt_state,
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    mu = {"/".join(k): np.array(v) for k, v in
          flatten_dict(adam.mu).items() if hasattr(v, "shape")}
    return metrics, params_from_jax(mu)


def test_two_shards_match_the_jax_trainer_on_two_devices(
        narrow, jax_two_devices):  # noqa: F811
    """Loss, psnr and the loss terms within LOSS_RTOL; the first moment
    after one update (0.1 x the reduced gradient) within
    GRAD_TOL["phase1"] of each parameter's max."""
    _, flat = narrow
    want_metrics, want_mu = jax_two_devices
    tr = _make(PHASE1, _two_shards(), params_from_jax(flat),
               steps_per_epoch=4, num_epochs=1)
    got = tr.train_epoch([_smooth_triplet(1)])
    assert set(got) == set(want_metrics)
    for k in got:
        np.testing.assert_allclose(got[k], want_metrics[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    mu = _moment(tr, "exp_avg")
    assert len(mu) > 100
    _assert_near(mu, {k: want_mu[k] for k in mu}, GRAD_TOL["phase1"], "mu")
    _assert_replicas_equal(tr)


@pytest.mark.parametrize("case", ["phase1", "phase3", "phase1_accum_clip"])
def test_two_shards_match_one_device_at_the_full_batch(narrow, case):  # noqa: F811,E501
    """Metrics, the reduced gradient (the accumulator after a micro-step
    of k = 2) and both Adam moments after an update. Phase 3 runs global
    motion and trains both branches; the accumulation case clips to a
    global norm the gradient exceeds."""
    _, flat = narrow
    phase = PHASE3 if case == "phase3" else PHASE1
    kw = (dict(grad_accum=2, clip_grad_norm=1e-3)
          if case.endswith("clip") else {})
    one = _make(phase, None, params_from_jax(flat), **kw)
    two = _make(phase, _two_shards(), params_from_jax(flat), **kw)
    batches = [_smooth_triplet(s, B=BATCH)
               for s in (2, 3)[:kw.get("grad_accum", 1)]]
    for i, b in enumerate(batches):
        _assert_metrics_near(two.train_step(*b), one.train_step(*b))
        if i + 1 < len(batches):
            acc = dict(zip([n for n, p in one.net.named_parameters()
                            if p.requires_grad], one._acc))
            _assert_near(dict(zip(acc, two._acc)), acc, MOMENT_TOL["grad"],
                         "gradient")
            norm = torch.sqrt(sum(torch.sum(g * g) for g in one._acc))
            assert norm > 10 * kw["clip_grad_norm"]
    assert one.updates == two.updates == 1
    for key in ("exp_avg", "exp_avg_sq"):
        _assert_near(_moment(two, key), _moment(one, key), MOMENT_TOL[key],
                     key)
    _assert_replicas_equal(two)


def test_a_one_by_one_mesh_is_bit_equal_to_no_mesh():
    """Two steps of phase 3: metrics, weights and Adam's state."""
    a = _make(PHASE3, None, seed=4)
    b = _make(PHASE3, make_mesh((1, 1), ["cpu"]), seed=4)
    assert len(b.replicas) == 1 and b.device == torch.device("cpu")
    for s in (5, 6):
        ma, mb = a.train_step(*_smooth_triplet(s)), b.train_step(
            *_smooth_triplet(s))
        assert list(ma) == list(mb)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for (k, p), q in zip(a.net.named_parameters(), b.net.parameters()):
        assert torch.equal(p, q), k
    for key in ("exp_avg", "exp_avg_sq"):
        mb = _moment(b, key)
        assert all(torch.equal(v, mb[k])
                   for k, v in _moment(a, key).items()), key


def test_an_indivisible_batch_and_a_spatial_axis_raise():
    """A training batch of 3 on two shards raises ValueError, as JAX's
    device_put of it over the 'data' axis does; a 'spatial' extent above
    1 raises NotImplementedError."""
    jmesh = jmake_mesh((2, 1), jax.devices()[:2])
    with pytest.raises(ValueError):
        jtrainer.Trainer._shard_batch(types.SimpleNamespace(mesh=jmesh),
                                      np.zeros((3, 8, 8, 3), np.float32))
    tr = _make(PHASE1, _two_shards())
    with pytest.raises(ValueError, match="divide"):
        tr.train_step(*_smooth_triplet(7, B=3))
    assert tr.step == 0 and all(p.grad is None for p in tr.trainable)
    with pytest.raises(NotImplementedError, match="spatial"):
        _make(PHASE1, make_mesh((1, 2), ["cpu", "cpu"]))


def test_replicas_follow_the_home_replica_and_its_state(narrow):  # noqa: F811,E501
    """After two updates every replica is bit-equal to the home one; a
    two-shard trainer's state restored into another two-shard trainer
    (another seed) copies into its replicas too; restored into a
    one-device trainer it gives the same next step (metrics, moments)."""
    _, flat = narrow
    phase = dataclasses.replace(PHASE1, warmup_steps=1)
    a = _make(phase, _two_shards(), params_from_jax(flat))
    for s in (8, 9):
        a.train_step(*_smooth_triplet(s, B=BATCH))
    assert a.updates == 2
    _assert_replicas_equal(a)
    state = a.state_dict()
    b = _make(phase, _two_shards(), seed=11)
    b.load_state_dict(state)
    _assert_replicas_equal(b)
    for (k, p), q in zip(a.net.named_parameters(), b.replicas[1].parameters()):
        assert torch.equal(p, q), k
    one = _make(phase, None, seed=12)
    one.load_state_dict(state)
    nxt = _smooth_triplet(10, B=BATCH)
    _assert_metrics_near(a.train_step(*nxt), one.train_step(*nxt))
    for key in ("exp_avg", "exp_avg_sq"):
        _assert_near(_moment(a, key), _moment(one, key), MOMENT_TOL[key],
                     key)


def test_eval_over_the_mesh_matches_one_device():
    """Batch 2 over the shards within LOSS_RTOL of one device; batch 1
    (the validation loader's, which JAX's device_put refuses over two
    devices) runs on the home replica alone, bit-equal to one device.
    The pose term, a mean over the batch's crops (two boxes in the
    first sample, one in the second), is taken over the whole batch."""
    mix = np.random.default_rng(5).standard_normal((3, 17)).astype(
        np.float32)

    def detector(gt):
        boxes = [np.array([[2, 3, 40, 44, 0.9, 0], [30, 8, 90, 60, 0.8, 0]],
                          np.float32),
                 np.array([[10, 5, 70, 50, 0.9, 0]], np.float32)]
        return boxes[:len(gt)]

    def pose_fn(c):
        m, h, w, _ = c.shape
        pooled = c.reshape(m, h // 4, 4, w // 4, 4, 3).mean((2, 4))
        return torch.einsum("mhwc,ck->mkhw", pooled, torch.from_numpy(mix))

    phase = dataclasses.replace(PHASE1, use_pose_loss=True, pose_w=10.0)
    one, two = (_make(phase, m, seed=13) for m in (None, _two_shards()))
    one.pose_loss = two.pose_loss = PoseLoss(detector, pose_fn)
    b = _smooth_triplet(14)
    want, got = one.eval_step(*b), two.eval_step(*b)
    assert list(want)[-1] == "pose_loss" and float(want["pose_loss"]) > 0
    _assert_metrics_near(got, want)
    b1 = tuple(x[:1] for x in b)
    with pytest.raises(ValueError):
        jtrainer.Trainer._shard_batch(
            types.SimpleNamespace(mesh=jmake_mesh((2, 1),
                                                  jax.devices()[:2])), b1[0])
    want, got = one.eval_step(*b1), two.eval_step(*b1)
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_the_cli_builds_a_mesh_exactly_when_jax_does():
    """JAX's CLI: `make_mesh()` (every device, shape (n, 1)) when JAX
    sees more than one device. The port's: over every card when
    --device is cuda and there is more than one; a named card or the
    CPU trains on that one device."""
    for count in (0, 1, 2, 4):
        with mock.patch.object(torch.cuda, "device_count", lambda: count), \
                mock.patch.object(torch.cuda, "is_available",
                                  lambda: count > 0):
            mesh = train_cli.train_mesh("cuda")
            assert train_cli.train_mesh("cuda:0") is None
            assert train_cli.train_mesh("cpu") is None
        if count <= 1:
            assert mesh is None
            continue
        want = jmake_mesh(devices=jax.devices()[:count])
        assert mesh.shape == dict(want.shape)
        assert [str(d) for d in mesh.axis_devices("data")] == [
            f"cuda:{i}" for i in range(count)]

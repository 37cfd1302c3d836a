"""Checkpoints out of the port: `convert.params_to_jax`, `save_npz` and
`save_checkpoint` read back by the JAX package (keys, shapes, values and
its forward), and the two checkpoint CLIs of the port."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from atmvfi_tpu.convert import load_torch_checkpoint
from atmvfi_tpu.models import Network as JNetwork
from atmvfi_tpu.models import get_config as jconfig
from atmvfi_tpu.train.checkpoints import (
    load_params_meta,
    load_params_npz,
    save_params_npz,
)
from atmvfi_tpu_torch import convert
from atmvfi_tpu_torch.cli import convert_checkpoint, export_checkpoint
from atmvfi_tpu_torch.models import Network, get_config
from test_torch_model import (
    NARROW,
    XLA_ROUTES,
    _jax_variables,
    _param_shapes,
    _random_params,
)

torch.set_num_threads(2)  # the test workers share the CPU


@pytest.fixture(scope="module")
def narrow():
    """(JAX config, the port's seeded narrow lite network, the JAX
    forward at 64x96 with its inputs, the port's I_t there)."""
    jcfg = dataclasses.replace(jconfig("lite"), **NARROW, **XLA_ROUTES)
    flat = _random_params(_param_shapes(jcfg), seed=6)
    net = Network(dataclasses.replace(get_config("lite"), **NARROW))
    net.load_state_dict(convert.params_from_jax(flat), strict=True)
    net.eval()
    rng = np.random.default_rng(3)
    ims = [rng.random((1, 64, 96, 3), dtype=np.float32) for _ in range(2)]
    with torch.no_grad():
        it = net(*(torch.from_numpy(i) for i in ims))["I_t"].numpy()
    fwd = jax.jit(JNetwork(jcfg).apply)

    def jax_it(variables):
        with jax.default_matmul_precision("highest"):
            return np.asarray(fwd(variables, *map(jnp.asarray, ims))["I_t"])

    return net, jax_it, it, flat


def test_save_npz_loads_into_jax(tmp_path, narrow):
    """port -> save_npz -> JAX load_params_npz: the same params, meta
    kept, and JAX's forward within 1e-4 of the port's (f32, 64x96)."""
    net, jax_it, it, flat = narrow
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, net.state_dict(), meta={"epoch": 7})
    variables = load_params_npz(path)
    assert load_params_meta(path) == {"epoch": 7}
    got = {"/".join(k): v for k, v in flatten_dict(variables).items()}
    assert set(got) == {f"params/{k}" for k in flat}
    for k, v in flat.items():
        np.testing.assert_array_equal(got[f"params/{k}"],
                                      np.asarray(v, np.float32))
    np.testing.assert_allclose(jax_it(variables), it, atol=1e-4, rtol=0)


def test_save_checkpoint_loads_into_jax(tmp_path, narrow):
    """port -> save_checkpoint (the reference's wrapped .pt) -> JAX
    load_torch_checkpoint: JAX's forward within 1e-4 of the port's; the
    port's reader gives back the state_dict exactly; cached buffers
    in the state_dict are dropped on the way out."""
    net, jax_it, it, _ = narrow
    path = str(tmp_path / "w.pt")
    sd = dict(net.state_dict())
    sd["local_motion_atmformer.0.attn.relative_coord"] = torch.zeros(2)
    convert.save_checkpoint(path, sd, meta={"epoch": 2})
    raw = torch.load(path, map_location="cpu", weights_only=False)
    assert set(raw) == {"model_state_dict", "optimizer_state_dict",
                        "meta_data", "train_metric", "val_metric"}
    assert raw["meta_data"] == {"epoch": 2}
    variables, _ = load_torch_checkpoint(path)
    np.testing.assert_allclose(jax_it(variables), it, atol=1e-4, rtol=0)
    back, _ = convert.load_checkpoint(path)
    assert set(back) == set(net.state_dict())
    for k, v in net.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_npz_keys_match_jax_save(tmp_path):
    """The port's .npz of a full lite model holds the keys, shapes and
    values of the JAX package's own `save_params_npz` of the same
    variables ({'params': ...}, as its trainer and converter write
    them)."""
    flat = _random_params(_param_shapes(jconfig("lite")), seed=8)
    sd = convert.params_from_jax(flat)
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    convert.save_npz(mine, sd, meta={"v": "lite"})
    save_params_npz(theirs, _jax_variables(flat), meta={"v": "lite"})
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_checkpoint_clis(tmp_path, capsys):
    """A full lite model: .npz -> export_checkpoint -> .pt ->
    convert_checkpoint -> .npz, each verified against the port's lite
    network; the weights and the meta survive the round trip. A narrow
    model fails the check."""
    flat = _random_params(_param_shapes(jconfig("lite")), seed=9)
    sd = convert.params_from_jax(flat)
    src, pt, back = (str(tmp_path / f) for f in ("a.npz", "b.pt", "c.npz"))
    convert.save_npz(src, sd, meta={"epoch": 4})
    assert export_checkpoint.main([src, pt, "--variant", "lite"]) == 0
    assert convert_checkpoint.main([pt, back, "--variant", "lite"]) == 0
    said = capsys.readouterr().out
    assert said.count("verified 232 parameters against lite") == 2
    got, meta = convert.load_npz(back)
    assert meta == {"meta_data": {"epoch": 4}, "train_metric": {},
                    "val_metric": {}}
    for k, v in sd.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    narrow = Network(dataclasses.replace(get_config("lite"), **NARROW))
    convert.save_npz(src, narrow.state_dict())
    with pytest.raises(SystemExit, match="shape mismatch"):
        export_checkpoint.main([src, pt, "--variant", "lite"])
    assert export_checkpoint.main([src, pt, "--no_verify"]) == 0
    assert convert.load_checkpoint(pt)[1] == {
        "meta_data": {}, "train_metric": {}, "val_metric": {}}

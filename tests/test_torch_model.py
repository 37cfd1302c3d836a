"""The port's weight bridge and whole two-frame forward against the JAX
package on the CPU (f32; JAX at HIGHEST matmul precision)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from atmvfi_tpu.convert.torch_export import to_torch_state_dict
from atmvfi_tpu.infer.pipeline import InterpolationPipeline as JPipeline
from atmvfi_tpu.models import Network as JNetwork
from atmvfi_tpu.models import get_config as jconfig
from atmvfi_tpu_torch.convert import load_checkpoint, load_npz, params_from_jax
from atmvfi_tpu_torch.infer import InterpolationPipeline
from atmvfi_tpu_torch.models import Network, get_config

torch.set_num_threads(2)  # the test workers share the CPU

# narrow lite: every token width divisible by the 8 heads
NARROW = dict(hidden_dims=(8, 16, 16, 32), last_feat_extra=16,
              global_mlp_hidden=64, refine_hidden=16)
XLA_ROUTES = dict(conv_impl="xla", tail_planar="off", attention_impl="xla",
                  warp_impl="xla")
# flow channels of the motion heads, scaled up so the warps move by
# several pixels (seeded random weights alone give sub-pixel flows)
FLOW_GAIN = {"global_motion_mlp_2": 3.0, "local_motion_mlp_2": 15.0,
             "upsample0_2": 40.0, "upsample1_3": 40.0, "upsample2_3": 40.0}


def _param_shapes(cfg):
    net = JNetwork(cfg)
    im = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    tree = jax.eval_shape(lambda a, b: net.init(jax.random.PRNGKey(0), a, b),
                          im, im)
    return {"/".join(k): v.shape for k, v in flatten_dict(tree["params"]).items()}


def _random_params(shapes, seed):
    """Seeded numpy params with the init statistics' scales."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, shape in sorted(shapes.items()):
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        elif leaf == "scale":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif leaf == "prelu":
            v = 0.25 + 0.05 * rng.standard_normal(shape)
        else:
            v = rng.uniform(-0.05, 0.05, shape)
        mod = path.split("/", 1)[0]
        if mod in FLOW_GAIN:
            v[..., -5:-1] *= FLOW_GAIN[mod]
        flat[path] = v.astype(np.float32)
    return flat


def _jax_variables(flat):
    return {"params": unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                      for k, v in flat.items()})}


@pytest.mark.parametrize("variant,millions", [("base", 51.5643),
                                              ("lite", 11.9755)])
def test_weight_bridge_and_param_counts(variant, millions):
    shapes = _param_shapes(jconfig(variant))
    flat = _random_params(shapes, seed=len(variant))
    sd = params_from_jax(flat)
    want = to_torch_state_dict(_jax_variables(flat))
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    net = Network(get_config(variant))
    net.load_state_dict(sd, strict=True)
    n = sum(p.numel() for p in net.parameters())
    assert n == sum(int(np.prod(s)) for s in shapes.values())
    assert round(n / 1e6, 4) == millions


@pytest.mark.parametrize("fmt", ["npz", "pt_wrapped", "pt_raw"])
def test_checkpoint_readers(tmp_path, fmt):
    """The JAX package's .npz and reference-format .pt files (wrapped or
    raw, with the cached resolution buffers) load strictly."""
    from atmvfi_tpu.train.checkpoints import save_params_npz

    cfg = dataclasses.replace(jconfig("lite"), **NARROW)
    flat = _random_params(_param_shapes(cfg), seed=3)
    want = params_from_jax(flat)
    if fmt == "npz":
        path = str(tmp_path / "p.npz")
        save_params_npz(path, _jax_variables(flat), meta={"step": 7})
        sd, meta = load_npz(path)
        assert meta == {"step": 7}
    else:
        path = str(tmp_path / "p.pt")
        raw = dict(want)
        raw["local_motion_atmformer.0.attn.relative_coord"] = torch.zeros(2)
        raw["local_motion_atmformer.1.attn_mask"] = torch.zeros(3)
        raw["feat_enhance_transformer.0.HW"] = torch.zeros(2)
        obj = raw if fmt == "pt_raw" else {
            "model_state_dict": raw, "optimizer_state_dict": None,
            "meta_data": {"epoch": 3}}
        torch.save(obj, path)
        sd, meta = load_checkpoint(path)
        assert meta == ({} if fmt == "pt_raw" else {"meta_data": {"epoch": 3}})
    net = Network(dataclasses.replace(get_config("lite"), **NARROW))
    net.load_state_dict(sd, strict=True)
    assert set(sd) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


@pytest.fixture(scope="module")
def narrow_pair():
    jcfg = dataclasses.replace(jconfig("lite"), **NARROW, **XLA_ROUTES)
    flat = _random_params(_param_shapes(jcfg), seed=0)
    net = Network(dataclasses.replace(get_config("lite"), **NARROW))
    net.load_state_dict(params_from_jax(flat), strict=True)
    return jcfg, _jax_variables(flat), net.eval(), flat


@pytest.mark.parametrize("global_motion", [True, False])
@pytest.mark.parametrize("hw", [(64, 96), (128, 128)])
def test_full_forward_matches_jax(narrow_pair, hw, global_motion):
    """64x96 center-pads the 1/8 (local, window 8) and 1/16 (global,
    window 12) token maps; 128x128 only the 1/16 one. Tolerances: I_t
    max |d| <= 1e-4, flows <= 1e-3 px (f32 on both sides)."""
    jcfg, variables, net, _ = narrow_pair
    rng = np.random.default_rng(hw[0] + global_motion)
    im0 = rng.random((1, *hw, 3), dtype=np.float32)
    im1 = rng.random((1, *hw, 3), dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(JNetwork(jcfg).apply, static_argnames="global_motion")(
            variables, jnp.asarray(im0), jnp.asarray(im1),
            global_motion=global_motion)
    with torch.no_grad():
        got = net(torch.from_numpy(im0), torch.from_numpy(im1),
                  global_motion=global_motion)
    assert np.abs(np.asarray(want["opt_flow_0"])).max() > 1.0  # real motion
    np.testing.assert_allclose(got["I_t"].numpy(), np.asarray(want["I_t"]),
                               atol=1e-4, rtol=0)
    for k in ("opt_flow_0", "opt_flow_1"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["occ_mask1"].numpy(),
                               np.asarray(want["occ_mask1"]), atol=1e-4)
    assert len(got["im_t_list"]) == len(want["im_t_list"])
    for g, w in zip(got["im_t_list"], want["im_t_list"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_pipeline_interpolate_matches_jax(narrow_pair):
    """uint8 in and out, replicate pad to 64, unpad, round: the two
    pipelines agree to one grey level (rounding at a .5 boundary)."""
    jcfg, variables, _, flat = narrow_pair
    rng = np.random.default_rng(9)
    f0 = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    f1 = np.roll(f0, (2, -3), (0, 1))
    jp = JPipeline(variables, variant="lite", dtype=jnp.float32)
    jp.cfg = jcfg
    jp.net = JNetwork(jcfg)  # read when the forward is first traced
    with jax.default_matmul_precision("highest"):
        want = jp.interpolate(f0, f1)
    tp = InterpolationPipeline(
        params_from_jax(flat),
        dataclasses.replace(get_config("lite"), **NARROW),
        dtype=torch.float32, device="cpu")
    got = tp.interpolate(f0, f1)
    assert got.shape == want.shape == (50, 70, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # the 4x stream: 4 frames per step plus the last source frame
    frames = list(tp.interpolate_stream([f0, f1], factor=4))
    assert len(frames) == 5
    np.testing.assert_array_equal(frames[0], f0)
    np.testing.assert_array_equal(frames[-1], f1)
    np.testing.assert_array_equal(frames[2], got)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InterpolationPipeline(None, dataclasses.replace(
            get_config("lite"), **NARROW))
    with pytest.raises(ValueError, match="global_motion"):
        InterpolationPipeline(None, "lite", global_motion=False,
                              ensemble_global_motion=True, device="cpu")

"""Attention windows above 12 (the card's key-tiled attention forms): the
port's narrow forward against JAX's at the same windows on the CPU, f32,
the same weights on both sides."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from atmvfi_tpu.models import Network as JNetwork
from atmvfi_tpu.models import get_config as jconfig
from atmvfi_tpu_torch.convert import params_from_jax
from atmvfi_tpu_torch.models import Network, get_config
from test_torch_model import (
    NARROW,
    XLA_ROUTES,
    _jax_variables,
    _param_shapes,
    _random_params,
)

torch.set_num_threads(2)  # the test workers share the CPU


@pytest.mark.parametrize("windows", [(16, 16, 16), (13, 13, 8)])
def test_large_window_forward_matches_jax(windows):
    """Windows (16, 16, 16) (N = 256) and 13 (N = 169, not a multiple of
    16) at 64x96, where the 1/8 and 1/16 token maps are center-padded to
    one window: I_t within 1e-4 of JAX's forward at the same windows,
    flows within 1e-3 px."""
    hw = (64, 96)
    jcfg = dataclasses.replace(jconfig("lite"), **NARROW,
                               **XLA_ROUTES).with_windows(*windows)
    flat = _random_params(_param_shapes(jcfg), seed=sum(windows))
    cfg = dataclasses.replace(get_config("lite"), **NARROW).with_windows(
        *windows)
    net = Network(cfg)
    net.load_state_dict(params_from_jax(flat), strict=True)
    assert net.local_motion_atmformer[1].attn.window_size == windows[0]
    rng = np.random.default_rng(hw[0])
    ims = [rng.random((1, *hw, 3), dtype=np.float32) for _ in range(2)]
    with jax.default_matmul_precision("highest"):
        want = jax.jit(JNetwork(jcfg).apply)(_jax_variables(flat),
                                             *map(jnp.asarray, ims))
    with torch.no_grad():
        got = net.eval()(*(torch.from_numpy(i) for i in ims))
    np.testing.assert_allclose(got["I_t"].numpy(), np.asarray(want["I_t"]),
                               atol=1e-4, rtol=0)
    for k in ("opt_flow_0", "opt_flow_1"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=0)

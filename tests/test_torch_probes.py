"""Row P's probes in the port, on the CPU: K2's exact gather over a tile
whose source rows spread over several rows (the warp-v2 loop probes of
`scripts/pallas_probe4.py`, p6's pattern) through the plain `flow_warp` /
`flow_warp_pair`, against numpy and against JAX's `flow_warp_tiled` in
interpret mode; the gridded matmul's plain version (the counterpart of
`tests/test_roofline.py:56`) against a @ b."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from atmvfi_tpu.ops.warp_pallas import flow_warp_tiled
from atmvfi_tpu_torch.ops import probe_cuda, warp_cuda

torch.set_num_threads(2)  # the test workers share the CPU


def test_spread_case_is_p6():
    """The case's first 8 x 128 tile is p6's gather: row 9 + i + (l % 3),
    column (7 l + i) % 128 (scripts/pallas_probe4.py:197-232)."""
    x, flow, want = probe_cuda.spread_gather_case()
    i = np.arange(8)[:, None] + np.zeros((1, 128), np.int64)
    row = 9 + i + np.arange(128)[None] % 3
    idx = (np.arange(128)[None] * 7 + i) % 128
    np.testing.assert_array_equal(want[0, :8, :, 0], x[0, :, :, 0][row, idx])
    assert np.all(flow == np.round(flow))
    assert np.ptp(flow[0, :8, :, 1]) == 2  # rows i + 9 to i + 11: spread 3


@pytest.mark.parametrize("form", ["single", "pair"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spread_gather_exact(form, dtype):
    """The plain K2 forms give numpy's x[row, col] exactly (every tap but
    one has weight 0), f32 and bf16 (values bf16-exact)."""
    x, flow, want = probe_cuda.spread_gather_case()
    xt, ft = torch.from_numpy(x).to(dtype), torch.from_numpy(flow)
    if form == "single":
        outs = [warp_cuda.flow_warp(xt, ft)]
    else:
        outs = warp_cuda.flow_warp_pair(xt, xt.flip(2), ft, ft)
        want = [want, x[:, :, ::-1][0][
            (9 + np.arange(64)[:, None] + np.arange(128)[None] % 3) % 64,
            (7 * np.arange(128)[None] + np.arange(64)[:, None]) % 128][None]]
    for o, w in zip(outs, want if form == "pair" else [want]):
        assert o.dtype == dtype
        np.testing.assert_array_equal(o.float().numpy(), w)


@pytest.mark.parametrize("inner", ["scan", "span"])
def test_spread_gather_matches_jax_tiled(inner):
    """At 64 x 256 (the tile-slab kernel takes W >= 256) the plain warp
    and JAX's flow_warp_tiled in interpret mode (v3 scan and the v2 span
    loop that p1-p6 probed) both give the exact gather."""
    x, flow, want = probe_cuda.spread_gather_case(64, 256, seed=1)
    got = warp_cuda.flow_warp(torch.from_numpy(x), torch.from_numpy(flow))
    jgot = flow_warp_tiled(jnp.asarray(x), jnp.asarray(flow), slab_rows=64,
                           interpret=True, inner=inner)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jgot), want)


@pytest.mark.parametrize("shape", [(128, 64, 64), (200, 48, 80)])
def test_grid_matmul_plain(shape):
    """Block by block over the 64-row grid (ragged last block too) equals
    a @ b; a CPU call counts a call and no launch."""
    M, K, N = shape
    rng = np.random.default_rng(M)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    probe_cuda.grid_matmul.calls = probe_cuda.grid_matmul.launches = 0
    out = probe_cuda.grid_matmul(a, b)
    torch.testing.assert_close(out, a @ b, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), a.numpy() @ b.numpy(),
                               atol=1e-4, rtol=1e-5)
    assert (probe_cuda.grid_matmul.calls,
            probe_cuda.grid_matmul.launches) == (1, 0)


def test_grid_matmul_refuses_other_devices():
    a = torch.empty(128, 64, device="meta")
    with pytest.raises(ValueError, match="no grid_matmul"):
        probe_cuda.grid_matmul(a, torch.empty(64, 64, device="meta"))

"""The port's tools on the CPU: `utils.profiling` (summarize of a Chrome
trace the test writes, a CPU capture), `parallel.make_deep_shard_sim`
against JAX's (narrow lite, f32; JAX at HIGHEST matmul precision) and
its projection, `utils.flow_io` byte-equal to the JAX package's writers
and read back both ways, and `utils.registry.build_from_cfg`."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from atmvfi_tpu.models import Network as JNetwork
from atmvfi_tpu.models import get_config as jconfig
from atmvfi_tpu.parallel import spatial as jspatial
from atmvfi_tpu.utils import flow_io as jflow_io
from atmvfi_tpu_torch.convert import params_from_jax
from atmvfi_tpu_torch.models import Network, get_config
from atmvfi_tpu_torch.ops import warp_cuda
from atmvfi_tpu_torch.parallel import (
    deep_shard_projection,
    make_deep_shard_sim,
    spatial_ici_bytes_deep,
)
from atmvfi_tpu_torch.utils import flow_io, profiling
from atmvfi_tpu_torch.utils.registry import build_from_cfg
from test_torch_model import (
    NARROW,
    XLA_ROUTES,
    _jax_variables,
    _param_shapes,
    _random_params,
)

torch.set_num_threads(2)  # the test workers share the CPU


# ---- profiling ------------------------------------------------------------
def _event(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 7,
            "ts": ts, "dur": dur}


def test_summarize_chrome_trace(tmp_path):
    """Busy time, families, stages (first range holding a kernel's start;
    the rest unattributed), the top kernels and the idle share of a
    trace written here; host events and non-stage ranges are ignored."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "x"}},
        _event("encoder", "gpu_user_annotation", 0, 100),
        _event("decoder", "gpu_user_annotation", 100, 100),
        _event("not a stage", "gpu_user_annotation", 0, 300),
        _event("encoder", "user_annotation", 0, 1000),  # host range
        _event("aten::mm", "cpu_op", 0, 500),  # host op
        _event("void conv3x3_wgmma_kernel<128, 1, 0>(Args)", "kernel", 10, 30),
        _event("void conv3x3_wgmma_kernel<128, 1, 0>(Args)", "kernel", 50, 20),
        _event("void warp_narrow_kernel<float, 4>(WarpArgs)", "kernel", 120,
               40),
        _event("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 170, 10),
        _event("grid_matmul_kernel(float const*)", "kernel", 250, 50),
    ]
    with open(tmp_path / profiling.TRACE_FILE, "w") as f:
        json.dump({"traceEvents": events}, f)
    s = profiling.summarize(str(tmp_path), top=2)
    assert s["total_ms"] == pytest.approx(0.150)
    assert s["span_ms"] == pytest.approx(0.290)
    assert s["idle_share"] == pytest.approx(1 - 150 / 290)
    assert s["by_category_ms"] == pytest.approx({
        "K3 / K4 conv kernels": 0.050, "row P grid matmul": 0.050,
        "K2 / K9 / K10 warp": 0.040, "elementwise / copy": 0.010})
    assert s["by_source_ms"] == pytest.approx({
        "encoder": 0.050, "decoder": 0.050, "unattributed": 0.050})
    assert list(s["by_kernel"]) == [
        "void conv3x3_wgmma_kernel<128, 1, 0>(Args)",
        "grid_matmul_kernel(float const*)"]
    assert s["by_kernel"]["void conv3x3_wgmma_kernel<128, 1, 0>(Args)"][
        "calls"] == 2


def test_capture_on_cpu(tmp_path):
    """A CPU capture returns fn's result and writes a Chrome trace that
    holds the forward's `span` range; with no device work in it,
    summarize refuses it rather than report a device time of 0."""
    from atmvfi_tpu_torch.models.network import span

    def fn(a, b):
        with span("encoder"):
            return a @ b

    a, b = torch.randn(8, 4), torch.randn(4, 3)
    out, trace_dir = profiling.capture(fn, a, b, trace_dir=str(tmp_path))
    assert trace_dir == str(tmp_path)
    torch.testing.assert_close(out, a @ b)
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "encoder" in names
    with pytest.raises(ValueError, match="no device kernels"):
        profiling.summarize(trace_dir)


# ---- the deep-shard simulation ----------------------------------------------
@pytest.fixture(scope="module")
def narrow():
    jcfg = dataclasses.replace(jconfig("lite"), **NARROW, **XLA_ROUTES)
    flat = _random_params(_param_shapes(jcfg), seed=0)
    net = Network(dataclasses.replace(get_config("lite"), **NARROW))
    net.load_state_dict(params_from_jax(flat), strict=True)
    return jcfg, _jax_variables(flat), net.eval()


@pytest.mark.parametrize("n,H", [(2, 128), (4, 256)])
def test_deep_shard_sim_matches_jax(narrow, n, H):
    """One interior shard's deep program with the collectives' stand-ins:
    I_t rows [1, H / n, W, 3] within 1e-4 of JAX's simulation; the
    shard's K10 (pre-align, blend) and row warps (token pre-align,
    decoder input) run once each pair, no full-frame warp."""
    jcfg, variables, net = narrow
    W = 64
    rng = np.random.default_rng(n)
    im0, im1 = (rng.random((1, H, W, 3), dtype=np.float32) for _ in range(2))
    jsim = jspatial.make_deep_shard_sim(JNetwork(jcfg), H, W, n)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jsim)(variables, jnp.asarray(im0), jnp.asarray(im1))
    for fn in (warp_cuda.warp_pair_srcfull, warp_cuda.flow_warp_rows,
               warp_cuda.flow_warp, warp_cuda.flow_warp_pair):
        fn.calls = 0
    got = make_deep_shard_sim(net, H, W, n)(torch.from_numpy(im0),
                                            torch.from_numpy(im1))
    assert got.shape == (1, H // n, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert (warp_cuda.warp_pair_srcfull.calls, warp_cuda.flow_warp_rows.calls,
            warp_cuda.flow_warp.calls, warp_cuda.flow_warp_pair.calls) == (
                2, 4, 0, 0)


def test_deep_shard_projection():
    """Projected frame time = shard ms + the deep schedule's bytes over
    the link rate (NVLink 4 one way, 450 GB/s, by default)."""
    cfg = get_config("base", torch.bfloat16)
    p = deep_shard_projection(20.0, 1088, 1920, 4, cfg)
    ici = spatial_ici_bytes_deep(1088, 1920, 4, cfg.fused_dim,
                                 cfg.global_dim, 2)
    assert p["ici_bytes"] == ici
    assert p["link_ms"] == pytest.approx(ici / 450e9 * 1e3)
    assert p["projected_fps"] == pytest.approx(1e3 / (20.0 + p["link_ms"]))
    with pytest.raises(ValueError):
        make_deep_shard_sim(Network(get_config("lite")), 1088, 1920, 3)


# ---- flow_io and the registry ------------------------------------------------
FILES = {
    "flo": ("write_flow", "read_flow", (7, 9, 2)),
    "pfm colour": ("write_pfm", "read_pfm", (5, 6, 3)),
    "pfm grey": ("write_pfm", "read_pfm", (5, 6)),
    "float3": ("write_float3", "read_float3", (4, 5, 2)),
}


@pytest.mark.parametrize("kind", list(FILES))
def test_flow_io_matches_jax(tmp_path, kind):
    """The port's writer gives the JAX writer's bytes; each package reads
    the other's file back exactly; `read` dispatches on the extension."""
    write, read, shape = FILES[kind]
    data = np.random.default_rng(len(kind)).standard_normal(shape).astype(
        np.float32)
    ext = kind.split()[0]
    mine, theirs = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
    getattr(flow_io, write)(mine, data)
    getattr(jflow_io, write)(theirs, data)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    for got in (getattr(flow_io, read)(theirs), getattr(jflow_io, read)(mine),
                flow_io.read(mine)):
        got = got[0] if isinstance(got, tuple) else got
        np.testing.assert_array_equal(got, data)


def test_build_from_cfg():
    meter = build_from_cfg({"type": "atmvfi_tpu_torch.utils.meters."
                                    "AverageMeter"})
    meter.update(2.0)
    meter.update(4.0)
    assert meter.avg == 3.0
    cfg = build_from_cfg({"type": "atmvfi_tpu_torch.models.config."
                                  "ATMVFIConfig", "num_heads": 4})
    assert cfg.num_heads == 4
    with pytest.raises(ValueError):
        build_from_cfg({"type": "NoDots"})

"""The port's counted roofline (`utils.roofline`) on the CPU: exact FLOPs
of known ops against JAX's `count_flops` (a transposed convolution at a
quarter of JAX's lhs-dilated count), the gridded matmul counted through
its grid, kernels counted by their plain versions in the wrapper's
compute dtype and bytes at the wrapper's operands, the base 1088x1920
forward by family against JAX's jaxpr, and no cache keeping a fake
tensor after a count."""
import dataclasses
import math
import time
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

import jax
import jax.numpy as jnp

from atmvfi_tpu.models import Network as JNetwork
from atmvfi_tpu.models import get_config as jconfig
from atmvfi_tpu.utils import roofline as jroof
from atmvfi_tpu_torch.models import Network, get_config
from atmvfi_tpu_torch.models import layers
from atmvfi_tpu_torch.ops import conv_cuda, probe_cuda, warp_cuda
from atmvfi_tpu_torch.utils import roofline
from test_torch_model import NARROW

torch.set_num_threads(2)  # the test workers share the CPU

S = jax.ShapeDtypeStruct


def _jax_conv(x, k, **kw):
    return jax.lax.conv_general_dilated(
        x, k, kw.get("strides", (1, 1)), kw.get("padding", "SAME"),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=kw.get("groups", 1))


CASES = {  # name -> (JAX fn, JAX args, port fn, port args, port / JAX)
    "dot": (lambda a, b: a @ b, (S((64, 32), jnp.float32),
                                 S((32, 48), jnp.float32)),
            lambda a, b: a @ b, ((64, 32), (32, 48)), 1.0),
    "batched dot": (lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                    (S((3, 16, 8), jnp.float32), S((3, 8, 24), jnp.float32)),
                    lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                    ((3, 16, 8), (3, 8, 24)), 1.0),
    "linear": (lambda x, w, b: x @ w + b,
               (S((10, 20), jnp.float32), S((20, 30), jnp.float32),
                S((30,), jnp.float32)),
               lambda x, w, b: F.linear(x, w, b), ((10, 20), (30, 20), (30,)),
               1.0),
    "conv 3x3": (_jax_conv, (S((1, 16, 16, 8), jnp.float32),
                             S((3, 3, 8, 24), jnp.float32)),
                 lambda x, k: F.conv2d(x, k, padding=1),
                 ((1, 8, 16, 16), (24, 8, 3, 3)), 1.0),
    "conv 3x3 stride 2": (lambda x, k: _jax_conv(x, k, strides=(2, 2),
                                                 padding=((1, 1), (1, 1))),
                          (S((2, 16, 16, 8), jnp.float32),
                           S((3, 3, 8, 12), jnp.float32)),
                          lambda x, k: F.conv2d(x, k, stride=2, padding=1),
                          ((2, 8, 16, 16), (12, 8, 3, 3)), 1.0),
    "deconv 2x2": (lambda x, k: jax.lax.conv_transpose(
                       x, k, (2, 2), "VALID",
                       dimension_numbers=("NHWC", "HWIO", "NHWC")),
                   (S((1, 8, 8, 16), jnp.float32),
                    S((2, 2, 16, 12), jnp.float32)),
                   lambda x, k: F.conv_transpose2d(x, k, stride=2),
                   ((1, 16, 8, 8), (16, 12, 2, 2)), 0.25),
}


@pytest.mark.parametrize("case", list(CASES))
def test_known_ops_match_jax(case):
    """tc FLOPs of a dot, a batched dot, a biased dense layer and convs
    equal JAX's mxu count; a k = 2, s = 2 transposed conv is a quarter of
    it (JAX counts the lhs-dilated input's zero taps)."""
    jfn, jargs, tfn, tshapes, ratio = CASES[case]
    want = jroof.count_flops(jfn, *jargs)["mxu_flops"]
    got = roofline.count_flops(tfn, *[torch.empty(s) for s in tshapes])
    assert got["tc_flops"] == want * ratio
    assert got["tc_f32_flops"] == got["tc_flops"]


def test_grid_matmul_counted_through_its_grid():
    """[128, 64] @ [64, 64] on grid (2,): exactly 2 * 2 * 64**3 tc FLOPs,
    as JAX counts the Pallas probe; the count neither calls nor launches
    the wrapper, and its result is a @ b's shape."""
    a, b = torch.randn(128, 64), torch.randn(64, 64)
    probe_cuda.grid_matmul.calls = probe_cuda.grid_matmul.launches = 0
    c = roofline.count_flops(probe_cuda.grid_matmul, a, b)
    assert c["tc_flops"] == 2 * 2 * 64 * 64 * 64 == 1_048_576
    assert c["kernels"] == {"grid_matmul": 1_048_576}
    assert c["bytes_min"] == c["bytes_io"] == (128 * 64 + 64 * 64
                                               + 128 * 64) * 4
    assert (probe_cuda.grid_matmul.calls,
            probe_cuda.grid_matmul.launches) == (0, 0)
    assert not any(isinstance(m, roofline.Count)
                   for m in _get_current_dispatch_mode_stack())


def test_kernel_counts_in_wrapper_dtype_and_operand_bytes():
    """A bf16 K3 call inside a function: its tc FLOPs are bf16 (the plain
    version's f32 upcast does not count), its bytes are its operands in
    their own dtypes and its result, the input's doubling materializes
    only as the kernel's operand."""
    x = torch.randn(1, 16, 16, 32).to(torch.bfloat16)
    w, b, a = torch.randn(24, 32, 3, 3), torch.randn(24), torch.randn(24)

    def f(x, w, b, a):
        return conv_cuda.conv3x3(x * 2, w, b, a)

    c = roofline.count_flops(f, x, w, b, a)
    flops = 2 * 16 * 16 * 24 * 9 * 32
    assert (c["tc_bf16_flops"], c["tc_f32_flops"]) == (flops, 0)
    assert c["kernels"]["conv3x3"] == pytest.approx(flops, rel=0.01)
    io = x.numel() * 2 + (w.numel() + 48) * 4 + 16 * 16 * 24 * 2
    assert c["bytes_io"] == io
    bd = roofline.live_bytes_breakdown(f, x, w, b, a)
    assert bd == {"io": io, "kernel:conv3x3": x.numel() * 2}
    assert roofline.io_bytes(f, x, w, b, a) == io


def _jax_families(jaxpr, scale=1.0, out=None):
    """tc FLOPs of a jaxpr by family, walked as `count_jaxpr` walks it."""
    out = Counter() if out is None else out
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "dot_general":
            out["dot"] += jroof._dot_flops(e) * scale
        elif name == "conv_general_dilated":
            dn = e.params["dimension_numbers"]
            k = "x".join(str(int(e.invars[1].aval.shape[i]))
                         for i in dn.rhs_spec[2:])
            kind = ("deconv" if any(d > 1 for d in e.params["lhs_dilation"])
                    else "conv")
            out[f"{kind} {k}"] += jroof._conv_flops(e) * scale
        elif name == "scan":
            _jax_families(e.params["jaxpr"].jaxpr,
                          scale * e.params["length"], out)
        elif name == "while":
            _jax_families(e.params["body_jaxpr"].jaxpr, scale, out)
        elif name == "cond":
            _jax_families(e.params["branches"][-1].jaxpr, scale, out)
        elif name == "pallas_call":
            grid = getattr(e.params.get("grid_mapping"), "grid", ()) or ()
            inner = e.params["jaxpr"]
            _jax_families(getattr(inner, "jaxpr", inner),
                          scale * math.prod(int(g) for g in grid), out)
        else:
            inner = e.params.get("jaxpr") or e.params.get("call_jaxpr")
            if inner is not None:
                _jax_families(getattr(inner, "jaxpr", inner), scale, out)
    return out


def test_base_1080p_families_match_jax():
    """Base, bf16 towers, global motion, 1088x1920: conv 3x3, conv 1x1
    and dot equal JAX's within 0.1 %, the deconv family is exactly JAX's
    / 4, and the MLP's depthwise 3x3 convs (JAX: shifted multiply-adds,
    vpu work) are simt work here. Total tc 5.917 TFLOP."""
    H, W = 1088, 1920
    net = JNetwork(jconfig("base", dtype=jnp.bfloat16))
    im = S((1, H, W, 3), jnp.float32)
    v = jax.eval_shape(lambda a, b: net.init(jax.random.PRNGKey(0), a, b),
                       im, im)
    jaxpr = jax.make_jaxpr(lambda v, a, b: net.apply(v, a, b)["I_t"])(
        v, im, im)
    want = _jax_families(jaxpr.jaxpr)
    got = roofline.model_roofline("base", H, W)
    fam = got["families"]
    assert set(want) == {"conv 3x3", "conv 1x1", "dot", "deconv 2x2"}
    for k in ("conv 3x3", "conv 1x1", "dot"):
        assert fam[k] == pytest.approx(want[k], rel=1e-3)
    assert fam["deconv 2x2"] == want["deconv 2x2"] / 4
    assert fam["depthwise 3x3"] > 0
    assert got["tc_flops"] == sum(fam[k] for k in want)
    assert got["tc_tflop"] == pytest.approx(5.917, abs=1e-3)
    assert got["tc_f32_flops"] == 0


def test_model_roofline_4k_on_the_cpu():
    """Base 2176x3840 counts in well under a minute with no card; every
    tc family is 4x its 1088x1920 count (work per pixel), and the walls
    follow the H100 SXM rates."""
    t0 = time.perf_counter()
    r4 = roofline.model_roofline("base", 2176, 3840)
    assert time.perf_counter() - t0 < 60
    r1 = roofline.model_roofline("base", 1088, 1920)
    for k, v in r1["families"].items():
        assert r4["families"][k] == pytest.approx(4 * v, rel=1e-6)
    assert r4["wall_tc_ms"] == pytest.approx(
        r4["tc_bf16_flops"] / 989e12 * 1e3)
    assert r4["wall_hbm_ms"] == pytest.approx(r4["bytes_min"] / 3.35e12 * 1e3)
    assert r4["sol_ms"] == max(r4["wall_tc_ms"], r4["wall_simt_ms"],
                               r4["wall_hbm_ms"])
    assert r4["bound"] in ("tc", "simt", "hbm")
    assert r4["bytes_io"] < r4["bytes_min"]


def test_model_roofline_f32_and_lite():
    """The towers in f32 move every tc FLOP to tc_f32 (charged at 67
    TFLOP/s); lite at 128x384 matches JAX's count with its deconvs at a
    quarter."""
    r = roofline.model_roofline("lite", 128, 384, dtype=torch.float32)
    assert r["tc_bf16_flops"] == 0 and r["tc_f32_flops"] == r["tc_flops"]
    b = roofline.model_roofline("lite", 128, 384)
    assert b["tc_flops"] == r["tc_flops"]
    jr = jroof.model_roofline("lite", 128, 384)
    dec = b["families"]["deconv 2x2"]
    assert b["tc_flops"] + 3 * dec == pytest.approx(jr["mxu_flops"],
                                                    rel=1e-3)


def test_no_cache_keeps_a_fake_tensor():
    """A real narrow forward after a count is bit-identical to one before
    it; the window-mask and weight-pack caches hold no fake tensor, and
    the wrappers' call counts are untouched by the count."""
    from torch._subclasses.fake_tensor import FakeTensor

    cfg = dataclasses.replace(get_config("lite"), **NARROW)
    net = Network(cfg).eval()
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.random((1, 64, 96, 3), dtype=np.float32))
            for _ in range(2))
    calls0 = warp_cuda.flow_warp_pair.calls
    with torch.inference_mode():
        before = net(a, b)["I_t"]
    calls = warp_cuda.flow_warp_pair.calls
    c = roofline.count_flops(lambda n, x, y: n(x, y)["I_t"], net, a, b)
    assert c["tc_flops"] > 0 and warp_cuda.flow_warp_pair.calls == calls
    assert layers._device_mask.cache_info().currsize == 0
    assert not any(isinstance(v[2], FakeTensor) or
                   any(isinstance(t, FakeTensor) for t in
                       (v[2] if isinstance(v[2], tuple) else ()))
                   for v in conv_cuda._packs.values())
    with torch.inference_mode():
        after = net(a, b)["I_t"]
    assert torch.equal(before, after)
    assert warp_cuda.flow_warp_pair.calls - calls == calls - calls0 > 0

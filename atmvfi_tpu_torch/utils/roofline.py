"""Counted-FLOP roofline of the port: an aten-op counter and an H100
speed-of-light report.

Counterpart of `atmvfi_tpu/utils/roofline.py`, which walks a jaxpr. Here
`Count` is a `TorchDispatchMode` that sees every aten op a call issues.
`count_flops` runs the call on fake tensors (`FakeTensorMode`: shapes,
dtypes and devices, no data and no arithmetic), so a base 4K forward
counts in seconds on a CPU with no card. The work is split into

  * `tc`   -- mm / bmm / addmm / baddbmm / convolution FLOPs (tensor-core
              work; JAX's `mxu`), by the dtype the card computes them in:
              `tc_bf16` (bf16 and f16) and `tc_f32`;
  * `simt` -- elementwise / reduction / gather FLOPs (JAX's `vpu`),

and two byte figures: `bytes_min`, a traffic floor under a fusion model
(each distinct storage counts once, at materialization points only: the
operands and results of tc ops, gathers and scatters, reduction
results, kernel operands and results, top-level I/O; elementwise and
layout chains count nothing), and `bytes_io`, the call's inputs
(tensors, and the parameters and buffers of module arguments) and
outputs alone. All numbers are per call.

Conventions (those of the JAX module):
  * one fused multiply-add is 2 FLOPs; [M, K] x [K, N] is 2MKN;
  * a convolution is 2 * out_elems * kh * kw * Cin / groups; a
    depthwise one (one input channel a group) is simt work, as JAX's
    depthwise conv is written as shifted multiply-adds;
  * elementwise ops count 1 per output element, transcendentals 4,
    gathers / scatters / sorts 2; reductions count their input elements;
  * integer ops count like float ops.

Where it departs from JAX (both in ROADMAP's departures):
  * a transposed convolution counts its true work, 2 * in_pixels * Cin
    * Cout / groups * kh * kw. JAX counts `lax.conv_transpose` as a
    convolution over the lhs-dilated input, four times that for the
    model's k = 2, s = 2 deconvs (three taps in four multiply zeros);
  * `tc` is split by dtype: bf16 work is charged at the tensor cores'
    bf16 rate, f32 work at the CUDA cores' f32 rate (TF32 is off
    wherever the port is checked).

Kernels count as the function they compute, as the JAX walker enters a
`pallas_call` body: while a count is active every kernel wrapper of
`ops` hands its call to the count's `kernel_call`, which runs the
wrapper's plain version under the counter, whatever the device (the one
seam: `ops._autograd.kernel_wrapper`, which finds the count on the
dispatch stack by that method). Its FLOPs go to the
kernel's own bucket (`kernels`) and to `tc` / `simt`, its tc FLOPs in
the wrapper's compute dtype (the dtype of its result: the plain versions
upcast bf16 operands to f32, which the kernel does not); its bytes are
the wrapper's operands and results alone, in their own dtypes, under
`kernel:<wrapper>`. Values inside the plain version are on-chip values.

The count is a context manager; nothing is counted outside it. It
drops the model's tensor caches (`models.layers.clear_caches`) as it
starts and ends, so no fake tensor stays in them; the weight packs of
`ops.conv_cuda` are made only inside a wrapper's launch, which a count
never reaches.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# aten ops that are data movement or metadata: no FLOPs (they contribute
# bytes only where a materializing op reads their result)
_FREE = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "squeeze", "unsqueeze", "slice", "select", "narrow", "split",
    "split_with_sizes", "unbind", "chunk", "as_strided", "alias", "detach",
    "lift_fresh", "lift_fresh_copy", "clone", "copy", "copy_", "_to_copy",
    "to", "contiguous", "cat", "stack", "constant_pad_nd", "pad", "roll",
    "flip", "repeat", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "new_zeros", "new_ones", "new_full", "fill",
    "fill_", "zero_", "arange", "linspace", "scalar_tensor",
    "_local_scalar_dense", "unfold", "diagonal", "movedim", "_reshape_alias",
    "_unsafe_index_put", "set_", "resize_", "_has_compatible_shallow_copy_type",
    "is_same_size", "_foreach_copy_", "unsqueeze_", "squeeze_", "view_as",
    "expand_as", "index_fill", "masked_fill_", "pixel_shuffle",
}
# a few FLOPs per element (multi-pass on the CUDA cores)
_TRANSCENDENTAL = {
    "exp", "exp_", "log", "log_", "tanh", "tanh_", "sigmoid", "sigmoid_",
    "sin", "cos", "rsqrt", "sqrt", "sqrt_", "erf", "pow", "pow_", "exp2",
    "log1p", "expm1", "gelu", "gelu_", "log2", "reciprocal", "atan2",
    "silu", "softplus",
}
_GATHER = {
    "gather", "index_select", "index", "_unsafe_index", "scatter",
    "scatter_", "scatter_add", "scatter_add_", "index_put", "index_put_",
    "index_add", "index_add_", "sort", "topk", "take", "embedding",
    "grid_sampler_2d", "upsample_bilinear2d", "upsample_nearest2d",
    "masked_select", "nonzero",
}
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
    "argmin", "var", "std", "var_mean", "std_mean", "norm",
    "linalg_vector_norm", "any", "all", "logsumexp", "cumsum",
}
_TC = {"mm", "bmm", "addmm", "baddbmm", "convolution"}

_LOW = (torch.bfloat16, torch.float16)


def _elems(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _tensors(x):
    """Tensors in x (tensors, sequences, dicts and modules' parameters
    and buffers), depth first."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, torch.nn.Module):
        yield from x.parameters()
        yield from x.buffers()
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _tc_flops(name: str, args, out) -> tuple:
    """(FLOPs, family) of one tensor-core op."""
    if name == "mm":
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2.0 * m * k * n, "dot"
    if name == "addmm":
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2.0 * m * k * n, "dot"
    if name == "bmm":
        b, m, k = args[0].shape
        return 2.0 * b * m * k * args[1].shape[2], "dot"
    if name == "baddbmm":
        b, m, k = args[1].shape
        return 2.0 * b * m * k * args[2].shape[2], "dot"
    x, w = args[0], args[1]
    transposed = bool(args[6]) if len(args) > 6 else False
    k = 1
    for d in w.shape[2:]:
        k *= int(d)
    fam = "x".join(str(int(d)) for d in w.shape[2:])
    if transposed:  # weight [Cin, Cout / g, kh, kw]: the true work
        pixels = x.numel() // x.shape[1]
        return (2.0 * pixels * x.shape[1] * w.shape[1] * k,
                f"deconv {fam}")
    return 2.0 * out.numel() * k * w.shape[1], f"conv {fam}"


def _depthwise(args) -> bool:
    """A convolution with one input channel a group (and several groups)."""
    groups = int(args[8]) if len(args) > 8 else 1
    return groups > 1 and args[1].shape[1] == 1 and not (
        len(args) > 6 and bool(args[6]))


def _simt_flops(name: str, args, out) -> float:
    outs = sum(_elems(t) for t in _tensors(out))
    if name in _TRANSCENDENTAL:
        return 4.0 * outs
    if name in _GATHER:
        return 2.0 * outs
    if name in _REDUCE:
        return float(_elems(args[0]) if args else 0)
    ins = _elems(args[0]) if args else 0
    if name in ("_softmax", "_log_softmax"):
        # max and sum reductions, subtract, exp, divide
        return 2.0 * ins + 6.0 * _elems(out)
    if name == "native_layer_norm":
        # two reductions, centre, square, scale, shift, rsqrt per row
        return 2.0 * ins + 5.0 * _elems(out[0])
    return float(outs)


def _tc_key(dtype) -> str:
    return "bf16" if dtype in _LOW else "f32"


class Count(TorchDispatchMode):
    """Count the aten ops issued inside the block (see the module doc).

        with Count() as c:
            c.io(inputs)
            out = fn(*inputs)
            c.io(out)
        c.result()

    Used on real tensors it runs them; `count_flops` runs the call on
    fake tensors instead."""

    def __init__(self):
        super().__init__()
        self.tc = Counter()          # "bf16" / "f32" -> FLOPs
        self.simt = 0.0
        self.families = Counter()    # "conv 3x3", "dot", ... -> FLOPs
        self.kernels = Counter()     # wrapper name -> FLOPs
        self.buckets = Counter()     # materialization bucket -> bytes
        self.bytes_io = 0.0
        self._views = {}             # storage -> {view: (bucket, bytes)}
        self._io_seen = set()
        self._keep = []              # keeps counted storages alive
        self._kernel = None          # [tc, simt] FLOPs inside a kernel

    # -- bytes ----------------------------------------------------------
    def _add(self, t, bucket: str, move: bool = False) -> None:
        """Count t's bytes once per distinct view, a storage at most its
        own size; with `move` a view counted already is moved into
        `bucket` (the call's outputs count as I/O, as in JAX)."""
        if not isinstance(t, torch.Tensor) or t.numel() <= 1:
            return
        st = t.untyped_storage()
        views = self._views.setdefault(st._cdata, {})
        view = (t.storage_offset(), tuple(t.shape), tuple(t.stride()),
                t.dtype)
        if view in views:
            old, n = views[view]
            if move and old != bucket:
                self.buckets[old] -= n
                self.buckets[bucket] += n
                views[view] = (bucket, n)
            return
        n = max(0, min(t.numel() * t.element_size(),
                       st.nbytes() - sum(v[1] for v in views.values())))
        views[view] = (bucket, n)
        self._keep.append(t)
        if n > 0:
            self.buckets[bucket] += n

    def io(self, *xs) -> None:
        """Count tensors (in sequences, dicts, modules) as top-level I/O:
        `bytes_io` and the `io` bucket of `bytes_min`."""
        for t in _tensors(xs):
            if t.numel() > 1:
                k = (t.untyped_storage()._cdata, t.storage_offset(),
                     tuple(t.shape), t.dtype)
                if k not in self._io_seen:
                    self._io_seen.add(k)
                    self.bytes_io += t.numel() * t.element_size()
            self._add(t, "io", move=True)

    # -- the dispatch hook ------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, _, name = func._schema.name.partition("::")
        if ns != "aten":
            return out
        name = name.split(".")[0]
        if name in _FREE:
            return out
        depthwise = name == "convolution" and _depthwise(args)
        if name in _TC and not depthwise:
            flops, fam = _tc_flops(name, args, out)
            self.families[fam] += flops
            if self._kernel is not None:
                self._kernel[0] += flops
                return out
            self.tc[_tc_key(args[1].dtype if name in ("addmm", "baddbmm")
                            else args[0].dtype)] += flops
            for t in (*_tensors(args), *_tensors(out)):
                self._add(t, name)
            return out
        if depthwise:
            # one input channel a group: CUDA-core work, as JAX's shifted
            # multiply-adds (models/layers.py::DWConv) are vpu work
            flops, fam = _tc_flops(name, args, out)
            self.families["depthwise " + fam[5:]] += flops
        else:
            flops = _simt_flops(name, args, out)
        if self._kernel is not None:
            self._kernel[1] += flops
            return out
        self.simt += flops
        if name in _GATHER:
            for t in (*_tensors(args), *_tensors(out)):
                self._add(t, name)
        elif name in _REDUCE or name in ("_softmax", "native_layer_norm"):
            for t in _tensors(out):
                self._add(t, name)
        return out

    # -- kernels ----------------------------------------------------------
    def kernel_call(self, name: str, plain, args, kwargs):
        """plain(*args, **kwargs) counted as kernel `name` (see the
        module doc); a kernel called inside another is part of it."""
        if self._kernel is not None:
            return plain(*args, **kwargs)
        self._kernel = [0.0, 0.0]
        try:
            out = plain(*args, **kwargs)
        finally:
            tc, simt = self._kernel
            self._kernel = None
        outs = [t for t in _tensors(out) if t.is_floating_point()]
        self.tc[_tc_key(outs[0].dtype if outs else torch.float32)] += tc
        self.simt += simt
        self.kernels[name] += tc + simt
        for t in (*_tensors((args, kwargs)), *_tensors(out)):
            self._add(t, f"kernel:{name}")
        return out

    # -- caches -----------------------------------------------------------
    def __enter__(self):
        _clear_caches()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _clear_caches()

    def result(self) -> Dict[str, Any]:
        tc = self.tc["bf16"] + self.tc["f32"]
        return {
            "tc_flops": tc,
            "tc_bf16_flops": self.tc["bf16"],
            "tc_f32_flops": self.tc["f32"],
            "simt_flops": self.simt,
            "total_flops": tc + self.simt,
            "bytes_min": float(sum(self.buckets.values())),
            "bytes_io": float(self.bytes_io),
            "families": dict(self.families),
            "kernels": dict(self.kernels),
        }


def _clear_caches() -> None:
    from atmvfi_tpu_torch.models import layers

    layers.clear_caches()


@contextlib.contextmanager
def _faked_modules(modules, fake):
    """Swap the parameters and buffers of `modules` for fake copies for
    the duration (real and fake tensors do not mix in one op)."""
    saved = []
    for mod in modules:
        for m in mod.modules():
            for d in (m._parameters, m._buffers):
                for k, v in d.items():
                    if v is not None:
                        saved.append((d, k, v))
                        d[k] = fake(v)
    try:
        yield
    finally:
        for d, k, v in saved:
            d[k] = v


def _count(fn, args, kwargs) -> Count:
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        memo = {}

        def fake(x):
            if isinstance(x, torch.Tensor):
                if id(x) not in memo:
                    memo[id(x)] = mode.from_tensor(x)
                return memo[id(x)]
            if isinstance(x, (list, tuple)):
                return type(x)(fake(v) for v in x)
            if isinstance(x, dict):
                return {k: fake(v) for k, v in x.items()}
            return x

        fargs = fake(args)
        fkw = fake(kwargs)
        modules = [a for a in (*args, *kwargs.values())
                   if isinstance(a, torch.nn.Module)]
        with _faked_modules(modules, fake), Count() as c:
            c.io(fargs, fkw)
            with torch.no_grad():
                out = fn(*fargs, **fkw)
            c.io(out)
    return c


def count_flops(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run fn(*args, **kwargs) on fake tensors under a `Count`. Returns
    tc (by dtype) / simt FLOPs, the byte floor and the I/O bytes, the tc
    FLOPs by family and the FLOPs of each kernel. Modules among the
    arguments keep their weights; their parameters count as inputs."""
    return _count(fn, args, kwargs).result()


def live_bytes_breakdown(fn, *args, **kwargs) -> Dict[str, float]:
    """`bytes_min` of fn(*args, **kwargs) itemized by bucket: `io`, the
    aten op that materializes the value, or `kernel:<wrapper>`."""
    return {k: float(v) for k, v in
            _count(fn, args, kwargs).buckets.items() if v}


def io_bytes(fn, *args, **kwargs) -> float:
    """The absolute floor: bytes of the call's inputs and outputs only."""
    return _count(fn, args, kwargs).bytes_io


# H100 SXM, 700 W (NVIDIA data sheet, dense): tensor-core bf16 and TF32,
# f32 on the CUDA cores, HBM3
H100_SXM = {"tflops_bf16": 989.0, "tflops_tf32": 495.0, "tflops_f32": 67.0,
            "hbm_gbps": 3350.0}


def walls(counts: Dict[str, Any], chip: Optional[Dict[str, float]] = None
          ) -> Dict[str, Any]:
    """Speed-of-light walls of a count: tc (bf16 at the tensor cores'
    rate, f32 at the CUDA cores' f32 rate: TF32 off), simt (f32 rate)
    and HBM at `bytes_min`; SOL is the largest, as units overlap."""
    chip = chip or H100_SXM
    tc_s = (counts["tc_bf16_flops"] / (chip["tflops_bf16"] * 1e12)
            + counts["tc_f32_flops"] / (chip["tflops_f32"] * 1e12))
    simt_s = counts["simt_flops"] / (chip["tflops_f32"] * 1e12)
    hbm_s = counts["bytes_min"] / (chip["hbm_gbps"] * 1e9)
    io_s = counts["bytes_io"] / (chip["hbm_gbps"] * 1e9)
    sol_s = max(tc_s, simt_s, hbm_s)
    sol_io_s = max(tc_s, simt_s, io_s)
    return {
        "wall_tc_ms": tc_s * 1e3,
        "wall_simt_ms": simt_s * 1e3,
        "wall_hbm_ms": hbm_s * 1e3,
        "sol_ms": sol_s * 1e3,
        "sol_fps": 1.0 / sol_s if sol_s > 0 else float("inf"),
        "sol_fps_io": 1.0 / sol_io_s if sol_io_s > 0 else float("inf"),
        "bound": ("tc" if sol_s == tc_s else
                  "simt" if sol_s == simt_s else "hbm"),
    }


def model_roofline(variant: str = "lite", H: int = 2176, W: int = 4096,
                   global_motion: bool = True, fast: bool = False,
                   chip: Optional[Dict[str, float]] = None,
                   dtype=torch.bfloat16) -> Dict[str, Any]:
    """Counted FLOPs, bytes and SOL fps of one forward frame at H x W
    (the towers in `dtype`), on fake tensors: no card, no arithmetic."""
    from atmvfi_tpu_torch.models import Network, get_config

    cfg = get_config(variant, dtype=dtype)
    if fast:
        cfg = cfg.fast()
    net = Network(cfg).eval()
    # never written: the count makes fake copies of the frames
    im = torch.empty(1, H, W, 3)

    def fwd(net, a, b):
        return net(a, b, global_motion=global_motion)["I_t"]

    counts = count_flops(fwd, net, im, im)
    return {
        **counts,
        "tc_tflop": counts["tc_flops"] / 1e12,
        "simt_tflop": counts["simt_flops"] / 1e12,
        "hbm_gb_min": counts["bytes_min"] / 1e9,
        "hbm_gb_io": counts["bytes_io"] / 1e9,
        **walls(counts, chip),
    }

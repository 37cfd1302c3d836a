"""An aten-op counter of FLOPs, run on fake tensors.

A frozen copy of the program's counting rules (`utils/roofline.py`),
kept with the benchmark so that a change to the program cannot move
the yardstick, and pointed at the benchmark's own reference forward:

* `tc` -- mm / bmm / addmm / baddbmm / convolution FLOPs (tensor-core
  work), by the dtype of their operands: "bf16" (bf16 and f16), "f32";
* `simt` -- elementwise, reduction and gather FLOPs;
* one fused multiply-add is 2 FLOPs; [M, K] x [K, N] is 2MKN; a
  convolution is 2 * out_elems * kh * kw * Cin / groups, a transposed
  one 2 * in_pixels * Cin * Cout / groups * kh * kw; a depthwise conv
  (one input channel a group) is simt work; elementwise ops count 1 a
  output element, transcendentals 4, gathers 2, reductions their input
  elements.

Besides, every convolution is logged with its FLOPs and the bytes of
its operands and result (`convs`), for the per-call roofline bounds of
`metrics/conv_roofline.py`: activation bytes (input read once, output
written once) and weight bytes apart, since a batch reads its weights
once.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
    "_unsafe_index_put", "set_", "resize_", "is_same_size", "view_as",
    "expand_as", "replication_pad2d", "index_put_", "index_put",
}
_TRANSCENDENTAL = {
    "exp", "log", "tanh", "sigmoid", "sin", "cos", "rsqrt", "sqrt", "erf",
    "pow", "gelu", "reciprocal",
}
_GATHER = {
    "gather", "index_select", "index", "_unsafe_index", "grid_sampler_2d",
    "upsample_bilinear2d",
}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "var", "var_mean"}
_TC = {"mm", "bmm", "addmm", "baddbmm", "convolution"}
_LOW = (torch.bfloat16, torch.float16)


def _elems(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (list, tuple)):
        return sum(_elems(v) for v in x)
    return 0


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_key(dtype) -> str:
    return "bf16" if dtype in _LOW else "f32"


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.tc = Counter()
        self.simt = 0.0
        self.families = Counter()
        self.convs = Counter()  # (flops, act bytes, weight bytes, dtype)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns, _, name = func._schema.name.partition("::")
        name = name.split(".")[0]
        if ns != "aten" or name in _FREE:
            return out
        if name == "convolution":
            x, w = args[0], args[1]
            transposed = bool(args[6])
            groups = int(args[8])
            k = 1
            for d in w.shape[2:]:
                k *= int(d)
            if transposed:
                flops = 2.0 * (x.numel() // x.shape[1]) * x.shape[1] \
                    * w.shape[1] * k / groups
                fam = "deconv"
            else:
                flops = 2.0 * out.numel() * k * w.shape[1]
                fam = "depthwise conv" if groups > 1 and w.shape[1] == 1 \
                    else "conv"
            fam += " " + "x".join(str(int(d)) for d in w.shape[2:])
            self.families[fam] += flops
            self.convs[(flops, _bytes(x) + _bytes(out), _bytes(w),
                        _dtype_key(x.dtype))] += 1
            if fam.startswith("depthwise"):
                self.simt += flops
            else:
                self.tc[_dtype_key(x.dtype)] += flops
            return out
        if name in _TC:
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            b = args[2] if name in ("addmm", "baddbmm") else args[1]
            if a.dim() == 2:
                flops = 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
            else:
                flops = 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
            self.families["dot"] += flops
            self.tc[_dtype_key(a.dtype)] += flops
            return out
        outs = _elems(out)
        if name in _TRANSCENDENTAL:
            self.simt += 4.0 * outs
        elif name in _GATHER:
            self.simt += 2.0 * outs
        elif name in _REDUCE:
            self.simt += float(_elems(args[0]) if args else 0)
        elif name == "_softmax":
            self.simt += 2.0 * _elems(args[0]) + 6.0 * outs
        elif name == "native_layer_norm":
            self.simt += 2.0 * _elems(args[0]) + 5.0 * _elems(out[0])
        else:
            self.simt += float(outs)
        return out

    def result(self) -> Dict[str, Any]:
        convs = sorted([*key, n] for key, n in self.convs.items())
        return {
            "tc_bf16_flops": self.tc["bf16"],
            "tc_f32_flops": self.tc["f32"],
            "simt_flops": self.simt,
            "families": dict(sorted(self.families.items())),
            "convs": convs,  # [flops, act bytes, weight bytes, dtype, calls]
        }

"""Gradients through the kernel wrappers.

The TPU kernels have no backward kernel: each JAX op's custom VJP is
`jax.vjp` of its XLA reference (e.g. `atmvfi_tpu/ops/warp_pallas.py::
_tiled_warp_bwd`, `conv_pallas.py::_op_bwd`, `attention_pallas.py::
_block_bwd_rule`). The port does the same. `launch(kernel, plain, *args)`
runs `kernel(*args)` (the CUDA launch) and, when autograd is recording
and a floating operand requires grad, wraps it in a Function whose
backward recomputes `plain(*args)` (the wrapper's plain version, same
signature) on the saved inputs under grad mode and returns
`torch.autograd.grad` of it. Gradients therefore reach the wrapper's
arguments in their own layout (OIHW conv weights, not the packed copy).

Otherwise -- inference mode, no_grad, or no operand requiring grad --
`kernel(*args)` runs directly, so serving keeps its launches and pays
no autograd bookkeeping.

Arguments may be tensors, None, Python values or lists/tuples of
tensors (a conv's sources); outputs a tensor or a tuple of tensors and
Nones.

`kernel_wrapper(plain)` decorates every public kernel wrapper: the one
seam through which a counter sees kernels as the functions they compute.
A counter is a dispatch mode (`TorchDispatchMode`) with a method
`kernel_call(name, plain, args, kwargs)`; the counted roofline's
`Count` is one. While such a mode is on the dispatch stack, the wrapper
hands its call to the innermost one, which runs `plain` (the plain
version, taking the wrapper's arguments) under it, whatever the device,
and neither the wrapper's calls nor its launches count; otherwise the
wrapper runs.
"""
from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def _tensors(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from (t for t in a if isinstance(t, torch.Tensor))
        elif isinstance(a, torch.Tensor):
            yield a


def needs_grad(*args) -> bool:
    """Whether a kernel call on `args` must record a gradient."""
    return torch.is_grad_enabled() and any(
        t.requires_grad and t.is_floating_point() for t in _tensors(args))


def _flatten(args):
    """(tensors, spec): spec rebuilds args with `_unflatten`."""
    flat, spec = [], []
    for a in args:
        if isinstance(a, (list, tuple)) and any(
                isinstance(t, torch.Tensor) for t in a):
            spec.append(("seq", type(a), len(a)))
            flat.extend(a)
        elif isinstance(a, torch.Tensor):
            spec.append(("tensor",))
            flat.append(a)
        else:
            spec.append(("value", a))
    return flat, spec


def _unflatten(spec, flat):
    args, i = [], 0
    for s in spec:
        if s[0] == "seq":
            args.append(s[1](flat[i:i + s[2]]))
            i += s[2]
        elif s[0] == "tensor":
            args.append(flat[i])
            i += 1
        else:
            args.append(s[1])
    return args


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


class _KernelFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, spec, *flat):
        # operands that require grad are saved for backward; the others
        # (images, masks, coordinates) are kept as they are, since they
        # may be inference tensors (cached by serving), which autograd
        # refuses to save
        ctx.plain, ctx.spec = plain, spec
        ctx.save_for_backward(*[t for t in flat if t.requires_grad])
        ctx.others = [None if t.requires_grad else t for t in flat]
        return kernel(*_unflatten(spec, flat))

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        wants = ctx.needs_input_grad[3:]
        inputs = [next(saved).detach().requires_grad_(w) if o is None
                  else (o.clone() if o.is_inference() else o)
                  for o, w in zip(ctx.others, wants)]
        with torch.enable_grad():
            outs = _as_tuple(ctx.plain(*_unflatten(ctx.spec, inputs)))
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if isinstance(o, torch.Tensor) and o.requires_grad
                 and g is not None]
        diff = [t for t, w in zip(inputs, wants) if w]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], diff, [g for _, g in pairs],
            allow_unused=True) if pairs and diff else [None] * len(diff))
        return (None, None, None,
                *[next(got) if w else None for w in wants])


def launch(kernel, plain, *args):
    """kernel(*args), differentiable through `plain` when grad is on."""
    if not needs_grad(*args):
        return kernel(*args)
    flat, spec = _flatten(args)
    return _KernelFunction.apply(kernel, plain, spec, *flat)


def kernel_wrapper(plain):
    """Decorator of a kernel wrapper whose plain version `plain` takes
    the same arguments (see the module doc)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            for mode in reversed(_get_current_dispatch_mode_stack()):
                kernel_call = getattr(mode, "kernel_call", None)
                if kernel_call is not None:
                    return kernel_call(fn.__name__, plain, args, kwargs)
            return fn(*args, **kwargs)
        return wrapper
    return deco

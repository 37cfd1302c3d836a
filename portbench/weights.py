"""Seeded, fan-in-scaled weights for a configuration, made on the device.

One normal draw from a `torch.Generator` on `device` covers every
parameter of `reference.network.spec`; each parameter's slice is then
scaled by its kind:

* a conv or deconv followed by PReLU: N(0, 2 / ((1 + 0.25^2) fan_in))
  (He's rule for the PReLU slope 0.25), other convs and linears:
  N(0, 1 / fan_in);
* biases N(0, 0.02^2), PReLU slopes 0.25 + N(0, 0.02^2), layer-norm
  gains 1 + N(0, 0.05^2) and shifts N(0, 0.02^2).

The same f32 state dict goes to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.network import Sizes, spec

_PRELU_GAIN = math.sqrt(2.0 / (1.0 + 0.25 ** 2))


def make_state_dict(sizes: Sizes, seed: int, device) -> Dict[str, torch.Tensor]:
    items = spec(sizes)
    total = sum(math.prod(shape) for _, shape, _, _ in items)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    out, i = {}, 0
    for name, shape, kind, fan_in in items:
        n = math.prod(shape)
        z = flat[i:i + n].view(shape)
        i += n
        if kind in ("conv_prelu", "deconv"):
            t = z * (_PRELU_GAIN / math.sqrt(fan_in))
        elif kind in ("conv", "linear"):
            t = z * (1.0 / math.sqrt(fan_in))
        elif kind == "prelu":
            t = 0.25 + 0.02 * z
        elif kind == "ln_w":
            t = 1.0 + 0.05 * z
        else:  # bias, ln_b
            t = 0.02 * z
        out[name] = t
    return out

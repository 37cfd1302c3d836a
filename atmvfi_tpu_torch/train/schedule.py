"""LR schedule: cosine annealing with linear warmup dampening
(`atmvfi_tpu/train/schedule.py`): lr(t) = (last + (init - last) *
(1 + cos(pi * min(t, t_max) / t_max)) / 2) * min(1, (t + 1) / warmup),
in f32 as the JAX schedule computes it. t counts optimizer updates, from
0 for the first."""
from __future__ import annotations

import numpy as np


def cosine_with_linear_warmup(init_lr: float, last_lr: float, t_max: int,
                              warmup_steps: int):
    """-> schedule(step) -> lr (a Python float)."""
    f = np.float32

    def schedule(step) -> float:
        step = f(step)
        t = min(step, f(t_max))
        cosine = f(last_lr) + f(init_lr - last_lr) * f(0.5) * (
            f(1.0) + np.cos(f(np.pi) * t / f(t_max)))
        damp = min(f(1.0), (step + f(1.0)) / f(max(warmup_steps, 1)))
        return float(f(cosine * damp))

    return schedule

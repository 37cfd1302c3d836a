"""Train-state checkpoints for resume (`atmvfi_tpu/train/checkpoints.py`).

`save_train_state(ckpt_dir, state, step)` writes `ckpt_dir/step_{step}/
train_state.pt` with `torch.save`; the JAX package writes an orbax
checkpoint into the same `step_{step}` directory. `state` is what
`Trainer.state_dict()` returns (model, optimizer, schedule position,
step, accumulated gradients). The portable params-only file is
`convert.save_npz` / `load_npz`, which the JAX package's
`load_params_npz` reads.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch

_FILE = "train_state.pt"


def save_train_state(ckpt_dir: str, state: Any, step: int) -> None:
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    torch.save(state, os.path.join(path, _FILE))


def restore_train_state(ckpt_dir: str, step: int, target: Any = None) -> Any:
    """The saved state on the CPU; with `target` (a `Trainer`), loaded
    into it (`target.load_state_dict`), which is returned."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}", _FILE))
    state = torch.load(path, map_location="cpu", weights_only=False)
    if target is None:
        return state
    target.load_state_dict(state)
    return target


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None

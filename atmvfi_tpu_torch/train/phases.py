"""The 4-phase training recipe and its freeze masks
(`atmvfi_tpu/train/phases.py`).

Each phase is a dataclass. The freeze partition is the JAX package's:
every state_dict name belongs to the group of its top-level flax module
(`convert.flax_path_of`), decided by the same prefixes:

  global  -- last_feat_extract, global fusion, global ATMFormers + MLP
  refiner -- the residual-refinement U-Net (refine_proj = the port's
             `proj`, down1-3, up1-3, refine_head)
  local   -- everything else
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

from atmvfi_tpu_torch.convert import flax_path_of


def _is_global(name: str) -> bool:
    return name.startswith(
        ("last_feat_extract", "global_feature_fusion",
         "global_motion_atmformer", "global_motion_mlp"))


def _is_refiner(name: str) -> bool:
    return name.startswith(
        ("refine_proj", "down1", "down2", "down3", "up1", "up2", "up3",
         "refine_head"))


def trainable_mask(names: Iterable[str], train_local: bool,
                   train_global: bool, refiner_only: bool = False
                   ) -> Dict[str, bool]:
    """{state_dict name: True where the parameter receives updates}."""

    def decide(key: str) -> bool:
        top = flax_path_of(key).split("/", 1)[0]
        if refiner_only:
            return _is_refiner(top)
        if _is_global(top):
            return train_global
        return train_local

    return {k: decide(k) for k in names}


@dataclasses.dataclass(frozen=True)
class PhaseConfig:
    name: str
    global_motion: bool
    train_local: bool
    train_global: bool
    refiner_only: bool = False
    # optimisation
    init_lr: float = 2e-4
    last_lr: float = 1e-4
    weight_decay: float = 1e-4
    num_epochs: int = 150
    batch_size: int = 24
    warmup_steps: int = 2000
    warmup_steps_resume: int = 400
    # loss switchboard
    use_lap_loss: bool = True
    use_warping_loss: bool = True
    use_l1_loss: bool = False
    use_perceptual_loss: bool = False
    use_style_loss: bool = False
    use_bidirect_warp_loss: bool = False
    use_sobel_loss: bool = False
    use_pose_loss: bool = False
    lap_w: float = 1.0
    warping_w: float = 0.25
    l1_w: float = 1.0
    perceptual_w: float = 0.05
    style_w: float = 5e-9
    bidirect_w: float = 1.0
    sobel_w: float = 1.0
    pose_w: float = 1.0
    datasets: Tuple[str, ...] = ("vimeo90k",)


# Phase 1: local branch from scratch on Vimeo
PHASE1 = PhaseConfig(
    name="phase1_local", global_motion=False,
    train_local=True, train_global=False,
)

# Phase 2: global branch pretrain, local frozen
PHASE2 = PhaseConfig(
    name="phase2_global", global_motion=True,
    train_local=False, train_global=True,
    datasets=("vimeo90k", "x4k"),
)

# Phase 3: joint finetune, alternating Vimeo / X4K
PHASE3 = PhaseConfig(
    name="phase3_joint", global_motion=True,
    train_local=True, train_global=True,
    init_lr=4e-5, last_lr=1e-5, num_epochs=300, batch_size=16,
    warmup_steps=500, warmup_steps_resume=50,
    datasets=("vimeo90k", "x4k"),
)

# Phase 4: perception finetune (adds the VGG perceptual + style losses)
PHASE4 = PhaseConfig(
    name="phase4_perception", global_motion=True,
    train_local=True, train_global=True,
    init_lr=4e-5, last_lr=1e-5, num_epochs=300, batch_size=16,
    warmup_steps=500, warmup_steps_resume=50,
    use_perceptual_loss=True, use_style_loss=True,
    datasets=("vimeo90k", "x4k"),
)

PHASES = {p.name: p for p in (PHASE1, PHASE2, PHASE3, PHASE4)}


def get_phase(name: str) -> PhaseConfig:
    if name in PHASES:
        return PHASES[name]
    alias = {"1": PHASE1, "2": PHASE2, "3": PHASE3, "4": PHASE4}
    return alias[str(name)]

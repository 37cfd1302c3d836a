"""Training: phases, schedule, trainer, checkpoints (the port's
`atmvfi_tpu/train/`)."""

from atmvfi_tpu_torch.train.phases import (
    PHASE1,
    PHASE2,
    PHASE3,
    PHASE4,
    PHASES,
    PhaseConfig,
    get_phase,
    trainable_mask,
)
from atmvfi_tpu_torch.train.schedule import cosine_with_linear_warmup
from atmvfi_tpu_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    make_criterion,
)

__all__ = [
    "PHASE1",
    "PHASE2",
    "PHASE3",
    "PHASE4",
    "PHASES",
    "PhaseConfig",
    "Trainer",
    "TrainerConfig",
    "cosine_with_linear_warmup",
    "get_phase",
    "make_criterion",
    "trainable_mask",
]

"""Training CLI: the 4-phase recipe with the PyTorch/CUDA port.

    python -m atmvfi_tpu_torch.cli.train --phase 1 --variant base \
        --vimeo_path /data/vimeo_triplet [--x4k_path ...] [--bf16] \
        [--debug --debug_iter 3] [--device cpu]

Phases: 1 local branch from scratch (Vimeo, batch 24, lr 2e-4 -> 1e-4);
2 global branch, local frozen (Vimeo and X4K); 3 joint finetune,
alternating Vimeo / X4K (batch 16, lr 4e-5 -> 1e-5); 4 perception
finetune (adds the VGG16 perceptual and style losses, which need
--vgg_npz). The flags are those of the JAX package's `cli/train.py`,
plus --device (the card by default; `cpu` runs the kernels' plain
versions). --debug runs --debug_iter steps of each epoch's training and
validation. Every epoch writes the params `.npz` of the JAX package's
format to --model_checkpoints. With --device cuda and more than one
card, each batch is split over every card (`train_mesh`, the JAX CLI's
rule: a mesh whenever there is more than one device).
"""
from __future__ import annotations

import argparse
import dataclasses
import random

import numpy as np
import torch


def seed_all(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def train_mesh(device: str):
    """The data-parallel mesh over every card when `device` is "cuda"
    and there are two or more, else None (one device)."""
    if device == "cuda" and torch.cuda.device_count() > 1:
        from atmvfi_tpu_torch.parallel import make_mesh

        return make_mesh()
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--phase", type=str, default="1", help="1|2|3|4 or name")
    p.add_argument("--variant", choices=["base", "lite"], default="base")
    p.add_argument("--vimeo_path", type=str, default=None)
    p.add_argument("--x4k_path", type=str, default=None)
    p.add_argument("--snu_path", type=str, default=None, help="val split dir")
    p.add_argument("--snu_img_path", type=str, default="")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_epoch", type=int, default=None)
    p.add_argument("--init_lr", type=float, default=None)
    p.add_argument("--last_lr", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--load_ckpt", type=str, default=None,
                   help="initial weights (.pt or .npz)")
    p.add_argument("--resume_train", action="store_true")
    p.add_argument("--model_checkpoints", type=str, default="./checkpoints")
    p.add_argument("--vgg_npz", type=str, default=None,
                   help="VGG16 weights for the phase 4 perceptual loss")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--debug_iter", type=int, default=5)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--seed", type=int, default=22112023)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from atmvfi_tpu_torch.data import (
        DataLoader,
        SNUFilmDataset,
        VimeoDataset,
        X4KTrain,
    )
    from atmvfi_tpu_torch.train import Trainer, TrainerConfig, get_phase

    seed_all(args.seed)
    phase = get_phase(args.phase)
    overrides = {}
    for field, arg in (("batch_size", args.batch_size),
                       ("num_epochs", args.num_epoch),
                       ("init_lr", args.init_lr),
                       ("last_lr", args.last_lr)):
        if arg is not None:
            overrides[field] = arg
    if overrides:
        phase = dataclasses.replace(phase, **overrides)

    train_loaders = []
    if args.vimeo_path and "vimeo90k" in phase.datasets:
        ds = VimeoDataset("train", args.vimeo_path, seed=args.seed)
        train_loaders.append(DataLoader(
            ds, phase.batch_size, shuffle=True, num_workers=args.num_workers,
            seed=args.seed))
    if args.x4k_path and "x4k" in phase.datasets:
        ds = X4KTrain(args.x4k_path, random_crop=True, patch_size=448,
                      min_t_step_size=2, max_t_step_size=32, seed=args.seed)
        bs = max(phase.batch_size // 3, 1)  # the reference's 5 against 16
        train_loaders.append(DataLoader(
            ds, bs, shuffle=True, num_workers=args.num_workers,
            seed=args.seed))
    if not train_loaders:
        p.error("no training data: pass --vimeo_path (and --x4k_path)")

    if args.snu_path:
        val_ds = SNUFilmDataset("hard", args.snu_path, args.snu_img_path)
        val_loader = DataLoader(val_ds, 1, shuffle=False, drop_last=False,
                                num_workers=2)
    else:
        val_ds = VimeoDataset("test", args.vimeo_path)
        val_loader = DataLoader(val_ds, phase.batch_size, shuffle=False,
                                drop_last=False, num_workers=args.num_workers)

    init_state_dict = None
    if args.load_ckpt:
        from atmvfi_tpu_torch.convert import load_checkpoint, load_npz

        if args.load_ckpt.endswith((".pt", ".pth")):
            init_state_dict, meta = load_checkpoint(args.load_ckpt)
            print(f"loaded torch checkpoint; meta keys: {list(meta)}")
        else:
            init_state_dict, _ = load_npz(args.load_ckpt)

    perceptual = None
    if phase.use_perceptual_loss or phase.use_style_loss:
        if args.vgg_npz:
            from atmvfi_tpu_torch.losses import VGGPerceptualLoss

            perceptual = VGGPerceptualLoss(args.vgg_npz)
        else:
            print("WARNING: phase uses perceptual loss but no --vgg_npz; "
                  "perceptual/style terms disabled")

    mesh = train_mesh(args.device)
    trainer = Trainer(
        TrainerConfig(
            phase=phase, variant=args.variant,
            dtype=torch.bfloat16 if args.bf16 else torch.float32,
            steps_per_epoch=len(train_loaders[0]),
            num_epochs=(phase.num_epochs if args.num_epoch is None
                        else args.num_epoch),
            resume=args.resume_train,
            checkpoint_dir=args.model_checkpoints,
            seed=args.seed, device=args.device),
        mesh=mesh, perceptual_loss=perceptual,
        init_state_dict=init_state_dict)
    n = sum(p.numel() for p in trainer.net.parameters())
    print(f"total parameters: {n / 1e6:.2f} M | phase {phase.name} | "
          f"devices {len(trainer.replicas)} (home {trainer.device})")

    max_iters = args.debug_iter if args.debug else None
    trainer.fit(train_loaders, val_loader, max_iters=max_iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

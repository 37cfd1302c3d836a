"""Benchmark CLI of the port: the Vimeo90K, UCF101, SNU-FILM and Xiph
protocols (`evalkit.harness`).

    python -m atmvfi_tpu_torch.cli.benchmark --dataset vimeo90k \
        --path /data/vimeo_triplet --ckpt model.pt --model_type base \
        [--fp32] [--TTA] [--limit N] [--device cpu]

The flags of the JAX package's `cli/benchmark.py`, and --device (default
cuda; cpu runs the kernels' plain PyTorch versions). Each dataset's
protocol: global motion off for Vimeo90K and UCF101, on for SNU-FILM
and Xiph; Xiph pads to 32, the others to 64. The working type is bf16
unless --fp32. Prints the result JSON.
"""
from __future__ import annotations

import argparse
import json
import random

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True,
                   choices=["vimeo90k", "ucf101", "snufilm", "xiph"])
    p.add_argument("--path", required=True)
    p.add_argument("--img_data_path", default="", help="SNU image root")
    p.add_argument("--ckpt", required=True,
                   help="reference .pt/.pth or JAX-package .npz")
    p.add_argument("--model_type", choices=["base", "lite"], default="base")
    p.add_argument("--TTA", action="store_true")
    p.add_argument("--TTA_swaporder", action="store_true")
    p.add_argument("--ensemble_global", action="store_true")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--profiling", action="store_true",
                   help="no per-item progress prints; the runners always "
                        "report seconds / fps in the result")
    p.add_argument("--seed", type=int, default=22112023)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from atmvfi_tpu_torch.evalkit import harness
    from atmvfi_tpu_torch.infer.pipeline import load_pipeline

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    # per-dataset protocol: global motion off for Vimeo / UCF, on for
    # SNU / Xiph
    global_motion = args.dataset in ("snufilm", "xiph")
    pipeline = load_pipeline(
        args.ckpt, variant=args.model_type,
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        global_motion=global_motion,
        ensemble_global_motion=args.ensemble_global,
        pad_divisor=32 if args.dataset == "xiph" else 64,
        device=args.device)

    if args.dataset == "vimeo90k":
        res = harness.run_vimeo90k(pipeline, args.path, args.TTA, args.limit,
                                   progress=not args.profiling,
                                   tta_swaporder=args.TTA_swaporder)
    elif args.dataset == "ucf101":
        res = harness.run_ucf101(pipeline, args.path, args.TTA, args.limit)
    elif args.dataset == "snufilm":
        res = harness.run_snufilm(pipeline, args.path, args.img_data_path,
                                  tta=args.TTA, limit=args.limit)
    else:
        res = harness.run_xiph(pipeline, args.path, tta=args.TTA,
                               frame_limit=args.limit)
    print()
    print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

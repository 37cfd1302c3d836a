"""2x / 4x / 8x frame interpolation with the PyTorch/CUDA port.

    python -m atmvfi_tpu_torch.cli.demo_2x --frame0 a.png --frame1 b.png \
        --out mid.png [--model_type lite] [--ckpt model.pt] [--fp32] [--fast]
        [--ensemble_global] [--spatial_shards N]
    python -m atmvfi_tpu_torch.cli.demo_2x --frames_dir frames/ \
        --factor 4 --out out_dir/

Two-frame mode writes the middle frame; directory mode interpolates the
sorted frames of a directory and writes the Nx sequence. Frames are
.npy (uint8 [H, W, 3]) or, when Pillow is installed, any image format
it reads. Without --ckpt the model runs on seeded random weights (a
smoke run, not a result). --device cpu runs the plain PyTorch versions
of the kernels on the CPU. --fast is the serving profile: the
full-resolution global pre-alignment is folded into the final flows (a
small documented deviation from the default forward).
--ensemble_global picks the global motion of the frames at full, 1/2 or
1/4 size that aligns them best. --spatial_shards N splits each frame
pair into N row slabs (`parallel.make_spatial_forward`), spread over the
visible cards in turn (all N on one card when there is one); it prints
the device of each shard.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_EXTS = (".npy", ".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".tif", ".tiff")


def read_frame(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        from PIL import Image

        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"))
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"{path}: need uint8 [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
    return img


def write_frame(path: str, img: np.ndarray) -> None:
    if path.endswith(".npy"):
        np.save(path, img)
        return
    from PIL import Image

    Image.fromarray(img).save(path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_type", choices=["base", "lite"], default="base")
    p.add_argument("--ckpt", help="reference .pt/.pth or JAX-package .npz")
    p.add_argument("--global_off", action="store_true",
                   help="disable the global motion branch")
    p.add_argument("--frame0")
    p.add_argument("--frame1")
    p.add_argument("--frames_dir")
    p.add_argument("--out", default="output_interpolated.png")
    p.add_argument("--factor", type=int, default=2, choices=[2, 4, 8])
    p.add_argument("--fp32", action="store_true",
                   help="f32 towers (parity mode); default bf16")
    p.add_argument("--fast", action="store_true",
                   help="serving profile: composed full-res warps")
    p.add_argument("--ensemble_global", action="store_true",
                   help="multiscale global motion ensemble")
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="split each frame pair into N row slabs")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.spatial_shards < 1:
        p.error("--spatial_shards must be >= 1")

    import torch

    from atmvfi_tpu_torch.infer import InterpolationPipeline, load_pipeline

    from atmvfi_tpu_torch.parallel import make_mesh

    dtype = torch.float32 if args.fp32 else torch.bfloat16
    mesh = None
    if args.spatial_shards > 1:
        n = args.spatial_shards
        if torch.device(args.device).type == "cuda" and \
                torch.cuda.is_available():
            cards = torch.cuda.device_count()
            devices = [f"cuda:{i % cards}" for i in range(n)]
        else:
            devices = [args.device] * n
        mesh = make_mesh((1, n), devices)
    kw = dict(variant=args.model_type, dtype=dtype,
              global_motion=not args.global_off,
              ensemble_global_motion=args.ensemble_global,
              device=args.device, fast=args.fast, mesh=mesh)
    if args.ckpt:
        pipe = load_pipeline(args.ckpt, **kw)
    else:
        print("WARNING: no --ckpt given; running seeded random weights "
              "(smoke mode)", file=sys.stderr)
        pipe = InterpolationPipeline(None, **kw)
    for i, d in enumerate(pipe.shard_devices):
        print(f"shard {i}: {d}")

    if args.frames_dir:
        names = sorted(n for n in os.listdir(args.frames_dir)
                       if n.lower().endswith(_EXTS))
        if len(names) < 2:
            p.error(f"{args.frames_dir}: need at least two frames")
        os.makedirs(args.out, exist_ok=True)
        frames = (read_frame(os.path.join(args.frames_dir, n)) for n in names)
        ext = os.path.splitext(names[0])[1]
        count = 0
        for i, f in enumerate(pipe.interpolate_stream(frames, args.factor)):
            write_frame(os.path.join(args.out, f"{i:06d}{ext}"), f)
            count += 1
        print(f"wrote {count} frames to {args.out}")
        return 0
    if not (args.frame0 and args.frame1):
        p.error("give --frame0 and --frame1, or --frames_dir")
    f0, f1 = read_frame(args.frame0), read_frame(args.frame1)
    if args.factor == 2:
        write_frame(args.out, pipe.interpolate(f0, f1))
        print(f"wrote {args.out}")
        return 0
    stem, ext = os.path.splitext(args.out)
    frames = list(pipe.interpolate_stream([f0, f1], args.factor))
    for i, f in enumerate(frames[1:-1], 1):  # the frames between the two
        write_frame(f"{stem}_{i}{ext}", f)
    print(f"wrote {len(frames) - 2} frames as {stem}_<i>{ext}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

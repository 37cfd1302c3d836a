"""2x / 4x / 8x frame interpolation with the PyTorch/CUDA port.

    python -m atmvfi_tpu_torch.cli.demo_2x --frame0 a.png --frame1 b.png \
        --out mid.png [--model_type lite] [--ckpt model.pt] [--fp32] [--fast]
        [--ensemble_global] [--spatial_shards N]
    python -m atmvfi_tpu_torch.cli.demo_2x --frames_dir frames/ \
        --factor 4 --out out_dir/ [--batch 4] [--combine_video]
    python -m atmvfi_tpu_torch.cli.demo_2x --video in.y4m --out out \
        [--factor 2] [--batch 4]

Two-frame mode writes the middle frame; directory mode interpolates the
sorted frames of a directory and writes the Nx sequence (with
--combine_video each written frame is the source frame, held `factor`
frames, stacked above the output); video mode reads a .y4m and writes
`<out>.y4m` at factor x the frame rate, in the input's colorspace family
(other containers through imageio when it is installed, to
`<out>.mp4`). --batch N packs N consecutive pairs into one forward in
the directory and video modes. Frames are .npy (uint8 [H, W, 3]) or,
when Pillow is installed, any image format it reads. Without --ckpt the
model runs on seeded random weights (a smoke run, not a result).
--device cpu runs the plain PyTorch versions of the kernels on the CPU.
--fast is the serving profile: the full-resolution global pre-alignment
is folded into the final flows (a small documented deviation from the
default forward). --ensemble_global picks the global motion of the
frames at full, 1/2 or 1/4 size that aligns them best. --spatial_shards
N splits each frame pair into N row slabs
(`parallel.make_spatial_forward`), spread over the visible cards in
turn (all N on one card when there is one); it prints the device of
each shard.
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


def write_video(args, stream) -> int:
    """--video: a .y4m through the port's reader and writer, another
    container through imageio when it imports."""
    stem = os.path.splitext(args.out)[0]
    if args.video.lower().endswith(".y4m"):
        from atmvfi_tpu_torch.utils.video import Y4MReader, Y4MWriter

        out_path = args.out if args.out.endswith(".y4m") else stem + ".y4m"
        with Y4MReader(args.video) as reader:
            fps_n, fps_d = reader.fps
            colorspace = ("C444" if reader.colorspace.startswith("C444")
                          else "C420")
            count = 0
            with Y4MWriter(out_path, reader.width, reader.height,
                           fps=(fps_n * args.factor, fps_d),
                           colorspace=colorspace) as writer:
                for f in stream(iter(reader)):
                    writer.write(f)
                    count += 1
            print(f"wrote {out_path}: {count} frames at "
                  f"{args.factor * reader.fps_float:g} fps")
        return 0
    try:
        import imageio.v2 as iio

        reader = iio.get_reader(args.video)
        fps = reader.get_meta_data().get("fps", 24)
    except Exception as e:  # no imageio, or no backend for the container
        print(f"video decode unavailable ({e}); use a .y4m input or "
              "--frames_dir instead")
        return 1
    out_path = args.out if args.out.endswith(".mp4") else stem + ".mp4"
    writer = iio.get_writer(out_path, fps=fps * args.factor)
    try:
        for f in stream(np.asarray(im)[..., :3] for im in reader):
            writer.append_data(f)
    finally:
        writer.close()
        reader.close()
    print(f"wrote {out_path} at {fps * args.factor} fps")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_type", choices=["base", "lite"], default="base")
    p.add_argument("--ckpt", help="reference .pt/.pth or JAX-package .npz")
    p.add_argument("--global_off", action="store_true",
                   help="disable the global motion branch")
    p.add_argument("--frame0")
    p.add_argument("--frame1")
    p.add_argument("--frames_dir")
    p.add_argument("--video", help=".y4m (or, with imageio, any video)")
    p.add_argument("--out", default="output_interpolated.png")
    p.add_argument("--factor", type=int, default=2, choices=[2, 4, 8])
    p.add_argument("--batch", type=int, default=1,
                   help="pairs per forward in the stream modes (the same "
                        "frames as batch 1 within float noise)")
    p.add_argument("--combine_video", action="store_true",
                   help="--frames_dir: write each source frame above its "
                        "outputs")
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
    if args.batch < 1:
        p.error("--batch must be >= 1")
    if args.batch > 1 and args.spatial_shards > 1:
        p.error("--batch > 1 does not combine with --spatial_shards > 1 "
                "(row-sharded serving takes one pair a forward)")

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

    def stream(frames):
        return pipe.interpolate_stream_batched(frames, args.factor,
                                               args.batch)

    if args.frames_dir:
        names = sorted(n for n in os.listdir(args.frames_dir)
                       if n.lower().endswith(_EXTS))
        if len(names) < 2:
            p.error(f"{args.frames_dir}: need at least two frames")
        os.makedirs(args.out, exist_ok=True)
        sources = []  # the frames read so far (for --combine_video)

        def frames():
            for n in names:
                f = read_frame(os.path.join(args.frames_dir, n))
                if args.combine_video:
                    sources.append(f)
                yield f

        ext = os.path.splitext(names[0])[1]
        count = 0
        for i, f in enumerate(stream(frames())):
            if args.combine_video:
                src = sources[min(i // args.factor, len(sources) - 1)]
                f = np.concatenate([src, f], axis=0)
            write_frame(os.path.join(args.out, f"{i:06d}{ext}"), f)
            count += 1
        print(f"wrote {count} frames to {args.out}")
        return 0
    if args.video:
        if args.combine_video:
            print("--combine_video applies to --frames_dir mode only")
        return write_video(args, stream)
    if not (args.frame0 and args.frame1):
        p.error("give --frame0 and --frame1, --frames_dir or --video")
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

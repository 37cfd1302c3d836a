"""Where the time of the two-frame serving path goes, on one GPU.

    python -m atmvfi_tpu_torch.tools.profile_main_path [--model base|lite]
        [--attention_impl pallas] [--warp_impl tiled_blend] [--fuse_pairs]
        [--fast] [--spatial_shards N] [--windows LOCAL GLOBAL]

Runs `InterpolationPipeline.interpolate_device` (bf16 towers, global
motion on, seeded weights, 1088x1920 frames already on the card; the
route fields of `models.config` as the flags set them) for
five frames under torch.profiler after a warm-up and prints one JSON
line: host-clock ms per frame, device busy ms per frame
(the sum of kernel times), the device's idle share over the profiled
window, device ms per forward stage (the `span` ranges of
models/network.py), per kernel family and per kernel, all read from the
trace by `utils.profiling` (`capture`, `summarize`, its `FAMILIES`). With
--spatial_shards N the forward is the row-sharded schedule with N
shards on the card (`parallel.make_spatial_forward`), whose stages are
the shards' front, middle and tail ranges, the gathers and the work
computed once for all shards (replicated). With --windows the
pipeline runs at `set_window_sizes(LOCAL, GLOBAL)` (windows above 12 take
the attention kernels' key-tiled forms). Needs a CUDA device; it does
not fall back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=["base", "lite"], default="base")
    p.add_argument("--attention_impl", default="auto")
    p.add_argument("--warp_impl", default="auto")
    p.add_argument("--fuse_pairs", action="store_true",
                   help="hcw_fuse_pairs: the conv pairs as K12")
    p.add_argument("--fast", action="store_true",
                   help="the serving profile (composed full-res warps)")
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="row-sharded schedule with N shards on the card")
    p.add_argument("--windows", type=int, nargs=2, metavar=("LOCAL", "GLOBAL"),
                   help="attention window sizes (default: the model's)")
    args = p.parse_args(argv)

    import dataclasses

    import torch

    from atmvfi_tpu_torch.infer import InterpolationPipeline
    from atmvfi_tpu_torch.models import get_config
    from atmvfi_tpu_torch.parallel import make_mesh
    from atmvfi_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device", file=sys.stderr)
        return 2
    cfg = dataclasses.replace(get_config(args.model),
                              attention_impl=args.attention_impl,
                              warp_impl=args.warp_impl,
                              hcw_fuse_pairs=args.fuse_pairs)
    n = args.spatial_shards
    mesh = make_mesh((1, n), ["cuda:0"] * n) if n > 1 else None
    pipe = InterpolationPipeline(None, cfg, torch.bfloat16,
                                 global_motion=True, device="cuda",
                                 fast=args.fast, mesh=mesh)
    if args.windows:
        pipe.set_window_sizes(local=args.windows[0], global_=args.windows[1])
    g = torch.Generator(device="cuda").manual_seed(0)
    H, W, frames = 1088, 1920, 5
    x0 = torch.rand(1, H, W, 3, generator=g, device="cuda")
    x1 = torch.roll(x0, (3, -5), (1, 2))
    for _ in range(2):
        pipe.interpolate_device(x0, x1)
    torch.cuda.synchronize()

    def frames_run():  # host clock of the frames, not of the export
        t0 = time.perf_counter()
        for _ in range(frames):
            pipe.interpolate_device(x0, x1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as trace_dir:
        wall, _ = profiling.capture(frames_run, trace_dir=trace_dir)
        summary = profiling.summarize(trace_dir, top=20)
    ms = lambda v: v / frames  # noqa: E731  per frame
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps(dict(
        model=args.model, dtype="bf16", size=[H, W], global_motion=True,
        attention_impl=pipe.cfg.attention_impl, warp_impl=pipe.cfg.warp_impl,
        hcw_fuse_pairs=pipe.cfg.hcw_fuse_pairs,
        compose_full_res_warps=pipe.cfg.compose_full_res_warps,
        spatial_shards=n, windows=[pipe.cfg.local_window,
                                   pipe.cfg.global_window],
        frames=frames, gpu=smi,
        wall_ms_per_frame=wall * 1e3 / frames,
        device_busy_ms_per_frame=ms(summary["total_ms"]),
        idle_share=summary["idle_share"],
        stages_ms={s: ms(v) for s, v in summary["by_source_ms"].items()},
        families_ms={f: ms(v) for f, v in
                     summary["by_category_ms"].items()},
        top_kernels=[dict(name=k[:120], ms=ms(v["ms"]),
                          calls_per_frame=v["calls"] / frames)
                     for k, v in summary["by_kernel"].items()],
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

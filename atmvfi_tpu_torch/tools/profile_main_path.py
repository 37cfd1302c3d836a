"""Where the time of the two-frame serving path goes, on one GPU.

    python -m atmvfi_tpu_torch.tools.profile_main_path [--model base|lite]
        [--attention_impl pallas] [--warp_impl tiled_blend] [--fuse_pairs]
        [--fast] [--spatial_shards N]

Runs `InterpolationPipeline.interpolate_device` (bf16 towers, global
motion on, seeded weights, 1088x1920 frames already on the card; the
route fields of `models.config` as the flags set them) for
five frames under torch.profiler after a warm-up and prints one JSON
line: host-clock ms per frame, device busy ms per frame
(the sum of kernel times), the device's idle share over the profiled
window, device ms per forward stage (the `span` ranges of
models/network.py), per kernel family and per kernel. With
--spatial_shards N the forward is the row-sharded schedule with N
shards on the card (`parallel.make_spatial_forward`), whose stages are
the shards' front, middle and tail ranges, the gathers and the work
computed once for all shards (replicated). Needs a CUDA device;
it does not fall back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import defaultdict

STAGES = ("encoder", "global_motion", "prealign", "local_motion", "enhance",
          "decoder", "refine", "front", "middle", "tail", "gather",
          "replicated")
FAMILIES = (  # first match wins
    ("K12 conv pair", r"pair_bf16_kernel|pair_f32_kernel"),
    ("K3-K6 conv kernels", r"igemm_"),
    ("K1 / K7 attention", r"gemm_bf16_kernel|gemm_f32_kernel|"
                          r"attn_(mma_)?kernel"),
    ("K2 / K9 / K10 warp", r"warp_narrow_kernel|warp_wide_kernel|"
                           r"warp_blend_kernel"),
    ("conv (cuDNN)", r"conv|cudnn|fprop|dgrad|wgrad|implicit|nchw|nhwc"),
    ("dense (cuBLAS)", r"gemm|cublas|nvjet"),
    ("elementwise / copy", r"elementwise|vectorized|copy|cat|index|pad|"
                           r"roll|reduce|softmax|layer_norm|Memcpy|Memset"),
)


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name, re.IGNORECASE):
            return fam
    return "other"


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
    args = p.parse_args(argv)

    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from atmvfi_tpu_torch.infer import InterpolationPipeline
    from atmvfi_tpu_torch.models import get_config
    from atmvfi_tpu_torch.parallel import make_mesh

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
    g = torch.Generator(device="cuda").manual_seed(0)
    H, W, frames = 1088, 1920, 5
    x0 = torch.rand(1, H, W, 3, generator=g, device="cuda")
    x1 = torch.roll(x0, (3, -5), (1, 2))
    for _ in range(2):
        pipe.interpolate_device(x0, x1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            pipe.interpolate_device(x0, x1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in dev if e.name in STAGES]
    kernels = [e for e in dev if e.name not in STAGES]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    by_stage = defaultdict(float)
    by_family = defaultdict(float)
    by_kernel = defaultdict(lambda: [0.0, 0])
    busy = 0.0
    for k in kernels:
        us = k.time_range.elapsed_us()
        busy += us
        by_family[family(k.name)] += us
        rec = by_kernel[k.name]
        rec[0] += us
        rec[1] += 1
        stage = next((s for s, a, b in ranges
                      if a <= k.time_range.start < b), "unattributed")
        by_stage[stage] += us
    span_us = (max(k.time_range.end for k in kernels)
               - min(k.time_range.start for k in kernels))
    ms = lambda us: us / 1e3 / frames  # noqa: E731  per frame
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:20]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps(dict(
        model=args.model, dtype="bf16", size=[H, W], global_motion=True,
        attention_impl=pipe.cfg.attention_impl, warp_impl=pipe.cfg.warp_impl,
        hcw_fuse_pairs=pipe.cfg.hcw_fuse_pairs,
        compose_full_res_warps=pipe.cfg.compose_full_res_warps,
        spatial_shards=n, frames=frames, gpu=smi,
        wall_ms_per_frame=wall * 1e3 / frames,
        device_busy_ms_per_frame=ms(busy),
        idle_share=1.0 - busy / span_us,
        stages_ms={s: ms(v) for s, v in sorted(by_stage.items(),
                                               key=lambda kv: -kv[1])},
        families_ms={f: ms(v) for f, v in sorted(by_family.items(),
                                                 key=lambda kv: -kv[1])},
        top_kernels=[dict(name=k[:120], ms=ms(v[0]),
                          calls_per_frame=v[1] / frames)
                     for k, v in top],
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

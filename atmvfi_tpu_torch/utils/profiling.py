"""Profiling helpers: capture and summarize torch.profiler device traces.

Counterpart of `atmvfi_tpu/utils/profiling.py` (jax.profiler). Run a
function under `capture()`, which writes a Chrome trace; `summarize()`
reads it back and groups the device time (kernels, copies and sets) by
kernel family (`FAMILIES`, the port's kernels K1-K12 and the library
calls around them) and by forward stage (the `span` ranges of
`models/network.py` and `parallel/spatial.py`, `STAGES`), with the
device's idle share over the traced window.
`tools/profile_main_path.py` reads its traces through these.
"""
from __future__ import annotations

import collections
import json
import os
import re
import tempfile
from typing import Callable, Dict, Optional, Tuple

import torch

STAGES = ("encoder", "global_motion", "prealign", "local_motion", "enhance",
          "decoder", "refine", "front", "middle", "tail", "gather",
          "replicated")
FAMILIES = (  # first match wins
    ("K12 conv pair", r"pair_bf16_kernel|pair_f32_kernel"),
    # K5 on K3's wgmma kernel (mode 1) or its folded body; K6 on wgmma
    ("K5 multi-source conv", r"conv3x3_wgmma_kernel<\d+, ?1, ?1>|"
                             r"conv3x3_fold_kernel"),
    ("K6 deconv", r"deconv2x_wgmma_kernel"),
    # K3 / K4; the implicit GEMM (igemm_*) also runs K5 / K6 where their
    # sources take no TMA map (f32, odd layouts: off the bf16 main path)
    ("K3 / K4 conv kernels", r"igemm_|conv3x3_wgmma_kernel"),
    ("K1 GEMM launches", r"::lg::|gemm_f32_kernel"),
    ("K1 / K7 attention launch", r"attn_(mma_)?(tiled_)?kernel"),
    ("K2 / K9 / K10 warp", r"warp_narrow_kernel|warp_wide_kernel|"
                           r"warp_blend_kernel"),
    ("row P grid matmul", r"grid_matmul_kernel"),
    ("conv (cuDNN)", r"conv|cudnn|fprop|dgrad|wgrad|implicit|nchw|nhwc"),
    ("dense (cuBLAS)", r"gemm|cublas|nvjet"),
    ("elementwise / copy", r"elementwise|vectorized|copy|cat|index|pad|"
                           r"roll|reduce|softmax|layer_norm|Memcpy|Memset"),
)
# Chrome-trace categories of device work and of the device-side ranges
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_CAT = "gpu_user_annotation"
TRACE_FILE = "trace.json"


def family(name: str) -> str:
    """The kernel family (`FAMILIES`) of a device event's name."""
    for fam, pat in FAMILIES:
        if re.search(pat, name, re.IGNORECASE):
            return fam
    return "other"


def capture(fn: Callable, *args, trace_dir: Optional[str] = None
            ) -> Tuple[object, str]:
    """Run fn(*args) under torch.profiler (CPU activity, and CUDA where a
    card is present), synchronize, and write the Chrome trace to
    `trace_dir/trace.json` (a new temporary directory when None).
    Returns (fn's result, trace_dir)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="atmvfi_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    return out, trace_dir


def summarize(trace_dir: str, top: int = 20) -> Dict:
    """Device time of the trace in `trace_dir`: `total_ms` (busy: the
    sum of kernel, copy and set durations), `by_category_ms` (kernel
    family), `by_source_ms` (forward stage; "unattributed" outside every
    range), `by_kernel` (the `top` names: ms and calls), `span_ms` (first
    start to last end) and `idle_share` (1 - busy / span). Raises when
    the trace holds no device work: a host-only trace is no device
    profile."""
    path = os.path.join(trace_dir, TRACE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no trace under {trace_dir}")
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, ranges = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append(e)
        elif e.get("cat") == RANGE_CAT and e.get("name") in STAGES:
            ranges.append((e["name"], e["ts"], e["ts"] + e["dur"]))
    if not dev:
        raise ValueError(f"{path}: no device kernels in the trace")
    by_cat: collections.Counter = collections.Counter()
    by_src: collections.Counter = collections.Counter()
    by_kernel: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    total = 0.0
    for e in dev:
        us = float(e["dur"])
        total += us
        by_cat[family(e["name"])] += us
        stage = next((s for s, a, b in ranges if a <= e["ts"] < b),
                     "unattributed")
        by_src[stage] += us
        rec = by_kernel[e["name"]]
        rec[0] += us
        rec[1] += 1
    span = (max(e["ts"] + e["dur"] for e in dev)
            - min(e["ts"] for e in dev))
    return {
        "total_ms": total / 1e3,
        "by_category_ms": {k: v / 1e3 for k, v in by_cat.most_common()},
        "by_source_ms": {k: v / 1e3 for k, v in by_src.most_common()},
        "by_kernel": {k: {"ms": v[0] / 1e3, "calls": v[1]} for k, v in
                      sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
                      [:top]},
        "span_ms": span / 1e3,
        "idle_share": 1.0 - total / span if span > 0 else 0.0,
    }


def print_summary(summary: Dict) -> None:
    print(f"device busy: {summary['total_ms']:.3f} ms over "
          f"{summary['span_ms']:.3f} ms (idle share "
          f"{summary['idle_share']:.3f})")
    print("by family:")
    for k, v in summary["by_category_ms"].items():
        print(f"  {v:10.3f} ms  {k}")
    print("by stage:")
    for k, v in summary["by_source_ms"].items():
        print(f"  {v:10.3f} ms  {k}")

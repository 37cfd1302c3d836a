"""Capture a device trace of a traced window and reduce it.

`capture(fn)` runs fn() under torch.profiler (CPU and CUDA activity)
inside a host range named `WINDOW`, synchronizes inside it, writes the
Chrome trace to a temporary file under TMPDIR, reads it back, deletes
it and returns `summarize` of it. The traced window is that range: from
the host entering it to the device's last work in it.

`summarize` is a frozen copy of the program's `utils/profiling.py`
arithmetic (the kernel families, the forward stages), with the idle
share taken over the traced window from the union of the device's
intervals (kernels, copies, sets): overlapping events count once, and
the host's gaps at both ends of the window count as idle.
"""
from __future__ import annotations

import collections
import json
import os
import re
import tempfile
from typing import Callable, Dict, List, Tuple

WINDOW = "portbench.window"
STAGES = ("encoder", "global_motion", "prealign", "local_motion", "enhance",
          "decoder", "refine", "front", "middle", "tail", "gather",
          "replicated")
FAMILIES = (  # first match wins
    ("K12 conv pair", r"pair_bf16_kernel|pair_f32_kernel"),
    ("K5 multi-source conv", r"conv3x3_wgmma_kernel<\d+, ?1, ?1>|"
                             r"conv3x3_fold_kernel"),
    ("K6 deconv", r"deconv2x_wgmma_kernel"),
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
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_CAT = "gpu_user_annotation"
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name, re.IGNORECASE):
            return fam
    return "other"


def capture(fn: Callable[[], object]) -> Dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return summarize(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_labels(host: List[Tuple[float, float, str]],
                 times: List[float]) -> List[str]:
    """What the host was doing at each of `times`: the outermost and
    innermost host ranges around it ("python" where none is). One sweep
    over the ranges sorted by start."""
    host = sorted((e for e in host if e[2] != WINDOW),
                  key=lambda e: (e[0], -e[1]))
    order = sorted(range(len(times)), key=lambda k: times[k])
    labels = [""] * len(times)
    active: List[Tuple[float, float, str]] = []
    i = 0
    for k in order:
        t = times[k]
        while i < len(host) and host[i][0] <= t:
            active.append(host[i])
            i += 1
        active = [e for e in active if e[1] > t]
        if not active:
            labels[k] = "python"
            continue
        outer, inner = active[0][2], active[-1][2]
        labels[k] = outer if outer == inner else f"{outer} > {inner}"
    return labels


def summarize(events: List[Dict]) -> Dict:
    """The traced window's device work, in seconds: `window_s`, `busy_s`
    (the union of device intervals inside the window), `kernels` (the
    number of kernel launches), `family_s` and `stage_s` (device time
    by kernel family and forward stage), `kernel_s` (by kernel name),
    `gaps_s` (idle time by what the host was doing), `device` (each
    device event inside the window: name, start, duration)."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation" and "dur" in e]
    if not win:
        raise ValueError("the trace has no window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, ranges, host = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a or (a == b and w0 <= a <= w1):
                dev.append((e["name"], a, b, cat))
        elif cat == RANGE_CAT and e.get("name") in STAGES:
            ranges.append((e["name"], a, b))
        elif cat in HOST_CATS:
            host.append((a, b, e["name"]))
    if not any(c == "kernel" for *_, c in dev):
        raise ValueError("no device kernels in the traced window")
    by_fam: collections.Counter = collections.Counter()
    by_stage: collections.Counter = collections.Counter()
    by_kernel: collections.Counter = collections.Counter()
    for name, a, b, _ in dev:
        us = b - a
        by_fam[family(name)] += us
        by_kernel[name] += us
        stage = next((s for s, ra, rb in ranges if ra <= a < rb),
                     "unattributed")
        by_stage[stage] += us
    busy = _union([(a, b) for _, a, b, _ in dev])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps: collections.Counter = collections.Counter()
    for (a, b), label in zip(idle, _host_labels(
            host, [(a + b) / 2 for a, b in idle])):
        gaps[label] += b - a
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": sum(1 for *_, c in dev if c == "kernel"),
        "family_s": {k: v / 1e6 for k, v in by_fam.most_common()},
        "stage_s": {k: v / 1e6 for k, v in by_stage.most_common()},
        "kernel_s": {k: v / 1e6 for k, v in by_kernel.most_common(TOP)},
        "gaps_s": {k: v / 1e6 for k, v in gaps.most_common()},
        "device": [(n, a / 1e6, (b - a) / 1e6) for n, a, b, _ in dev],
    }


def breakdown(summary: Dict) -> Dict:
    """The result line's `breakdown`: device time by kernel family and
    idle time by what the host was doing, ten entries each."""
    return {
        "device_ops": [[k, v] for k, v in
                       list(summary["family_s"].items())[:TOP]],
        "idle_gaps": [[k, v] for k, v in
                      list(summary["gaps_s"].items())[:TOP]],
    }

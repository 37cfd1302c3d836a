"""One run of one cell: set-up, the timed window, the traced window, the
check against the reference, and the metrics.

Everything is found by name (see README.md): the cell in
`BENCHMARK.json` and `workloads/<cell>.json`, its configuration in
`configs/<config>.json`, its traffic mix in `traffic/<traffic>.json`,
each metric's reader in `metrics/<metric>.py`, the counted work in
`counts/<config>@<H>x<W>.json` and the chip's peaks in `peaks.json`.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCHMARK = os.path.join(os.path.dirname(ROOT), "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "atmvfi_tpu")


def dtype(name: str):
    """The torch dtype a configuration names ("bfloat16", "float32")."""
    import torch
    return getattr(torch, name)


def _load(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, kind, name + ".json")) as f:
        return json.load(f)


def load_config(name: str, root: str = ROOT) -> dict:
    return _load(root, "configs", name)


def load_traffic(name: str, root: str = ROOT) -> dict:
    return _load(root, "traffic", name)


def load_workload(name: str, root: str = ROOT) -> dict:
    return _load(root, "workloads", name)


def load_bench(path: str = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str, root: str = ROOT):
    """The reader module of metric `name` (`metrics/<name>.py`)."""
    path = os.path.join(root, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_counts(config: str, height: int, width: int,
                root: str = ROOT) -> Optional[dict]:
    path = os.path.join(root, "counts", f"{config}@{height}x{width}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_peaks(kind: str, root: str = ROOT) -> Optional[dict]:
    with open(os.path.join(root, "peaks.json")) as f:
        return json.load(f).get(kind)


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer ones."""
    ms = bench["per_layer" if trace else "end_to_end"]
    return [m for m in ms if cell in m.get("workloads", [cell])]


def padded(config: dict, traffic: dict):
    d = config["pad_divisor"]
    return -(-traffic["height"] // d) * d, -(-traffic["width"] // d) * d


def build_program(config: dict, state_dict, device):
    """The program under test: the port's pipeline at the configuration's
    widths, routes and serving dtype, holding the seed's weights."""
    from atmvfi_tpu_torch.infer.pipeline import InterpolationPipeline
    from atmvfi_tpu_torch.models import ATMVFIConfig

    m = dict(config["model"])
    m["hidden_dims"] = tuple(m["hidden_dims"])
    cfg = ATMVFIConfig(name=config["variant"],
                       pyramid_level=len(m["hidden_dims"]), **m,
                       attention_impl=config["attention_impl"],
                       warp_impl=config["warp_impl"])
    return InterpolationPipeline(
        state_dict=state_dict, variant=cfg, dtype=dtype(config["dtype"]),
        global_motion=config["global_motion"],
        pad_divisor=config["pad_divisor"], device=device)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT, bench: dict = None,
             t0: float = None, plant=None) -> Dict:
    """One run; returns the result line's object (see README.md).
    `device="cpu"` is for tests: it skips nothing but the chip.
    `plant(pipeline)`, where given, breaks the program before the
    warm-up (the checks' fault readings and tests)."""
    import numpy as np
    import torch

    from portbench import check, drive, frames
    from portbench import trace as tr
    from portbench import weights
    from portbench.reference import network as R

    t0 = time.perf_counter() if t0 is None else t0
    bench = load_bench() if bench is None else bench
    entry = cell_entry(bench, cell)
    work = load_workload(cell, root)
    config = load_config(entry["config"], root)
    traffic = load_traffic(entry["traffic"], root)
    sizes = R.Sizes.from_dict(config["model"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    # set-up: weights and frames from the seed, the program, warm-up
    marks = [("imports", time.perf_counter())]
    sd = weights.make_state_dict(sizes, seed, dev)
    pool = frames.make_pool(traffic, seed, dev)
    marks.append(("weights and frames", time.perf_counter()))
    pipe = build_program(config, sd, dev)
    if plant is not None:
        plant(pipe)
    drv = drive.MODES[traffic["mode"]](pipe, pool, traffic)
    marks.append(("program", time.perf_counter()))
    drv.warmup()
    sample = drive.sample_pairs(traffic, work["sample"], seed)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    prev = t0
    for name, t in marks:
        print(f"setup {name} {t - prev:.3f} s", file=sys.stderr)
        prev = t

    win = drv.window(seconds, sample)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"window {win.frames} frames in {win.seconds:.3f} s", file=sys.stderr)
    if win.latencies_s:
        lat = np.asarray(win.latencies_s) * 1e3
        print("latency ms: first " + " ".join(f"{v:.2f}" for v in lat[:3])
              + " median %.2f p95 %.2f max %.2f" % (
                  np.median(lat), np.percentile(lat, 95), lat.max()),
              file=sys.stderr)
    summary, traced_frames = None, 0
    if trace:
        box = {}
        summary = tr.capture(lambda: box.setdefault("n", drv.traced(
            traffic["trace_steps"])))
        traced_frames = box["n"]

    # the check, once the program's state is freed
    del drv, pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    missing = [q for q in sample if q not in win.samples]
    refs = check.reference_frames(sd, sizes, pool, sorted(win.samples),
                                  config["pad_divisor"], dev)
    nums = check.numbers((win.samples[q], refs[q]) for q in sorted(refs))
    limits = work.get("limits", {})
    attempted = len(win.latencies_s) if win.latencies_s is not None \
        else win.frames
    correct = (check.verdict(nums, limits) and not missing
               and win.failed == 0 and win.frames > 0)

    H, W = padded(config, traffic)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    run = SimpleNamespace(
        cell=entry, workload=work, config=config, traffic=traffic,
        setup_s=setup_s, window=win, window_peak_bytes=window_peak,
        trace=summary, traced_frames=traced_frames,
        counts=load_counts(entry["config"], H, W, root),
        peaks=load_peaks(kind, root))
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        v = load_metric(m["name"], root).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": entry["chips"],
                   "memory_peak_bytes": max(setup_peak, window_peak)
                   if cuda else 0}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": win.failed, "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        out["breakdown"] = tr.breakdown(summary)
        print(json.dumps({"stage_s": summary["stage_s"],
                          "kernel_s": summary["kernel_s"],
                          "kernels": summary["kernels"],
                          "traced_frames": traced_frames}), file=sys.stderr)
    if missing:
        print(f"sampled pairs never delivered: {missing}", file=sys.stderr)
    out["check"] = {k: {"value": nums[k], "limit": limits.get(k)}
                    for k in check.NUMBERS}
    for k in check.NUMBERS:
        print(f"check {k} {nums[k]!r} limit {limits.get(k)!r}", file=sys.stderr)
    return out

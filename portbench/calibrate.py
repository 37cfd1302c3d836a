"""Readings that set a cell's check limits, at the cell's own size.

    python portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --fault-seeds 7,8,9 [--seconds 2]

For each of `--seeds`, a run of the cell (`harness.run_cell`, a short
window at the cell's own load) gives the program's numbers. For each of
`--control-seeds`, the control: the reference computed with its towers'
operands rounded to fp8 (e4m3, per-tensor scale), put in the program's
place on the same sampled pairs, against the f32 reference. For each
of `--fault-seeds`, one run with each fault of `faults.py` planted that
the cell's batch can show. One JSON line a reading on standard output.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def control(cell: str, seed: int, device: str = "cuda",
            root: str = harness.ROOT, bench: dict = None) -> dict:
    import torch

    from portbench import check, drive, frames, weights
    from portbench.reference import network as R

    bench = harness.load_bench() if bench is None else bench
    entry = harness.cell_entry(bench, cell)
    work = harness.load_workload(cell, root)
    config = harness.load_config(entry["config"], root)
    traffic = harness.load_traffic(entry["traffic"], root)
    sizes = R.Sizes.from_dict(config["model"])
    dev = torch.device(device)
    sd = weights.make_state_dict(sizes, seed, dev)
    pool = frames.make_pool(traffic, seed, dev)
    sample = drive.sample_pairs(traffic, work["sample"], seed)
    args = (sd, sizes, pool, sample, config["pad_divisor"], dev)
    ref = check.reference_frames(*args)
    low = check.reference_frames(*args, R.Precision(round_fn=R.fp8_round))
    return check.numbers((low[q], ref[q]) for q in sample)


def main(argv=None) -> None:
    from portbench import faults

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    bench = harness.load_bench()
    traffic = harness.load_traffic(
        harness.cell_entry(bench, a.workload)["traffic"])

    def emit(kind, seed, nums):
        print(json.dumps({"cell": a.workload, "kind": kind, "seed": seed,
                          **nums}), flush=True)

    for s in seeds:
        out = harness.run_cell(a.workload, s, a.seconds, False, bench=bench)
        emit("program", s, {k: v["value"] for k, v in out["check"].items()})
    for s in [int(x) for x in a.control_seeds.split(",") if x]:
        emit("control_fp8", s, control(a.workload, s, bench=bench))
    for s in [int(x) for x in a.fault_seeds.split(",") if x]:
        for name, fn in faults.FAULTS.items():
            if name == "half_batch" and traffic["batch"] < 2:
                continue
            out = harness.run_cell(a.workload, s, a.seconds, False,
                                   bench=bench, plant=fn)
            emit("fault_" + name, s,
                 {k: v["value"] for k, v in out["check"].items()})


if __name__ == "__main__":
    main()

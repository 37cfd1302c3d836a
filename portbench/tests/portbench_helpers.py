"""A throwaway copy of the benchmark's data with tiny cells, for CPU runs."""
import json
import os
import shutil

from portbench import harness

TINY = {"height": 60, "width": 100, "pool": 4, "trace_steps": 1}
LIMITS = None  # the cells' own limits, read from their workload files


def tiny_root(tmp_path, cells=(("tiny-stream", "atmvfi-lite-bf16",
                                "stream-1080p-b4", "base-1080p-stream-b4"),
                               ("tiny-pair", "atmvfi-base-bf16",
                                "pair-1080p", "base-1080p-pair"))):
    """(root, bench): a copy of portbench/ under tmp_path with, for each
    (name, config, traffic like, limits of cell), a traffic mix cut to
    60 x 100 frames and a pool of 4 (every pair sampled) and a cell file holding that cell's limits, and
    BENCHMARK.json with the cells added. Nothing else is edited."""
    root = str(tmp_path / "portbench")
    shutil.copytree(harness.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.load_bench()
    for name, config, like, limits_of in cells:
        t = harness.load_traffic(like, root)
        t.update(TINY)
        with open(os.path.join(root, "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
        w = harness.load_workload(limits_of, root)
        with open(os.path.join(root, "workloads", name + ".json"), "w") as f:
            json.dump(w, f)
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": name, "chips": 1, "why": "x"})
    with open(str(tmp_path / "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root, bench

"""The benchmark of atmvfi_tpu_torch: one run of one cell.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output (README.md
says what it holds) and the compared numbers beside their limits as the
last lines of standard error. Exits 2, printing no result, where no
CUDA card is visible or fewer than the cell asks for, and 3 where
`jax`, `jaxlib`, `flax` or the JAX package `atmvfi_tpu` is loaded once
the run is over (top-level module names compared whole).
"""
import time

T0 = time.perf_counter()  # the run's set-up time starts here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = harness.load_bench()
    chips = harness.cell_entry(bench, a.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                           bench=bench, t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"no result: loaded {bad}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

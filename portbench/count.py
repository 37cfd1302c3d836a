"""Count the work of one forward of a configuration at a padded shape.

    python portbench/count.py --config atmvfi-base-bf16 --height 1088 --width 1920

runs the reference forward (`reference/network.py`) with its towers in
the configuration's serving dtype on fake tensors (shapes only, no
arithmetic, no card) under the frozen counter (`counter.py`), for one
frame pair, and writes `counts/<config>@<H>x<W>.json`. The benchmark
reads these files at run time and never counts.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.counter import Count  # noqa: E402
from portbench.reference import network as R  # noqa: E402


def count(config: dict, height: int, width: int) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    sizes = R.Sizes.from_dict(config["model"])
    prec = R.Precision(tower=harness.dtype(config["dtype"]))
    with FakeTensorMode():
        w = {name: torch.empty(shape) for name, shape, _, _ in R.spec(sizes)}
        im = torch.empty(1, height, width, 3)
        with Count() as c, torch.no_grad():
            R.forward(w, sizes, im, im, prec)
    return {"config": config["name"], "height": height, "width": width,
            "pairs": 1, **c.result()}


def path_for(root: str, config: str, height: int, width: int) -> str:
    return os.path.join(root, "counts", f"{config}@{height}x{width}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    a = ap.parse_args(argv)
    cfg = harness.load_config(a.config)
    out = path_for(harness.ROOT, a.config, a.height, a.width)
    with open(out, "w") as f:
        json.dump(count(cfg, a.height, a.width), f, indent=1)
        f.write("\n")
    print(out)


if __name__ == "__main__":
    main()

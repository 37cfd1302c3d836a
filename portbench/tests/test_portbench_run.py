"""Whole runs of tiny cells on the CPU (the harness's look for a chip
skipped), the faults that must turn `correct` false, the fp8 control,
the modules a run loads, and the card's own runs."""
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import calibrate, faults, harness
from portbench_helpers import tiny_root

REPO = os.path.dirname(harness.ROOT)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("pb"))


@pytest.mark.parametrize("cell", ["tiny-stream", "tiny-pair"])
def test_a_new_cell_is_found_and_runs_correct(tiny, cell):
    """A cell added as files alone (traffic, workload, a BENCHMARK.json
    entry) runs through the harness unedited, and the program comes out
    correct under the cell's limits. Three seconds cycle the pool of 4
    pairs on the CPU, so every sampled pair is delivered."""
    root, bench = tiny
    out = harness.run_cell(cell, 2 ** 31 + 21, 3.0, False, device="cpu",
                           root=root, bench=bench)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"
    names = [m["name"] for m in harness.metrics_of(bench, cell, False)]
    assert "frames_per_s" in out["metrics"] and "setup_s" in out["metrics"]
    assert set(out["metrics"]) <= set(names)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-stream", "unchanged"), ("tiny-stream", "half_batch"),
    ("tiny-stream", "altered"), ("tiny-pair", "unchanged"),
    ("tiny-pair", "altered")])
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault):
    root, bench = tiny
    out = harness.run_cell(cell, 2 ** 31 + 22, 3.0, False, device="cpu",
                           root=root, bench=bench,
                           plant=faults.FAULTS[fault])
    assert not out["correct"]


@pytest.mark.parametrize("cell", ["tiny-stream", "tiny-pair"])
def test_the_fp8_control_is_not_correct(tiny, cell):
    """The reference with fp8 towers in the program's place fails the
    cell's limits."""
    root, bench = tiny
    nums = calibrate.control(cell, 2 ** 31 + 23, device="cpu", root=root,
                             bench=bench)
    limits = harness.load_workload(cell, root)["limits"]
    assert any(nums[k] > limits[k] for k in limits)


_PROBE = """
import json, sys
sys.path.insert(0, {repo!r})
import portbench.reference.network, portbench.check, portbench.frames
ref_only = sorted({{m.split('.')[0] for m in sys.modules}})
from portbench import harness, count, calibrate, drive, trace, weights
harness.build_program(harness.load_config('atmvfi-lite-bf16'), None, 'cpu')
print(json.dumps([ref_only, sorted({{m.split('.')[0] for m in sys.modules}})]))
"""


def test_no_jax_nor_the_jax_package_is_loaded():
    """Top-level module names compared whole: `atmvfi_tpu_torch` is the
    program, `atmvfi_tpu` the JAX package."""
    out = subprocess.run([sys.executable, "-c", _PROBE.format(repo=REPO)],
                         capture_output=True, text=True, check=True)
    ref_only, everything = json.loads(out.stdout.strip().splitlines()[-1])
    assert not set(ref_only) & {"atmvfi_tpu_torch", *harness.FORBIDDEN}
    assert "atmvfi_tpu_torch" in everything
    assert not set(everything) & set(harness.FORBIDDEN)


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "base-1080p-pair",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run
    raises before it could print a result."""
    import shutil
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "portbench")
    code = ("import sys; sys.path.insert(0, '.'); from portbench import "
            "harness; harness.run_cell('base-1080p-pair', 5, 1, False, "
            "device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0 and "atmvfi_tpu_torch" in out.stderr


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_bench()["workloads"]])
def test_card_run_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483901", "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]

"""BENCHMARK.json against the contract's shape, and every file a cell
needs found by name."""
import json
import os
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = harness.cell_entry(BENCH, cell)
    work = harness.load_workload(cell)
    config = harness.load_config(entry["config"])
    traffic = harness.load_traffic(entry["traffic"])
    assert set(work["limits"]) == {"frame_mean_abs", "tile_mean_abs"}
    assert work["sample"] >= 1 and entry["chips"] == 1
    assert traffic["mode"] in ("stream", "pair")
    H, W = harness.padded(config, traffic)
    assert harness.load_counts(entry["config"], H, W) is not None
    e2e = harness.metrics_of(BENCH, cell, False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    per_layer = harness.metrics_of(BENCH, cell, True)
    assert per_layer
    for m in per_layer:  # the end-to-end metric it moves is the cell's
        assert m["moves"] in [e["name"] for e in e2e]
    for m in e2e + per_layer:
        assert callable(harness.load_metric(m["name"]).read)


@pytest.mark.parametrize("conf", BENCH["configs"])
def test_config_file_is_the_run_configuration(conf):
    path = os.path.join(os.path.dirname(harness.ROOT), conf["file"])
    with open(path) as f:
        data = json.load(f)
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert conf["reduced"] == []

"""Each counted-work file equals a fresh count by count.py."""
import glob
import json
import os

import pytest

from portbench import count, harness

FILES = sorted(glob.glob(os.path.join(harness.ROOT, "counts", "*.json")))


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_counts_file_equals_a_fresh_count(path):
    with open(path) as f:
        kept = json.load(f)
    cfg = harness.load_config(kept["config"])
    fresh = json.loads(json.dumps(count.count(cfg, kept["height"],
                                              kept["width"])))
    assert fresh == kept


def test_count_matches_the_known_base_1080p_work():
    """5.9162 TFLOP of bf16 products a base 1088x1920 frame: conv 3x3
    4.2394, dot 1.3238, deconv 0.3187, conv 1x1 0.0342 (the program's
    own counter read the same families)."""
    c = count.count(harness.load_config("atmvfi-base-bf16"), 1088, 1920)
    fam = {k: round(v / 1e12, 4) for k, v in c["families"].items()}
    assert fam["conv 3x3"] == 4.2394 and fam["deconv 2x2"] == 0.3187
    assert fam["conv 1x1"] == 0.0342 and fam["dot"] == 1.3238
    assert c["tc_f32_flops"] == 0
    assert round(c["tc_bf16_flops"] / 1e12, 4) == 5.9162

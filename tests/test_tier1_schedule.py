"""Tier-1's loadfile schedule (``tier1_schedule.py``) on a synthetic collection.

Imports neither JAX nor torch and runs in well under a second.
"""
import os
from types import SimpleNamespace

import pytest

from tier1_schedule import HEAVY, LongestFirstScheduling, work_units

PLANAR_TRUE = "tests/test_model.py::test_planar_tail_matches_default[True]"
PLANAR_FALSE = "tests/test_model.py::test_planar_tail_matches_default[False]"
KERNEL_ROUTE = "tests/test_spatial.py::test_spatial_forward_kernel_route_single_shard"

# Three heavy tests among four files: test_b holds the most tests, and
# test_a and test_c tie on count, so collection order decides.
# test_model.py's other test goes last, with its file.
COLLECTION = [
    "tests/test_a.py::test_1",
    "tests/test_a.py::test_2",
    "tests/test_b.py::test_1",
    "tests/test_b.py::test_2[x]",
    "tests/test_b.py::test_2[y]",
    "tests/test_c.py::test_1",
    "tests/test_c.py::test_2",
    PLANAR_FALSE,
    "tests/test_model.py::test_small",
    PLANAR_TRUE,
    KERNEL_ROUTE,
]

EXPECTED_UNITS = [
    (PLANAR_TRUE, [PLANAR_TRUE]),
    (PLANAR_FALSE, [PLANAR_FALSE]),
    (KERNEL_ROUTE, [KERNEL_ROUTE]),
    ("tests/test_b.py", ["tests/test_b.py::test_1", "tests/test_b.py::test_2[x]",
                         "tests/test_b.py::test_2[y]"]),
    ("tests/test_a.py", ["tests/test_a.py::test_1", "tests/test_a.py::test_2"]),
    ("tests/test_c.py", ["tests/test_c.py::test_1", "tests/test_c.py::test_2"]),
    ("tests/test_model.py", ["tests/test_model.py::test_small"]),
]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def make_scheduler(pytestconfig):
    """The hook of the repo's root ``conftest.py``, as pytest loaded it."""
    root_conftest = os.path.join(_REPO_ROOT, "conftest.py")
    for plugin in pytestconfig.pluginmanager.get_plugins():
        if getattr(plugin, "__file__", None) == root_conftest:
            return plugin.pytest_xdist_make_scheduler
    pytest.fail("pytest did not load the root conftest.py")


class _Config:
    """The parts of ``pytest.Config`` the hook and xdist's scheduler read."""

    def __init__(self, **option):
        self.option = SimpleNamespace(**option)

    def getoption(self, name, default=None):
        return getattr(self.option, name, default)

    getvalue = getoption


class _Node:
    """A worker as the scheduler sees it; records the units it is sent."""

    def __init__(self, name, collection, handed):
        self.gateway = SimpleNamespace(id=name)
        self.collection = collection
        self.handed = handed
        self.pending = []
        self.shutting_down = False

    def send_runtest_some(self, indices):
        self.handed.append([self.collection[i] for i in indices])
        self.pending.extend(indices)

    def shutdown(self):
        self.shutting_down = True


def test_units_put_heavy_tests_alone_first_and_keep_files_whole():
    units = work_units(COLLECTION)
    assert units == EXPECTED_UNITS
    handed_out = [nodeid for _, ids in units for nodeid in ids]
    assert sorted(handed_out) == sorted(COLLECTION)


def test_units_ignore_heavy_tests_not_collected():
    # As in a run of one file, or with -k: none of HEAVY's tests collected.
    small = ["tests/test_model.py::test_small", "tests/test_model.py::test_other"]
    assert work_units(small) == [("tests/test_model.py", small)]
    assert work_units([]) == []


def test_scheduler_hands_out_units_in_order_and_every_test_once(make_scheduler):
    """xdist's own queue and refill rule, driven with two workers."""
    sched = make_scheduler(
        _Config(dist="loadfile", tx=["2*popen"], loadscopereorder=True), log=None)
    assert isinstance(sched, LongestFirstScheduling)
    handed = []
    nodes = [_Node(f"gw{i}", COLLECTION, handed) for i in range(2)]
    for node in nodes:
        sched.add_node(node)
        sched.add_node_collection(node, COLLECTION)
    sched.schedule()
    while any(node.pending for node in nodes):
        for node in nodes:
            if node.pending:
                sched.mark_test_complete(node, node.pending.pop(0))
    assert handed == [ids for _, ids in EXPECTED_UNITS]
    assert sched.tests_finished


@pytest.mark.parametrize("option", [{"dist": "load"}, {"dist": "no"}, {}],
                         ids=["load", "no", "without-xdist"])
def test_hook_leaves_other_modes_to_xdist(make_scheduler, option):
    assert make_scheduler(_Config(**option), log=None) is None


def test_heavy_tests_exist():
    """Each file HEAVY names defines each test it names."""
    for nodeid in HEAVY:
        path, _, name = nodeid.partition("::")
        with open(os.path.join(_REPO_ROOT, path), encoding="utf-8") as f:
            assert f"\ndef {name.split('[', 1)[0]}(" in f.read(), nodeid

"""pytest hooks for every test directory of the repo.

Under pytest-xdist's ``--dist loadfile`` the work units and their order
come from ``tests/tier1_schedule.py``: the heaviest tests each on their
own, handed out first. Other modes, and runs without xdist, are left as
they are.
"""
import os
import sys

import pytest

_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")


# xdist's DSession answers this first-result hook too; tryfirst makes
# this answer come first. optionalhook lets runs without xdist load
# this file, and xdist is imported only when the hook is called.
@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getoption("dist", None) != "loadfile":
        return None
    if _TESTS not in sys.path:
        sys.path.insert(0, _TESTS)
    from tier1_schedule import LongestFirstScheduling

    return LongestFirstScheduling(config, log)

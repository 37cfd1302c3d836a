"""Tier-1's schedule under ``--dist loadfile``: the longest units first.

pytest-xdist's loadfile scheduler keeps each test file on one worker
and queues the files by test count, largest first. A file that holds a
few heavy tests then sets the run's wall time by itself, and a unit of
one heavy test would be handed out last. Here each collected test that
``HEAVY`` names is a unit of its own, and these units go out first,
longest first. Every other test keeps its file's unit (the port's test
files build their JAX references once a file), in xdist's own order.
The refill rule and everything else is xdist's. The root
``conftest.py`` returns this scheduler under ``--dist loadfile``.

A test that takes over about 100 s on the CPU goes into ``HEAVY`` with
its measured seconds.
"""
from collections import OrderedDict

from xdist.scheduler import LoadFileScheduling

# Seconds in the Tier-1 run of e2e0a4f on the CPU (six workers, --dist
# loadfile): every test at or above 100 s.
HEAVY = {
    "tests/test_model.py::test_planar_tail_matches_default[True]": 521.9,
    "tests/test_model.py::test_planar_tail_matches_default[False]": 360.1,
    "tests/test_model.py::test_planar_tail_matches_default_bf16": 355.5,
    "tests/test_spatial.py::test_spatial_forward_kernel_route_single_shard": 329.3,
    "tests/test_conv_pallas.py::test_model_conv_impl_pallas_matches_xla": 163.0,
    "tests/test_deconv_pallas.py::test_model_deconv_hcw_path_matches_xla": 152.1,
    "tests/test_pallas_attention.py::test_model_forward_with_block_kernel_matches_xla": 148.0,
    "tests/test_conv_pallas.py::test_model_route_skips_infeasible_conv_pair": 145.3,
    "tests/test_spatial.py::test_spatial_forward_matches_single_device[True-True]": 144.6,
    "tests/test_spatial.py::test_dp_forward_matches_single_device": 119.0,
    "tests/test_video.py::test_demo_video_y4m_end_to_end": 118.9,
    "tests/test_model.py::test_refiner_hcw_unet_matches_xla": 116.9,
    "tests/test_pipeline.py::test_interpolate_stream_2x": 115.3,
    "tests/test_train.py::test_dryrun_multichip_8dev": 109.9,
    "tests/test_train.py::test_train_step_single_device": 103.0,
    "tests/test_trainer_options.py::test_demo_cli_smoke": 102.5,
    "tests/test_pallas_attention.py::test_model_forward_with_pallas_attention_matches_xla": 101.4,
}


def unit_scope(nodeid):
    """The work unit of a collected test: the test itself if named, else its file."""
    return nodeid if nodeid in HEAVY else nodeid.split("::", 1)[0]


def work_units(nodeids):
    """The ordered work units of a collection, as ``[(scope, [nodeid, ...])]``.

    ``HEAVY``'s tests come first, each alone, longest first; then the
    files, by test count, largest first; ties keep collection order, as
    in xdist.
    """
    units = {}
    for nodeid in nodeids:
        units.setdefault(unit_scope(nodeid), []).append(nodeid)
    return sorted(units.items(), key=lambda unit: (-HEAVY.get(unit[0], 0.0), -len(unit[1])))


class LongestFirstScheduling(LoadFileScheduling):
    """xdist's loadfile scheduling over ``work_units``."""

    _in_order = False

    def _split_scope(self, nodeid):
        return unit_scope(nodeid)

    def _assign_work_unit(self, node):
        # xdist's schedule() queues the units by count and hands out the
        # first ones in the same call: order the queue before the first.
        if not self._in_order:
            self.workqueue = OrderedDict(
                (scope, self.workqueue[scope]) for scope, _ in work_units(self.collection))
            self._in_order = True
        super()._assign_work_unit(node)

"""Device grids for the multi-device serving schedules.

Counterpart of `atmvfi_tpu/parallel/mesh.py::make_mesh`: a ('data',
'spatial') grid of devices. 'data' splits the batch (`spatial.
make_dp_forward`), 'spatial' the rows of one frame pair
(`spatial.make_spatial_forward`). A device may appear more than once:
that is how n shards run on one card, in turn, in one process.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


class DeviceMesh:
    """`devices[d][s]`: the device of data shard d, spatial shard s;
    `shape[axis]` the extent of an axis, as the JAX mesh has it."""

    def __init__(self, devices: List[List[torch.device]]):
        self.devices = devices
        self.shape: Dict[str, int] = {DATA_AXIS: len(devices),
                                      SPATIAL_AXIS: len(devices[0])}

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along one axis of the grid (the other axis at 0)."""
        if axis == SPATIAL_AXIS:
            return list(self.devices[0])
        return [row[0] for row in self.devices]

    def __repr__(self):
        return f"DeviceMesh({self.shape}, {self.devices})"


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> DeviceMesh:
    """A (data, spatial) grid over `devices` (default: every CUDA device;
    shape default (len(devices), 1), pure data parallelism)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass the devices "
                               "(e.g. ['cpu', 'cpu'])")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devs), 1)
    d, s = shape
    if d < 1 or s < 1 or d * s != len(devs):
        raise ValueError(f"mesh {tuple(shape)} does not hold {len(devs)} "
                         "devices")
    return DeviceMesh([devs[i * s:(i + 1) * s] for i in range(d)])

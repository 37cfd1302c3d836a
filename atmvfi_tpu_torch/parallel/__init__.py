"""Multi-device serving: device grids, row-sharded and data-parallel
schedules (counterpart of `atmvfi_tpu/parallel`)."""
from atmvfi_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    DeviceMesh,
    make_mesh,
)
from atmvfi_tpu_torch.parallel.spatial import (
    Gather,
    Replicated,
    deep_shard_projection,
    make_deep_shard_sim,
    make_dp_forward,
    make_spatial_forward,
    run_lockstep,
    spatial_ici_bytes,
    spatial_ici_bytes_deep,
)

__all__ = [
    "DATA_AXIS",
    "DeviceMesh",
    "Gather",
    "Replicated",
    "SPATIAL_AXIS",
    "deep_shard_projection",
    "make_deep_shard_sim",
    "make_dp_forward",
    "make_mesh",
    "make_spatial_forward",
    "run_lockstep",
    "spatial_ici_bytes",
    "spatial_ici_bytes_deep",
]

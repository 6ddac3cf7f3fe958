"""Partition routing and the sharded two-phase skyline over a device mesh."""

from skyline_tpu_torch.parallel.mesh import (
    make_mesh,
    sharded_two_phase_skyline,
)
from skyline_tpu_torch.parallel.partitioners import (
    PARTITIONERS,
    mr_angle,
    mr_dim,
    mr_grid,
    partition_ids,
)

__all__ = [
    "PARTITIONERS",
    "mr_dim",
    "mr_grid",
    "mr_angle",
    "partition_ids",
    "make_mesh",
    "sharded_two_phase_skyline",
]

"""A window's query over a mesh in one call: partition, local, merge.

Counterpart of ``skyline_tpu/parallel/pipeline.py``: partition ids by the
configured MR-* strategy on the device, rows grouped by their target place
with one stable argsort (the keyBy shuffle, FlinkSkyline.java:138), the
grouped rows split evenly over the places, then the sharded two-phase
skyline and its counts.

Real partitions differ in size, so place i takes the i-th equal slice of
the place-sorted order and a logical partition's rows may straddle two
places; the global skyline does not depend on placement (the merge law),
only the local phase's pruning does.
"""

from __future__ import annotations

import torch

from skyline_tpu_torch.parallel.chips import on_device
from skyline_tpu_torch.parallel.mesh import AXIS, Mesh, build_two_phase
from skyline_tpu_torch.parallel.partitioners import partition_ids


def build_window_pipeline(
    mesh: Mesh,
    *,
    algo: str = "mr-angle",
    num_partitions: int | None = None,
    domain_max: float = 1000.0,
    axis: str = AXIS,
    local_block: int = 2048,
    cross_block: int = 8192,
):
    """``step(x, valid) -> (global_keep, local_count, global_count,
    order)``. ``x`` (N, d) float32 and ``valid`` (N,) bool, N a multiple
    of the place count, on the first place's device. ``global_keep``
    follows the place-sorted row order ``order`` (``x[order]`` are the
    sorted rows; ``argsort(order)`` maps the mask back); the counts are
    0-d int64 tensors, read by nobody here."""
    places = mesh.axis_places(axis)
    n_dev = len(places)
    if num_partitions is None:
        num_partitions = 2 * n_dev  # the reference's 2x over-partitioning
    two_phase = build_two_phase(
        mesh, axis=axis, local_block=local_block, cross_block=cross_block
    )

    def step(x: torch.Tensor, valid: torch.Tensor):
        with on_device(places[0]):
            pids = partition_ids(x, algo, num_partitions, domain_max)
            dev = pids.to(torch.int64) % n_dev  # logical partition -> place
            order = torch.argsort(torch.where(valid, dev, n_dev), stable=True)
            local_keep, global_keep = two_phase(x[order], valid[order])
            return global_keep, local_keep.sum(), global_keep.sum(), order

    return step

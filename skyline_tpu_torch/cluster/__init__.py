"""Cluster plane: lease-fenced write-path HA + multi-host partitioned ingest
with a host-level tournament merge.

Counterpart of ``skyline_tpu/cluster/``:

- ``lease``: the on-disk lease/fencing-token plane beside the WAL, the
  epoch-stamped ``FencedWalWriter``, and the ``ClusterSupervisor`` that
  promotes the most-caught-up replica when the primary's lease expires.
- ``merge``: the third tournament level — host roots, host witness
  summaries, and the cross-host pairwise ladder (two K2 launches a pair on
  a card).
- ``coordinator``: ``ClusterPartitionSet`` (the partition-set facade over
  per-host members) and ``ClusterEngine`` (the drop-in engine over it),
  plus live partition-group migration between hosts.
"""

from skyline_tpu_torch.cluster.coordinator import ClusterEngine, ClusterPartitionSet
from skyline_tpu_torch.cluster.lease import (
    ClusterStatus,
    ClusterSupervisor,
    FencedWalWriter,
    LeaseKeeper,
    LeaseLostError,
    LeasePlane,
    LeaseRecord,
    WalFencedError,
)

__all__ = [
    "ClusterEngine",
    "ClusterPartitionSet",
    "ClusterStatus",
    "ClusterSupervisor",
    "FencedWalWriter",
    "LeaseKeeper",
    "LeaseLostError",
    "LeasePlane",
    "LeaseRecord",
    "WalFencedError",
]

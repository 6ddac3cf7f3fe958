"""Query-serving plane: versioned snapshots, delta subscriptions, admission.

Counterpart of ``skyline_tpu/serve/``. The engine publishes each completed
global skyline as an immutable versioned snapshot
(``snapshot.SnapshotStore``); readers are served lock-free from the latest
published version under a client staleness bound, subscribers catch up on
what entered/left between versions (``deltas.DeltaRing``), the wire bodies
are serialized once at publish (``bodystore.BodyStore``), and the
expensive forced-merge path is admission-controlled with explicit load
shedding (``admission``). ``server.SkylineServer`` exposes all of it over a
stdlib asyncio HTTP server.

The WAL-tailing read replica (``replica.SkylineReplica``,
``ReplicaDivergence``, ``run_replica``) loads lazily, as in the reference:
plain serve users do not pay for the resilience plane.
"""

from skyline_tpu_torch.serve.admission import AdmissionController, QueryGate, TokenBucket
from skyline_tpu_torch.serve.deltas import (
    DeltaRing,
    apply_delta_record,
    delta_wal_record,
    snapshot_delta,
    snapshot_wal_record,
)
from skyline_tpu_torch.serve.server import QueryBridge, ServeConfig, SkylineServer
from skyline_tpu_torch.serve.snapshot import Snapshot, SnapshotStore


def __getattr__(name):
    # the replica pulls in the resilience plane; load it lazily so plain
    # serve users don't pay for (or depend on) the WAL machinery
    if name in ("SkylineReplica", "ReplicaDivergence", "run_replica"):
        from skyline_tpu_torch.serve import replica as _replica

        return getattr(_replica, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdmissionController",
    "DeltaRing",
    "QueryBridge",
    "QueryGate",
    "ReplicaDivergence",
    "ServeConfig",
    "SkylineReplica",
    "Snapshot",
    "SnapshotStore",
    "TokenBucket",
    "apply_delta_record",
    "delta_wal_record",
    "run_replica",
    "snapshot_delta",
    "snapshot_wal_record",
]

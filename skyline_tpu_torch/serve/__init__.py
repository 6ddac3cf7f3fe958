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

The read replica (``serve/replica.py`` of the reference: ``SkylineReplica``,
``ReplicaDivergence``, ``run_replica``) needs the write-ahead log and the
supervisor, which are not ported yet; asking for it raises ``ImportError``.
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
    if name in ("SkylineReplica", "ReplicaDivergence", "run_replica"):
        raise ImportError(
            f"skyline_tpu_torch.serve.{name}: the read replica needs the "
            "write-ahead log and the supervisor, not ported yet (ROADMAP "
            "queue 1 item 6)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdmissionController",
    "DeltaRing",
    "QueryBridge",
    "QueryGate",
    "ServeConfig",
    "Snapshot",
    "SnapshotStore",
    "TokenBucket",
    "apply_delta_record",
    "delta_wal_record",
    "snapshot_delta",
    "snapshot_wal_record",
]

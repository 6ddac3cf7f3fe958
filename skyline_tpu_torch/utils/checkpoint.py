"""Engine checkpoint / resume.

Counterpart of ``skyline_tpu/utils/checkpoint.py``, with the same ``.npz``
format: a checkpoint written by either package loads into the other and
gives the same next answer. The format is topology-free: a flat or sharded
engine's checkpoint restores as flat or as sharded over any chip count
(``mesh_chips``), as a cluster over any host count (``cluster_hosts``) or
onto any device mesh (``mesh``), because ``restore_all`` splits the
per-partition state by owning chip, host or place.

The reference job declares all operator state as Flink managed state but never
enables checkpointing, so a crash loses everything (SURVEY.md §5 —
"the mechanism is wired, the feature is off"). Here the feature is on: the
full engine state — per-partition skylines, pending buffers, barrier
bookkeeping, pending queries, in-flight aggregations, counters — serializes
to one ``.npz`` and restores into a fresh engine, preserving
exactly-the-same-results semantics for any subsequent stream suffix.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np

from skyline_tpu_torch.resilience.faults import fault_point
from skyline_tpu_torch.stream.engine import EngineConfig, SkylineEngine, _QueryState

_FORMAT_VERSION = 1


def _content_crc(meta: dict, arrays: dict) -> int:
    """CRC32 over the meta doc (sans the crc field itself, sort-keyed so a
    json round trip recomputes identically) + every array's bytes in sorted
    key order."""
    scrubbed = {k: v for k, v in meta.items() if k != "crc32"}
    crc = zlib.crc32(json.dumps(scrubbed, sort_keys=True).encode("utf-8"))
    for k in sorted(arrays):
        crc = zlib.crc32(np.ascontiguousarray(arrays[k]).tobytes(), crc)
    return crc


def save_engine(engine: SkylineEngine, path: str, extra_meta: dict | None = None) -> None:
    """Serialize engine state to ``path`` (.npz, single file).

    The write is atomic and torn-proof: the npz lands in ``path + ".tmp"``
    first, is fsynced, and only then renamed over ``path`` with
    ``os.replace`` — a crash mid-save can never corrupt the previous good
    checkpoint. A content CRC32 (meta + arrays) rides in the meta doc so
    ``load_engine`` detects bit rot and deliberately torn files.

    ``extra_meta``: opaque caller state stored under ``meta["extra"]``
    (the resilience layer records consumed bus offsets here)."""
    cfg = engine.config
    if engine.pset.device_ingest:
        # un-flushed rows live in the device accumulation window, which has
        # no host pending representation; folding them into the skylines
        # first is result-equivalent (the merge law) and makes the
        # checkpoint self-contained
        engine.pset.sync_ingest_bookkeeping()
        engine.pset.flush_all()
    arrays: dict[str, np.ndarray] = {}
    meta = {
        "version": _FORMAT_VERSION,
        # every EngineConfig field, so restore cannot silently revert a
        # flag (e.g. query_timeout_ms=0 would resurrect the wait-forever
        # latch the watchdog exists to prevent)
        "config": {
            "parallelism": cfg.parallelism,
            "algo": cfg.algo,
            "domain_max": cfg.domain_max,
            "dims": cfg.dims,
            "buffer_size": cfg.buffer_size,
            "emit_skyline_points": cfg.emit_skyline_points,
            "query_timeout_ms": cfg.query_timeout_ms,
            "grid_prefilter": cfg.grid_prefilter,
            "initial_capacity": cfg.initial_capacity,
            "flush_policy": cfg.flush_policy,
            "overlap_rows": cfg.overlap_rows,
            "ingest": cfg.ingest,
        },
        "records_in": engine.records_in,
        "dropped": engine.dropped,
        "partitions": [],
        "pending": {},
        "inflight": [],
        "results": engine._results,
        "extra": dict(extra_meta or {}),
    }
    for p in engine.partitions:
        arrays[f"sky_{p.partition_id}"] = p.skyline_host()
        arrays[f"pending_{p.partition_id}"] = engine.pset.pending_rows_of(
            p.partition_id
        )
        meta["partitions"].append(
            {
                "id": p.partition_id,
                "max_seen_id": p.max_seen_id,
                "start_time_ms": p.start_time_ms,
                # CPU attribution is set-wide (stream/batched.py); every
                # partition records the set total, and load takes the max,
                # which also merges old per-partition checkpoints correctly
                "processing_ns": p.processing_ns,
                "records_seen": p.records_seen,
            }
        )
    for pid, queries in engine._pending_queries.items():
        meta["pending"][str(pid)] = [q.payload for q in queries]
    for payload, q in engine._inflight.items():
        meta["inflight"].append(
            {
                "payload": payload,
                "qid": q.qid,
                "required": q.required,
                "dispatch_ms": q.dispatch_ms,
                "last_arrival_ms": q.last_arrival_ms,
                "answered": sorted(q.partials),
                "local_sizes": {str(k): v for k, v in q.local_sizes.items()},
                "start_times": {str(k): v for k, v in q.start_times.items()},
                "cpu_ms": {str(k): v for k, v in q.cpu_ms.items()},
            }
        )
        for pid, part in q.partials.items():
            arrays[f"qpart_{_slug(payload)}_{pid}"] = part
    meta["crc32"] = _content_crc(meta, arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, __meta__=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **arrays)
        f.flush()
        os.fsync(f.fileno())
    fault_point("checkpoint.pre_replace")
    os.replace(tmp, path)


def load_engine(
    path: str, mesh=None, mesh_chips: int = 0, cluster_hosts: int = 0,
    with_meta: bool = False, tracer=None, telemetry=None, device: str = "cuda",
) -> SkylineEngine:
    """Restore an engine from a checkpoint written by ``save_engine`` (of
    either package) onto ``device`` — the card unless the caller asks for
    the CPU.

    ``mesh_chips`` > 0 restores into a ``distributed.ShardedEngine`` of
    that many chips (placement is runtime state, not checkpoint state: any
    checkpoint restores onto any chip count); ``cluster_hosts`` > 0 restores
    into a ``cluster.ClusterEngine`` of that many hosts, with ``mesh_chips``
    as the chips of each (``restore_all`` splits by owned partition id).
    ``mesh`` (a ``parallel.mesh.Mesh``) restores a flat engine onto that
    device mesh, from any checkpoint, meshed or not; its places' device
    type then stands for ``device``.
    ``with_meta=True`` returns ``(engine, meta)`` so callers can read the
    ``extra`` doc (recovery offsets). ``tracer``/``telemetry`` thread the
    worker's observability hubs into the restored engine. A checkpoint
    whose content CRC disagrees raises ``ValueError`` (and a torn npz
    raises from ``np.load``) — the checkpoint manager treats either as
    "fall back to the previous good checkpoint"."""
    if mesh is not None:
        device = mesh.device_type
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        if "crc32" in meta:  # pre-hardening checkpoints lack it; load as-is
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            if _content_crc(meta, arrays) != meta["crc32"]:
                raise ValueError(f"checkpoint CRC mismatch in {path}")
        # tolerate fields added/removed across versions within format 1
        import dataclasses

        known = {f.name for f in dataclasses.fields(EngineConfig)}
        cfg = EngineConfig(
            **{k: v for k, v in meta["config"].items() if k in known and k != "device"},
            device=device,
        )
        if cluster_hosts:
            from skyline_tpu_torch.cluster import ClusterEngine

            engine = ClusterEngine(
                cfg, hosts=cluster_hosts, chips_per_host=mesh_chips or 1,
                tracer=tracer, telemetry=telemetry,
            )
        elif mesh_chips:
            from skyline_tpu_torch.distributed import ShardedEngine

            engine = ShardedEngine(cfg, chips=mesh_chips, tracer=tracer, telemetry=telemetry)
        else:
            engine = SkylineEngine(cfg, mesh=mesh, tracer=tracer, telemetry=telemetry)
        engine.records_in = meta["records_in"]
        engine.dropped = meta["dropped"]
        engine._results = meta["results"]

        by_id = {pm["id"]: pm for pm in meta["partitions"]}
        engine.pset.restore_all(
            [z[f"sky_{p}"] for p in range(cfg.num_partitions)],
            [z[f"pending_{p}"] for p in range(cfg.num_partitions)],
        )
        for pid, pm in by_id.items():
            p = engine.partitions[pid]
            p.max_seen_id = pm["max_seen_id"]
            p.start_time_ms = pm["start_time_ms"]
            p.records_seen = pm["records_seen"]
        engine.pset.processing_ns = max(
            (pm["processing_ns"] for pm in meta["partitions"]), default=0
        )

        inflight_by_payload = {}
        for qm in meta["inflight"]:
            q = _QueryState(
                qid=qm["qid"],
                payload=qm["payload"],
                required=qm["required"],
                dispatch_ms=qm["dispatch_ms"],
            )
            q.last_arrival_ms = qm["last_arrival_ms"]
            q.local_sizes = {int(k): v for k, v in qm["local_sizes"].items()}
            q.start_times = {int(k): v for k, v in qm["start_times"].items()}
            q.cpu_ms = {int(k): v for k, v in qm["cpu_ms"].items()}
            for pid in qm["answered"]:
                q.partials[pid] = z[f"qpart_{_slug(qm['payload'])}_{pid}"]
            inflight_by_payload[qm["payload"]] = q
        engine._inflight = inflight_by_payload
        for pid_s, payloads in meta["pending"].items():
            engine._pending_queries[int(pid_s)] = [
                inflight_by_payload[pl] for pl in payloads if pl in inflight_by_payload
            ]
    if with_meta:
        return engine, meta
    return engine


def _slug(payload: str) -> str:
    return payload.replace(",", "_").replace("/", "_")

"""The skyline worker: the bridge between the transport plane and the engine.

The port's copy of ``skyline_tpu/bridge/worker.py``, the counterpart of the
reference's Flink job process: consumes the data topic (earliest) and query
topic (latest), feeds the ``SkylineEngine`` on the engine's device (the
card unless ``EngineConfig.device`` asks for the CPU), and produces one JSON
result per completed query on the output topic (FlinkSkyline.java job
wiring :84-97, :177-183). Works over any bus exposing
``produce``/``consumer`` (MemoryBus or KafkaBus).

Ported: the flat and sliding engines, each on one device or over a device
mesh (``mesh``, ``--mesh N``: ``parallel/mesh.py``), the sharded engine
(``mesh_chips``, ``--mesh-chips``: ``distributed.ShardedEngine`` with its
chip journals, chip health and online failover), the cluster engine
(``cluster_hosts``, ``--cluster-hosts``: ``cluster.ClusterEngine``, with
the lease-fenced WAL and honest demotion when deposed), the serving plane
with its WAL-tailing read replicas (``replicas``, ``--replicas``;
``--replica-of`` runs a standalone replica), the stats server, the WAL,
checkpoints and crash recovery, and the ops journal.
"""

from __future__ import annotations

import os
import socket
import sys
import time
import uuid

from skyline_tpu_torch.bridge.wire import format_result, parse_tuple_lines
from skyline_tpu_torch.resilience.faults import fault_point, install_from_env
from skyline_tpu_torch.resilience.wal import batch_digest
from skyline_tpu_torch.stream.engine import EngineConfig, SkylineEngine
from skyline_tpu_torch.utils.devices import device_type

# Reference topic names (FlinkSkyline.java:68-70)
INPUT_TOPIC = "input-tuples"
QUERY_TOPIC = "queries"
OUTPUT_TOPIC = "output-skyline"


class SkylineWorker:
    def __init__(
        self,
        bus,
        config: EngineConfig,
        input_topic: str = INPUT_TOPIC,
        query_topic: str = QUERY_TOPIC,
        output_topic: str = OUTPUT_TOPIC,
        mesh=None,
        mesh_chips: int = 0,
        cluster_hosts: int = 0,
        stats_port: int | None = None,
        window_size: int = 0,
        slide: int = 0,
        emit_per_slide: bool = False,
        max_drain_polls: int = 256,
        tracer=None,
        serve_port: int | None = None,
        serve_config=None,
        telemetry=None,
        trace_ring: int = 4096,
        trace_out: str | None = None,
        jax_profile_dir: str | None = None,
        resilience=None,
        replicas: int = 0,
    ):
        """``mesh_chips``: > 0 runs the sharded engine
        (``distributed.ShardedEngine``): the partitions in ``mesh_chips``
        contiguous groups over the visible cards, queries answered by the
        two-level tournament, with chip journals beside the WAL under
        ``SKYLINE_CHIP_BARRIER`` when crash safety is on. ``mesh``: a
        ``parallel.mesh.Mesh`` the partition state shards over (the flat
        or the sliding engine; exclusive with ``mesh_chips`` and
        ``cluster_hosts``).
        ``stats_port``: serve
        live /stats + /healthz JSON on this port (0 picks a free one; None
        disables) — the Flink-Web-UI role for this stack. ``window_size`` +
        ``slide`` (both > 0) switch the worker to the sliding-window engine
        (``stream.sliding_engine``), same transport and result planes.
        ``max_drain_polls``: cap on trigger-pending data re-polls per step
        (see ``step``); at the 65536-row default poll size the default cap
        drains up to ~16.7M rows before a trigger is applied anyway.
        ``serve_port``: start the query-serving plane (``serve/``) on this
        port (0 picks a free one; None disables): the engine publishes
        every completed global skyline as a versioned snapshot, and
        ``GET /skyline`` / ``POST /query`` / ``GET /deltas`` serve reads,
        forced merges, and delta catch-up with admission control;
        ``GET /explain`` (also on the stats port, and inline via
        ``/skyline?explain=1``) returns the per-query EXPLAIN plan that
        produced an answer (telemetry/explain.py, RUNBOOK §2k).
        ``serve_config``: a ``serve.ServeConfig`` overriding the admission
        and ring knobs (its ``port`` is overridden by ``serve_port``).
        ``tracer``: optional ``metrics.tracing.Tracer``; by default the
        worker traces its own loop (transport poll / parse / engine phases)
        with ``sync_device=False`` so the breakdown is observable in
        ``/stats`` without perturbing the async device pipeline.
        ``telemetry``: optional shared ``telemetry.Telemetry`` hub; the
        worker always has one (created here when not given, span ring sized
        ``trace_ring``) and threads it through the engine and both HTTP
        servers — latency histograms + per-query spans cost one lock each.
        ``trace_out``: write the span ring as Chrome trace-event JSON to
        this path on ``close()`` (load at https://ui.perfetto.dev).
        ``jax_profile_dir`` (the reference's name, kept for the CLI's
        ``--jax-profile-dir``): opt-in — wrap each forced-query injection
        (POST /query) in ``torch.profiler`` and write its Chrome trace to
        this directory, so a device-level profile of exactly one
        consistency merge can be captured from a live worker.
        ``resilience``: a ``resilience.ResilienceConfig`` enabling crash
        safety — on construction the worker restores the newest valid
        checkpoint, replays the WAL (digest-verified, exactly the committed
        spans) to the crashed incarnation's exact position, re-seats the
        serving plane's snapshot + delta ring, then records every consumed
        span and published delta to a fresh WAL segment; periodic
        checkpoints truncate the log. None (default) keeps the reference's
        lose-everything behavior. ``cluster_hosts``: > 0 runs the cluster
        engine (``cluster/``) over that many in-process hosts, with
        ``mesh_chips`` as the chips of each; with ``resilience`` the worker
        takes the write lease and stamps every WAL frame with its fencing
        token. ``replicas``: in-process WAL-tailing read replicas
        (``serve/replica.py``) beside the engine, each on its own port;
        they need ``resilience`` and the serving plane."""
        from skyline_tpu_torch.metrics.tracing import Tracer
        from skyline_tpu_torch.telemetry import Telemetry

        if mesh_chips and mesh is not None:
            raise ValueError("mesh and mesh_chips are mutually exclusive")
        if mesh_chips and window_size:
            raise ValueError("sliding-window mode does not support mesh_chips")
        if cluster_hosts and mesh is not None:
            raise ValueError("mesh and cluster_hosts are mutually exclusive")
        if cluster_hosts and window_size:
            raise ValueError("sliding-window mode does not support cluster_hosts")
        self.mesh_chips = int(mesh_chips)
        self.cluster_hosts = int(cluster_hosts)
        self.bus = bus
        self.max_drain_polls = max_drain_polls
        self.tracer = tracer if tracer is not None else Tracer(sync_device=False)
        self.telemetry = (
            telemetry if telemetry is not None
            else Telemetry(span_capacity=trace_ring)
        )
        self.trace_out = trace_out
        self._jax_profile_dir = jax_profile_dir
        self._profiles_written = 0
        self._phase_snapshot_ms: dict[str, float] = {}
        self._last_phase_report_s = 0.0
        # None = undecided, True = zero-copy array plane, False = line plane
        self._arrays_plane: bool | None = None
        # (ids, values) tail of an oversized array batch, served in
        # max_records micro-batches by subsequent _poll_data calls
        self._data_carry: tuple | None = None
        # -- crash safety (resilience=None keeps all of this inert) -------
        self.resilience = resilience
        self._ckpt_mgr = None
        self._wal = None
        self._opslog = None
        self._chip_wal = None
        self._lease_plane = None
        self._lease_keeper = None
        self._deposed = False
        self._snap_store = None
        self._serve_ring = None
        self._bodystore = None
        self._data_pos = 0  # consumed data-topic records (replay currency)
        self._query_pos = 0  # consumed query-topic records
        self._dirty = False  # work since the last checkpoint
        self._last_ckpt_s = time.monotonic()
        self._stop_requested = False
        self._recovered: dict | None = None
        restored_engine = None
        restored_meta = None
        wal_records: list = []
        wal_torn = 0
        if resilience is not None:
            if window_size:
                raise ValueError(
                    "sliding-window mode does not support crash safety "
                    "(utils/checkpoint.py covers the tumbling engine only)"
                )
            install_from_env()  # arm SKYLINE_FAULT_PLAN (parse-once)
            from skyline_tpu_torch.resilience import WAL_SUBDIR
            from skyline_tpu_torch.resilience.checkpoints import CheckpointManager
            from skyline_tpu_torch.resilience.wal import read_records

            self._ckpt_mgr = CheckpointManager(
                resilience.checkpoint_dir,
                retain=resilience.checkpoint_retain,
                telemetry=self.telemetry,
            )
            hit = self._ckpt_mgr.restore_latest(
                mesh=mesh, mesh_chips=mesh_chips, cluster_hosts=cluster_hosts,
                tracer=self.tracer,
                telemetry=self.telemetry, device=config.device,
            )
            ckpt_path = None
            if hit is not None:
                restored_engine, restored_meta, ckpt_path = hit
            self._wal_dir = os.path.join(resilience.checkpoint_dir, WAL_SUBDIR)
            wal_records, wal_torn = read_records(self._wal_dir)
            # sharded group-consistency check: at the highest barrier seq
            # common to all chip journals, every chip must agree on the
            # global epoch digest; divergence raises WalReplayError here,
            # BEFORE any replay could publish from inconsistent groups (a
            # flat worker's directory holds no chip journal: zero chips)
            from skyline_tpu_torch.resilience.chip_wal import verify_chip_barriers

            chip_verdict = verify_chip_barriers(self._wal_dir)
            if hit is not None or wal_records:
                self._recovered = {
                    "checkpoint": ckpt_path,
                    "wal_records": len(wal_records),
                    "wal_torn_segments": wal_torn,
                    "replayed_batches": 0,
                }
                if chip_verdict["chips"]:
                    self._recovered["chip_barriers"] = chip_verdict
        if window_size:
            from skyline_tpu_torch.stream.sliding_engine import SlidingEngine

            self.engine = SlidingEngine(
                config,
                window_size=window_size,
                slide=slide,
                mesh=mesh,
                emit_per_slide=emit_per_slide,
                tracer=self.tracer,
                telemetry=self.telemetry,
            )
        elif restored_engine is not None:
            # the checkpoint carries its full EngineConfig; trust it over the
            # passed config so a restarted incarnation can't silently change
            # result semantics mid-stream
            self.engine = restored_engine
        elif cluster_hosts:
            # multi-host cluster ingest: mesh_chips becomes the per-host
            # chip count, so --cluster-hosts 4 --mesh-chips 2 runs the full
            # three-level tournament
            from skyline_tpu_torch.cluster import ClusterEngine

            self.engine = ClusterEngine(
                config, hosts=cluster_hosts,
                chips_per_host=mesh_chips or 1, tracer=self.tracer,
                telemetry=self.telemetry,
            )
        elif mesh_chips:
            from skyline_tpu_torch.distributed import ShardedEngine

            self.engine = ShardedEngine(
                config, chips=mesh_chips, tracer=self.tracer,
                telemetry=self.telemetry,
            )
        else:
            self.engine = SkylineEngine(
                config, mesh=mesh, tracer=self.tracer, telemetry=self.telemetry
            )
        self.output_topic = output_topic
        self._data = bus.consumer(input_topic, from_beginning=True)
        self._queries = bus.consumer(query_topic, from_beginning=False)
        self.results_emitted = 0
        if resilience is not None:
            # warm the learned-dispatch planes BEFORE replay so the replay
            # flushes themselves run under the checkpointed winners
            # instead of re-paying cold exploration
            self._restore_dispatch_state(restored_meta)
            self._replay(restored_meta, wal_records)
        self.serve_server = None
        self._serve_bridge = None
        if serve_port is not None:
            from skyline_tpu_torch.serve import (
                DeltaRing,
                QueryBridge,
                ServeConfig,
                SkylineServer,
                SnapshotStore,
            )

            scfg = serve_config if serve_config is not None else ServeConfig()
            store = SnapshotStore(history=scfg.history)
            ring = DeltaRing(store, capacity=scfg.delta_ring)
            self.engine.attach_snapshots(store)
            self._serve_bridge = QueryBridge()
            self._snap_store = store
            self._serve_ring = ring
            # zero-copy body store: wire bodies serialize once per
            # publish, off the read path. With resilience the store file
            # lands beside the WAL so --replicas / --replica-of processes
            # map the primary's exact bytes); without a WAL dir it stays
            # in-process (publish-time serialization still wins).
            from skyline_tpu_torch.utils.knobs import env_bool

            if env_bool("SKYLINE_BODYSTORE", True):
                from skyline_tpu_torch.serve.bodystore import BodyStore

                wal_dir = getattr(self, "_wal_dir", None)
                self._bodystore = BodyStore(
                    os.path.join(wal_dir, "bodystore.dat")
                    if wal_dir is not None
                    else None
                ).attach(store)
            try:
                self.serve_server = SkylineServer(
                    store,
                    deltas=ring,
                    admission=scfg.admission(),
                    stats_cb=self.stats,
                    bridge=self._serve_bridge,
                    port=serve_port,
                    host=scfg.host,
                    telemetry=self.telemetry,
                    read_cache=scfg.read_cache_entries,
                    bodystore=self._bodystore,
                )
            except OSError as e:
                # like /stats: the serving plane is optional — a port
                # conflict must not take the ingest plane down
                self.engine.snapshots = None
                self._serve_bridge = None
                self._snap_store = None
                self._serve_ring = None
                if self._bodystore is not None:
                    self._bodystore.close()
                    self._bodystore = None
                print(
                    f"skyline worker: serve port {serve_port} unavailable "
                    f"({e}); continuing without the serving plane",
                    file=sys.stderr,
                )
        if resilience is not None:
            if self._snap_store is not None:
                self._restore_serve(wal_records)
            from skyline_tpu_torch.utils.knobs import env_float
            from skyline_tpu_torch.resilience.wal import WalWriter

            wal_kw = dict(
                segment_bytes=resilience.wal_segment_bytes,
                fsync=resilience.wal_fsync,
                telemetry=self.telemetry,
                # live replica tailers pin segment retention (barrier skips
                # segments they haven't consumed); stale acks expire so a
                # dead replica can't pin the log forever
                tailer_ttl_s=env_float("SKYLINE_WAL_TAILER_TTL_S", 600.0),
            )
            # durable cross-process ops journal (RUNBOOK §2s): every
            # control-plane transition this process performs — lease
            # acquire, demotion, quarantine, degraded publish — lands
            # beside the WAL so a post-mortem reconstructs the fleet's
            # causal timeline across processes
            from skyline_tpu_torch.telemetry.opslog import OpsLog, opslog_enabled

            if opslog_enabled():
                self._opslog = OpsLog(self._wal_dir, telemetry=self.telemetry)
                self.telemetry.opslog = self._opslog
                pset = getattr(self.engine, "pset", None)
                if pset is not None and hasattr(pset, "attach_opslog"):
                    pset.attach_opslog(self._opslog)
            if cluster_hosts:
                # write-path HA: this worker is the lease holder; every WAL
                # frame carries its fencing token, and the instant another
                # primary is promoted over us every append is rejected at
                # the WAL layer
                from skyline_tpu_torch.cluster import (
                    FencedWalWriter,
                    LeaseKeeper,
                    LeasePlane,
                )

                self._lease_plane = LeasePlane(self._wal_dir)
                # globally unique holder id: pid alone collides across
                # containers (pid 1) or hosts sharing the WAL dir, and
                # LeasePlane.acquire treats a same-named holder as self — a
                # collision would depose a live primary instead of refusing
                # to start
                self._lease_keeper = LeaseKeeper(
                    self._lease_plane,
                    f"worker-{socket.gethostname()}-{os.getpid()}"
                    f"-{uuid.uuid4().hex[:8]}",
                    telemetry=self.telemetry,
                )
                if self._lease_keeper.acquire() is None:
                    held = self._lease_plane.read_lease()
                    raise ValueError(
                        "write lease is held by "
                        f"{held.holder!r} (epoch {held.epoch}); refusing to "
                        "start a second primary against the same WAL"
                    )
                if self._opslog is not None:
                    self._opslog.record(
                        "lease_acquired",
                        epoch=self._lease_keeper.epoch,
                        fence=self._lease_plane.read_fence(),
                        holder=self._lease_keeper.holder,
                    )
                self._wal = FencedWalWriter(
                    self._wal_dir,
                    self._lease_keeper.epoch,
                    plane=self._lease_plane,
                    opslog=self._opslog,
                    **wal_kw,
                )
                status = getattr(self.telemetry, "cluster", None)
                if status is not None:
                    status.node_id = self._lease_keeper.holder
                    status.role = "primary"
                    status.lease_cb = self._lease_plane.doc
            else:
                self._wal = WalWriter(self._wal_dir, **wal_kw)
            # WAL replication-plane families (RUNBOOK §2s): retained
            # segments plus per-tailer ack age — a growing ack age is a
            # stalled replica still pinning retention
            def _wal_plane_series(wal=self._wal, wal_dir=self._wal_dir):
                from skyline_tpu_torch.resilience.wal import ack_ages_s

                gauges: dict = {}
                st = wal.stats()
                gauges["wal_segments_retained"] = [
                    ((), float(st.get("segments_retained", 0)))
                ]
                ages = ack_ages_s(wal_dir)
                if ages:
                    gauges["wal_tail_ack_age_s"] = [
                        ((("tailer", t),), round(age, 3))
                        for t, age in sorted(ages.items())
                    ]
                return {}, gauges

            self.telemetry.replication.append(_wal_plane_series)
            # chip-local journals for the sharded engine: per-chip flush
            # lineage + merge-time consistency barriers (policy "merge", the
            # default), or checkpoint-time barriers only ("checkpoint");
            # "off" skips the plane entirely
            if self.mesh_chips and not cluster_hosts:
                from skyline_tpu_torch.resilience.chip_wal import ChipWalPlane
                from skyline_tpu_torch.utils.knobs import chip_barrier_policy

                policy = chip_barrier_policy()
                if policy != "off":
                    self._chip_wal = ChipWalPlane(
                        self._wal_dir,
                        self.mesh_chips,
                        segment_bytes=resilience.wal_segment_bytes,
                        fsync=resilience.wal_fsync,
                        telemetry=self.telemetry,
                    )
                    if policy == "merge":
                        self.engine.pset.attach_chip_wal(self._chip_wal)
            # subscribe AFTER the serve restore so re-seating the head never
            # logs a bogus everything-entered delta
            if self._snap_store is not None:
                self._snap_store.on_publish(self._wal_on_publish)
            # divergence repro bundles freeze the live WAL segment slice;
            # without resilience the auditor's wal_dir stays None and
            # bundles simply omit the wal/ directory
            auditor = getattr(self.engine, "auditor", None)
            if auditor is not None:
                auditor.wal_dir = self._wal_dir
            self._wal.append(
                {
                    "type": "start",
                    "data_off": self._data_pos,
                    "query_off": self._query_pos,
                }
            )
            self._wal.flush(force=True)
        # WAL-tailing read replicas (serve/replica.py): each gets its own
        # SnapshotStore + ring + HTTP port, bootstraps from the newest
        # barrier in the WAL and live-tails publish deltas. In-process spawn
        # is the embedded/test mode; production runs them as separate
        # processes (--replica-of) so an engine death leaves them serving.
        self.replicas = []
        if replicas:
            if resilience is None or self._snap_store is None:
                raise ValueError(
                    "replicas require resilience (--checkpoint-dir) and the "
                    "serve plane (--serve)"
                )
            from skyline_tpu_torch.serve.replica import SkylineReplica

            # in-process replicas share the worker's hub for the labeled
            # replica families, the worker's ops journal, and see the
            # primary head directly for replica_lag_versions
            store = self._snap_store
            for i in range(int(replicas)):
                self.replicas.append(
                    SkylineReplica(
                        self._wal_dir,
                        port=0,
                        serve_config=serve_config,
                        replica_id=f"replica-{i}",
                        telemetry=self.telemetry,
                        opslog=self._opslog,
                        primary_head_cb=lambda s=store: s.head_version,
                    )
                )
        self.stats_server = None
        if stats_port is not None:
            from skyline_tpu_torch.metrics.httpstats import StatsServer

            try:
                self.stats_server = StatsServer(
                    self.stats, stats_port, telemetry=self.telemetry
                )
            except OSError as e:
                # observability is optional: a port conflict must not take
                # the worker (and with it the whole deploy stack) down
                print(
                    f"skyline worker: stats port {stats_port} unavailable "
                    f"({e}); continuing without /stats",
                    file=sys.stderr,
                )

    def stats(self) -> dict:
        """Engine counters + worker I/O counters (served by /stats)."""
        out = self.engine.stats()
        out["results_emitted"] = self.results_emitted
        out["phase_breakdown_ms"] = {
            k: round(v["total_ms"], 1) for k, v in self.tracer.report().items()
        }
        # latency distributions (ingest batch / merge / query latency /
        # serve reads): p50/p90/p99 summaries, the dashboard's tiles
        out["latency_ms"] = self.telemetry.latency_snapshot()
        out["device"] = self._device_doc()
        if self.serve_server is not None:
            out["serve"] = self.serve_server.admission.stats()
            out["snapshot_store"] = self.serve_server.store.stats()
        if self._ckpt_mgr is not None:
            res = {
                "checkpoint": self._ckpt_mgr.stats(),
                "data_off": self._data_pos,
                "query_off": self._query_pos,
            }
            if self._wal is not None:
                res["wal"] = self._wal.stats()
            if self._lease_keeper is not None:
                res["lease"] = {
                    "holder": self._lease_keeper.holder,
                    "epoch": self._lease_keeper.epoch,
                    "deposed": self._deposed,
                    **self._lease_plane.doc(),
                }
            if self._chip_wal is not None:
                res["chip_wal"] = self._chip_wal.stats()
            if self._opslog is not None:
                res["ops"] = self._opslog.stats()
            if self._recovered is not None:
                res["recovered"] = self._recovered
            out["resilience"] = res
        return out

    def _device_doc(self) -> dict:
        """Where this process's engine runs (``cuda:<index>`` with the
        card's name, or ``cpu``) and the hand-written kernels it has
        launched so far, by entry (only those launched)."""
        import torch

        from skyline_tpu_torch.ops import dominance_kernels as dk

        dev = torch.device(self.engine.config.device)
        doc = {"name": str(dev), "card": None}
        if dev.type == "cuda":
            index = torch.cuda.current_device() if dev.index is None else dev.index
            doc = {"name": f"cuda:{index}", "card": torch.cuda.get_device_name(index)}
        doc["launches"] = {k: v for k, v in dk.LAUNCHES.items() if v}
        return doc

    def close(self) -> None:
        if getattr(self, "_closed", False):
            return  # idempotent: callers and teardown paths may both close
        self._closed = True
        if self.trace_out:
            try:
                n = self.telemetry.spans.write_chrome(self.trace_out)
                print(
                    f"skyline worker: wrote {n} trace span(s) to "
                    f"{self.trace_out}",
                    file=sys.stderr,
                )
            except OSError as e:
                print(
                    f"skyline worker: --trace-out {self.trace_out} failed: {e}",
                    file=sys.stderr,
                )
        if self.stats_server is not None:
            self.stats_server.close()
        if self.serve_server is not None:
            self.serve_server.close()
        if self._bodystore is not None:
            self._bodystore.close()
        for replica in getattr(self, "replicas", []):
            replica.close()
        if self._wal is not None:
            try:
                self._wal.close()
            except OSError:
                pass
            self._wal = None
        if self._chip_wal is not None:
            try:
                self._chip_wal.close()
            except OSError:
                pass
            self._chip_wal = None
        if self._opslog is not None:
            self._opslog.close()
            self._opslog = None

    # -- crash recovery ----------------------------------------------------

    def _replay(self, meta: dict | None, records: list) -> None:
        """Rebuild the exact pre-crash ingest state: seek the data consumer
        to the checkpoint's committed offset, then re-ingest every WAL
        ``batch`` span (poll exactly ``hi - lo`` records, digest-verified)
        in the same per-call chunks the crashed incarnation used — with the
        restored engine as the base, the post-replay state is byte-identical
        to the uninterrupted run's at the same offset. The query consumer is
        re-seated to the last committed position so triggers that were
        polled but whose step never committed are re-polled (at-least-once
        trigger processing over exactly-once state)."""
        import numpy as np

        from skyline_tpu_torch.resilience.wal import WalReplayError, batch_digest

        data_base = 0
        query_off = None
        if meta is not None:
            extra = meta.get("extra", {})
            data_base = int(extra.get("data_off", 0))
            if "query_off" in extra:
                query_off = int(extra["query_off"])
        for rec in records:
            if rec.get("type") in ("start", "commit", "ckpt") and "query_off" in rec:
                query_off = int(rec["query_off"])
        if meta is None and not records:
            # first boot: anchor the positions (notably the query topic's
            # latest-reset offset, which only exists as a live position now)
            self._data_pos = self._pos_of(self._data)
            self._query_pos = self._pos_of(self._queries)
            return
        self._seek(self._data, data_base)
        pos = data_base
        replayed = 0
        dims = self.engine.config.dims
        for rec in records:
            if rec.get("type") != "batch":
                continue
            lo, hi, digest = int(rec["lo"]), int(rec["hi"]), rec["digest"]
            if hi <= data_base:
                continue  # already folded into the restored checkpoint
            if lo < data_base:
                raise WalReplayError(
                    f"batch span [{lo},{hi}) straddles checkpoint offset "
                    f"{data_base}"
                )
            if lo != pos:
                raise WalReplayError(
                    f"gap in WAL: expected a batch at offset {pos}, "
                    f"found [{lo},{hi})"
                )
            need = hi - lo
            got_total, dropped = 0, 0
            ids_parts: list = []
            val_parts: list = []
            while got_total < need:
                ids, values, dr, got = self._poll_data(need - got_total)
                if got == 0:
                    raise WalReplayError(
                        f"bus ended at offset {pos + got_total} while "
                        f"replaying to {hi}"
                    )
                got_total += got
                dropped += dr
                if ids.shape[0]:
                    ids_parts.append(ids)
                    val_parts.append(values)
            if got_total != need:
                raise WalReplayError(
                    f"replay chunk misalignment: span [{lo},{hi}) yielded "
                    f"{got_total} records"
                )
            ids = (
                np.concatenate(ids_parts)
                if ids_parts else np.empty(0, dtype=np.int64)
            )
            values = (
                np.concatenate(val_parts)
                if val_parts else np.empty((0, dims), dtype=np.float32)
            )
            if batch_digest(ids, values) != digest:
                self.telemetry.inc("wal.digest_mismatch")
                raise WalReplayError(
                    f"replay digest mismatch for span [{lo},{hi}): the bus "
                    "does not hold the bytes the WAL committed"
                )
            self.engine.dropped += dropped
            if ids.shape[0]:
                self.engine.process_records(ids, values)
            pos = hi
            replayed += 1
            self.telemetry.inc("wal.replayed")
        self._data_pos = pos
        if query_off is not None:
            self._seek(self._queries, query_off)
            self._query_pos = query_off
        else:
            self._query_pos = self._pos_of(self._queries)
        if self._recovered is not None:
            self._recovered["replayed_batches"] = replayed
        if replayed or meta is not None:
            print(
                f"skyline worker: recovered — checkpoint "
                f"{'yes' if meta is not None else 'no'}, replayed {replayed} "
                f"WAL batch(es) to data offset {pos}",
                file=sys.stderr,
            )

    @staticmethod
    def _seek(consumer, offset: int) -> None:
        seek = getattr(consumer, "seek", None)
        if seek is None:
            raise RuntimeError(
                "crash safety requires a seekable consumer (MemoryBus or "
                f"kafkalite); {type(consumer).__name__} has no seek()"
            )
        seek(offset)

    @staticmethod
    def _pos_of(consumer) -> int:
        position = getattr(consumer, "position", None)
        return int(position()) if position is not None else 0

    def _restore_serve(self, records: list) -> None:
        """Re-seat the serving plane from the WAL: head points from the last
        checkpoint barrier's inlined snapshot plus every delta after it
        (byte-exact — delta records carry the published row order), the
        delta ring from the same delta records, version numbering
        continuous. Until a live publish lands, reads carry
        ``"restored": true``."""
        import numpy as np

        from skyline_tpu_torch.resilience.wal import rows_from_b64
        from skyline_tpu_torch.serve.deltas import Delta, apply_delta_record

        base = None
        base_idx = -1
        for i, rec in enumerate(records):
            if rec.get("type") == "ckpt" and "snap" in rec:
                base, base_idx = rec["snap"], i
        delta_recs = [
            r for r in records[base_idx + 1 :] if r.get("type") == "delta"
        ]
        if base is None and not delta_recs:
            return
        d = int(base["d"] if base is not None else delta_recs[0]["d"])
        points = (
            rows_from_b64(base["rows"], d)
            if base is not None
            else np.empty((0, d), dtype=np.float32)
        )
        version = int(base["version"]) if base is not None else 0
        watermark = int(base.get("watermark_id", -1)) if base is not None else -1
        event_wm = base.get("event_wm_ms") if base is not None else None
        meta = dict(base.get("meta", {})) if base is not None else {}
        ring_deltas = []
        for rec in delta_recs:
            entered = rows_from_b64(rec["entered"], int(rec["d"]))
            left = rows_from_b64(rec["left"], int(rec["d"]))
            ring_deltas.append(
                Delta(int(rec["from"]), int(rec["to"]), entered, left)
            )
            points = apply_delta_record(points, rec)
            version = int(rec["to"])
            watermark = int(rec.get("wm", watermark))
            event_wm = rec.get("ewm", event_wm)
            meta = dict(rec.get("meta", {}))
        self._snap_store.restore_state(
            points, version, watermark_id=watermark, event_wm_ms=event_wm,
            meta=meta,
        )
        if event_wm is not None:
            # the engine's tracker resumes from the recovered watermark, so
            # a restored run's published watermarks match the uninterrupted
            # run's (monotone-max; never regresses past replayed batches)
            fr = getattr(self.engine, "freshness", None)
            if fr is not None:
                fr.restore(event_wm)
        if self._serve_ring is not None:
            self._serve_ring.seed(ring_deltas, version)
        print(
            f"skyline worker: serving plane restored at version {version} "
            f"({points.shape[0]} point(s), {len(ring_deltas)} delta(s))",
            file=sys.stderr,
        )

    def _wal_on_publish(self, prev, snap) -> None:
        """Persist each published snapshot transition so ``/deltas``
        subscribers survive a restart (the delta ring's WAL shadow)."""
        if self._wal is None:
            return
        from skyline_tpu_torch.serve.deltas import delta_wal_record

        self._wal.append(delta_wal_record(prev, snap))

    def _barrier_record(self) -> dict:
        rec = {
            "type": "ckpt",
            "data_off": self._data_pos,
            "query_off": self._query_pos,
        }
        snap = (
            self._snap_store.latest() if self._snap_store is not None else None
        )
        if snap is not None:
            from skyline_tpu_torch.serve.deltas import snapshot_wal_record

            rec["snap"] = snapshot_wal_record(snap)
        return rec

    def _dispatch_state(self) -> dict:
        """The learned-dispatch extra-meta block: kernel-profiler state
        (hub profiler + the PartitionSet's separate flush-chooser
        profiler) and the dispatch tuner's learned pins/overrides. All
        JSON-safe; absent planes contribute nothing."""
        out: dict = {}
        prof = getattr(self.engine, "profiler", None)
        if prof is not None and hasattr(prof, "export_state"):
            out["profiler"] = prof.export_state()
        pset = getattr(self.engine, "pset", None)
        fprof = getattr(pset, "_flush_prof", None) if pset is not None else None
        if fprof is not None and hasattr(fprof, "export_state"):
            out["flush_profiler"] = fprof.export_state()
        tuner = getattr(self.engine, "tuner", None)
        if tuner is not None:
            out["tuner"] = tuner.state_doc()
        return out

    def _restore_dispatch_state(self, meta: dict | None) -> None:
        """Re-adopt the checkpointed learned-dispatch state into the LIVE
        engine's planes (the restored engine shares the hub profiler the
        checkpoint exported from). Live measurements win over restored
        ones; the tuner re-validates every pin against the cascade
        table's oracle rule."""
        if meta is None:
            return
        extra = meta.get("extra", {})
        prof = getattr(self.engine, "profiler", None)
        if prof is not None and hasattr(prof, "restore_state"):
            prof.restore_state(extra.get("profiler"))
        fstate = extra.get("flush_profiler")
        pset = getattr(self.engine, "pset", None)
        if fstate and pset is not None:
            if getattr(pset, "_flush_prof", None) is None:
                from skyline_tpu_torch.telemetry.profiler import KernelProfiler

                pset._flush_prof = KernelProfiler()
            pset._flush_prof.restore_state(fstate)
        tuner = getattr(self.engine, "tuner", None)
        if tuner is not None:
            tuner.restore(extra.get("tuner"))

    def checkpoint_now(self) -> str | None:
        """Atomic checkpoint + WAL barrier (rotate, log the serve head,
        truncate everything the checkpoint now covers)."""
        if self._ckpt_mgr is None:
            return None
        path = self._ckpt_mgr.save(
            self.engine,
            extra_meta={
                "data_off": self._data_pos,
                "query_off": self._query_pos,
                # learned-dispatch plane: profiler EMAs (hub +
                # the flush chooser's separate per-set profiler) and the
                # tuner's pins/overrides ride the checkpoint so a
                # supervised restart resumes tuned instead of paying the
                # cold exploration flushes again
                **self._dispatch_state(),
            },
        )
        if self._wal is not None:
            self._wal.barrier(self._barrier_record())
        if self._chip_wal is not None:
            # the chip journals rotate with the main WAL (the checkpoint
            # supersedes older segments); the snapshot stays in the main WAL
            # only — chip journals carry positions, not rows
            self._chip_wal.checkpoint_barrier(
                {
                    "type": "ckpt",
                    "data_off": self._data_pos,
                    "query_off": self._query_pos,
                }
            )
        self._last_ckpt_s = time.monotonic()
        self._dirty = False
        return path

    def _maybe_checkpoint(self) -> None:
        if self._ckpt_mgr is None or not self._dirty:
            return
        interval = self.resilience.checkpoint_interval_s
        if interval <= 0:  # shutdown/manual-only mode
            return
        if time.monotonic() - self._last_ckpt_s >= interval:
            self.checkpoint_now()

    def shutdown(self) -> None:
        """Clean exit (SIGTERM/SIGINT): final checkpoint, force-fsync the
        WAL, close every server — a restart from this state replays
        nothing and loses nothing. A DEPOSED worker skips the final
        checkpoint: its WAL barrier would be rejected at the fence anyway,
        and the promoted primary now owns the durable state."""
        if self._ckpt_mgr is not None and self._dirty and not self._deposed:
            self.checkpoint_now()
        if self._wal is not None:
            self._wal.flush(force=True)
        self.close()

    def _maybe_renew_lease(self) -> None:
        """Renew the write lease when due; on deposition (a higher epoch on
        disk, or the fence moved past ours) demote instead of writing on —
        the honest half of the promotion drill."""
        if self._lease_keeper is None or self._deposed:
            return
        from skyline_tpu_torch.cluster import LeaseLostError

        try:
            self._lease_keeper.maybe_renew()
        except LeaseLostError as e:
            if self._opslog is not None:
                self._opslog.record(
                    "lease_renew_lost",
                    epoch=self._lease_keeper.epoch,
                    fence=self._lease_plane.read_fence(),
                    error=str(e),
                )
            self._demote(str(e))

    def _demote(self, reason: str) -> None:
        """This worker lost the write path: stop ingesting, mark the role,
        and let the loop exit WITHOUT a final checkpoint (the fence rejects
        our barrier; the promoted primary owns durability now)."""
        self._deposed = True
        self._stop_requested = True
        self.telemetry.inc("cluster.demotions")
        if self._opslog is not None:
            self._opslog.record(
                "demoted",
                epoch=(
                    self._lease_keeper.epoch
                    if self._lease_keeper is not None else None
                ),
                fence=(
                    self._lease_plane.read_fence()
                    if self._lease_plane is not None else None
                ),
                reason=reason,
            )
        status = getattr(self.telemetry, "cluster", None)
        if status is not None:
            status.role = "deposed"
        print(
            f"skyline worker: write lease lost ({reason}); demoting — "
            "no further WAL appends, no final checkpoint",
            file=sys.stderr,
        )

    def _signal_handler(self, signum, frame) -> None:
        self._stop_requested = True
        print(
            f"skyline worker: signal {signum} received; finishing the "
            "current step then checkpointing",
            file=sys.stderr,
        )

    def _poll_data(self, max_records: int):
        """One data-topic poll as ``(ids, values, dropped, got)`` where
        ``got`` counts raw records received (parsed + dropped — the idle /
        drain-bound signal). Prefers the transport's zero-copy array plane
        (kafkalite ``poll_arrays``: fetch blob -> native RecordBatch walk +
        CSV parse -> numpy, no per-record Python objects); falls back to
        line ``poll()`` + ``parse_tuple_lines`` for transports without it
        (MemoryBus, kafka-python) or when the native library is absent.
        The choice is latched on first resolution."""
        import numpy as np

        dims = self.engine.config.dims
        if self._data_carry is not None:
            # tail of a previous oversized array batch: serve the next
            # max_records micro-batch, preserving step()'s chunk contract
            ids, values = self._data_carry
            head_i, head_v = ids[:max_records], values[:max_records]
            self._data_carry = (
                (ids[max_records:], values[max_records:])
                if ids.shape[0] > max_records
                else None
            )
            return head_i, head_v, 0, head_i.shape[0]
        if self._arrays_plane is not False:
            poll_arrays = getattr(self._data, "poll_arrays", None)
            if poll_arrays is None:
                self._arrays_plane = False
            else:
                res = poll_arrays(dims)
                if res is None:  # native lib unavailable: latch line path
                    self._arrays_plane = False
                else:
                    self._arrays_plane = True
                    ids, values, dropped = res
                    if ids.shape[0] > max_records:
                        # one fetch can carry ~10-100x max_records; keep
                        # engine micro-batches at the documented size
                        self._data_carry = (
                            ids[max_records:],
                            values[max_records:],
                        )
                        ids, values = ids[:max_records], values[:max_records]
                    return ids, values, dropped, ids.shape[0] + dropped
        lines = self._data.poll(max_records)
        if not lines:
            return (
                np.empty(0, dtype=np.int64),
                np.empty((0, dims), dtype=np.float32),
                0,
                0,
            )
        with self.tracer.phase("worker/parse"):
            ids, values, dropped = parse_tuple_lines(lines, dims)
        return ids, values, dropped, len(lines)

    def step(self, max_records: int = 65536) -> int:
        """One poll cycle: snapshot triggers, ingest data, then apply the
        triggers. Returns the number of messages processed (0 == idle).

        Ordering matters: triggers are POLLED before data but APPLIED after
        it, and when a trigger arrived the data topic is DRAINED (polled
        until empty) first. A producer acks its data before sending the
        trigger that refers to it, so a visible trigger implies that data
        is committed at the broker; draining ingests all of it — including
        bursts larger than ``max_records`` — before the trigger runs. The
        reverse order (data first) has a race: the data fetch can complete
        empty just before a produce burst while the trigger fetch ~100 ms
        later sees the burst's trigger, and every still-empty partition
        then answers the query through the empty-partition fast path (the
        reference's :351 heuristic) — a premature empty result for a
        stream that was already produced. The kafkalite fetch is
        synchronous (an empty poll means no committed data at the offset),
        so the drain closes the race fully there; transports whose poll
        can return transiently empty mid-fetch (kafka-python) keep a
        narrowed version of it.

        The drain is BOUNDED at ``max_drain_polls`` re-polls: against a
        producer that sustains the stream indefinitely, an until-empty
        drain would starve the trigger, ``check_timeouts()``, and result
        emission forever. Hitting the bound applies the trigger against
        everything ingested so far — partitions that have data defer via
        the id-barrier until their required ids arrive, so the residual
        exposure is only the reference's own empty-partition fast-path
        heuristic (FlinkSkyline.java:351) for a partition that got nothing
        in ``max_drain_polls * max_records`` drained rows.
        """
        fault_point("kafka.poll")
        self._maybe_renew_lease()
        if self._deposed:
            return 0  # a deposed primary must not ingest another frame
        with self.tracer.phase("worker/poll"):
            triggers = self._queries.poll(max_records)
            ids, values, dropped, got = self._poll_data(max_records)
        self._query_pos += len(triggers)
        total_lines = 0
        drains = 0
        while got:
            if self._wal is not None:
                # the span is logged BEFORE ingest: a crash inside the merge
                # replays it; in-memory effects of the crashed attempt are
                # discarded wholesale, so state stays exactly-once
                self._wal.append(
                    {
                        "type": "batch",
                        "lo": self._data_pos,
                        "hi": self._data_pos + got,
                        "digest": batch_digest(ids, values),
                    }
                )
            self._data_pos += got
            total_lines += got
            self.engine.dropped += dropped
            if ids.shape[0]:
                with self.tracer.phase("worker/ingest"):
                    # wire tuples carry no producer timestamps, so the poll
                    # wall time is the batch's event-time stamp — a
                    # processing-time proxy the freshness lineage documents
                    # as such (RUNBOOK §2j)
                    self.engine.process_records(
                        ids, values, event_ms=time.time() * 1000.0
                    )
            if not triggers:
                break  # no trigger pending: one poll per cycle as before
            if drains >= self.max_drain_polls:
                # bounded drain: guarantee trigger/timeout progress. With an
                # immediate (required=0) trigger pending this means the query
                # answers against a TRUNCATED ingest — say so loudly, and
                # point at the knob (--max-drain-polls) that raises the bound
                print(
                    f"skyline worker: drain bound hit after {drains + 1} polls "
                    f"({total_lines} rows) with {len(triggers)} trigger(s) "
                    "pending — the stream may exceed "
                    "max_drain_polls * max_records; queries with an id "
                    "barrier defer safely, but an immediate (required=0) "
                    "trigger will answer against the rows drained so far. "
                    "Raise --max-drain-polls for larger finite streams.",
                    file=sys.stderr,
                )
                break
            drains += 1
            with self.tracer.phase("worker/poll"):
                ids, values, dropped, got = self._poll_data(max_records)
        with self.tracer.phase("worker/query"):
            for t in triggers:
                self.engine.process_trigger(t)
            if self._serve_bridge is not None:
                # forced consistency merges from POST /query run on this
                # thread, after bus triggers — the engine stays single-owner
                self._inject_serve_queries()
            self.engine.check_timeouts()
        results = self.engine.poll_results()
        if self._serve_bridge is not None:
            # serve-plane results return to their HTTP waiters, not the bus
            results = self._serve_bridge.fulfill(results)
        for result in results:
            self.bus.produce(self.output_topic, format_result(result))
            self.results_emitted += 1
            self._report_phases()
        work = total_lines + len(triggers)
        if work and self._wal is not None:
            # the step's durability point: positions commit (and, under the
            # batch fsync policy, everything above reaches the platter)
            self._wal.append(
                {
                    "type": "commit",
                    "data_off": self._data_pos,
                    "query_off": self._query_pos,
                }
            )
            self._wal.flush()
        if work:
            self._dirty = True
        self._maybe_checkpoint()
        return work

    def _inject_serve_queries(self) -> None:
        """Run the serve-plane's queued forced merges; with
        ``jax_profile_dir`` set (the reference's name), wrap the injection
        in ``torch.profiler`` and write its Chrome trace to that directory,
        so exactly one POST /query's device work lands in a profile."""
        if self._jax_profile_dir and self._serve_bridge.pending_injections:
            try:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if device_type(self.engine.config.device) == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.__enter__()
            except Exception as e:  # profiling is opt-in observability:
                # never let a profiler failure shed the query itself
                print(
                    f"skyline worker: torch.profiler failed to start ({e}); "
                    "running injection unprofiled",
                    file=sys.stderr,
                )
            else:
                try:
                    self._serve_bridge.inject(self.engine)
                finally:
                    self._export_profile(prof)
                return
        self._serve_bridge.inject(self.engine)

    def _export_profile(self, prof) -> None:
        self._profiles_written += 1
        path = os.path.join(
            self._jax_profile_dir,
            f"inject-{os.getpid()}-{self._profiles_written}.trace.json",
        )
        try:
            prof.__exit__(None, None, None)
            os.makedirs(self._jax_profile_dir, exist_ok=True)
            prof.export_chrome_trace(path)
        except Exception as e:
            print(
                f"skyline worker: writing the profile {path} failed ({e})",
                file=sys.stderr,
            )

    def _report_phases(self) -> None:
        """Per-result stderr breakdown: the DELTA of each phase since the
        previous report, so each line attributes only the wall spent since
        the last answered query (worker/* rows are the loop's own
        accounting; engine rows — partition_ids/route/flush/query — nest
        inside them). Rate-limited to one line per second so per-slide
        sliding emissions don't flood stderr; /stats always serves the
        cumulative totals."""
        now = time.monotonic()
        if now - self._last_phase_report_s < 1.0:
            return
        self._last_phase_report_s = now
        totals = {
            k: v["total_ms"] for k, v in self.tracer.report().items()
        }
        delta = {
            k: round(ms - self._phase_snapshot_ms.get(k, 0.0))
            for k, ms in totals.items()
            if ms - self._phase_snapshot_ms.get(k, 0.0) >= 0.5
        }
        self._phase_snapshot_ms = totals
        if delta:
            print(f"skyline worker: phase_breakdown_ms={delta}",
                  file=sys.stderr, flush=True)

    def run_forever(
        self,
        idle_sleep_s: float = 0.01,
        stop_after_idle_s: float | None = None,
        install_signal_handlers: bool | None = None,
    ):
        """Poll loop; optionally exits after ``stop_after_idle_s`` of silence.

        With crash safety on (and by default only then), SIGTERM/SIGINT are
        handled gracefully: the current step finishes, a final checkpoint +
        WAL fsync land, the servers close, and the loop returns — a restart
        from that state replays nothing and loses nothing."""
        if install_signal_handlers is None:
            install_signal_handlers = self.resilience is not None
        if install_signal_handlers:
            import signal

            try:
                for sig in (signal.SIGTERM, signal.SIGINT):
                    signal.signal(sig, self._signal_handler)
            except ValueError:
                pass  # not the main thread (embedded runs): flag-only stop
        idle_since = None
        while True:
            if self._stop_requested:
                self.shutdown()
                return
            try:
                n = self.step()
            except Exception as e:
                from skyline_tpu_torch.cluster import WalFencedError

                if not isinstance(e, WalFencedError):
                    raise
                # an append raced the promotion past the renew check: the
                # frame was rejected at the WAL layer (counted, loud) —
                # demote and exit without the final checkpoint
                self._demote(str(e))
                continue
            if n == 0:
                self._maybe_renew_lease()
                now = time.time()
                if idle_since is None:
                    idle_since = now
                elif stop_after_idle_s is not None and now - idle_since > stop_after_idle_s:
                    return
                # idle ticks drive the correctness canaries: with no
                # organic traffic to audit, the synthetic known-answer
                # micro-states keep every merge path under verification
                auditor = getattr(self.engine, "auditor", None)
                if auditor is not None:
                    auditor.maybe_canary()
                # idle ticks also drive the chip-health plane: staleness
                # scoring plus failover of any chip that quarantined since
                # the last merge — recovery must not wait for traffic
                health = getattr(self.engine, "health", None)
                if health is not None:
                    health.tick()
                    pset = getattr(self.engine, "pset", None)
                    if pset is not None and hasattr(pset, "maybe_failover"):
                        pset.maybe_failover()
                # idle ticks drive the dispatch tuner too: a quiet stream
                # still closes workload epochs, and the controller must
                # converge (or revert on SLO burn) without a query
                tuner = getattr(self.engine, "tuner", None)
                if tuner is not None:
                    tuner.maybe_tune()
                time.sleep(idle_sleep_s)
            else:
                idle_since = None


def build_worker(cfg, bus=None) -> SkylineWorker:
    """The worker a ``JobConfig`` describes, as ``main`` builds it: over
    ``bus`` (by default a ``KafkaBus`` on ``cfg.bootstrap``), the engine on
    ``cfg.device`` (the card unless ``--device cpu``; no card raises)."""
    from skyline_tpu_torch.bridge.kafka import KafkaBus

    if cfg.replica_of:
        raise ValueError(
            "--replica-of runs a standalone read replica, not a worker: "
            "use main() (or serve.replica.run_replica)"
        )
    # no compile cache to enable: the CUDA kernels and the native helper
    # build once into skyline_tpu_torch/_build/ and every restart loads them
    engine_cfg = cfg.engine_config()  # resolves the device: no card raises
    if bus is None:
        bus = KafkaBus(cfg.bootstrap)
    return SkylineWorker(
        bus,
        engine_cfg,
        input_topic=cfg.input_topic,
        query_topic=cfg.query_topic,
        output_topic=cfg.output_topic,
        mesh=cfg.build_mesh(),
        mesh_chips=cfg.mesh_chips,
        cluster_hosts=cfg.cluster_hosts,
        stats_port=cfg.stats_port if cfg.stats_port > 0 else None,
        window_size=cfg.window_size,
        slide=cfg.slide,
        emit_per_slide=cfg.emit_per_slide,
        max_drain_polls=cfg.max_drain_polls,
        serve_port=cfg.serve_port if cfg.serve_port >= 0 else None,
        serve_config=cfg.serve_config() if cfg.serve_port >= 0 else None,
        trace_ring=cfg.trace_ring,
        trace_out=cfg.trace_out or None,
        jax_profile_dir=cfg.jax_profile_dir or None,
        resilience=cfg.resilience_config(),
        replicas=cfg.replicas,
    )


def main(argv=None):
    """CLI: run the worker against a Kafka broker with reference-style flags
    (the `flink run` equivalent of README_Ubuntu_Setup.md's job launch)."""
    from skyline_tpu_torch.utils.config import parse_job_args

    cfg = parse_job_args(argv)
    if cfg.replica_of:
        # standalone read replica: no broker, no engine, no device — bootstrap
        # from the primary's WAL directory and tail it until signalled
        from skyline_tpu_torch.serve.replica import run_replica

        return run_replica(
            cfg.replica_of,
            port=cfg.serve_port if cfg.serve_port >= 0 else 0,
            serve_config=cfg.serve_config(),
        )
    worker = build_worker(cfg)
    print(
        f"skyline worker: algo={cfg.algo} partitions={worker.engine.config.num_partitions} "
        f"dims={cfg.dims} broker={cfg.bootstrap} device={cfg.device}"
        f" mesh={cfg.mesh or 'off'} chips={cfg.mesh_chips or 'off'}"
        f" cluster={cfg.cluster_hosts or 'off'}"
        + (f" stats=:{worker.stats_server.port}" if worker.stats_server else "")
        + (f" serve=:{worker.serve_server.port}" if worker.serve_server else "")
        + (f" checkpoints={cfg.checkpoint_dir}" if cfg.checkpoint_dir else "")
        + (
            " replicas=" + ",".join(f":{r.port}" for r in worker.replicas)
            if worker.replicas
            else ""
        ),
        file=sys.stderr,
    )
    try:
        worker.run_forever()
    finally:
        worker.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The streaming skyline engine: partition routing, query barrier, global merge.

Counterpart of ``skyline_tpu/stream/engine.py``. One object replaces the
reference's Flink job graph (FlinkSkyline.java:61-186): the ``keyBy``
shuffle becomes vectorized host-side partition-id routing;
``SkylineLocalProcessor`` becomes ``PartitionSet`` (all logical partitions
stacked on the device) addressed through ``PartitionView`` facades; the
query broadcast becomes a loop over partitions; and
``GlobalSkylineAggregator`` becomes a device-side union skyline with the
same countdown-latch semantics, timing decomposition and optimality metric.

Ingest: with device ingest (the default on a card for the lazy and overlap
policies, as the reference defaults to it on its accelerator) raw batches
are uploaded and routed, sorted and sliced on the device
(``stream/device_window.py``), and the host barrier bookkeeping syncs only
when a query needs it; with host ingest (always under the incremental
policy) ``partition_ids_np`` routes each batch on the host. After routing,
``PartitionSet.maybe_flush`` runs the policy's automatic flush.

Record-id barrier semantics: a trigger ``"qid,N"`` executes on a partition
only once that partition has seen a record id >= N — or immediately if the
partition has never seen data (``max_seen_id == -1``, FlinkSkyline.java:351).
Pending triggers are re-evaluated whenever new data reaches the partition.

Every flush policy of the reference runs (``"incremental"``, the default,
``"lazy"`` and ``"overlap"``), and the global merge is the reference's
default plane (``PartitionSet.global_merge_launch``: the epoch-keyed cache,
delta and tree merges). With ``SKYLINE_QUERY_OVERLAP`` on (the default) a
trigger whose barriers all pass launches the merge and returns; the result
is harvested at the next ``process_records`` once its stats have landed,
or, waiting for them, at the next trigger or ``poll_results`` — results
stay in trigger order, with at most one merge in flight. Flushes run the
reference's flush dominance cascade (the grid prefilter and, on a card by
default, the mixed-precision passes; ``PartitionSet.flush_cascade_stats``).
The query watchdog is the reference's: with ``query_timeout_ms`` set,
``check_timeouts`` finalises an overdue query as a partial result. With
``grid_prefilter`` the reference's midpoint prefilter drops a row past the
domain's midpoint in every coordinate once a witness at or below it has
been seen (host ingest only).

The observability plane is the reference's. Without a hub the engine still
keeps the event-time freshness lineage, a kernel profiler (shared with the
mask dispatch) and the workload characterizer, each behind its knob
(``utils/knobs.py``); ``stats()`` reports them with the engine's counters
and the merge plane's and flush cascade's blocks. With a
``telemetry.Telemetry`` hub it also records latency histograms, spans and
counters, a trace id per query, the flight recorder's decisions, one
EXPLAIN plan per query and the dispatch tuner's epochs. The answers are the
same bytes with the plane or without it.

The serving plane: ``attach_snapshots(store)`` (a
``serve.snapshot.SnapshotStore``) publishes every complete answer as an
immutable versioned snapshot, keyed by the partition-epoch key on the
device path so a repeated trigger over unchanged state dedupes; with a
store attached the answers materialise their points even when
``emit_skyline_points`` is off. With a hub and ``SKYLINE_AUDIT`` on, the
``audit.Auditor`` shadow-checks the published snapshot against the host
oracle at the tail of each emission (``SKYLINE_AUDIT_SAMPLE`` of them).
An engine without a store does none of this.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from skyline_tpu_torch.bridge.wire import parse_trigger
from skyline_tpu_torch.metrics.tracing import NULL_TRACER
from skyline_tpu_torch.ops.dispatch import skyline_keep_np
from skyline_tpu_torch.parallel.partitioners import partition_ids_np
from skyline_tpu_torch.stream.batched import PartitionSet, PartitionView
from skyline_tpu_torch.stream.window import DEFAULT_BUFFER_SIZE
from skyline_tpu_torch.utils.devices import resolve_device
from skyline_tpu_torch.utils import knobs


@dataclass
class EngineConfig:
    """Engine flags, defaults matching the reference job's
    (FlinkSkyline.java:62-76): parallelism=4 → numPartitions=8, algo
    mr-angle, domain 1000, dims 2, and the reference engine's incremental
    flush policy."""

    parallelism: int = 4
    algo: str = "mr-angle"
    domain_max: float = 1000.0
    dims: int = 2
    buffer_size: int = DEFAULT_BUFFER_SIZE
    emit_skyline_points: bool = False
    # failure detection: a query whose barrier never clears on some partition
    # finalizes as a PARTIAL result after this long (0 = wait forever, the
    # reference job's behaviour)
    query_timeout_ms: float = 0.0
    # the reference job's GridDominanceFilter (FlinkSkyline.java:717-734),
    # safe: a tuple with every coordinate >= domain/2 (and one >) is dropped
    # before routing, but only once a witness with every coordinate <=
    # domain/2 has been seen (it dominates or equals the midpoint, which
    # dominates the dropped tuple). Barriers advance with the dropped ids.
    grid_prefilter: bool = False
    # pre-size per-partition skyline buffers (0 = grow on demand)
    initial_capacity: int = 0
    # "incremental": merge pending rows at the buffer_size cadence (the
    # reference's processBuffer model); "lazy": accumulate and compute at
    # query time via append-only SFS rounds; "overlap": the lazy machinery
    # flushed without count syncs every ``overlap_rows`` rows. Identical
    # results all three ways.
    flush_policy: str = "incremental"
    # rows accumulated between automatic flushes under flush_policy="overlap"
    overlap_rows: int = 262144
    # expected rows per window (0 = unknown): pre-sizes the device-ingest
    # window buffer
    window_capacity: int = 0
    # "device": routing, sort and block slicing on the device
    # (stream/device_window.py), lazy/overlap without grid_prefilter only;
    # "host": numpy routing in process_records; "auto": device on a card for
    # lazy/overlap without grid_prefilter, else host
    ingest: str = "auto"
    # where the state lives and the kernels run: "cuda" unless the caller
    # asks for "cpu" (the plain PyTorch path)
    device: str = "cuda"

    def __post_init__(self):
        resolve_device(self.device)

    @property
    def num_partitions(self) -> int:
        # 2x over-partitioning for skew tolerance (FlinkSkyline.java:74-76)
        return 2 * self.parallelism


def echo_record_count(payload: str):
    """The reference echoes the payload's second field as record_count
    (FlinkSkyline.java:640-642); a count-less payload gives the quoted
    string ``"unknown"`` instead of the reference's invalid JSON."""
    parts = payload.split(",")
    if len(parts) > 1 and parts[1].strip().lstrip("-").isdigit():
        return int(parts[1])
    return "unknown"


def optimality_mean(survivors, sizes, num_partitions: int) -> float:
    """Mean over ALL partitions of survivors_i / localSize_i, empty
    partitions contributing 0 (FlinkSkyline.java:592-608)."""
    ratios = 0.0
    for surv, size in zip(survivors, sizes):
        if size > 0:
            ratios += surv / size
    return ratios / num_partitions


@dataclass
class _QueryState:
    """Aggregator state for one in-flight query (FlinkSkyline.java:490-495)."""

    qid: str
    payload: str
    required: int
    dispatch_ms: float
    partials: dict = field(default_factory=dict)  # pid -> (k, d) local skyline
    local_sizes: dict = field(default_factory=dict)
    start_times: dict = field(default_factory=dict)
    cpu_ms: dict = field(default_factory=dict)
    last_arrival_ms: float = 0.0
    # telemetry: trace id minted at trigger ingestion + the perf clock at
    # dispatch, so the end-to-end "query" span is recordable
    trace_id: str | None = None
    span_t0_ns: int = 0
    # the EXPLAIN plan minted beside the trace id, annotated along the merge
    # path and finalized at result emission
    plan: object | None = None


class SkylineEngine:
    """Single-device streaming engine over ``num_partitions`` logical
    partitions.

    Usage: ``process_records`` / ``process_trigger`` as data and control
    planes; completed query results accumulate and are drained with
    ``poll_results`` (each result is a dict with the reference's JSON
    fields); ``stats()`` polls the engine's counters. ``last_flush_ms`` /
    ``last_merge_ms`` hold the host walls of the last device answer's flush
    and global merge; the device is synchronised between the two, so each
    wall holds its own kernels. An overlapped merge's wall is its launch
    plus its harvest."""

    def __init__(self, config: EngineConfig, tracer=None, telemetry=None):
        """``tracer``: an optional ``metrics.tracing.Tracer`` timing the
        reference's phases (routing, flush kernels, transfers, the global
        merge); ``None`` costs nothing.

        ``telemetry``: an optional ``telemetry.Telemetry`` hub — latency
        histograms (ingest batch, global merge, query latency), a
        ``trace_id`` per query, spans, counters, the flight recorder,
        EXPLAIN plans and the dispatch tuner; ``None`` records none of
        these."""
        self.config = config
        self.device = resolve_device(config.device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.telemetry = telemetry
        # the serving plane's snapshot store (attach_snapshots)
        self.snapshots = None
        # device ingest needs the lazy or overlap policy (the engine is
        # single-device) and no grid prefilter, which reads raw host values
        device_ok = config.flush_policy in ("lazy", "overlap") and not config.grid_prefilter
        if config.ingest == "device":
            if not device_ok:
                raise ValueError(
                    "ingest='device' requires single-device lazy/overlap "
                    "without grid_prefilter"
                )
            use_device = True
        elif config.ingest == "auto":
            use_device = device_ok and self.device.type == "cuda"
        elif config.ingest == "host":
            use_device = False
        else:
            raise ValueError(f"unknown ingest mode {config.ingest!r}")
        self._init_planes(config, telemetry)
        self.pset = PartitionSet(
            config.num_partitions,
            config.dims,
            config.buffer_size,
            initial_capacity=config.initial_capacity,
            flush_policy=config.flush_policy,
            device=self.device,
            route=(config.algo, config.domain_max) if use_device else None,
            window_capacity=config.window_capacity,
            overlap_rows=config.overlap_rows,
            tracer=self.tracer,
            counters=telemetry.counters if telemetry is not None else None,
            profiler=self.profiler,
            flight=telemetry.flight if telemetry is not None else None,
        )
        self.partitions = [
            PartitionView(self.pset, i) for i in range(config.num_partitions)
        ]
        self._pending_queries: dict[int, list[_QueryState]] = {
            i: [] for i in range(config.num_partitions)
        }
        # every query dispatched and not yet emitted, by payload
        self._inflight: dict[str, _QueryState] = {}
        self._results: list[dict] = []
        self.records_in = 0
        self.dropped = 0
        self.prefiltered = 0
        self._midpoint_witness = False  # the grid prefilter's safety latch
        self.last_flush_ms: float | None = None
        self.last_merge_ms: float | None = None
        # the overlapped merge in flight: (query, handle, now_ms, flush wall
        # ms, launch ms)
        self._inflight_merge: tuple | None = None

    def _init_planes(self, config: EngineConfig, telemetry) -> None:
        """The observability planes, as the reference's engine builds them:
        host-side bookkeeping only. Without a hub the freshness lineage, a
        private kernel profiler and the workload characterizer still run
        (each behind its knob); EXPLAIN, the audit counters and the tuner
        need a hub. The partition set, built after, takes the profiler and
        the flight recorder (``PartitionSet.attach_observability``)."""
        from skyline_tpu_torch.telemetry import (
            FreshnessTracker,
            KernelProfiler,
            WorkloadCharacterizer,
        )

        self.freshness = FreshnessTracker(telemetry) if knobs.freshness_enabled() else None
        if knobs.kernel_profile_enabled():
            self.profiler = telemetry.profiler if telemetry is not None else KernelProfiler()
        else:
            self.profiler = None
        # EXPLAIN: one QueryPlan per trigger into the hub's ring. The marks
        # anchor the per-query attribution windows: cascade counters and
        # kernel dispatches since the previous plan finalized belong to the
        # next query's plan.
        self._explain_on = knobs.explain_enabled() and telemetry is not None
        self._explain_cascade_mark: dict = {}
        self._explain_kernel_mark: dict = {}
        if self._explain_on:
            # register the series before the first query
            telemetry.inc("explain.records", 0)
        # the audit plane: sampled shadow verification of published
        # snapshots against the host oracle, plus the canary sweep the
        # engine's owner ticks from its idle loop. Post-publish, host-side.
        self.auditor = None
        if telemetry is not None and knobs.audit_enabled():
            from skyline_tpu_torch.audit import Auditor

            self.auditor = Auditor(self, telemetry)
            telemetry.inc("audit.checks", 0)
            telemetry.inc("audit.divergence", 0)
        # the workload characterizer, fed from the ingest path
        self.workload = None
        if knobs.workload_enabled():
            self.workload = WorkloadCharacterizer(
                config.dims,
                counters=telemetry.counters if telemetry is not None else None,
                flight=telemetry.flight if telemetry is not None else None,
            )
            if telemetry is not None:
                telemetry.workload = self.workload
        # the dispatch tuner: ticked from the query path, passive until a
        # workload epoch has closed
        self.tuner = None
        if telemetry is not None and knobs.tuner_enabled():
            from skyline_tpu_torch.telemetry.tuner import DispatchTuner

            self.tuner = DispatchTuner(
                telemetry=telemetry,
                workload=self.workload,
                profiler=self.profiler,
                flush_profiler=lambda: getattr(self.pset, "_flush_prof", None),
            )
            telemetry.tuner = self.tuner

    def attach_snapshots(self, store) -> None:
        """Publish completed global skylines to ``store`` (a
        ``serve.snapshot.SnapshotStore``). Costs nothing until attached;
        once attached, query answers materialize their points even when
        ``emit_skyline_points`` is off (the snapshot IS the read path)."""
        self.snapshots = store

    # -- data plane -------------------------------------------------------

    def process_records(
        self,
        ids: np.ndarray,
        values: np.ndarray,
        now_ms: float | None = None,
        event_ms=None,
    ) -> None:
        """Route a micro-batch of records to partitions and advance barriers.

        ids: (N,) int64 global record ids; values: (N, d) float32.
        ``event_ms`` (optional): the batch's producer event time for the
        freshness lineage, a scalar or a (min, max) pair in epoch ms; the
        wall clock when absent."""
        tel = self.telemetry
        if tel is None:
            return self._process_records(ids, values, now_ms, event_ms)
        t0 = time.perf_counter_ns()
        try:
            return self._process_records(ids, values, now_ms, event_ms)
        finally:
            end = time.perf_counter_ns()
            tel.histogram("ingest_batch_ms").observe((end - t0) / 1e6)
            tel.spans.record("ingest", t0, end, args={"rows": int(values.shape[0])})

    def _process_records(self, ids, values, now_ms=None, event_ms=None) -> None:
        if values.shape[0] == 0:
            return
        if now_ms is None:
            now_ms = time.time() * 1000.0
        cfg = self.config
        self.records_in += values.shape[0]
        if self.workload is not None:
            # before the ingest paths fork, so every path sees the same raw
            # stream; a bounded stride sample inside
            self.workload.observe(values)
        ev_hi = None
        if self.freshness is not None:
            # absent stamps fall back to the wall clock, not the caller's
            # now_ms (an injected clock would poison the lag histograms)
            if event_ms is None:
                ev_lo = ev_hi = time.time() * 1000.0
            elif isinstance(event_ms, (tuple, list)):
                ev_lo, ev_hi = float(event_ms[0]), float(event_ms[1])
            else:
                ev_lo = ev_hi = float(event_ms)
            self.freshness.on_ingest(ev_lo, ev_hi)
        if self.snapshots is not None:
            # the latest snapshot is now one ingest advance behind
            self.snapshots.note_ingest(int(ids.max()), event_ms=ev_hi)
        if self.pset.device_ingest:
            # routing and barrier stats on the device; the host bookkeeping
            # syncs only when a pending query needs its barrier re-evaluated
            with self.tracer.phase("ingest/devroute"):
                self.pset.ingest_chunk(ids, values, now_ms)
            if any(self._pending_queries.values()):
                self.pset.sync_ingest_bookkeeping()
                for p in range(cfg.num_partitions):
                    now_ms = self._recheck_pending(p, now_ms)
            self.pset.maybe_flush()
            self._note_flush()
            self._harvest_inflight(block=False)
            return
        with self.tracer.phase("partition_ids"):
            pids = partition_ids_np(values, cfg.algo, cfg.num_partitions, cfg.domain_max)
        doomed_pids = None
        if cfg.grid_prefilter:
            doomed_pids = self._midpoint_prefilter(values, ids, pids, now_ms)
        # group rows by partition with one argsort (the keyBy shuffle; rows
        # the prefilter dropped carry partition P and sort past the rest).
        # now_ms advances through the loop: an answer's snapshot flush takes
        # real time, and later answers in the SAME call must see a clock past
        # it or the timing decomposition goes impossible (local > total)
        with self.tracer.phase("route"):
            order = np.argsort(pids, kind="stable")
            sorted_pids = pids[order]
            sorted_vals = values[order]
            sorted_ids = ids[order]
            bounds = np.searchsorted(sorted_pids, np.arange(cfg.num_partitions + 1))
            for p in range(cfg.num_partitions):
                lo, hi = bounds[p], bounds[p + 1]
                if lo == hi:
                    continue
                self.partitions[p].add_batch(
                    sorted_vals[lo:hi], int(sorted_ids[lo:hi].max()), now_ms
                )
                now_ms = self._recheck_pending(p, now_ms)
        # the policy's automatic flush: one batched merge of every
        # partition's pending rows (incremental), or an overlap flush
        self.pset.maybe_flush()
        self._note_flush()
        if doomed_pids is not None:
            # partitions whose barrier advanced only through dropped rows
            # recheck their pending queries after the kept rows have routed
            for p in doomed_pids:
                now_ms = self._recheck_pending(int(p), now_ms)
        # an overlapped merge whose stats landed is harvested here; one still
        # running stays in flight (ingest never waits for it)
        self._harvest_inflight(block=False)

    def _midpoint_prefilter(self, values, ids, pids, now_ms):
        """The grid prefilter: once a row with every coordinate <= domain/2
        has been seen, drop rows with every coordinate >= domain/2 and one
        >. Each partition's barrier advances with its dropped rows' ids
        BEFORE filtering, so a dropped id still reaches the barrier. A
        dropped row's partition id becomes P in ``pids`` (in place), so the
        routing's stable sort puts it past every partition's rows. Returns
        the partitions reached by dropped rows (None when nothing dropped).
        The reference's row tests (``all``/``any`` over axis 1), one column
        at a time."""
        mid = self.config.domain_max / 2.0
        cols = [values[:, k] for k in range(values.shape[1])]
        if not self._midpoint_witness:
            witness = cols[0] <= mid
            for c in cols[1:]:
                witness &= c <= mid
            self._midpoint_witness = bool(witness.any())
            if not self._midpoint_witness:
                return None
        doomed, over = cols[0] >= mid, cols[0] > mid
        for c in cols[1:]:
            doomed &= c >= mid
            over |= c > mid
        doomed &= over
        if not doomed.any():
            return None
        doomed_pids = np.unique(pids[doomed])
        for p in doomed_pids:
            part = self.partitions[p]
            mx = int(ids[doomed & (pids == p)].max())
            if part.start_time_ms is None:
                part.start_time_ms = now_ms
            part.max_seen_id = max(part.max_seen_id, mx)
        self.prefiltered += int(doomed.sum())
        pids[doomed] = self.config.num_partitions
        return doomed_pids

    def _note_flush(self) -> None:
        """Advance the freshness flush stage once no ingested row is still
        pending: lazy and overlap flushes may leave rows buffered past a
        ``maybe_flush``, and their batches keep aging until a flush takes
        them."""
        if self.freshness is not None and self.pset.pending_rows_total == 0:
            self.freshness.on_flush()

    # -- control plane ----------------------------------------------------

    def process_trigger(self, payload: str, now_ms: float | None = None) -> None:
        """Broadcast a query trigger to every partition (the flatMap fan-out,
        FlinkSkyline.java:145-157).

        Fast path: when every partition's barrier passes at dispatch (a
        trigger after its window is ingested), the local snapshots and the
        global merge run on the device with only per-partition counts (and
        the points, when asked for) coming back to the host."""
        if now_ms is None:
            now_ms = time.time() * 1000.0
        # an earlier overlapped merge lands before a new query dispatches:
        # results stay in trigger order, at most one merge in flight
        self._harvest_inflight()
        # the barrier checks below read per-partition max ids
        self.pset.sync_ingest_bookkeeping()
        qid, required = parse_trigger(payload)
        q = _QueryState(qid=qid, payload=payload, required=required, dispatch_ms=now_ms)
        flight = None
        if self.telemetry is not None:
            q.trace_id = self.telemetry.mint_trace_id()
            q.span_t0_ns = time.perf_counter_ns()
            # this trigger's flush and launch decisions carry its trace id
            flight = self.telemetry.flight
            flight.set_trace(q.trace_id)
        if self._explain_on:
            from skyline_tpu_torch.telemetry.explain import QueryPlan

            q.plan = QueryPlan(q.trace_id, qid)
            # parked for global_merge_launch to claim onto its handle
            self.pset.set_explain(q.plan)
        self._inflight[payload] = q
        try:
            if all(
                part.max_seen_id >= required or part.max_seen_id == -1
                for part in self.partitions
            ):
                self._answer_all_device(q, now_ms)
                return
            for p in range(self.config.num_partitions):
                part = self.partitions[p]
                if part.max_seen_id >= required or part.max_seen_id == -1:
                    now_ms = self._answer(p, q, now_ms)
                else:
                    self._pending_queries[p].append(q)
        finally:
            if flight is not None:
                flight.set_trace(None)
            # a plan no merge claimed (host path, pending barrier) must not
            # leak onto a later query's merge
            self.pset.set_explain(None)

    def _recheck_pending(self, p: int, now_ms: float) -> float:
        """Returns the advanced clock (answers add their snapshot wall so
        the caller's subsequent answers don't time-travel before them)."""
        part = self.partitions[p]
        still = []
        for q in self._pending_queries[p]:
            if part.max_seen_id >= q.required:
                now_ms = self._answer(p, q, now_ms)
            else:
                still.append(q)
        self._pending_queries[p] = still
        return now_ms

    # -- local answer + global aggregation --------------------------------

    def _answer(self, p: int, q: _QueryState, now_ms: float) -> float:
        """Partition p finalizes its local skyline for query q
        (processQuery, FlinkSkyline.java:367-403). The snapshot's own wall
        advances the arrival clock — the reference stamps arrival when the
        partial reaches the aggregator, AFTER processQuery's flush."""
        part = self.partitions[p]
        t0 = time.perf_counter_ns()
        local = part.snapshot()
        self._note_flush()
        t1 = time.perf_counter_ns()
        if self.telemetry is not None:
            self.telemetry.spans.record(
                "local", t0, t1, trace_id=q.trace_id, tid=p,
                args={"rows": int(local.shape[0])},
            )
        arrival_ms = now_ms + (t1 - t0) / 1e6
        start = part.start_time_ms if part.start_time_ms is not None else now_ms
        q.partials[p] = local
        q.local_sizes[p] = local.shape[0]
        q.start_times[p] = start
        q.cpu_ms[p] = part.processing_ms
        q.last_arrival_ms = max(q.last_arrival_ms, arrival_ms)
        if len(q.partials) >= self.config.num_partitions:
            self._finalize(q, max(arrival_ms, q.last_arrival_ms))
        return arrival_ms

    def _finalize(
        self, q: _QueryState, now_ms: float, partial_missing: list[int] | None = None
    ) -> None:
        """All partitions reported (or the watchdog gave up on
        ``partial_missing``): global merge of the host partials + metrics +
        result emission (GlobalSkylineAggregator final block,
        FlinkSkyline.java:573-657). ``now_ms`` continues the caller's clock;
        the merge's own wall is added on top."""
        merge_t0 = time.perf_counter_ns()
        with self.tracer.phase("global_merge"):
            pids_order = sorted(q.partials)
            origins = np.concatenate(
                [np.full(q.partials[p].shape[0], p, dtype=np.int32) for p in pids_order]
            )
            union = (
                np.concatenate([q.partials[p] for p in pids_order], axis=0)
                if origins.size
                else np.empty((0, self.config.dims), dtype=np.float32)
            )
            keep = skyline_keep_np(union, self.device)
            global_sky = union[keep]
        survivors_per_pid = np.bincount(
            origins[keep], minlength=self.config.num_partitions
        )
        if self.freshness is not None:
            self.freshness.on_merge()
        merge_end_ns = time.perf_counter_ns()
        merge_ms = (merge_end_ns - merge_t0) / 1e6
        if self.telemetry is not None:
            self.telemetry.spans.record(
                "merge", merge_t0, merge_end_ns, trace_id=q.trace_id,
                args={"union_rows": int(union.shape[0]),
                      "skyline_size": int(global_sky.shape[0])},
            )
            self.telemetry.histogram("global_merge_ms").observe(merge_ms)
        now = now_ms + merge_ms
        job_start = min(q.start_times.values()) if q.start_times else now
        map_finish = q.last_arrival_ms if q.partials else now
        local_ms = max(q.cpu_ms.values()) if q.cpu_ms else 0.0
        map_wall = max(0.0, map_finish - job_start)
        optimality = optimality_mean(
            [survivors_per_pid[p] for p in pids_order],
            [q.local_sizes[p] for p in pids_order],
            self.config.num_partitions,
        )
        if self.snapshots is not None:
            self._publish_snapshot(global_sky, q)
        self._emit_result(
            q,
            skyline_size=int(global_sky.shape[0]),
            optimality=float(optimality),
            ingestion=max(0.0, map_wall - local_ms),
            local_ms=local_ms,
            global_ms=now - map_finish,
            total_ms=now - job_start,
            latency_ms=now - q.dispatch_ms,
            points=global_sky if self.config.emit_skyline_points else None,
            partial_missing=partial_missing,
        )

    def _answer_all_device(self, q: _QueryState, now_ms: float) -> None:
        """All barriers passed at dispatch: answer every partition and run
        the global merge on the device. Equivalent to _answer x P followed
        by _finalize, but local skylines never leave the device. The flush
        wall advances the arrival clock (local phase); the merge wall rides
        on top (global phase). With the query overlap on, the merge is only
        launched here and its handle parked for ``_harvest_inflight``."""
        tel = self.telemetry
        t0 = time.perf_counter_ns()
        self.pset.flush_all()
        self._note_flush()
        if self.device.type == "cuda":
            # the flush wall includes its queued K1/K2 work; the merge's
            # first count read would wait for it anyway
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter_ns()
        self.last_flush_ms = (t1 - t0) / 1e6
        if tel is not None:
            # one stacked launch covers every partition's local skyline
            tel.spans.record(
                "local", t0, t1, trace_id=q.trace_id,
                args={"partitions": self.config.num_partitions},
            )
        # an attached snapshot store needs the points even when the result
        # omits them: the snapshot is the serving read path
        emit = self.config.emit_skyline_points or self.snapshots is not None
        if knobs.query_overlap_enabled():
            handle = self.pset.global_merge_launch(emit_points=emit)
            launch_ms = (time.perf_counter_ns() - t1) / 1e6
            self._inflight_merge = (q, handle, now_ms, self.last_flush_ms, launch_ms)
            return
        counts, surv, g, pts = self.pset.global_merge_stats(emit_points=emit)
        if self.freshness is not None:
            self.freshness.on_merge()
        merge_end_ns = time.perf_counter_ns()
        self.last_merge_ms = (merge_end_ns - t1) / 1e6
        if tel is not None:
            tel.spans.record(
                "merge", t1, merge_end_ns, trace_id=q.trace_id,
                args={"skyline_size": int(g)},
            )
            tel.histogram("global_merge_ms").observe(self.last_merge_ms)
        self._emit_device_result(
            q, now_ms, self.last_flush_ms, self.last_merge_ms, counts, surv, g, pts,
            source_key=self.pset.epoch_key,
        )

    def _harvest_inflight(self, block: bool = True) -> bool:
        """Land the overlapped merge, if one is in flight. ``block=False``
        harvests only when its stats have already landed, so ingest never
        waits. The query's merge wall is the launch plus the harvest, as
        the reference charges it: the time in flight ran under ingest.
        Returns True when a result was emitted."""
        if self._inflight_merge is None:
            return False
        q, handle, now_ms, flush_wall_ms, launch_ms = self._inflight_merge
        if not block and not handle.ready():
            return False
        self._inflight_merge = None
        h0 = time.perf_counter_ns()
        counts, surv, g, pts = self.pset.global_merge_harvest(handle)
        if self.freshness is not None:
            self.freshness.on_merge()
        h1 = time.perf_counter_ns()
        self.last_merge_ms = launch_ms + (h1 - h0) / 1e6
        if self.telemetry is not None:
            self.telemetry.spans.record(
                "merge", h0, h1, trace_id=q.trace_id,
                args={"skyline_size": int(g), "overlapped": True},
            )
            self.telemetry.histogram("global_merge_ms").observe(self.last_merge_ms)
        self._emit_device_result(
            q, now_ms, flush_wall_ms, self.last_merge_ms, counts, surv, g, pts,
            source_key=handle.key,
        )
        return True

    def _emit_device_result(
        self, q, now_ms, flush_wall_ms, merge_ms, counts, surv, g, pts, source_key
    ) -> None:
        """Snapshot publish, timing decomposition and result emission of the
        device answer. ``source_key`` is the epoch key of the flushed state
        the merge saw, so repeated triggers over unchanged state dedupe in
        the store (the host ``_finalize`` path publishes un-keyed: its
        unions mix per-partition arrival times)."""
        if self.snapshots is not None:
            self._publish_snapshot(pts, q, source_key=source_key)
        starts = [s for s in self.pset.start_time_ms if s is not None]
        map_finish = now_ms + flush_wall_ms
        now = map_finish + merge_ms
        job_start = min(starts) if starts else now
        local_ms = self.pset.processing_ms
        map_wall = max(0.0, map_finish - job_start)
        self._emit_result(
            q,
            skyline_size=g,
            optimality=optimality_mean(surv, counts, self.config.num_partitions),
            ingestion=max(0.0, map_wall - local_ms),
            local_ms=local_ms,
            global_ms=now - map_finish,
            total_ms=now - job_start,
            latency_ms=now - q.dispatch_ms,
            points=pts if self.config.emit_skyline_points else None,
        )

    def _publish_snapshot(self, points, q: _QueryState, source_key=None) -> None:
        """Publish a completed global skyline, stamped with the query's
        trace id and wrapped in a "publish" span when telemetry is on.
        ``source_key``: opaque identity of the engine state the points came
        from (the partition-epoch key) — the store dedupes repeat publishes
        of an unchanged state instead of minting a new version."""
        meta = {"query_id": q.qid, "source_key": source_key}
        if q.trace_id is not None:
            meta["trace_id"] = q.trace_id
        if self.freshness is not None:
            # the merged window's newest event time becomes the snapshot's
            # published watermark (monotone; None until any event stamped)
            meta["event_wm_ms"] = self.freshness.on_publish()
        if self.telemetry is None:
            self.snapshots.publish(points, **meta)
            return
        t0 = time.perf_counter_ns()
        snap = self.snapshots.publish(points, **meta)
        self.telemetry.spans.record(
            "publish", t0, time.perf_counter_ns(), trace_id=q.trace_id
        )
        if q.plan is not None and snap is not None:
            # a deduped publish returns the EXISTING snapshot — the plan
            # still records which version its answer's bytes live under
            q.plan.publish = {
                "version": int(snap.version),
                "deduped": bool(self.snapshots.last_publish_deduped),
                "event_wm_ms": meta.get("event_wm_ms"),
            }

    def _emit_result(
        self,
        q: _QueryState,
        *,
        skyline_size: int,
        optimality: float,
        ingestion: float,
        local_ms: float,
        global_ms: float,
        total_ms: float,
        latency_ms: float,
        points=None,
        partial_missing=None,
    ) -> None:
        result = {
            "query_id": q.qid,
            "record_count": echo_record_count(q.payload),
            "skyline_size": skyline_size,
            "optimality": optimality,
            "ingestion_time_ms": int(ingestion),
            "local_processing_time_ms": int(local_ms),
            "global_processing_time_ms": int(global_ms),
            "total_processing_time_ms": int(total_ms),
            "query_latency_ms": int(latency_ms),
        }
        if partial_missing is not None:
            result["partial"] = True
            result["missing_partitions"] = partial_missing
        if points is not None:
            result["skyline_points"] = points.tolist()
        if self.telemetry is not None:
            if q.trace_id is not None:
                # the wire's optional extension field, after the reference's
                result["trace_id"] = q.trace_id
            self.telemetry.inc("queries.answered")
            self.telemetry.histogram("query_latency_ms").observe(latency_ms)
            if q.span_t0_ns:
                self.telemetry.spans.record(
                    "query", q.span_t0_ns, time.perf_counter_ns(),
                    trace_id=q.trace_id,
                    args={"query_id": q.qid, "skyline_size": skyline_size},
                )
        if self.workload is not None and partial_missing is None:
            # one trajectory point per complete answer (a partial one would
            # poison the dominance-rate series)
            self.workload.note_query(skyline_size, self.records_in)
        if q.plan is not None:
            self._finalize_plan(
                q,
                skyline_size=skyline_size,
                local_ms=local_ms,
                global_ms=global_ms,
                total_ms=total_ms,
                latency_ms=latency_ms,
            )
        if (
            self.auditor is not None
            and partial_missing is None
            and self.snapshots is not None
        ):
            # shadow-verify AFTER the answer is out the door (plan already
            # finalized, snapshot already published); partial answers
            # exclude state, so they are never audited. Observability must
            # never take the answer down.
            try:
                self.auditor.maybe_check(q)
            except Exception:
                self.telemetry.inc("audit.errors")
        self._results.append(result)
        self._inflight.pop(q.payload, None)

    def _finalize_plan(
        self, q, *, skyline_size, local_ms, global_ms, total_ms, latency_ms
    ) -> None:
        """Close a query's EXPLAIN plan: attribute the window's flush-cascade
        and kernel-dispatch deltas, stamp the timing decomposition and the
        workload regime, tick the tuner, land the record in the hub's ring
        and nest an ``explain/<path>`` span under the query span. The
        cascade counters' device read stays outside the guard, so a card
        fault is raised; a fault in the host-side bookkeeping after it
        never takes the answer down, as in the reference: it is counted
        (``explain.errors``) and noted in the flight recorder."""
        from skyline_tpu_torch.telemetry.explain import cascade_delta, kernel_delta

        cascade_now = self.pset.flush_cascade_stats()
        try:
            plan = q.plan
            if plan.merge is None:
                # the host merge (pending barriers, timeouts): no device
                # merge claimed the plan
                plan.merge = {"path": "host", "cached": False,
                              "skyline_size": int(skyline_size)}
            plan.cascade = cascade_delta(self._explain_cascade_mark, cascade_now)
            self._explain_cascade_mark = cascade_now
            if self.profiler is not None:
                kernels_now = self.profiler.snapshot_counts()
                plan.kernels = kernel_delta(self._explain_kernel_mark, kernels_now)
                self._explain_kernel_mark = kernels_now
            plan.timing = {
                "local_ms": round(float(local_ms), 3),
                "global_ms": round(float(global_ms), 3),
                "total_ms": round(float(total_ms), 3),
                "latency_ms": round(float(latency_ms), 3),
            }
            if self.workload is not None:
                plan.workload = self.workload.regime()
            if self.tuner is not None:
                # one cadence-gated controller epoch per query, then the
                # dispatch context this answer ran under
                self.tuner.maybe_tune()
                plan.tuner = self.tuner.explain_block()
            self.telemetry.explain.add(plan.to_doc())
            self.telemetry.inc("explain.records")
            if q.span_t0_ns:
                self.telemetry.spans.record(
                    f"explain/{plan.merge.get('path')}",
                    q.span_t0_ns,
                    time.perf_counter_ns(),
                    trace_id=q.trace_id,
                    tid=3,
                    args={
                        "path": plan.merge.get("path"),
                        "pruned": (plan.tree or {}).get("partitions_pruned", 0),
                        "kernels": len(plan.kernels),
                        "version": (plan.publish or {}).get("version"),
                    },
                )
        except Exception as e:
            self.telemetry.inc("explain.errors")
            self.telemetry.flight.note("explain.error", error=repr(e))

    # -- failure detection -------------------------------------------------

    def check_timeouts(self, now_ms: float | None = None) -> int:
        """Finalize overdue queries as partial results (the watchdog the
        reference job lacks). A timed-out query emits with ``"partial":
        true`` and ``"missing_partitions"`` listing the non-reporting
        partitions; its pending barrier entries are withdrawn. Returns the
        number of queries timed out."""
        timeout = self.config.query_timeout_ms
        if timeout <= 0:
            return 0
        # an overlapped merge's query is still in _inflight; land it before
        # the scan so the watchdog cannot finalize it a second time
        self._harvest_inflight()
        if not self._inflight:
            return 0
        if now_ms is None:
            now_ms = time.time() * 1000.0
        overdue = [q for q in self._inflight.values() if now_ms - q.dispatch_ms > timeout]
        for q in overdue:
            missing = [p for p in range(self.config.num_partitions) if p not in q.partials]
            for p in missing:
                self._pending_queries[p] = [pq for pq in self._pending_queries[p] if pq is not q]
            self._finalize(q, now_ms, partial_missing=missing)
        return len(overdue)

    # -- results ----------------------------------------------------------

    def poll_results(self) -> list[dict]:
        self._harvest_inflight()
        out, self._results = self._results, []
        return out

    @property
    def inflight_queries(self) -> int:
        return len(self._inflight)

    # -- observability ----------------------------------------------------

    def stats(self, include_skyline_counts: bool = False) -> dict:
        """Live engine counters as a poll-able dict (the role the Flink Web
        UI plays for the reference job). ``include_skyline_counts=True``
        adds exact per-partition skyline sizes at the cost of one device
        sync."""
        self.pset.sync_ingest_bookkeeping()
        # the counters below describe a settled state, not a merge mid-air
        self._harvest_inflight()
        tree_info = self.pset.last_tree_info or {}
        out = {
            "records_in": self.records_in,
            "dropped": self.dropped,
            "prefiltered": self.prefiltered,
            "inflight_queries": len(self._inflight),
            "pending_flush_rows": self.pset.pending_rows_total,
            "processing_ms": self.pset.processing_ms,
            "partitions": {
                "records_seen": self.pset.records_seen.tolist(),
                "max_seen_id": self.pset.max_seen_id.tolist(),
            },
            "meshed": False,
            "merge_cache": {
                "hits": self.pset.merge_cache_hits,
                "misses": self.pset.merge_cache_misses,
                "delta_merges": self.pset.merge_delta_merges,
                "delta_rows": self.pset.merge_delta_rows,
                "last_dirty_fraction": self.pset.last_dirty_fraction,
            },
            "merge_tree": {
                "merges": self.pset.merge_tree_merges,
                "levels": tree_info.get("levels", 0),
                "partitions_pruned": self.pset.merge_partitions_pruned,
                "pruned_fraction": tree_info.get("pruned_fraction", 0.0),
                "candidates_per_level": tree_info.get("candidates_per_level", []),
            },
            "flush_cascade": self.pset.flush_cascade_stats(),
        }
        if self._explain_on:
            out["explain"] = self.telemetry.explain.doc()
        if self.auditor is not None:
            out["audit"] = self.telemetry.audit.doc()
        if self.freshness is not None:
            out["freshness"] = self.freshness.stats()
        if self.workload is not None:
            out["workload"] = self.workload.stats()
        if self.profiler is not None:
            phase = self.tracer.report().get("flush/merge_kernel")
            out["kernel_profile"] = self.profiler.doc(
                phase_total_ms=phase["total_ms"] if phase else None
            )
        if include_skyline_counts:
            out["partitions"]["skyline_counts"] = self.pset.sky_counts().tolist()
        return out

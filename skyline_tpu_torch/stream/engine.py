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
``check_timeouts`` finalises an overdue query as a partial result.
Telemetry (the engine's ``stats()`` and its ``flush_cascade`` block),
snapshots, EXPLAIN and audit are not ported; the reference documents its
results as identical without them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from skyline_tpu_torch.bridge.wire import parse_trigger
from skyline_tpu_torch.ops.dispatch import skyline_keep_np
from skyline_tpu_torch.parallel.partitioners import partition_ids_np
from skyline_tpu_torch.stream.batched import PartitionSet, PartitionView
from skyline_tpu_torch.stream.window import DEFAULT_BUFFER_SIZE
from skyline_tpu_torch.utils.devices import resolve_device
from skyline_tpu_torch.utils.knobs import query_overlap_enabled


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
    # (stream/device_window.py), lazy/overlap only; "host": numpy routing in
    # process_records; "auto": device on a card for lazy/overlap, else host
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


class SkylineEngine:
    """Single-device streaming engine over ``num_partitions`` logical
    partitions.

    Usage: ``process_records`` / ``process_trigger`` as data and control
    planes; completed query results accumulate and are drained with
    ``poll_results`` (each result is a dict with the reference's JSON
    fields). ``last_flush_ms`` / ``last_merge_ms`` hold the host walls of
    the last device answer's flush and global merge; the device is
    synchronised between the two, so each wall holds its own kernels. An
    overlapped merge's wall is its launch plus its harvest."""

    def __init__(self, config: EngineConfig):
        self.config = config
        self.device = resolve_device(config.device)
        # device ingest needs the lazy or overlap policy (the engine is
        # single-device)
        device_ok = config.flush_policy in ("lazy", "overlap")
        if config.ingest == "device":
            if not device_ok:
                raise ValueError("ingest='device' requires the lazy/overlap flush policy")
            use_device = True
        elif config.ingest == "auto":
            use_device = device_ok and self.device.type == "cuda"
        elif config.ingest == "host":
            use_device = False
        else:
            raise ValueError(f"unknown ingest mode {config.ingest!r}")
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
        self.last_flush_ms: float | None = None
        self.last_merge_ms: float | None = None
        # the overlapped merge in flight: (query, handle, now_ms, flush wall
        # ms, launch ms)
        self._inflight_merge: tuple | None = None

    # -- data plane -------------------------------------------------------

    def process_records(
        self, ids: np.ndarray, values: np.ndarray, now_ms: float | None = None
    ) -> None:
        """Route a micro-batch of records to partitions and advance barriers.

        ids: (N,) int64 global record ids; values: (N, d) float32."""
        if values.shape[0] == 0:
            return
        if now_ms is None:
            now_ms = time.time() * 1000.0
        cfg = self.config
        if self.pset.device_ingest:
            # routing and barrier stats on the device; the host bookkeeping
            # syncs only when a pending query needs its barrier re-evaluated
            self.pset.ingest_chunk(ids, values, now_ms)
            if any(self._pending_queries.values()):
                self.pset.sync_ingest_bookkeeping()
                for p in range(cfg.num_partitions):
                    now_ms = self._recheck_pending(p, now_ms)
            self.pset.maybe_flush()
            self._harvest_inflight(block=False)
            return
        pids = partition_ids_np(values, cfg.algo, cfg.num_partitions, cfg.domain_max)
        # group rows by partition with one argsort (the keyBy shuffle).
        # now_ms advances through the loop: an answer's snapshot flush takes
        # real time, and later answers in the SAME call must see a clock past
        # it or the timing decomposition goes impossible (local > total)
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
        # an overlapped merge whose stats landed is harvested here; one still
        # running stays in flight (ingest never waits for it)
        self._harvest_inflight(block=False)

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
        self._inflight[payload] = q
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
        t1 = time.perf_counter_ns()
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
        merge_ms = (time.perf_counter_ns() - merge_t0) / 1e6
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
        t0 = time.perf_counter_ns()
        self.pset.flush_all()
        if self.device.type == "cuda":
            # the flush wall includes its queued K1/K2 work; the merge's
            # first count read would wait for it anyway
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter_ns()
        self.last_flush_ms = (t1 - t0) / 1e6
        emit = self.config.emit_skyline_points
        if query_overlap_enabled():
            handle = self.pset.global_merge_launch(emit_points=emit)
            launch_ms = (time.perf_counter_ns() - t1) / 1e6
            self._inflight_merge = (q, handle, now_ms, self.last_flush_ms, launch_ms)
            return
        counts, surv, g, pts = self.pset.global_merge_stats(emit_points=emit)
        self.last_merge_ms = (time.perf_counter_ns() - t1) / 1e6
        self._emit_device_result(
            q, now_ms, self.last_flush_ms, self.last_merge_ms, counts, surv, g, pts
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
        self.last_merge_ms = launch_ms + (time.perf_counter_ns() - h0) / 1e6
        self._emit_device_result(
            q, now_ms, flush_wall_ms, self.last_merge_ms, counts, surv, g, pts
        )
        return True

    def _emit_device_result(
        self, q, now_ms, flush_wall_ms, merge_ms, counts, surv, g, pts
    ) -> None:
        """Timing decomposition and result emission of the device answer."""
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
            points=pts,
        )

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
        self._results.append(result)
        self._inflight.pop(q.payload, None)

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

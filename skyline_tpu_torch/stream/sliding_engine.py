"""Sliding-window streaming engine: partitioned continuous skyline.

Counterpart of ``skyline_tpu/stream/sliding_engine.py`` (BASELINE config
#4, count-based sliding window, high overlap), with the same external
surface as ``SkylineEngine``: ``process_records`` / ``process_trigger`` /
``poll_results`` / ``check_timeouts`` / ``stats``, the same partitioners,
id-barrier trigger semantics and result JSON.

Semantics. The stream is cut into global slides of ``slide`` tuples (by
arrival order, exactly — incoming batches are split at slide boundaries
before routing). A window is the last ``K = window_size / slide`` closed
buckets. Each partition keeps a device ring of its OWN rows per bucket
(bucket skylines computed once at close — the merge law makes the union
exact); eviction is a ring-slot overwrite. A query trigger answers over the
current window plus the in-progress slide's rows (bucket-granular eviction:
between ``window_size`` and ``window_size + slide - 1`` most recent tuples —
the same contract as ``SlidingSkyline.current_skyline``).

Device shape: rings are stacked ``(P, K, C, d)``; a slide close is one step
for all partitions (bucket skyline + ring write + window-union skyline +
compact) and one host read, the per-partition survivor counts. On a card
once the flat window reaches 8,192 rows both skyline passes are K3 over
every partition in one launch each (``skyline_mask_kernel`` on (P, N, d));
below that, and on the CPU, the chunked scan per partition; at d <= 2 the
sweep.

With a ``mesh`` (``parallel/mesh.py``) the P axis of the rings splits over
the places of its first axis, P/n contiguous partitions each: every slide
close runs one batched slide step for each run of places on one device,
over their partitions, on that device (with every place on one card, one
step over every partition; over several devices each keeps its
partitions' rings and window skylines, and only the slide's rows, the
counts and the answer's prefixes cross). The reference keeps its scan
kernels under a mesh, for GSPMD's sake; the answers are exact and
compacted either way, so each place here takes the same branch as a flat
engine would (K3 on a card past the threshold).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from skyline_tpu_torch.bridge.wire import parse_trigger
from skyline_tpu_torch.metrics.tracing import NULL_TRACER
from skyline_tpu_torch.ops.block_skyline import skyline_mask_scan
from skyline_tpu_torch.ops.dispatch import skyline_keep_np
from skyline_tpu_torch.ops.dominance import compact
from skyline_tpu_torch.ops.dominance_kernels import skyline_mask_kernel
from skyline_tpu_torch.ops.sweep2d import skyline_mask_sweep
from skyline_tpu_torch.parallel.chips import gather_to, on_device
from skyline_tpu_torch.parallel.mesh import Placed
from skyline_tpu_torch.parallel.partitioners import partition_ids_np
from skyline_tpu_torch.stream.engine import (
    EngineConfig,
    _QueryState,
    echo_record_count,
    optimality_mean,
)
from skyline_tpu_torch.utils.buckets import next_pow2
from skyline_tpu_torch.utils.devices import resolve_device, upload_async

# the flat window (K * C rows) from which a card runs both passes through
# K3: below it the scan's exact-size passes win (the reference's gate)
K3_MIN_ROWS = 8192


def _per_partition(mask, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(P, N) survivor mask, ``mask`` run on each partition alone."""
    return torch.stack([mask(x[p], valid[p]) for p in range(x.shape[0])])


def _slide_step_batched(rings, ring_valids, slot: int, rows, rows_valid, use_k3: bool = False):
    """Close one global slide across all partitions.

    rings (P, K, C, d), ring_valids (P, K, C) — the slot written in place;
    slot (the same ring position for every partition: slides are global);
    rows (P, C, d) padded, rows_valid (P, C). Returns (win_sky (P, K*C, d),
    win_valid (P, K*C), win_counts (P,)) with each partition's window
    skyline compacted to the front of its flat buffer.

    ``use_k3`` runs both skyline passes as one K3 launch over every
    partition (the window-union pass is the slide's cost at north-star
    shapes: at 8-D the bucket skylines barely shrink, so the union is
    nearly K full buckets). Otherwise the chunked scan per partition, and
    the sweep at d <= 2 whatever ``use_k3`` says."""
    P, k, c, d = rings.shape
    if d <= 2:
        def mask(x, v):
            return _per_partition(skyline_mask_sweep, x, v)
    elif use_k3:
        mask = skyline_mask_kernel
    else:
        def mask(x, v):
            return _per_partition(skyline_mask_scan, x, v)
    bucket_keep = mask(rows, rows_valid)
    bvals, bvalid, _ = compact(rows, bucket_keep, c)
    rings[:, slot] = bvals
    ring_valids[:, slot] = bvalid
    flat = rings.reshape(P, k * c, d)
    fvalid = ring_valids.reshape(P, k * c)
    wkeep = mask(flat, fvalid)
    return compact(flat, wkeep, k * c)


class SlidingEngine:
    """Partitioned sliding-window skyline engine (see module docstring).

    ``tracer`` times the phases ``route``, ``slide/step`` and
    ``query/snapshot_transfer``; ``telemetry`` (a ``telemetry.Telemetry``
    hub, or any object with ``histogram(name).observe``, ``spans.record``
    and ``mint_trace_id``) receives the reference's latency histograms,
    trace ids and spans;
    ``attach_snapshots`` takes any store with ``note_ingest`` and
    ``publish``."""

    def __init__(
        self,
        config: EngineConfig,
        window_size: int,
        slide: int,
        mesh=None,
        emit_per_slide: bool = False,
        tracer=None,
        telemetry=None,
    ):
        if window_size % slide != 0:
            raise ValueError(
                f"window_size {window_size} must be a multiple of slide {slide}"
            )
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(config.device)
        if mesh is not None:
            axis = mesh.axis_names[0]
            if config.num_partitions % int(mesh.shape[axis]):
                raise ValueError(
                    f"num_partitions {config.num_partitions} must be divisible by "
                    f"mesh axis size {mesh.shape[axis]}"
                )
            self.device = resolve_device(mesh.axis_places(axis)[0])
        self.window_size = window_size
        self.slide = slide
        self.k = window_size // slide
        self.emit_per_slide = emit_per_slide
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.telemetry = telemetry
        P = config.num_partitions
        # start capacity at the balanced-routing bucket (2x headroom over
        # slide/P); grows when routing skew overflows it
        self._cap = next_pow2(max(2 * slide // max(P, 1), 64), min_cap=128)
        self._use_k3 = self._k3_gate()
        self._rings = torch.full(
            (P, self.k, self._cap, config.dims), float("inf"), dtype=torch.float32,
            device=self.device,
        )
        self._ring_valids = torch.zeros(
            (P, self.k, self._cap), dtype=torch.bool, device=self.device
        )
        if mesh is not None:
            rings = Placed.split(mesh, self._rings, mesh.axis_names[0])
            if rings.on(self.device) is None:
                # places on several devices: each keeps its partitions' rings
                self._rings = rings
                self._ring_valids = Placed.split(mesh, self._ring_valids, mesh.axis_names[0])
        # per-partition current-window skylines (device cache from the last
        # slide close; ``Placed`` as the rings are) + exact survivor counts on
        # the host
        self._win_sky: torch.Tensor | Placed | None = None
        self._win_host: list[np.ndarray] | None = None  # host cache of _win_sky
        self._win_counts = np.zeros(P, dtype=np.int64)
        self._slot = 0
        self._slides_closed = 0
        # current slide's routed rows, per partition (host)
        self._pend: list[list[np.ndarray]] = [[] for _ in range(P)]
        self._pend_rows = np.zeros(P, dtype=np.int64)
        self._slide_fill = 0  # tuples of the in-progress slide
        self.records_in = 0
        self.dropped = 0
        self.prefiltered = 0
        self.max_seen_id = np.full(P, -1, dtype=np.int64)
        self.records_seen = np.zeros(P, dtype=np.int64)
        self.start_time_ms: list[float | None] = [None] * P
        self.processing_ns = 0
        # bytes of window skyline moved to the host by the answers so far
        self.answer_host_bytes = 0
        self._pending_queries: dict[int, list[_QueryState]] = {i: [] for i in range(P)}
        self._inflight: dict[str, _QueryState] = {}
        self._results: list[dict] = []
        self.snapshots = None

    def _k3_gate(self) -> bool:
        """K3 for both passes on a card once the flat window clears
        ``K3_MIN_ROWS`` (the reference's ``use_pallas`` gate with its
        ``on_tpu()`` read as "the engine's device is CUDA")."""
        return self.device.type == "cuda" and self.k * self._cap >= K3_MIN_ROWS

    def attach_snapshots(self, store) -> None:
        """Publish each answered window's global skyline to ``store``."""
        self.snapshots = store

    # -- data plane -------------------------------------------------------

    def process_records(self, ids, values, now_ms: float | None = None, event_ms=None) -> None:
        """Split the batch at global slide boundaries, route each segment,
        close slides as they fill. ``event_ms`` is accepted for call-site
        parity with the reference's ``SkylineEngine`` and ignored."""
        tel = self.telemetry
        if tel is None:
            return self._process_records(ids, values, now_ms)
        t0 = time.perf_counter_ns()
        try:
            return self._process_records(ids, values, now_ms)
        finally:
            end = time.perf_counter_ns()
            tel.histogram("ingest_batch_ms").observe((end - t0) / 1e6)
            tel.spans.record("ingest", t0, end, args={"rows": int(values.shape[0])})

    def _process_records(self, ids, values, now_ms: float | None = None) -> None:
        if values.shape[0] == 0:
            return
        if now_ms is None:
            now_ms = time.time() * 1000.0
        self.records_in += values.shape[0]
        if self.snapshots is not None:
            self.snapshots.note_ingest(int(ids.max()))
        pos = 0
        n = values.shape[0]
        # now_ms advances through routing answers and slide closes: wall
        # spent in either must be seen by later answers in the same call or
        # total < local becomes possible
        while pos < n:
            take = min(self.slide - self._slide_fill, n - pos)
            now_ms = self._route(ids[pos : pos + take], values[pos : pos + take], now_ms)
            self._slide_fill += take
            pos += take
            if self._slide_fill == self.slide:
                now_ms = self._close_slide(now_ms)
                self._slide_fill = 0

    def _route(self, ids, values, now_ms: float) -> float:
        cfg = self.config
        with self.tracer.phase("route"):
            pids = partition_ids_np(values, cfg.algo, cfg.num_partitions, cfg.domain_max)
            order = np.argsort(pids, kind="stable")
            s_pids, s_vals, s_ids = pids[order], values[order], ids[order]
            bounds = np.searchsorted(s_pids, np.arange(cfg.num_partitions + 1))
            for p in range(cfg.num_partitions):
                lo, hi = bounds[p], bounds[p + 1]
                if lo == hi:
                    continue
                if self.start_time_ms[p] is None:
                    self.start_time_ms[p] = now_ms
                self.max_seen_id[p] = max(self.max_seen_id[p], int(s_ids[lo:hi].max()))
                self.records_seen[p] += hi - lo
                self._pend[p].append(np.array(s_vals[lo:hi]))
                self._pend_rows[p] += hi - lo
                now_ms = self._recheck_pending(p, now_ms)
        return now_ms

    def _close_slide(self, now_ms: float) -> float:
        t0 = time.perf_counter_ns()
        P = self.config.num_partitions
        d = self.config.dims
        max_rows = int(self._pend_rows.max())
        if max_rows > self._cap:
            self._grow(next_pow2(max_rows, min_cap=128))
        rows = np.full((P, self._cap, d), np.inf, dtype=np.float32)
        rvalid = np.zeros((P, self._cap), dtype=bool)
        for p in range(P):
            if self._pend[p]:
                r = (
                    self._pend[p][0]
                    if len(self._pend[p]) == 1
                    else np.concatenate(self._pend[p], axis=0)
                )
                rows[p, : r.shape[0]] = r
                rvalid[p, : r.shape[0]] = True
        self._pend = [[] for _ in range(P)]
        self._pend_rows[:] = 0
        with self.tracer.phase("slide/step"):
            self._win_sky, counts = self._slide_step(
                upload_async(rows, self.device), upload_async(rvalid, self.device)
            )
            # the slide's one host read
            self._win_counts = counts.cpu().numpy().astype(np.int64)
        self._win_host = None  # device cache replaced; host copy is stale
        self._slot = (self._slot + 1) % self.k
        self._slides_closed += 1
        step_ns = time.perf_counter_ns() - t0
        self.processing_ns += step_ns
        now_ms = now_ms + step_ns / 1e6  # the close's wall advances the clock
        if self.emit_per_slide:
            q = _QueryState(
                qid=f"slide-{self._slides_closed - 1}",
                payload=f"slide-{self._slides_closed - 1},{self.records_in}",
                required=0,
                dispatch_ms=now_ms,
            )
            now_ms = self._answer_window(q, now_ms)
        return now_ms

    def _slide_step(self, rows: torch.Tensor, rvalid: torch.Tensor):
        """The slide step over every partition. With a mesh whose places
        span several devices the rings are ``Placed`` slices: one batched
        step a slice, on its device, writing its ring slot in place there.
        Returns (window skylines (P, K*C, d) — ``Placed`` likewise —,
        counts (P,) on the engine's device)."""
        if not isinstance(self._rings, Placed):
            win, _, counts = _slide_step_batched(
                self._rings, self._ring_valids, self._slot, rows, rvalid,
                use_k3=self._use_k3,
            )
            return win, counts
        wins, cnts = [], []
        for (span, dev, rg), (_, _, rv) in zip(self._rings.parts, self._ring_valids.parts):
            with on_device(dev):
                r, v = gather_to(dev, [rows[span], rvalid[span]])
                win, _, counts = _slide_step_batched(rg, rv, self._slot, r, v, use_k3=self._use_k3)
            wins.append((span, dev, win))
            cnts.append(counts)
        return Placed(tuple(wins)), torch.cat(gather_to(self.device, cnts))

    def _grow(self, new_cap: int) -> None:
        """Routing skew overflowed a ring's row capacity: grow all rings
        (rare; the closed buckets keep their slots and rows)."""
        extra = new_cap - self._cap

        def grow(t, fill):
            pad = torch.full((*t.shape[:2], extra, *t.shape[3:]), fill, dtype=t.dtype,
                             device=t.device)
            return torch.cat([t, pad], dim=2)

        for name, fill in (("_rings", float("inf")), ("_ring_valids", False)):
            t = getattr(self, name)
            fn = functools.partial(grow, fill=fill)
            setattr(self, name, t.map(fn) if isinstance(t, Placed) else fn(t))
        self._cap = new_cap
        # growth can push the flat window past the K3 threshold
        self._use_k3 = self._k3_gate()

    # -- control plane ----------------------------------------------------

    def process_trigger(self, payload: str, now_ms: float | None = None) -> None:
        if now_ms is None:
            now_ms = time.time() * 1000.0
        qid, required = parse_trigger(payload)
        q = _QueryState(qid=qid, payload=payload, required=required, dispatch_ms=now_ms)
        if self.telemetry is not None:
            q.trace_id = self.telemetry.mint_trace_id()
            q.span_t0_ns = time.perf_counter_ns()
        self._inflight[payload] = q
        P = self.config.num_partitions
        blocked = [
            p for p in range(P)
            if not (self.max_seen_id[p] >= required or self.max_seen_id[p] == -1)
        ]
        if not blocked:
            self._answer_window(q, now_ms)
        for p in blocked:
            self._pending_queries[p].append(q)

    def _recheck_pending(self, p: int, now_ms: float) -> float:
        """Drop cleared barriers for partition ``p``; a query answers once
        no partition's pending list holds it anymore. Returns the advanced
        clock (answers take real wall; later answers in the same call must
        not time-travel before them)."""
        still = []
        unblocked = []
        for q in self._pending_queries[p]:
            if self.max_seen_id[p] >= q.required:
                unblocked.append(q)
            else:
                still.append(q)
        self._pending_queries[p] = still
        for q in unblocked:
            if not any(q in lst for lst in self._pending_queries.values()):
                now_ms = self._answer_window(q, now_ms)
        return now_ms

    # -- answering --------------------------------------------------------

    def _current_partials(self):
        """Per-partition current window contributions (host arrays) plus a
        per-partition flag: does the contribution still need a local
        skyline prune (True unless it came straight from the exact
        window-skyline cache with no pending rows). Only each partition's
        counted prefix of the window cache crosses to the host, in one
        copy."""
        P = self.config.num_partitions
        d = self.config.dims
        need_prune = [False] * P
        if self._win_sky is not None:
            if self._win_host is None:
                with self.tracer.phase("query/snapshot_transfer"):
                    counts = self._win_counts.tolist()
                    win = self._win_sky
                    parts = win.parts if isinstance(win, Placed) else ((slice(0, P), None, win),)
                    host = np.concatenate([
                        torch.cat([t[p - s.start, : counts[p]] for p in range(s.start, s.stop)])
                        .cpu().numpy()
                        for s, _, t in parts
                    ])
                    self.answer_host_bytes += host.nbytes
                    self._win_host = np.split(host, np.cumsum(counts)[:-1])
            parts = list(self._win_host)
        else:
            # _win_sky is None only before the first slide closes
            if self._slides_closed != 0:
                raise RuntimeError("window cache missing after a slide closed")
            parts = [np.empty((0, d), np.float32) for _ in range(P)]
        for p in range(P):
            if self._pend[p]:
                pend = np.concatenate(self._pend[p], axis=0)
                parts[p] = np.concatenate([parts[p], pend], axis=0)
                need_prune[p] = True
        return parts, need_prune

    def _answer_window(self, q: _QueryState, now_ms: float) -> float:
        t0 = time.perf_counter_ns()
        parts, need_prune = self._current_partials()
        P = self.config.num_partitions
        # local pass: prune each contribution to its partition's window
        # skyline (already exact when served from the slide-close cache)
        local = []
        for p in range(P):
            arr = parts[p]
            if arr.shape[0] and need_prune[p]:
                arr = arr[skyline_keep_np(arr, self.device)]
            local.append(arr)
        sizes = [a.shape[0] for a in local]
        if any(sizes):
            union = np.concatenate(local, axis=0)
            origins = np.concatenate([np.full(s, p, dtype=np.int32) for p, s in enumerate(sizes)])
            keep = skyline_keep_np(union, self.device)
        else:
            union = np.empty((0, self.config.dims), np.float32)
            origins = np.empty((0,), np.int32)
            keep = np.zeros((0,), dtype=bool)
        global_sky = union[keep]
        surv = np.bincount(origins[keep], minlength=P)
        merge_end_ns = time.perf_counter_ns()
        merge_ms = (merge_end_ns - t0) / 1e6
        if self.telemetry is not None:
            self.telemetry.spans.record(
                "merge", t0, merge_end_ns, trace_id=q.trace_id,
                args={"skyline_size": int(global_sky.shape[0])},
            )
            self.telemetry.histogram("global_merge_ms").observe(merge_ms)
        now = now_ms + merge_ms

        starts = [s for s in self.start_time_ms if s is not None]
        job_start = min(starts) if starts else now
        local_ms = self.processing_ns / 1e6
        map_wall = max(0.0, now_ms - job_start)
        result = {
            "query_id": q.qid,
            "record_count": echo_record_count(q.payload),
            "skyline_size": int(global_sky.shape[0]),
            "optimality": optimality_mean(surv, sizes, P),
            "ingestion_time_ms": int(max(0.0, map_wall - local_ms)),
            "local_processing_time_ms": int(local_ms),
            "global_processing_time_ms": int(merge_ms),
            "total_processing_time_ms": int(now - job_start),
            "query_latency_ms": int(now - q.dispatch_ms),
            "window_size": self.window_size,
            "slide": self.slide,
            "slides_closed": self._slides_closed,
            "window_filled": self._slides_closed >= self.k,
        }
        if self.config.emit_skyline_points:
            result["skyline_points"] = global_sky.tolist()
        if self.snapshots is not None:
            meta = {}
            if q.trace_id is not None:
                meta["trace_id"] = q.trace_id
            p0 = time.perf_counter_ns()
            self.snapshots.publish(
                global_sky,
                query_id=q.qid,
                # window identity: an unchanged (records_in, slides_closed)
                # means a byte-identical recompute, so the store can dedupe
                source_key=(self.records_in, self._slides_closed),
                slides_closed=self._slides_closed,
                window_filled=self._slides_closed >= self.k,
                **meta,
            )
            if self.telemetry is not None:
                self.telemetry.spans.record(
                    "publish", p0, time.perf_counter_ns(), trace_id=q.trace_id
                )
        if self.telemetry is not None:
            if q.trace_id is not None:
                result["trace_id"] = q.trace_id
            self.telemetry.histogram("query_latency_ms").observe(result["query_latency_ms"])
            if q.span_t0_ns:
                self.telemetry.spans.record(
                    "query", q.span_t0_ns, time.perf_counter_ns(),
                    trace_id=q.trace_id,
                    args={"query_id": q.qid, "skyline_size": int(global_sky.shape[0])},
                )
        self._results.append(result)
        self._inflight.pop(q.payload, None)
        return now

    # -- results / observability ------------------------------------------

    def poll_results(self) -> list[dict]:
        out, self._results = self._results, []
        return out

    def check_timeouts(self, now_ms: float | None = None) -> int:
        """Sliding triggers answer from current state; a deferred barrier
        can still time out into a partial answer over what exists."""
        timeout = self.config.query_timeout_ms
        if timeout <= 0 or not self._inflight:
            return 0
        if now_ms is None:
            now_ms = time.time() * 1000.0
        overdue = [q for q in self._inflight.values() if now_ms - q.dispatch_ms > timeout]
        for q in overdue:
            for lst in self._pending_queries.values():
                if q in lst:
                    lst.remove(q)
            self._answer_window(q, now_ms)
            self._results[-1]["partial"] = True
        return len(overdue)

    @property
    def inflight_queries(self) -> int:
        return len(self._inflight)

    def stats(self, include_skyline_counts: bool = False) -> dict:
        out = {
            "mode": "sliding",
            # which skyline-mask path the slide step runs: "k3" is K3 over
            # every partition in one launch (the reference's "pallas");
            # "sweep" / "scan" are the d <= 2 and portable paths
            "mask_kernel": (
                "sweep"
                if self.config.dims <= 2
                else ("k3" if self._use_k3 else "scan")
            ),
            "records_in": self.records_in,
            "dropped": self.dropped,
            "prefiltered": self.prefiltered,
            "inflight_queries": len(self._inflight),
            "window_size": self.window_size,
            "slide": self.slide,
            "slides_closed": self._slides_closed,
            "pending_flush_rows": int(self._pend_rows.sum()),
            "processing_ms": self.processing_ns / 1e6,
            "partitions": {
                "records_seen": self.records_seen.tolist(),
                "max_seen_id": self.max_seen_id.tolist(),
            },
            "meshed": self.mesh is not None,
        }
        if include_skyline_counts:
            out["partitions"]["skyline_counts"] = self._win_counts.tolist()
        return out

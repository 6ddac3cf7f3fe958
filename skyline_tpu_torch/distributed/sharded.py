"""Sharded streaming engine: per-card partition groups and a two-level
tournament merge.

Counterpart of ``skyline_tpu/distributed/sharded.py``. The single-device
engine keeps all P partitions in one stacked buffer on one device.
``ShardedPartitionSet`` splits them into ``chips`` contiguous groups —
chip ``c`` owns global partitions ``[c*G, (c+1)*G)`` with ``G = P / chips``
— and each group is a full ``PartitionSet`` on its own device
(``parallel/chips.py`` ``chip_devices``: ``cuda:c % n`` over the visible
cards, or the CPU): its own pending rows, flush cascade, prune summaries,
merge cache and epoch subvector. Nothing crosses devices during ingest or
flush.

A global query is a TWO-LEVEL tournament:

1. intra-chip: each chip runs its own merge (the pruned tree at d > 2, K2
   pairs on a card) over its partitions, under ``torch.cuda.device`` of
   its card, giving one chip-local skyline root on that card;
2. cross-chip: the witness prefilter runs over CHIP summaries — one
   ``(2d+2)`` row per chip root (``partition_summaries_device``) — so a
   chip whose least corner another chip's witness strictly dominates is
   skipped before any copy; the surviving roots are copied to chip 0's
   device and merged pairwise (``tree_pair_merge``, K2 on a card) in
   ascending chip order.

Byte identity: groups are contiguous in partition id, each chip root is
byte-identical to the flat merge over its own partitions, and
``tree_pair_merge``'s stable compaction keeps (partition, storage row)
order at every cross-chip level — so the two-level root equals the flat
engine's output, rows and order. Flush cadence is part of that contract
(the lazy policy sum-sorts each flush's batch), so the facade flushes ALL
chips exactly when the single-device set would flush.

Chip fault tolerance: with ``SKYLINE_CHIP_MERGE_DEADLINE_MS`` set each
chip's level-1 merge runs on a watchdog thread under the chip's lock with
a deadline, retries, backoff and an optional hedge; a chip that misses it
is left out and the answer is published marked partial (the exact skyline
of the surviving chips' records). ``ChipHealth``
(``resilience/health.py``) scores the outcomes, and ``maybe_failover``
rebuilds a quarantined chip's group on a healthy chip's device from its
captured state. Every thread names its card: a new thread's current device
is ``cuda:0``.
"""

from __future__ import annotations

import hashlib
import threading
import time

import numpy as np
import torch

from skyline_tpu_torch.metrics.tracing import NULL_TRACER
from skyline_tpu_torch.ops import cascade
from skyline_tpu_torch.parallel.chips import chip_devices, gather_to, on_device
from skyline_tpu_torch.resilience.faults import InjectedCrash, fault_point
from skyline_tpu_torch.stream.batched import PartitionSet, to_host_async
from skyline_tpu_torch.stream.engine import SkylineEngine
from skyline_tpu_torch.stream.window import (
    DEFAULT_BUFFER_SIZE,
    _active_bucket,
    _next_pow2,
    partition_summaries_device,
    prune_witness_mask,
    tree_pair_merge,
    tree_points_device,
    tree_stats_device,
)
from skyline_tpu_torch.utils.knobs import (
    chip_failover_enabled,
    chip_hedge_ms,
    chip_merge_backoff_ms,
    chip_merge_deadline_ms,
    chip_merge_retries,
    failover_lock_ms,
    fleet_enabled,
)


def epoch_hex(key: bytes) -> str:
    """Short stable digest of an epoch key for WAL barrier records and
    logs (the raw key is a P*8-byte vector — too wide to journal)."""
    return hashlib.sha1(key).hexdigest()[:16]


class _ShardedMergeHandle:
    """An in-flight two-level merge — the sharded analogue of
    ``stream.batched._MergeHandle``. Chip-local merges are harvested at
    launch (their stats size the cross-chip leaves); the cross-chip pairs
    and their stats copy stay in flight until harvest."""

    __slots__ = (
        "key", "emit_points", "use_cache", "cached", "result", "stats", "event",
        "root_vals", "explain", "partial",
    )

    def __init__(self):
        self.cached = False
        self.result = None
        self.stats = None
        self.event = None
        self.root_vals = None
        self.explain = None
        # set when chips were EXCLUDED from this merge (deadline/failure):
        # {"excluded_chips", "reasons", "completeness_bound",
        #  "excluded_records"} — rides to the engine as a degraded answer
        self.partial = None

    def ready(self) -> bool:
        """True once the harvest would not wait."""
        return self.cached or self.event is None or self.event.query()


class ShardedPartitionSet:
    """Facade with the ``PartitionSet`` surface over per-chip groups.

    The engine (and ``PartitionView``, checkpointing, the audit plane) talk
    to this as to a single-device set; global partition ``p`` lives on chip
    ``p // group_size`` at local index ``p % group_size``. The barrier and
    metrics bookkeeping (max ids, record counts, pending rows) is kept
    facade-global, so flush-cadence decisions see what the single-device
    set would."""

    def __init__(
        self,
        num_partitions: int,
        dims: int,
        buffer_size: int = DEFAULT_BUFFER_SIZE,
        *,
        chips: int,
        initial_capacity: int = 0,
        tracer=None,
        flush_policy: str = "incremental",
        overlap_rows: int = 262144,
        window_capacity: int = 0,
        counters=None,
        device="cuda",
    ):
        """``device``: ``"cuda"`` (the default) spreads the groups over the
        visible cards, ``"cpu"`` keeps every group on the CPU."""
        if chips < 1:
            raise ValueError(f"chips must be >= 1, got {chips}")
        if num_partitions % chips:
            raise ValueError(
                f"num_partitions {num_partitions} must be divisible by chips {chips}"
            )
        self.num_partitions = num_partitions
        self.dims = dims
        self.buffer_size = buffer_size
        self.chips = chips
        self.group_size = num_partitions // chips
        self.flush_policy = flush_policy
        self.overlap_rows = overlap_rows
        # kept so failover can rebuild a group with ctor-identical shape
        self._initial_capacity = initial_capacity
        self._window_capacity = window_capacity
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._devices = chip_devices(chips, device)
        self._counters = counters
        self._chips: list[PartitionSet] = [self._group(self._devices[c]) for c in range(chips)]
        p = num_partitions
        # facade-global bookkeeping: the flush-cadence decision and the
        # engine's barrier checks read THESE, so they match the single-device
        # set bit for bit (chips keep their own mirrors)
        self._pending_rows = np.zeros(p, dtype=np.int64)
        self.max_seen_id = np.full(p, -1, dtype=np.int64)
        self.start_time_ms: list[float | None] = [None] * p
        self.records_seen = np.zeros(p, dtype=np.int64)
        self._processing_base_ns = 0
        self._profiler = None
        self._flight = None
        self._explain = None
        self._fleet = None
        self._spans = None
        # facade-level epoch-keyed cache of the TWO-LEVEL result (chips keep
        # their own intra-chip caches too)
        self._gm_cache: dict | None = None
        self.merge_cache_hits = 0
        self.merge_cache_misses = 0
        # the delta plane is intra-chip only; the facade reports zeros so
        # the engine's stats block keeps its shape
        self.merge_delta_merges = 0
        self.merge_delta_rows = 0
        self.last_dirty_fraction: float | None = None
        self.last_tree_info: dict | None = None
        # two-level merge attribution (sharded_stats, the EXPLAIN chips block)
        self.sharded_merges = 0
        self.chips_pruned_total = 0
        self.chips_considered_total = 0
        self.last_chip_info: dict | None = None
        # the chip journals (resilience/chip_wal.py), worker-attached
        self._chip_wal = None
        self._barrier_seq = 0
        # chip fault tolerance: health scores drive quarantine; the
        # deadline-bounded level 1 runs each chip's merge on a watchdog
        # thread serialized by that chip's lock (a PartitionSet is not
        # thread-safe: an abandoned attempt must never interleave with a
        # retry, a later merge, ingest, flush, checkpoint capture or
        # failover on the same group — all of which take the lock too)
        self._health = None
        self._chip_locks = [threading.Lock() for _ in range(chips)]
        self.degraded_merges = 0
        self.failovers = 0
        self.last_failover: dict | None = None
        # the most recent harvest's partial marker (None = full answer); the
        # engine reads it right after the harvest to mark the result
        self.last_partial: dict | None = None

    def _group(self, dev) -> PartitionSet:
        """A ctor-identical ``PartitionSet`` for one chip on ``dev``."""
        with on_device(dev):
            return PartitionSet(
                self.group_size,
                self.dims,
                self.buffer_size,
                initial_capacity=self._initial_capacity,
                flush_policy=self.flush_policy,
                device=dev,
                window_capacity=self._window_capacity,
                overlap_rows=self.overlap_rows,
                tracer=self.tracer,
                counters=self._counters,
            )

    # -- chip addressing ---------------------------------------------------

    @property
    def devices(self) -> list[torch.device]:
        """The device backing each chip index (failover may move one)."""
        return list(self._devices)

    def _dev(self, c: int):
        return on_device(self._devices[c])

    def _loc(self, p: int) -> tuple[int, int]:
        return divmod(p, self.group_size)

    # -- state versioning ----------------------------------------------------

    @property
    def epoch_key(self) -> bytes:
        """Concatenated chip epoch subvectors, ascending chip order — the
        identity of the whole sharded flushed state."""
        return b"".join(c.epoch_key for c in self._chips)

    # -- aggregate bookkeeping -----------------------------------------------

    @property
    def processing_ns(self) -> int:
        return self._processing_base_ns + sum(c.processing_ns for c in self._chips)

    @processing_ns.setter
    def processing_ns(self, v: int) -> None:
        # checkpoint restore re-applies the saved total through here
        for c in self._chips:
            c.processing_ns = 0
        self._processing_base_ns = int(v)

    @property
    def processing_ms(self) -> float:
        return self.processing_ns / 1e6

    @property
    def merge_tree_merges(self) -> int:
        return sum(c.merge_tree_merges for c in self._chips)

    @property
    def merge_partitions_pruned(self) -> int:
        return sum(c.merge_partitions_pruned for c in self._chips)

    @property
    def device_ingest(self) -> bool:
        return False

    @property
    def has_unsynced_ingest(self) -> bool:
        return False

    def sync_ingest_bookkeeping(self) -> None:  # device-ingest only
        return None

    @property
    def pending_rows_total(self) -> int:
        return int(self._pending_rows.sum())

    def _inc(self, name: str, n: int = 1) -> None:
        if self._counters is not None:
            self._counters.inc(name, n)

    # -- observability hooks -------------------------------------------------

    def attach_observability(self, profiler=None, flight=None, fleet=None, spans=None) -> None:
        """The engine's profiler and flight recorder (handed to every
        chip), the fleet plane's per-chip accounting and the span recorder
        for the per-chip tournament spans — host-side bookkeeping only."""
        self._profiler = profiler
        self._flight = flight
        self._fleet = fleet
        self._spans = spans
        for c in self._chips:
            c.attach_observability(profiler=profiler, flight=flight)

    def set_explain(self, plan) -> None:
        self._explain = plan

    def attach_chip_wal(self, plane) -> None:
        """Attach a ``resilience.chip_wal.ChipWalPlane``: per-chip flush
        notes plus the merge-time barrier records crash replay verifies
        group consistency against."""
        self._chip_wal = plane

    def attach_health(self, health) -> None:
        """Attach a ``resilience.health.ChipHealth``: merge outcomes feed its
        scores, and quarantine drives the bounded merge's exclusions and
        ``maybe_failover``."""
        self._health = health

    def _fnote(self, kind: str, **fields) -> None:
        if self._flight is not None:
            self._flight.note(kind, **fields)

    # -- ingest ----------------------------------------------------------------

    def add_batch(self, p: int, values: np.ndarray, max_id: int, now_ms: float) -> None:
        n = values.shape[0]
        if n == 0:
            return
        if self.start_time_ms[p] is None:
            self.start_time_ms[p] = now_ms
        self.max_seen_id[p] = max(self.max_seen_id[p], int(max_id))
        self.records_seen[p] += n
        self._pending_rows[p] += n
        c, lp = self._loc(p)
        if self._fleet is not None:
            self._fleet.note_ingest(c, n)
        # a deadline-abandoned merge attempt may still run inside this
        # chip's lock (_bounded_level1): ingest serializes behind it
        with self._chip_locks[c]:
            self._chips[c].add_batch(lp, values, max_id, now_ms)

    def maybe_flush(self) -> bool:
        """The single-device flush-cadence decision verbatim, over the
        facade-global pending state — then a flush of EVERY chip."""
        if self.flush_policy == "lazy":
            return False
        if self.flush_policy == "overlap":
            if self.pending_rows_total >= self.overlap_rows:
                self.flush_all(tighten=False)
                return True
            return False
        if int(self._pending_rows.max()) >= self.buffer_size:
            self.flush_all()
            return True
        return False

    def flush_all(self, tighten: bool = True) -> None:
        for c, chip in enumerate(self._chips):
            # the chip lock serializes the flush against any abandoned merge
            # attempt still in flight on this group; uncontended when healthy
            with self._chip_locks[c]:
                rows = chip.pending_rows_total
                t0 = time.perf_counter_ns()
                with self._dev(c):
                    chip.flush_all(tighten)
            if self._fleet is not None and rows:
                self._fleet.note_flush(c, rows, (time.perf_counter_ns() - t0) / 1e6)
            if self._chip_wal is not None and rows:
                self._chip_wal.note_flush(c, rows, epoch_hex(chip.epoch_key))
            if self._health is not None and rows:
                # a completed flush proves the chip alive between merges
                self._health.note_heartbeat(c)
        self._pending_rows[:] = 0

    def flush_cascade_stats(self) -> dict:
        docs = []
        for c, chip in enumerate(self._chips):
            with self._dev(c):
                docs.append(chip.flush_cascade_stats())
        seen = sum(d["prefilter_seen"] for d in docs)
        dropped = sum(d["prefilter_dropped"] for d in docs)
        return {
            "prefilter_enabled": docs[0]["prefilter_enabled"],
            "mixed_precision": docs[0]["mixed_precision"],
            "prefilter_seen": seen,
            "prefilter_dropped": dropped,
            "prefilter_drop_fraction": (dropped / seen) if seen else 0.0,
            "bf16_resolved": sum(d["bf16_resolved"] for d in docs),
        }

    # -- two-level tournament merge ------------------------------------------

    def global_merge_stats(self, emit_points: bool = False):
        return self.global_merge_harvest(self.global_merge_launch(emit_points))

    def global_merge_launch(self, emit_points: bool = False) -> _ShardedMergeHandle:
        """Launch the two-level merge. Level 1 (each chip's own merge)
        harvests at once — each chip's stats size its cross-chip leaf — but
        the level-2 pairs and the stats copy stay in flight until
        ``global_merge_harvest``.

        With ``SKYLINE_CHIP_MERGE_DEADLINE_MS`` set each chip's level-1
        merge is deadline-bounded (``_bounded_level1``); a chip that
        exhausts its budget is excluded and the handle carries a
        ``partial`` marker. The degraded answer is the EXACT skyline of the
        surviving chips' records — not a subset of the global skyline: a
        surviving point dominated only by excluded-chip data legitimately
        appears. Every true-skyline point on a surviving chip is present,
        and the missing record mass is bounded by the excluded chips'
        record share."""
        # heal before merging: a quarantined chip's group is re-owned by a
        # healthy chip now, so this merge runs at full strength
        self.maybe_failover()
        h = _ShardedMergeHandle()
        h.emit_points = emit_points
        h.key = self.epoch_key
        h.explain, self._explain = self._explain, None
        h.use_cache = cascade.merge_cache_on(False)
        cache = self._gm_cache if h.use_cache else None
        if cache is not None and cache["key"] == h.key:
            # no chip flushed since this two-level result: no launch and no
            # cross-chip copy
            self.merge_cache_hits += 1
            self._inc("sharded.cache_hit")
            self._fnote("sharded.cache_hit", key=epoch_hex(h.key))
            h.cached = True
            h.result = (
                cache["counts"].copy(), cache["surv"].copy(), cache["g"],
                self._cached_points() if emit_points else None,
            )
            if h.explain is not None:
                h.explain.merge = {
                    "path": "cache_hit", "cached": True, "epoch_key": h.key.hex(),
                    "dirty_fraction": 0.0, "dirty": [],
                    "clean": np.flatnonzero(cache["counts"] > 0).tolist(),
                    "skyline_size": int(cache["g"]),
                }
            return h
        self.merge_cache_misses += 1
        P, C, G, d = self.num_partitions, self.chips, self.group_size, self.dims
        # -- level 1: one merge per chip, on its own device ----------------
        chip_counts: list[np.ndarray] = []
        chip_surv: list[np.ndarray] = []
        chip_g: list[int] = []
        chip_pts: list = []  # (w_c, d) tensor on chip c's device, or None
        chip_summary: list[np.ndarray | None] = []
        want_prune = cascade.gate("chip_prune") and C > 1
        trace_id = h.explain.trace_id if h.explain is not None else None
        deadline_ms = chip_merge_deadline_ms()
        bounded = deadline_ms > 0 and C > 1
        failed: list[dict] = []
        for c, chip in enumerate(self._chips):
            t0 = time.perf_counter_ns()
            if bounded:
                br = self._bounded_level1(c, chip, want_prune, deadline_ms, failed)
                # the winning attempt's own wall (fault latency + merge, no
                # backoff sleeps, hedge waits or failed attempts)
                r, t0, t1 = br if br is not None else (None, t0, t0)
            else:
                fault_point("sharded.chip_merge", chip=c)
                with self._chip_locks[c]:
                    r = self._level1_chip(c, chip, want_prune)
                t1 = time.perf_counter_ns()
            if r is None:
                # excluded from this merge: the group contributes nothing
                chip_counts.append(np.zeros(G, dtype=np.int64))
                chip_surv.append(np.zeros(G, dtype=np.int64))
                chip_g.append(0)
                chip_pts.append(None)
                chip_summary.append(None)
                continue
            counts_c, surv_c, g_c, pts, summary = r
            chip_counts.append(counts_c)
            chip_surv.append(surv_c)
            chip_g.append(g_c)
            chip_pts.append(pts)
            chip_summary.append(summary)
            if self._spans is not None:
                self._spans.record(
                    "chip_merge", t0, t1, trace_id=trace_id, tid=c + 1,
                    args={"chip": c, "level": 1, "skyline": int(g_c)},
                )
            if self._fleet is not None:
                self._fleet.note_level1(c, g_c, (t1 - t0) / 1e6)
            if self._health is not None:
                self._health.note_merge_ok(c, (t1 - t0) / 1e6)
        if failed:
            lost = sum(
                int(self.records_seen[f["chip"] * G : (f["chip"] + 1) * G].sum()) for f in failed
            )
            total = int(self.records_seen.sum())
            h.partial = {
                "excluded_chips": [f["chip"] for f in failed],
                "reasons": [f["reason"] for f in failed],
                "excluded_records": lost,
                # the surviving chips' exact skyline drew on at least this
                # share of every record ingested so far
                "completeness_bound": round((total - lost) / total, 6) if total else 1.0,
            }
            self.degraded_merges += 1
            self._inc("sharded.degraded")
            self._fnote(
                "sharded.degraded", excluded=h.partial["excluded_chips"],
                reasons=h.partial["reasons"], bound=h.partial["completeness_bound"],
            )
        concat_counts = np.concatenate(chip_counts)
        alive = np.array([g > 0 for g in chip_g], dtype=bool)
        considered = int(alive.sum())
        # -- level 2: witness prune over chip summaries --------------------
        pruned = np.zeros(C, dtype=bool)
        witness_of = np.full(C, -1, dtype=np.int64)
        if want_prune and considered > 1:
            rows = [
                chip_summary[c] if chip_summary[c] is not None
                else np.full(2 * d + 2, np.inf, dtype=np.float32)
                for c in range(C)
            ]
            pruned, witness_of = prune_witness_mask(np.stack(rows), alive, d)
        npruned = int(pruned.sum())
        survivors = np.flatnonzero(alive & ~pruned)
        self.sharded_merges += 1
        self.chips_pruned_total += npruned
        self.chips_considered_total += considered
        # register the series at the first merge, not the first prune
        self._inc("sharded.merges")
        self._inc("sharded.chips_pruned", npruned)
        self._fnote("sharded.merge", chips=C, alive=considered, pruned=npruned,
                    survivors=len(survivors))
        if not len(survivors):
            # every chip empty: the zero state needs no kernels
            h.cached = True
            h.result = (
                concat_counts.astype(np.int64), np.zeros(P, dtype=np.int64), 0,
                np.empty((0, d), dtype=np.float32) if emit_points else None,
            )
            self._note_merge_info(h, chip_g, considered, pruned, witness_of, survivors, 0, [0])
            return h
        # -- gather the survivors onto the root device, ascending chip order
        t2 = time.perf_counter_ns()
        root_dev = self._devices[0]
        with on_device(root_dev):
            leaves = []
            for c in survivors:
                g = chip_g[c]
                w = chip_pts[c].shape[0]
                if self._fleet is not None:
                    # the cross-card copy: the padded root ships to chip 0 —
                    # except chip 0's own root, already resident
                    self._fleet.note_level2(c, False, 0 if c == 0 else w)
                (vals,) = gather_to(root_dev, [chip_pts[c]])
                # the chip root carries no partition ids; rebuild them from
                # the per-partition survivor counts (root rows are ascending
                # local partition with per-partition storage order)
                pid_np = np.zeros(w, dtype=np.int64)
                pid_np[:g] = np.repeat(
                    np.arange(G, dtype=np.int64) + c * G, chip_surv[c].astype(np.int64)
                )
                pids = torch.from_numpy(pid_np).to(root_dev)
                cnt = torch.tensor(g, dtype=torch.int64, device=root_dev)
                leaves.append((vals, pids, cnt, g))
            # -- pairwise tournament, adjacent pairs, odd tail passes up ----
            levels = 0
            cand = [len(leaves)]
            nodes = leaves
            while len(nodes) > 1:
                levels += 1
                nxt = []
                for i in range(0, len(nodes) - 1, 2):
                    av, ap, ac, aub = nodes[i]
                    bv, bp, bc, bub = nodes[i + 1]
                    out_cap = _active_bucket(max(aub + bub, 1))
                    vals, pids_out, cnt = tree_pair_merge(av, ap, ac, bv, bp, bc, out_cap)
                    nxt.append((vals, pids_out, cnt, min(aub + bub, out_cap)))
                if len(nodes) % 2:
                    nxt.append(nodes[-1])
                nodes = nxt
                cand.append(len(nodes))
            root_vals, root_pids, root_cnt, _ = nodes[0]
            h.root_vals = root_vals
            counts_dev = torch.from_numpy(concat_counts.astype(np.int64)).to(root_dev)
            h.stats, h.event = to_host_async(
                tree_stats_device(counts_dev, root_pids, root_cnt, P)
            )
        if self._spans is not None:
            # level-2 span: survivor gather + cross-chip pairwise launches
            # (kernels may still be in flight at harvest)
            self._spans.record(
                "cross_chip_merge", t2, time.perf_counter_ns(), trace_id=trace_id, tid=0,
                args={"level": 2, "survivors": len(survivors), "pruned": npruned,
                      "levels": levels},
            )
        self._note_merge_info(h, chip_g, considered, pruned, witness_of, survivors, levels, cand)
        return h

    def _level1_chip(self, c: int, chip: PartitionSet, want_prune: bool):
        """One chip's own merge on its device: harvest the stats, take the
        padded root points and (under the chip prune) the (2d+2) summary
        row. Returns ``(counts, surv, g, pts, summary)``."""
        with self._dev(c):
            ch = chip.global_merge_launch(False)
            counts_c, surv_c, g_c, _ = chip.global_merge_harvest(ch)
            pts = None
            summary = None
            if g_c > 0:
                w = _active_bucket(max(g_c, 1))
                pts = chip.merge_points_device(ch, w)
                if want_prune:
                    # the chip root as a one-partition stack: its (1, 2d+2)
                    # [min_corner | witness | sums] row is the whole
                    # cross-chip prune input
                    cnt = torch.tensor([g_c], dtype=torch.int64, device=pts.device)
                    summary = chip._host(partition_summaries_device(pts[None], cnt, w))[0]
        return counts_c, surv_c, g_c, pts, summary

    def _bounded_level1(self, c: int, chip: PartitionSet, want_prune: bool,
                        deadline_ms: float, failed: list):
        """Deadline-bounded level 1 for one chip: the merge runs on a
        watchdog thread with a per-chip budget, a bounded retry ladder
        (``SKYLINE_CHIP_MERGE_RETRIES`` extra attempts under exponential
        ``SKYLINE_CHIP_MERGE_BACKOFF_MS``) and an optional hedge
        (``SKYLINE_CHIP_HEDGE_MS`` > 0 races a second attempt; the first to
        take the chip's lock computes). Returns ``(level1_tuple, t0_ns,
        t1_ns)`` with the winning attempt's own interval, or None once the
        budget is spent — the chip is left out of THIS answer and
        ChipHealth decides quarantine.

        ``fault_point`` fires OUTSIDE the chip lock (an injected hang parks
        the attempt without wedging the lock), the merge INSIDE it, on the
        chip's card (``_level1_chip`` enters its device: the thread's own
        current device is ``cuda:0``). On a deadline ``done`` is set before
        the exclusion returns, so a still-parked attempt bows out at the
        lock check instead of merging a group the main thread has moved on
        from. An unscoped ``InjectedCrash`` models a process death and
        re-raises; a chip-scoped one counts against the chip."""
        t_end = time.monotonic() + deadline_ms / 1000.0
        retries = chip_merge_retries()
        backoff_s = chip_merge_backoff_ms() / 1000.0
        hedge_s = chip_hedge_ms() / 1000.0
        attempt = 0
        while True:
            done = threading.Event()
            slot: dict = {}

            def run(done=done, slot=slot):
                s0 = time.perf_counter_ns()
                try:
                    fault_point("sharded.chip_merge", chip=c)
                    with self._chip_locks[c]:
                        if done.is_set():
                            return  # a sibling won or the deadline passed
                        r = self._level1_chip(c, chip, want_prune)
                        slot.setdefault("ok", (r, s0, time.perf_counter_ns()))
                        # set before the lock is released, so a hedge waiting
                        # on it bows out instead of merging the group again
                        done.set()
                except BaseException as e:  # InjectedCrash included
                    slot.setdefault("err", e)
                finally:
                    done.set()

            threading.Thread(target=run, daemon=True, name=f"chip{c}-merge-a{attempt}").start()
            remaining = t_end - time.monotonic()
            if hedge_s > 0 and remaining > hedge_s and not done.wait(hedge_s):
                threading.Thread(target=run, daemon=True, name=f"chip{c}-merge-hedge").start()
            finished = done.wait(max(0.0, t_end - time.monotonic()))
            if finished and "ok" in slot:
                return slot["ok"]
            if finished and "err" in slot:
                e = slot["err"]
                if isinstance(e, InjectedCrash) and not e.chip_scoped:
                    raise e  # process death: never absorbed as a chip fault
                attempt += 1
                if attempt <= retries and time.monotonic() + backoff_s < t_end:
                    time.sleep(backoff_s)
                    backoff_s *= 2
                    continue
                reason = f"{type(e).__name__}: {e}"
                if self._health is not None:
                    self._health.note_merge_error(c, reason)
            else:
                # abandon the attempt(s) in flight: a thread still parked at
                # its fault point must see done set at the lock check
                done.set()
                reason = f"deadline {deadline_ms:.0f}ms exceeded"
                if self._health is not None:
                    self._health.note_merge_timeout(c, deadline_ms)
            failed.append({"chip": c, "reason": reason})
            self._fnote("sharded.chip_excluded", chip=c, reason=reason)
            return None

    # -- online partition-group failover -------------------------------------

    def maybe_failover(self) -> list[int]:
        """Re-own every quarantined chip's partition group onto a healthy
        owner (called at merge launch and from worker idle ticks). Returns
        the chips healed. A no-op without an attached ChipHealth, with
        ``SKYLINE_CHIP_FAILOVER=0``, or when nothing is quarantined."""
        if self._health is None or not chip_failover_enabled():
            return []
        quarantined = self._health.quarantined()
        if not quarantined:
            return []
        healed = []
        for c in quarantined:
            owner = next(
                (o for o in range(self.chips) if o != c and not self._health.is_quarantined(o)),
                None,
            )
            if owner is None:
                self._fnote("sharded.failover_stalled", quarantined=quarantined)
                break  # no healthy owner left; stay degraded
            try:
                self.failover(c, owner)
            except TimeoutError:
                # a merge attempt still holds the chip's lock past the
                # bounded wait: capturing now would tear the group's state,
                # so stay degraded and retry at the next launch or tick
                continue
            healed.append(c)
        return healed

    def failover(self, c: int, owner: int | None = None) -> None:
        """Re-own chip ``c``'s partition group on ``owner``'s device — only
        this group's state moves, every other chip keeps serving.

        The group's per-partition state (skylines + pending rows, what a
        checkpoint carries) round-trips through ``audit_state`` into a fresh
        ctor-identical ``PartitionSet`` on the owner's device, and
        ``restore_all``'s byte-faithful contract makes the healed group
        merge byte-identically to an uninterrupted run. The chip journals
        supply the replay window since the last common barrier
        (``failover_window``), recorded in ``last_failover``.

        The capture and swap run under the chip's lock, waited for at most
        ``SKYLINE_CHIP_FAILOVER_LOCK_MS``: past that this raises
        ``TimeoutError`` and ``maybe_failover`` retries on a later tick."""
        if owner is None:
            owner = next(
                (
                    o for o in range(self.chips)
                    if o != c and (self._health is None or not self._health.is_quarantined(o))
                ),
                None,
            )
            if owner is None:
                raise RuntimeError(f"no healthy owner for chip {c}")
        t0 = time.perf_counter_ns()
        window = None
        if self._chip_wal is not None:
            try:
                window = self._chip_wal.failover_window(c)
            except (OSError, ValueError, KeyError):
                window = None  # journal unreadable: heal without the audit
        lock = self._chip_locks[c]
        wait_ms = failover_lock_ms()
        if not lock.acquire(timeout=wait_ms / 1000.0):
            self._inc("sharded.failover_lock_timeouts")
            self._fnote("sharded.failover_lock_timeout", chip=c, wait_ms=wait_ms)
            raise TimeoutError(
                f"chip {c} merge lock still held after {wait_ms:.0f}ms; failover deferred"
            )
        try:
            old = self._chips[c]
            old_epoch = epoch_hex(old.epoch_key)
            with self._dev(c):
                skies, pendings = old.audit_state()
            dev = self._devices[owner]
            grp = self._group(dev)
            with on_device(dev):
                grp.restore_all(skies, pendings)
            self._chips[c] = grp
            self._devices[c] = dev
        finally:
            lock.release()
        grp.attach_observability(profiler=self._profiler, flight=self._flight)
        self._gm_cache = None  # the cached two-level result is stale now
        wall_ms = (time.perf_counter_ns() - t0) / 1e6
        self.failovers += 1
        self.last_failover = {
            "chip": c, "owner": owner, "wall_ms": round(wall_ms, 3), "epoch": old_epoch,
            "wal_window": window,
        }
        self._inc("sharded.failovers")
        self._fnote("sharded.failover", chip=c, owner=owner, wall_ms=round(wall_ms, 3),
                    wal_window=window)
        if self._health is not None:
            self._health.heal(c)

    def _note_merge_info(self, h, chip_g, considered, pruned, witness_of, survivors, levels,
                         cand) -> None:
        """Record the two-level merge's attribution: ``last_chip_info`` for
        /stats, the chips and merge blocks of the riding EXPLAIN plan, and
        the aggregated ``last_tree_info`` the engine's merge_tree block
        reads."""
        C, G = self.chips, self.group_size
        pruned_list = [
            {"chip": int(c), "witness": int(witness_of[c])} for c in np.flatnonzero(pruned)
        ]
        per_chip = []
        for c in range(C):
            lo, hi = c * G, (c + 1) * G
            per_chip.append({
                "chip": c,
                "skyline": int(chip_g[c]),
                "records": int(self.records_seen[lo:hi].sum()),
                "pending": int(self._pending_rows[lo:hi].sum()),
                "pruned": bool(pruned[c]),
            })
        info = {
            "chips": C,
            "group_size": G,
            "alive": considered,
            "pruned": pruned_list,
            "survivors": [int(c) for c in survivors],
            "levels": levels,
            "candidates_per_level": cand,
            "per_chip": per_chip,
        }
        if h.partial is not None:
            info["degraded"] = h.partial
        if self._fleet is not None:
            for c in np.flatnonzero(pruned):
                self._fleet.note_level2(int(c), True, 0)
            imb = self._fleet.note_merge_done()
            info["imbalance"] = {
                "imbalance_index": imb["imbalance_index"],
                "skew_score": imb["skew_score"],
            }
        self.last_chip_info = info
        chip_infos = [c.last_tree_info for c in self._chips]
        intra_pruned = sum(i["partitions_pruned"] for i in chip_infos if i is not None)
        considered_parts = int((np.concatenate([c._count_ub for c in self._chips]) > 0).sum())
        self.last_tree_info = {
            "levels": max((i["levels"] for i in chip_infos if i is not None), default=0) + levels,
            "partitions_pruned": intra_pruned,
            "candidates_per_level": cand,
            "pruned_fraction": intra_pruned / considered_parts if considered_parts else 0.0,
        }
        if h.explain is not None:
            h.explain.merge = {
                "path": "sharded_tree",
                "cached": False,
                "epoch_key": h.key.hex(),
                "dirty_fraction": None,
                "dirty": list(range(self.num_partitions)),
                "clean": [],
            }
            if h.partial is not None:
                h.explain.merge["partial"] = True
            h.explain.chips = info

    def global_merge_harvest(self, handle: _ShardedMergeHandle):
        h = handle
        # the engine reads this right after the harvest: None = full answer,
        # a dict = mark the emitted result and snapshot degraded
        self.last_partial = h.partial
        if h.cached:
            return h.result
        P = self.num_partitions
        with self.tracer.phase("query/global_stats_sync"):
            svec = PartitionSet._landed(h.stats, h.event).astype(np.int64)
        counts = svec[:P].copy()
        surv = svec[P : 2 * P].copy()
        g = int(svec[2 * P])
        if h.explain is not None and h.explain.merge is not None:
            h.explain.merge["skyline_size"] = g
        if self._chip_wal is not None and h.partial is None:
            # a degraded merge never stamps a barrier: barriers certify an
            # ALL-chips consistent cut
            self._barrier_seq += 1
            self._chip_wal.merge_barrier(
                self._barrier_seq,
                epoch_hex(h.key),
                [epoch_hex(c.epoch_key) for c in self._chips],
                [int(x) for x in counts.reshape(self.chips, self.group_size).sum(axis=1)],
            )
        pts = None
        root = self._devices[0]
        if h.use_cache and h.partial is None:
            gcap = 2 * _next_pow2(max(g, 1))
            with on_device(root):
                pts_dev = tree_points_device(h.root_vals, gcap)
            self._gm_cache = {
                "key": h.key, "counts": counts.copy(), "surv": surv.copy(), "g": g,
                "pts_dev": pts_dev, "pts_host": None,
            }
            if h.emit_points:
                pts = self._cached_points()
        elif h.emit_points:
            out_cap = _next_pow2(max(g, 1))
            with self.tracer.phase("query/points_transfer"), on_device(root):
                pts = PartitionSet._host(tree_points_device(h.root_vals, out_cap))[:g].copy()
        return counts, surv, g, pts

    def _cached_points(self) -> np.ndarray:
        c = self._gm_cache
        if c["pts_host"] is None:
            with self.tracer.phase("query/points_transfer"):
                c["pts_host"] = PartitionSet._host(c["pts_dev"])[: c["g"]].copy()
        return c["pts_host"].copy()

    def merge_points_device(self, handle: _ShardedMergeHandle, out_cap: int) -> torch.Tensor:
        """Device buffer (on chip 0's device) of a harvested two-level
        merge's points, ``(out_cap, d)``, +inf past the true count — the
        ``PartitionSet.merge_points_device`` contract. Valid between a
        harvest and the next flush; prefers the facade cache buffer when it
        describes the handle's epoch."""
        h = handle
        cache = self._gm_cache
        if cache is not None and cache["key"] == h.key:
            pts = cache["pts_dev"]
            if pts.shape[0] >= out_cap:
                return pts[:out_cap]
            return tree_points_device(pts, out_cap)
        return tree_points_device(h.root_vals, out_cap)

    # -- snapshots / audit / checkpoint --------------------------------------

    def sky_counts(self) -> np.ndarray:
        out = []
        for c, chip in enumerate(self._chips):
            with self._dev(c):
                out.append(chip.sky_counts())
        return np.concatenate(out)

    def snapshot(self, p: int) -> np.ndarray:
        # flush ALL chips (cadence parity with the single-device set, whose
        # snapshot() flushes every partition), then read one
        self.flush_all()
        t0 = time.perf_counter_ns()
        c, lp = self._loc(p)
        with self._dev(c):
            out = self._chips[c].skyline_host(lp)
        self._processing_base_ns += time.perf_counter_ns() - t0
        return out

    def skyline_host(self, p: int) -> np.ndarray:
        c, lp = self._loc(p)
        with self._dev(c):
            return self._chips[c].skyline_host(lp)

    def pending_rows_of(self, p: int) -> np.ndarray:
        c, lp = self._loc(p)
        return self._chips[c].pending_rows_of(lp)

    def audit_state(self) -> tuple[list[np.ndarray], list[np.ndarray]]:
        skies: list[np.ndarray] = []
        pendings: list[np.ndarray] = []
        for c, chip in enumerate(self._chips):
            # serialized against any abandoned merge attempt on this group
            with self._chip_locks[c], self._dev(c):
                s, pd = chip.audit_state()
            skies.extend(s)
            pendings.extend(pd)
        return skies, pendings

    def restore_all(self, skies: list[np.ndarray], pendings: list[np.ndarray]) -> None:
        assert len(skies) == len(pendings) == self.num_partitions
        G = self.group_size
        for c, chip in enumerate(self._chips):
            with self._chip_locks[c], self._dev(c):
                chip.restore_all(skies[c * G : (c + 1) * G], pendings[c * G : (c + 1) * G])
        self.max_seen_id[:] = -1
        self.start_time_ms = [None] * self.num_partitions
        self.records_seen[:] = 0
        self._processing_base_ns = 0
        for p, pending in enumerate(pendings):
            self._pending_rows[p] = pending.shape[0]
        self._gm_cache = None

    # -- stats ---------------------------------------------------------------

    def sharded_stats(self) -> dict:
        out = {
            "chips": self.chips,
            "group_size": self.group_size,
            "merges": self.sharded_merges,
            "chips_pruned": self.chips_pruned_total,
            "chips_considered": self.chips_considered_total,
            "pruned_chip_fraction": (
                self.chips_pruned_total / self.chips_considered_total
                if self.chips_considered_total else 0.0
            ),
            "cache": {"hits": self.merge_cache_hits, "misses": self.merge_cache_misses},
            "devices": [str(d) for d in self._devices],
            "last": self.last_chip_info,
            "degraded_merges": self.degraded_merges,
            "failovers": self.failovers,
            "last_failover": self.last_failover,
        }
        if self._fleet is not None:
            out["fleet"] = self._fleet.doc()
        if self._chip_wal is not None:
            out["chip_wal"] = self._chip_wal.stats()
        if self._health is not None:
            out["health"] = self._health.doc()
        return out


class ShardedEngine(SkylineEngine):
    """``SkylineEngine`` with the partition set sharded into per-chip groups
    and queries answered by the two-level tournament. Drop-in: same config,
    same wire results, same serving and audit planes — the published
    skyline is byte-identical to the single-device engine's. The groups go
    over the visible cards unless ``config.device`` is ``"cpu"``."""

    def __init__(self, config, chips: int, tracer=None, telemetry=None):
        if config.ingest == "device":
            raise ValueError(
                "ingest='device' is single-device only; the sharded engine routes on host"
            )
        self.mesh_chips = int(chips)
        super().__init__(config, tracer=tracer, telemetry=telemetry)
        fleet = None
        if telemetry is not None and fleet_enabled():
            from skyline_tpu_torch.telemetry.fleet import FleetStats

            fleet = FleetStats(self.mesh_chips, flight=telemetry.flight)
            # on the hub: both HTTP surfaces serve /fleet and the
            # skyline_chip_*{chip=...} families from there
            telemetry.fleet = fleet
        self.pset.attach_observability(
            profiler=self.profiler,
            flight=telemetry.flight if telemetry is not None else None,
            fleet=fleet,
            spans=telemetry.spans if telemetry is not None else None,
        )
        # chip fault tolerance: merge outcomes feed the scores, quarantine
        # drives exclusion and online failover; the hub's reference serves
        # the /health chip block
        from skyline_tpu_torch.resilience.health import ChipHealth

        self.health = ChipHealth(self.mesh_chips, telemetry=telemetry)
        self.pset.attach_health(self.health)
        if telemetry is not None:
            telemetry.health = self.health

    def _make_pset(self, config, telemetry, use_device: bool) -> ShardedPartitionSet:
        return ShardedPartitionSet(
            config.num_partitions,
            config.dims,
            config.buffer_size,
            chips=self.mesh_chips,
            initial_capacity=config.initial_capacity,
            tracer=self.tracer,
            flush_policy=config.flush_policy,
            overlap_rows=config.overlap_rows,
            window_capacity=config.window_capacity,
            counters=telemetry.counters if telemetry is not None else None,
            device=self.device,
        )

    def _sync_devices(self) -> None:
        for dev in dict.fromkeys(self.pset.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def stats(self, include_skyline_counts: bool = False) -> dict:
        out = super().stats(include_skyline_counts)
        out["sharded"] = self.pset.sharded_stats()
        return out

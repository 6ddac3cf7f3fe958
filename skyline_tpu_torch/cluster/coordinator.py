"""Multi-host partitioned ingest + the host-level tournament coordinator.

Counterpart of ``skyline_tpu/cluster/coordinator.py``.
``ClusterPartitionSet`` is the sharded facade's pattern applied one level
up: host ``h`` owns the contiguous global partitions ``[h*G, (h+1)*G)`` with
``G = P / hosts``, and each member is a full engine-grade partition set of
its own — a ``ShardedPartitionSet`` when ``chips_per_host > 1`` (so a
cluster query is a THREE-level tournament: partitions → chips → hosts) or a
flat ``PartitionSet`` at one chip. Members expose the same merge surface
(``global_merge_launch`` / ``global_merge_harvest`` /
``merge_points_device``), which is what makes the host level a dozen lines
of reuse instead of a new merge. The hosts are in-process members, as in the
reference.

Placement: flat members sit on the engine's device; a sharded member maps
its chip ``c`` to ``cuda:c % n`` over the visible cards
(``parallel/chips.py``), or keeps every chip on the CPU. The host ladder
runs on the root device — the engine's own, ``cuda:0`` by default — and
each surviving member root is copied there before its pair.

Byte contract: the cluster answer is byte-identical (rows AND order) to the
flat single-host merge for every host count × chip count × flush policy,
because (a) members are contiguous in pid, (b) each member root is already
canonical over its own pids, and (c) ``tree_pair_merge``'s stable
compaction preserves (pid, storage-row) order at the host level exactly as
it does at the chip level. Flush cadence is facade-global for the same
reason it is in the sharded set — flush points are part of the byte
contract under the lazy policy.

Elastic rebalance: ``migrate(h)`` drains host ``h``, captures its slice
through ``audit_state`` (the checkpoint currency), rebuilds the member —
possibly at a DIFFERENT chip count — and restores byte-faithfully via
``restore_all``; ``checkpoint_slice``/``restore_slice`` do the same through
an on-disk npz (the reference's format) so a group checkpointed on host A
restores on host B. In-process, swapping the member object already fences
the source (no pid routes to it afterwards); the cross-process write fence
is the lease plane's job (``cluster/lease.py``). Migrations are budgeted
(``SKYLINE_CLUSTER_MIGRATION_BUDGET``) so a flapping health signal cannot
thrash state between hosts forever.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib

import numpy as np
import torch

from skyline_tpu_torch.cluster.merge import host_leaf, prune_hosts, tournament
from skyline_tpu_torch.distributed.sharded import ShardedPartitionSet, epoch_hex, on_device
from skyline_tpu_torch.metrics.tracing import NULL_TRACER
from skyline_tpu_torch.ops import cascade
from skyline_tpu_torch.stream.batched import PartitionSet, to_host_async
from skyline_tpu_torch.stream.engine import SkylineEngine
from skyline_tpu_torch.stream.window import (
    DEFAULT_BUFFER_SIZE,
    _next_pow2,
    tree_points_device,
    tree_stats_device,
)
from skyline_tpu_torch.utils.devices import resolve_device


def _migration_budget() -> int:
    from skyline_tpu_torch.utils.knobs import env_int

    return env_int("SKYLINE_CLUSTER_MIGRATION_BUDGET", 8)


class _ClusterMergeHandle:
    """An in-flight three-level merge (host level async until harvest)."""

    __slots__ = (
        "key", "emit_points", "use_cache", "cached", "result", "stats", "event",
        "root_vals", "explain", "host_info", "partial",
    )

    def __init__(self):
        self.cached = False
        self.result = None
        self.stats = None
        self.event = None
        self.root_vals = None
        self.explain = None
        self.host_info = None
        self.partial = None

    def ready(self) -> bool:
        """True once the harvest would not wait."""
        return self.cached or self.event is None or self.event.query()


class ClusterPartitionSet:
    """Facade with the ``PartitionSet`` surface over per-host members.

    Global partition ``p`` lives on host ``p // group_size`` at local
    index ``p % group_size``. Flush-cadence bookkeeping is facade-global
    (the byte contract), and each member keeps its own chip-level
    machinery — witness summaries, merge caches, epoch subvectors —
    untouched.
    """

    def __init__(
        self,
        num_partitions: int,
        dims: int,
        buffer_size: int = DEFAULT_BUFFER_SIZE,
        *,
        hosts: int,
        chips_per_host: int = 1,
        initial_capacity: int = 0,
        tracer=None,
        flush_policy: str = "incremental",
        overlap_rows: int = 262144,
        window_capacity: int = 0,
        counters=None,
        device="cuda",
    ):
        """``device``: ``"cuda"`` (the default) puts flat members on the
        card (``cuda:0`` unless an index is given) and spreads a sharded
        member's chips over the visible cards; ``"cpu"`` keeps every member
        on the CPU."""
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        if num_partitions % hosts:
            raise ValueError(
                f"num_partitions {num_partitions} must be divisible by "
                f"hosts {hosts}"
            )
        group = num_partitions // hosts
        if chips_per_host < 1:
            raise ValueError(
                f"chips_per_host must be >= 1, got {chips_per_host}"
            )
        if chips_per_host > 1 and group % chips_per_host:
            raise ValueError(
                f"per-host group size {group} must be divisible by "
                f"chips_per_host {chips_per_host}"
            )
        self.num_partitions = num_partitions
        self.dims = dims
        self.buffer_size = buffer_size
        self.hosts = hosts
        self.group_size = group
        self.chips_per_host = chips_per_host
        self.flush_policy = flush_policy
        self.overlap_rows = overlap_rows
        self._initial_capacity = initial_capacity
        self._window_capacity = window_capacity
        self.mesh = None
        self.tracer = tracer if tracer is not None else NULL_TRACER
        root = resolve_device(device)
        if root.type == "cuda" and root.index is None:
            root = torch.device("cuda", 0)
        # the host ladder's device, and every flat member's
        self._root = root
        self._counters = counters
        self._members = [self._build_member(chips_per_host) for _ in range(hosts)]
        self._member_chips = [chips_per_host] * hosts
        p = num_partitions
        # facade-global bookkeeping: identical flush-cadence inputs to the
        # single-device set (members keep their own mirrors)
        self._pending_rows = np.zeros(p, dtype=np.int64)
        self.max_seen_id = np.full(p, -1, dtype=np.int64)
        self.start_time_ms: list[float | None] = [None] * p
        self.records_seen = np.zeros(p, dtype=np.int64)
        self._processing_base_ns = 0
        self._profiler = None
        self._flight = None
        self._explain = None
        self._spans = None
        self._gm_cache: dict | None = None
        self.merge_cache_hits = 0
        self.merge_cache_misses = 0
        # shape parity with the engine's stats block (delta plane is
        # member-internal, the facade reports zeros)
        self.merge_delta_merges = 0
        self.merge_delta_rows = 0
        self.last_dirty_fraction: float | None = None
        self.last_tree_info: dict | None = None
        # host-level attribution
        self.cluster_merges = 0
        self.hosts_pruned_total = 0
        self.hosts_considered_total = 0
        self.rows_shipped_total = 0
        self.rows_saved_total = 0
        self.last_host_info: dict | None = None
        self.last_partial: dict | None = None
        # elastic rebalance
        self._host_locks = [threading.Lock() for _ in range(hosts)]
        self._health = None
        self._opslog = None
        self.migrations = 0
        self.last_migration: dict | None = None
        self.fenced_sources = 0

    def _build_member(self, chips: int):
        if chips > 1:
            return ShardedPartitionSet(
                self.group_size,
                self.dims,
                self.buffer_size,
                chips=chips,
                initial_capacity=self._initial_capacity,
                tracer=self.tracer,
                flush_policy=self.flush_policy,
                overlap_rows=self.overlap_rows,
                window_capacity=self._window_capacity,
                counters=self._counters,
                device=self._root.type,
            )
        with on_device(self._root):
            return PartitionSet(
                self.group_size,
                self.dims,
                self.buffer_size,
                initial_capacity=self._initial_capacity,
                tracer=self.tracer,
                flush_policy=self.flush_policy,
                overlap_rows=self.overlap_rows,
                window_capacity=self._window_capacity,
                counters=self._counters,
                device=self._root,
            )

    # -- host addressing -----------------------------------------------------

    @property
    def devices(self) -> list[torch.device]:
        """Every device a member's state lives on, each once, the root
        first (a sharded member's chips, a flat member's device)."""
        out = [self._root]
        for m in self._members:
            for dev in (m.devices if hasattr(m, "devices") else [m.device]):
                if dev not in out:
                    out.append(dev)
        return out

    @property
    def root_device(self) -> torch.device:
        """The device the host ladder runs on and the answer lands on."""
        return self._root

    def _loc(self, p: int) -> tuple[int, int]:
        return divmod(p, self.group_size)

    # -- state versioning ------------------------------------------------------

    @property
    def epoch_key(self) -> bytes:
        return b"".join(m.epoch_key for m in self._members)

    # -- aggregate bookkeeping -------------------------------------------------

    @property
    def processing_ns(self) -> int:
        return self._processing_base_ns + sum(
            m.processing_ns for m in self._members
        )

    @processing_ns.setter
    def processing_ns(self, v: int) -> None:
        for m in self._members:
            m.processing_ns = 0
        self._processing_base_ns = int(v)

    @property
    def processing_ms(self) -> float:
        return self.processing_ns / 1e6

    @property
    def merge_tree_merges(self) -> int:
        return sum(m.merge_tree_merges for m in self._members)

    @property
    def merge_partitions_pruned(self) -> int:
        return sum(m.merge_partitions_pruned for m in self._members)

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

    def _fnote(self, kind: str, **fields) -> None:
        if self._flight is not None:
            self._flight.note(kind, **fields)

    # -- observability hooks ---------------------------------------------------

    def attach_observability(
        self, profiler=None, flight=None, fleet=None, spans=None
    ) -> None:
        self._profiler = profiler
        self._flight = flight
        self._spans = spans
        for m in self._members:
            m.attach_observability(profiler=profiler, flight=flight)

    def set_explain(self, plan) -> None:
        self._explain = plan

    def attach_chip_wal(self, plane) -> None:
        """Chip-WAL barriers are member-internal in a cluster (each host
        journals its own groups); the facade-level consistency story is
        the lease/fence plane plus barrier records in the main WAL."""
        return None

    def attach_health(self, health) -> None:
        """Attach a host-level health supervisor (the ``ChipHealth``
        scorer reused with host indices): quarantine decisions drive
        ``maybe_failover``'s live migrations."""
        self._health = health

    def attach_opslog(self, opslog) -> None:
        """Attach the durable cross-process ops journal (RUNBOOK §2s):
        host migrations and failovers become journal records beside the
        flight-ring notes."""
        self._opslog = opslog

    # -- ingest ----------------------------------------------------------------

    def add_batch(
        self, p: int, values: np.ndarray, max_id: int, now_ms: float
    ) -> None:
        n = values.shape[0]
        if n == 0:
            return
        if self.start_time_ms[p] is None:
            self.start_time_ms[p] = now_ms
        self.max_seen_id[p] = max(self.max_seen_id[p], int(max_id))
        self.records_seen[p] += n
        self._pending_rows[p] += n
        h, lp = self._loc(p)
        with self._host_locks[h]:
            self._members[h].add_batch(lp, values, max_id, now_ms)

    def maybe_flush(self) -> bool:
        """The single-device flush-cadence decision verbatim over the
        facade-global pending state, then a flush of EVERY host."""
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
        for h, m in enumerate(self._members):
            with self._host_locks[h]:
                m.flush_all(tighten)
        self._pending_rows[:] = 0

    def flush_cascade_stats(self) -> dict:
        docs = [m.flush_cascade_stats() for m in self._members]
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

    # -- three-level tournament merge ------------------------------------------

    def global_merge_stats(self, emit_points: bool = False):
        return self.global_merge_harvest(self.global_merge_launch(emit_points))

    def global_merge_launch(self, emit_points: bool = False):
        """Launch the cluster merge: per-host leaves harvest synchronously
        (each host's own two-level merge), the host witness prune decides
        who ships, and the host-level pairwise ladder + packed stats stay
        in flight until ``global_merge_harvest``."""
        self.maybe_failover()
        h = _ClusterMergeHandle()
        h.emit_points = emit_points
        h.key = self.epoch_key
        h.explain, self._explain = self._explain, None
        use_cache = cascade.merge_cache_on(False)
        h.use_cache = use_cache
        cache = self._gm_cache if use_cache else None
        if cache is not None and cache["key"] == h.key:
            self.merge_cache_hits += 1
            self._inc("cluster.cache_hit")
            h.cached = True
            h.result = (
                cache["counts"].copy(),
                cache["surv"].copy(),
                cache["g"],
                self._cached_points() if emit_points else None,
            )
            if h.explain is not None:
                h.explain.merge = {
                    "path": "cache_hit",
                    "cached": True,
                    "epoch_key": h.key.hex(),
                    "dirty_fraction": 0.0,
                    "dirty": [],
                    "clean": np.flatnonzero(cache["counts"] > 0).tolist(),
                    "skyline_size": int(cache["g"]),
                }
            return h
        self.merge_cache_misses += 1
        P, H, G, d = self.num_partitions, self.hosts, self.group_size, self.dims
        want_prune = cascade.gate("host_prune") and H > 1
        trace_id = h.explain.trace_id if h.explain is not None else None
        host_counts: list[np.ndarray] = []
        host_surv: list[np.ndarray] = []
        host_g: list[int] = []
        host_pts: list = []
        host_summary: list[np.ndarray | None] = []
        for hst, member in enumerate(self._members):
            t0 = time.perf_counter_ns()
            with self._host_locks[hst]:
                counts_h, surv_h, g_h, pts, summary = host_leaf(
                    member, want_prune
                )
            t1 = time.perf_counter_ns()
            host_counts.append(counts_h)
            host_surv.append(surv_h)
            host_g.append(g_h)
            host_pts.append(pts)
            host_summary.append(summary)
            if self._spans is not None:
                self._spans.record(
                    "host_merge", t0, t1, trace_id=trace_id, tid=hst + 1,
                    args={"host": hst, "level": "host", "skyline": int(g_h)},
                )
            if self._health is not None:
                self._health.note_merge_ok(hst, (t1 - t0) / 1e6)
        concat_counts = np.concatenate(host_counts)
        alive = np.array([g > 0 for g in host_g], dtype=bool)
        considered = int(alive.sum())
        pruned = np.zeros(H, dtype=bool)
        witness_of = np.full(H, -1, dtype=np.int64)
        if want_prune and considered > 1:
            pruned, witness_of = prune_hosts(host_summary, alive, d)
        npruned = int(pruned.sum())
        survivors = np.flatnonzero(alive & ~pruned)
        self.cluster_merges += 1
        self.hosts_pruned_total += npruned
        self.hosts_considered_total += considered
        self._inc("cluster.merges")
        self._inc("cluster.hosts_pruned", npruned)
        self._fnote(
            "cluster.merge", hosts=H, alive=considered, pruned=npruned,
            survivors=len(survivors),
        )
        if not len(survivors):
            h.cached = True
            h.result = (
                concat_counts.astype(np.int64),
                np.zeros(P, dtype=np.int64),
                0,
                np.empty((0, d), dtype=np.float32) if emit_points else None,
            )
            self._note_merge_info(
                h, host_g, considered, pruned, witness_of, survivors,
                0, [0], 0, 0,
            )
            return h
        # interconnect accounting: a pruned or empty host ships ZERO rows;
        # each survivor ships its padded root once (host 0's is resident)
        shipped = saved = 0
        leaves = []
        root_dev = self._root
        for hst in survivors:
            g = host_g[hst]
            w = host_pts[hst].shape[0]
            if hst != 0:
                shipped += w
            pid_np = np.zeros(w, dtype=np.int64)
            pid_np[:g] = np.repeat(
                np.arange(G, dtype=np.int64) + hst * G,
                host_surv[hst].astype(np.int64),
            )
            leaves.append((host_pts[hst], pid_np, g))
        for hst in np.flatnonzero(pruned):
            saved += host_pts[hst].shape[0]
        self.rows_shipped_total += shipped
        self.rows_saved_total += saved
        t2 = time.perf_counter_ns()
        root_vals, root_pids, root_cnt, levels, cand = tournament(
            leaves, root_dev
        )
        h.root_vals = root_vals
        with on_device(root_dev):
            counts_dev = torch.from_numpy(concat_counts.astype(np.int64)).to(root_dev)
            h.stats, h.event = to_host_async(
                tree_stats_device(counts_dev, root_pids, root_cnt, P)
            )
        if self._spans is not None:
            self._spans.record(
                "cross_host_merge", t2, time.perf_counter_ns(),
                trace_id=trace_id, tid=0,
                args={"level": "cluster", "survivors": len(survivors),
                      "pruned": npruned, "levels": levels},
            )
        self._note_merge_info(
            h, host_g, considered, pruned, witness_of, survivors, levels,
            cand, shipped, saved,
        )
        return h

    def _note_merge_info(
        self, h, host_g, considered, pruned, witness_of, survivors, levels,
        cand, shipped, saved,
    ) -> None:
        H, G = self.hosts, self.group_size
        pruned_list = [
            {"host": int(c), "witness": int(witness_of[c])}
            for c in np.flatnonzero(pruned)
        ]
        per_host = []
        for hst in range(H):
            lo, hi = hst * G, (hst + 1) * G
            per_host.append({
                "host": hst,
                "chips": self._member_chips[hst],
                "skyline": int(host_g[hst]),
                "records": int(self.records_seen[lo:hi].sum()),
                "pending": int(self._pending_rows[lo:hi].sum()),
                "pruned": bool(pruned[hst]),
            })
        info = {
            "hosts": H,
            "group_size": G,
            "alive": considered,
            "pruned": pruned_list,
            "survivors": [int(c) for c in survivors],
            "levels": levels,
            "candidates_per_level": cand,
            "rows_shipped": int(shipped),
            "rows_saved": int(saved),
            "per_host": per_host,
        }
        self.last_host_info = info
        member_infos = [m.last_tree_info for m in self._members]
        intra_pruned = sum(
            i["partitions_pruned"] for i in member_infos if i is not None
        )
        self.last_tree_info = {
            "levels": max(
                (i["levels"] for i in member_infos if i is not None),
                default=0,
            ) + levels,
            "partitions_pruned": intra_pruned,
            "candidates_per_level": cand,
            "pruned_fraction": (
                intra_pruned / self.num_partitions
                if self.num_partitions else 0.0
            ),
        }
        if h.explain is not None:
            h.explain.merge = {
                "path": "cluster_tree",
                "cached": False,
                "epoch_key": h.key.hex(),
                "dirty_fraction": None,
                "dirty": list(range(self.num_partitions)),
                "clean": [],
            }
            h.explain.hosts = info

    def global_merge_harvest(self, handle):
        h = handle
        self.last_partial = h.partial
        if h.cached:
            return h.result
        P = self.num_partitions
        with self.tracer.phase("query/global_stats_sync"):
            svec = PartitionSet._landed(h.stats, h.event).astype(np.int64)
        counts = svec[:P].copy()
        surv = svec[P: 2 * P].copy()
        g = int(svec[2 * P])
        if h.explain is not None and h.explain.merge is not None:
            h.explain.merge["skyline_size"] = g
        pts = None
        if h.use_cache:
            gcap = 2 * _next_pow2(max(g, 1))
            with on_device(self._root):
                pts_dev = tree_points_device(h.root_vals, gcap)
            self._gm_cache = {
                "key": h.key,
                "counts": counts.copy(),
                "surv": surv.copy(),
                "g": g,
                "pts_dev": pts_dev,
                "pts_host": None,
            }
            if h.emit_points:
                pts = self._cached_points()
        elif h.emit_points:
            out_cap = _next_pow2(max(g, 1))
            with self.tracer.phase("query/points_transfer"), on_device(self._root):
                pts = PartitionSet._host(tree_points_device(h.root_vals, out_cap))[:g].copy()
        return counts, surv, g, pts

    def _cached_points(self) -> np.ndarray:
        c = self._gm_cache
        if c["pts_host"] is None:
            with self.tracer.phase("query/points_transfer"):
                c["pts_host"] = PartitionSet._host(c["pts_dev"])[: c["g"]].copy()
        return c["pts_host"].copy()

    def merge_points_device(self, handle: _ClusterMergeHandle, out_cap: int) -> torch.Tensor:
        """Device buffer (on the root device) of a harvested cluster
        merge's points, ``(out_cap, d)``, +inf past the true count — the
        ``PartitionSet.merge_points_device`` contract."""
        cache = self._gm_cache
        if cache is not None and cache["key"] == handle.key:
            pts = cache["pts_dev"]
            if pts.shape[0] >= out_cap:
                return pts[:out_cap]
            return tree_points_device(pts, out_cap)
        return tree_points_device(handle.root_vals, out_cap)

    # -- elastic rebalance -----------------------------------------------------

    def maybe_failover(self) -> list[int]:
        """Live-migrate every quarantined host's partition group onto
        fresh state (called at merge-launch entry and from worker idle
        ticks — the same hook discipline as chip failover). Returns the
        hosts migrated. No-op without an attached health supervisor."""
        if self._health is None:
            return []
        quarantined = self._health.quarantined()
        if not quarantined:
            return []
        healed = []
        for hst in quarantined:
            try:
                self.migrate(hst, reason="quarantined")
            except RuntimeError:
                self._fnote(
                    "cluster.migration_budget_exhausted", host=hst,
                    budget=_migration_budget(),
                )
                break
            self._health.heal(hst)
            healed.append(hst)
        return healed

    def migrate(
        self, hst: int, *, chips: int | None = None, reason: str = "manual"
    ) -> dict:
        """Drain → capture slice → restore on a fresh member (possibly at
        a different chip count) → fence the source. The slice currency is
        ``audit_state``/``restore_all`` — the byte-faithful checkpoint
        contract — so the next answer after a migration is byte-identical
        to an unmigrated run. Budgeted: raises ``RuntimeError`` once
        ``SKYLINE_CLUSTER_MIGRATION_BUDGET`` is spent."""
        if not 0 <= hst < self.hosts:
            raise ValueError(f"host {hst} out of range 0..{self.hosts - 1}")
        budget = _migration_budget()
        if self.migrations >= budget:
            raise RuntimeError(
                f"migration budget exhausted ({budget}); raise "
                "SKYLINE_CLUSTER_MIGRATION_BUDGET to allow more"
            )
        target_chips = self._member_chips[hst] if chips is None else int(chips)
        if target_chips > 1 and self.group_size % target_chips:
            raise ValueError(
                f"group size {self.group_size} not divisible by "
                f"chips {target_chips}"
            )
        t0 = time.perf_counter_ns()
        with self._host_locks[hst]:
            old = self._members[hst]
            old.flush_all()  # drain: pending rows fold into the skylines
            source_epoch = epoch_hex(old.epoch_key)
            skies, pendings = old.audit_state()
            grp = self._build_member(target_chips)
            grp.restore_all(skies, pendings)
            self._members[hst] = grp
            self._member_chips[hst] = target_chips
            # the drain folded this group's pending rows into its skylines;
            # the facade-global cadence inputs must agree with the member or
            # the next maybe_flush fires early — a flush-cadence deviation
            # the byte contract counts as observable
            for i, pd in enumerate(pendings):
                self._pending_rows[hst * self.group_size + i] = pd.shape[0]
        grp.attach_observability(profiler=self._profiler, flight=self._flight)
        self._gm_cache = None
        # the source member is unroutable the instant the swap lands; the
        # counter records that the old incarnation was deliberately fenced,
        # not leaked
        self.fenced_sources += 1
        self.migrations += 1
        wall_ms = (time.perf_counter_ns() - t0) / 1e6
        doc = {
            "host": hst,
            "chips": target_chips,
            "reason": reason,
            "wall_ms": round(wall_ms, 3),
            "source_epoch": source_epoch,
            "source_fenced": True,
        }
        self.last_migration = doc
        self._inc("cluster.migrations")
        self._fnote("cluster.migration", **doc)
        if self._opslog is not None:
            self._opslog.record("host_migrated", **doc)
        return doc

    def checkpoint_slice(self, hst: int, path: str) -> None:
        """Persist host ``hst``'s partition-group slice (post-drain) as a
        torn-proof npz: the portable half of a cross-host migration."""
        with self._host_locks[hst]:
            member = self._members[hst]
            member.flush_all()
            skies, pendings = member.audit_state()
        arrays: dict = {}
        for i, (s, pd) in enumerate(zip(skies, pendings)):
            arrays[f"sky_{i}"] = s
            arrays[f"pending_{i}"] = pd
        meta = {
            "host": hst,
            "group_size": self.group_size,
            "dims": self.dims,
        }
        crc = zlib.crc32(json.dumps(meta, sort_keys=True).encode())
        for k in sorted(arrays):
            crc = zlib.crc32(np.ascontiguousarray(arrays[k]).tobytes(), crc)
        meta["crc32"] = crc
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                __meta__=np.frombuffer(
                    json.dumps(meta).encode(), dtype=np.uint8
                ),
                **arrays,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def restore_slice(
        self, hst: int, path: str, *, chips: int | None = None
    ) -> dict:
        """Restore a slice written by ``checkpoint_slice`` into host
        ``hst`` — at a possibly different chip count — and fence the
        member it replaces. Counts against the migration budget."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            if meta["group_size"] != self.group_size or meta["dims"] != self.dims:
                raise ValueError(
                    f"slice shape mismatch: checkpoint is "
                    f"{meta['group_size']}x{meta['dims']}, facade group is "
                    f"{self.group_size}x{self.dims}"
                )
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            scrubbed = {k: v for k, v in meta.items() if k != "crc32"}
            crc = zlib.crc32(json.dumps(scrubbed, sort_keys=True).encode())
            for k in sorted(arrays):
                crc = zlib.crc32(
                    np.ascontiguousarray(arrays[k]).tobytes(), crc
                )
            if crc != meta["crc32"]:
                raise ValueError(f"slice CRC mismatch in {path}")
            skies = [arrays[f"sky_{i}"] for i in range(self.group_size)]
            pendings = [
                arrays[f"pending_{i}"] for i in range(self.group_size)
            ]
        budget = _migration_budget()
        if self.migrations >= budget:
            raise RuntimeError(
                f"migration budget exhausted ({budget}); raise "
                "SKYLINE_CLUSTER_MIGRATION_BUDGET to allow more"
            )
        target_chips = self._member_chips[hst] if chips is None else int(chips)
        with self._host_locks[hst]:
            old = self._members[hst]
            source_epoch = epoch_hex(old.epoch_key)
            grp = self._build_member(target_chips)
            grp.restore_all(skies, pendings)
            self._members[hst] = grp
            self._member_chips[hst] = target_chips
            # facade-global pending bookkeeping tracks the restored slice
            # (checkpoint_slice drains first, so these are zeros), not the
            # replaced member's stale counts
            for i, pd in enumerate(pendings):
                self._pending_rows[hst * self.group_size + i] = pd.shape[0]
        grp.attach_observability(profiler=self._profiler, flight=self._flight)
        self._gm_cache = None
        self.fenced_sources += 1
        self.migrations += 1
        doc = {
            "host": hst,
            "chips": target_chips,
            "reason": "restore_slice",
            "from": path,
            "source_epoch": source_epoch,
            "source_fenced": True,
        }
        self.last_migration = doc
        self._inc("cluster.migrations")
        return doc

    # -- snapshots / audit / checkpoint ----------------------------------------

    def sky_counts(self) -> np.ndarray:
        return np.concatenate([m.sky_counts() for m in self._members])

    def snapshot(self, p: int) -> np.ndarray:
        self.flush_all()
        t0 = time.perf_counter_ns()
        h, lp = self._loc(p)
        out = self._members[h].skyline_host(lp)
        self._processing_base_ns += time.perf_counter_ns() - t0
        return out

    def skyline_host(self, p: int) -> np.ndarray:
        h, lp = self._loc(p)
        return self._members[h].skyline_host(lp)

    def pending_rows_of(self, p: int) -> np.ndarray:
        h, lp = self._loc(p)
        return self._members[h].pending_rows_of(lp)

    def audit_state(self) -> tuple[list[np.ndarray], list[np.ndarray]]:
        skies: list[np.ndarray] = []
        pendings: list[np.ndarray] = []
        for h, m in enumerate(self._members):
            with self._host_locks[h]:
                s, pd = m.audit_state()
            skies.extend(s)
            pendings.extend(pd)
        return skies, pendings

    def restore_all(
        self, skies: list[np.ndarray], pendings: list[np.ndarray]
    ) -> None:
        assert len(skies) == len(pendings) == self.num_partitions
        G = self.group_size
        for h, m in enumerate(self._members):
            with self._host_locks[h]:
                m.restore_all(
                    skies[h * G: (h + 1) * G],
                    pendings[h * G: (h + 1) * G],
                )
        self.max_seen_id[:] = -1
        self.start_time_ms = [None] * self.num_partitions
        self.records_seen[:] = 0
        self._processing_base_ns = 0
        for p, pending in enumerate(pendings):
            self._pending_rows[p] = pending.shape[0]
        self._gm_cache = None

    # -- stats -----------------------------------------------------------------

    def cluster_stats(self) -> dict:
        considered = self.hosts_considered_total
        shipped, saved = self.rows_shipped_total, self.rows_saved_total
        out = {
            "hosts": self.hosts,
            "group_size": self.group_size,
            "chips_per_host": list(self._member_chips),
            "merges": self.cluster_merges,
            "hosts_pruned": self.hosts_pruned_total,
            "hosts_considered": considered,
            "host_pruned_fraction": (
                self.hosts_pruned_total / considered if considered else 0.0
            ),
            "rows_shipped": shipped,
            "rows_saved": saved,
            "ship_saved_fraction": (
                saved / (shipped + saved) if (shipped + saved) else 0.0
            ),
            "cache": {
                "hits": self.merge_cache_hits,
                "misses": self.merge_cache_misses,
            },
            "last": self.last_host_info,
            "migrations": self.migrations,
            "migration_budget": _migration_budget(),
            "fenced_sources": self.fenced_sources,
            "last_migration": self.last_migration,
        }
        if self._health is not None:
            out["health"] = self._health.doc()
        return out


class ClusterEngine(SkylineEngine):
    """``SkylineEngine`` over the multi-host facade: same config, same wire
    results, same serving and audit planes — the published skyline is
    byte-identical to the single-host engine's at every host count. The
    members go on the card unless ``config.device`` is ``"cpu"``."""

    def __init__(
        self, config, hosts: int, chips_per_host: int = 1, tracer=None,
        telemetry=None,
    ):
        if config.ingest == "device":
            raise ValueError(
                "ingest='device' is single-device only; the cluster "
                "engine routes on host"
            )
        self.cluster_hosts = int(hosts)
        self.chips_per_host = int(chips_per_host)
        super().__init__(config, tracer=tracer, telemetry=telemetry)
        self.pset.attach_observability(
            profiler=self.profiler,
            flight=telemetry.flight if telemetry is not None else None,
            spans=telemetry.spans if telemetry is not None else None,
        )
        # host-level health: the chip scorer generalizes — indices are
        # hosts here, and quarantine drives live migration instead of
        # chip failover
        from skyline_tpu_torch.resilience.health import ChipHealth

        self.host_health = ChipHealth(self.cluster_hosts)
        self.pset.attach_health(self.host_health)
        if telemetry is not None:
            from skyline_tpu_torch.cluster.lease import ClusterStatus

            status = getattr(telemetry, "cluster", None)
            if status is None:
                status = ClusterStatus(node_id=f"coordinator-{os.getpid()}")
                telemetry.cluster = status
            status.coordinator_cb = self.pset.cluster_stats
            status.telemetry = telemetry

    def _make_pset(self, config, telemetry, use_device: bool) -> ClusterPartitionSet:
        return ClusterPartitionSet(
            config.num_partitions,
            config.dims,
            config.buffer_size,
            hosts=self.cluster_hosts,
            chips_per_host=self.chips_per_host,
            initial_capacity=config.initial_capacity,
            tracer=self.tracer,
            flush_policy=config.flush_policy,
            overlap_rows=config.overlap_rows,
            window_capacity=config.window_capacity,
            counters=telemetry.counters if telemetry is not None else None,
            device=self.device,
        )

    def _sync_devices(self) -> None:
        for dev in self.pset.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def stats(self, include_skyline_counts: bool = False) -> dict:
        out = super().stats(include_skyline_counts)
        out["cluster"] = self.pset.cluster_stats()
        return out

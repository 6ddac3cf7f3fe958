"""Stacked partition-set state: all logical partitions' skylines in one
``(P, cap, d)`` device buffer.

Counterpart of ``skyline_tpu/stream/batched.py`` on one device, with host
or device ingest. The semantics are SkylineLocalProcessor's state model
(FlinkSkyline.java:214-445), under one of three flush policies:

- ``"incremental"`` (the default, as in the reference): once the largest
  partition's pending rows reach ``buffer_size`` (the processBuffer
  cadence, FlinkSkyline.java:232), every partition's pending rows merge
  into its running skyline, one batched merge step per round
  (``stream/window.py`` ``merge_step_active``, three K2 passes on a card).
- ``"lazy"``: pending rows accumulate until a query-time flush streams each
  partition's sum-sorted window through append-only SFS rounds
  (``ops/sfs.py``) — one batched round for balanced loads, per-partition
  rounds under routing skew — then prunes old rows against new ones.
- ``"overlap"``: the lazy machinery with automatic flushes every
  ``overlap_rows`` pending rows; on the device window those flushes read
  no exact counts (``tighten=False``): had-old detection and buckets come
  from the host upper bounds.

At d <= 2 every policy's flush is one sort-and-sweep over the old
skylines and all pending rows (``ops/sweep2d.py``, ``_flush_sweep``): no
pairwise work and no dominance kernel. The three policies give the same
answers (the merge law), though rows sit in different orders: merge order
(incremental), sum order (lazy/overlap SFS appends) or (partition, x, y)
order (the sweep) — each the reference's order for the same policy.

Host ingest (``add_batch``) keeps routed rows per partition on the host and
assembles and uploads each block. Device ingest (``route=...``,
``ingest_chunk``) uploads raw chunks once and routes, sorts and slices
blocks on the device (``stream/device_window.py``); with
``SKYLINE_RANK_CASCADE`` on, its rounds and cleanup compare dense ranks
(K4–K7).

The global merge is the reference's default plane (``global_merge_launch``
and ``global_merge_harvest``): every flush advances the epochs of the
partitions it changes; a merge over an unchanged epoch vector is an exact
hit of the epoch-keyed cache, one over few dirty partitions a delta merge
against the cached global skyline, and at d > 2 a merge runs as a pruned
tournament tree (a witness prefilter, then pairs of partition skylines,
two K2 passes a pair on a card); ``SKYLINE_MERGE_TREE=0`` gives the flat
pass (one K3 or K7), ``SKYLINE_MERGE_CACHE=0`` a full merge at every
trigger. Every path gives the same answer bytes.

The flush dominance cascade is the reference's too, both stages exact:
(1) the quantized-grid prefilter (``SKYLINE_FLUSH_PREFILTER``, on at d >= 3)
drops pending host rows whose grid cell a representative cell of their
partition's skyline strictly dominates, before any merge kernel — the grid
summary is launched at each flush tail and copied to pinned memory behind a
CUDA event; (2) the mixed-precision passes (``SKYLINE_MIXED_PRECISION``, on
by default on a card, off on the CPU) — the bf16 row pre-drop ahead of each
SFS and merge round, and K1–K3 counted as their ``mp`` launches (on a card
the f32 compare kernel either way).
``flush_cascade_stats`` reports both stages' counters.

The host-ingest lazy flush races its paths as the reference's does
(``_choose_lazy_path``, ``ops/cascade.py`` ``resolve_flush``): under
``auto`` the SFS rounds against the host sorted cascade on the CPU, and
against the device sorted cascade on a card, each whole flush timed under
its path's signature and the least EMA wins once each has run;
``SKYLINE_SORTED_SFS`` and ``SKYLINE_DEVICE_CASCADE`` force or exclude a
path. The merge plane's and the prefilter's gates read through the cascade
table, so a tuner override acts where the environment leaves a knob unset.

Observability (``attach_observability``, ``set_explain``, ``tracer`` and
``counters``) is the reference's: every dispatch the reference wraps in a
``flush/merge_kernel`` phase is timed under its profiler signature (variant,
d, N-bucket, backend, mp; ``stream/window.py`` ``KERNEL_VARIANTS``), the
flight recorder keeps the flush, cascade, prune and cache decisions, the
counters sink gets the ``merge.*`` and ``flush.*`` counts, and a parked
EXPLAIN plan rides the merge handle from launch to harvest. All of it is
host-side bookkeeping around work already queued: the answers are the same
with it or without.

``merge_points_device`` hands a harvested merge's points to the sharded
engine's cross-chip level on the device (``distributed/sharded.py``). Every
device-side step names its device (``self.device``), so a set placed on
``cuda:1`` by the sharded engine never touches the current device's stream
or memory.

With a ``mesh`` (``parallel/mesh.py``) the partitions split over the places
of its first axis, P/n contiguous each, as the reference shards them: the
state lives on the first place's device, and each flush step runs every
place's partitions on that place's device (``stream/window.py``
``meshed_*``: one batched call for each run of places on one device, so a
mesh on one card steps as a flat set does; over several devices each
keeps its partitions' slice between steps, and reading ``sky`` gathers).
The reference's gates for a mesh hold: no device ingest, no d <= 2
sweep, no sequential SFS variant, no flush race, no grid prefilter, and
no merge cache or tree (the engine merges a meshed set's partials by the
sharded two-phase).

Per-partition CPU attribution follows the reference: flush wall time is
accounted to the set, and every partition reports the set total as its
``processing_ms``.
"""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from skyline_tpu_torch.metrics.tracing import NULL_TRACER
from skyline_tpu_torch.ops import cascade
from skyline_tpu_torch.ops.device_cascade import device_cascade_keep
from skyline_tpu_torch.ops.sfs import sfs_cleanup, sfs_round, sfs_round_single
from skyline_tpu_torch.ops.sorted_sfs import sorted_sfs_keep
from skyline_tpu_torch.ops.sweep2d import partitioned_sweep2_core, scatter_sweep2
from skyline_tpu_torch.parallel.mesh import Placed
from skyline_tpu_torch.resilience.faults import fault_point
from skyline_tpu_torch.stream import device_window as dw
from skyline_tpu_torch.stream.window import (
    DEFAULT_BUFFER_SIZE,
    GRID_BINS,
    _MIN_CAP,
    _active_bucket,
    _next_pow2,
    extract_cached_leaf,
    extract_sky_leaf,
    global_merge_delta_device,
    global_merge_stats_device,
    global_points_device,
    grid_summary_device,
    merge_step_active,
    meshed_merge_step,
    meshed_sfs_cleanup,
    meshed_sfs_round,
    partition_summaries_device,
    prune_witness_mask,
    tree_pair_merge,
    tree_points_device,
    tree_stats_device,
)
from skyline_tpu_torch.utils.devices import resolve_device, upload_async
from skyline_tpu_torch.telemetry.profiler import KernelProfiler
from skyline_tpu_torch.utils.knobs import (
    flush_stage_depth,
    mixed_precision_enabled,
    profile_cost_enabled,
)

# Sequential-SFS probe block: rounds start at this size so a small-skyline
# partition never pays big-block dominance work; the loop escalates to the
# row-scaled block once a round's surviving count exceeds half a block.
_PROBE_B = 8192

# Device-ingest chunks are split and padded to power-of-two buckets capped
# here.
_CHUNK_BUCKET_MAX = 65536

# Host rows per step of the grid prefilter's cell coding: the (chunk,
# GRID_REPS, d) comparison stays ~10 MB at d = 8 whatever the pending window.
_PREFILTER_CHUNK = 16384


def _codes(ladder: np.ndarray, y: np.ndarray) -> np.ndarray:
    """``#(ladder <= y)`` for each value of ``y`` (m,) f32 against one
    dimension's ladder (GRID_BINS + 1,) f32 — the reference's cell code
    plus one; 0 for NaN. An estimate from the ladder's span, moved a step
    up or down, kept where ``ladder[c - 1] <= y < ladder[c]`` holds (a
    binary search for the few rows it does not settle): the count for a strictly
    increasing ladder, and some value in [0, GRID_BINS + 1] for any other
    (whose dimension never certifies)."""
    n = ladder.shape[0]
    pad = np.concatenate([[-np.inf], ladder, [np.inf]]).astype(np.float32)
    with np.errstate(all="ignore"):
        est = (y - ladder[0]) * np.float32((n - 1) / (ladder[-1] - ladder[0]))
        est = np.nan_to_num(np.clip(est, -1.0, n - 1), nan=-1.0)
    c = np.floor(est).astype(np.int64) + 1
    c = np.minimum(c + (pad[c + 1] <= y), n)
    c = np.maximum(c - (pad[c] > y), 0)
    settled = (pad[c] <= y) & (y < pad[c + 1])
    nan = np.isnan(y)
    rest = ~settled & ~nan
    if rest.any():
        c[rest] = np.searchsorted(ladder, y[rest], side="right")
    c[nan] = 0
    return c


def grid_drop(bounds: np.ndarray, ux: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The grid prefilter's test for one partition: (m,) bool, True where
    some representative's cell code is below row y's in every dimension.
    bounds (GRID_BINS + 1, d) is the partition's ladder, ux (R, d) the
    representatives' codes (R <= 64; GRID_BINS + 1 never certifies), y
    (m, d) the pending rows.

    The reference's test, computed another way: y's code in a dimension is
    ``vy = #(bounds <= y) - 1`` (``_codes``; -1 for NaN), and ``masks[v +
    1, k]`` holds one bit per representative with ``ux[r, k] < v``, so a
    row is dropped iff the AND of its d masks is not 0 — d lookups a row in
    place of an (R, d) comparison. In a dimension whose ladder failed the
    host check every code is GRID_BINS + 1, its masks are 0 and the row's
    code there does not matter."""
    yt = np.ascontiguousarray(np.asarray(y, np.float32).T)  # one dimension a row
    R, d = ux.shape
    bit = np.left_shift(np.uint64(1), np.arange(R, dtype=np.uint64))
    levels = np.arange(-1, GRID_BINS + 1)[:, None, None]  # v = -1 .. GRID_BINS
    masks = np.bitwise_or.reduce(
        np.where(ux[None, :, :] < levels, bit[None, :, None], np.uint64(0)), axis=1
    )  # (GRID_BINS + 2, d)
    acc = np.full(yt.shape[1], ~np.uint64(0))
    for k in range(d):
        acc &= masks[_codes(bounds[:, k], yt[k]), k]
    return acc != 0


def to_host_async(t: torch.Tensor):
    """Queue a copy of ``t`` to host memory: (host tensor, event) on a card
    — a ``non_blocking`` copy into pinned memory (a pageable copy would
    wait) on ``t``'s device's current stream, with an event recorded on
    that stream after it — or (t, None) on the CPU, where it is already
    there. Nothing here reads the current device, so a tensor on
    ``cuda:1`` is waited for on its own card."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.device(t.device):
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
    return host, event


class _MergeHandle:
    """An in-flight global merge: every kernel queued, nothing waited for.

    Made by ``PartitionSet.global_merge_launch`` and consumed once by
    ``global_merge_harvest``. It keeps the launch-time epoch, so the harvest
    knows whether flushes landed in between. ``stats`` is a host tensor (in
    pinned memory on a card) that ``event`` marks as landed."""

    __slots__ = (
        "key", "epoch", "emit_points", "use_cache", "cached", "result", "stats",
        "event", "union", "keep", "root_vals", "dirty", "clean_total", "explain",
    )

    def __init__(self):
        self.explain = None
        self.cached = False
        self.result = None
        self.stats = None
        self.event = None
        self.union = None
        self.keep = None
        self.root_vals = None
        self.dirty = None
        self.clean_total = 0

    def ready(self) -> bool:
        """True once the harvest would not wait: a cache hit, a merge on the
        CPU (computed at launch), or a card whose stats copy has landed."""
        return self.cached or self.event is None or self.event.query()


class PartitionSet:
    """Device-stacked state for ``num_partitions`` logical partitions."""

    def __init__(
        self,
        num_partitions: int,
        dims: int,
        buffer_size: int = DEFAULT_BUFFER_SIZE,
        initial_capacity: int = 0,
        flush_policy: str = "incremental",
        device="cuda",
        route: tuple[str, float] | None = None,
        window_capacity: int = 0,
        overlap_rows: int = 262144,
        tracer=None,
        counters=None,
        profiler=None,
        flight=None,
        mesh=None,
    ):
        """``initial_capacity``: pre-size the per-partition skyline buffers
        (rounded up to the power-of-two bucket) so a workload that knows
        its steady-state skyline size skips every growth step.

        ``flush_policy``: ``"incremental"`` (default), ``"lazy"`` or
        ``"overlap"`` (see the module docstring); ``overlap_rows`` is the
        overlap policy's automatic flush threshold.

        ``device``: where the skylines live and the kernels run; ``"cuda"``
        unless the caller asks for ``"cpu"`` (the plain PyTorch path).

        ``route``: ``(algo, domain_max)`` enables DEVICE ingest for the
        lazy and overlap policies: raw chunks are uploaded as they arrive
        and partition routing, the flush-time (pid, sum) sort and SFS block
        slicing run on the device (``ingest_chunk``,
        stream/device_window.py). ``None`` keeps host routing (the engine
        routes and calls ``add_batch``).

        ``window_capacity``: expected rows per window (0 = unknown); pre-sizes
        the device-ingest window so a full window never reallocates.

        ``tracer``: a ``metrics.tracing.Tracer`` timing the reference's
        phases (``flush/assemble``, ``flush/device_put``,
        ``flush/merge_kernel``, ``flush/prefilter``, ``flush/sweep``,
        ``flush/sort``, ``flush/rank``, ``ingest/bookkeeping_sync``,
        ``query/global_stats_sync``, ``query/points_transfer``,
        ``query/count_sync``, ``query/snapshot_transfer``); with
        ``sync_device`` each ``flush/merge_kernel`` phase waits for the card.
        ``counters``: a ``metrics.collector.Counters``-like sink
        (``inc(name, n)``) for the merge plane's and the flush cascade's
        counts. ``profiler`` and ``flight``: see
        ``attach_observability``.

        ``mesh``: a ``parallel.mesh.Mesh`` whose first axis the partitions
        split over (``num_partitions`` a multiple of its extent); the state
        then lives on that axis's first place, whatever ``device`` says."""
        if flush_policy not in ("incremental", "lazy", "overlap"):
            raise ValueError(f"unknown flush_policy {flush_policy!r}")
        if route is not None and (mesh is not None or flush_policy == "incremental"):
            raise ValueError(
                "device ingest (route=...) requires a single-device lazy/overlap "
                "PartitionSet"
            )
        self.mesh = mesh
        if mesh is not None:
            # the first axis carries the partitions; other axes replicate
            self._axis = mesh.axis_names[0]
            n_axis = int(mesh.shape[self._axis])
            if num_partitions % n_axis:
                raise ValueError(
                    f"num_partitions {num_partitions} must be divisible by "
                    f"mesh axis {self._axis!r} size {n_axis}"
                )
            device = mesh.axis_places(self._axis)[0]
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.num_partitions = num_partitions
        self.dims = dims
        self.buffer_size = buffer_size
        self.initial_capacity = initial_capacity
        self.overlap_rows = overlap_rows
        self.flush_policy = flush_policy
        self._route = route
        self.window_capacity = window_capacity
        # device-ingest accumulation state (route is not None)
        self._dev_window: torch.Tensor | None = None  # (dev_cap, d), +inf padded
        self._dev_pids: torch.Tensor | None = None  # (dev_cap,) int32, sentinel P
        self._dev_cap = 0
        self._dev_rows = 0  # valid rows accumulated
        # per-chunk (stats (2, P) on the device, now_ms) awaiting a host
        # bookkeeping sync: only a query barrier or a trigger needs them
        self._chunk_stats: list[tuple] = []
        p = num_partitions
        # pending micro-batch rows awaiting a flush, per partition
        self._pending: list[list[np.ndarray]] = [[] for _ in range(p)]
        self._pending_rows = np.zeros(p, dtype=np.int64)
        # stacked running skylines: (P, cap, d), rows >= count are +inf
        self._cap = _next_pow2(max(initial_capacity, _MIN_CAP))
        self._sky_parts = None
        self.sky = torch.full(
            (p, self._cap, dims), float("inf"), dtype=torch.float32,
            device=self.device,
        )
        # survivor counts: device vector (exact, read lazily) + host upper
        # bounds (drive capacity growth WITHOUT per-flush syncs)
        self._count_dev = torch.zeros(p, dtype=torch.int64, device=self.device)
        self._count_ub = np.zeros(p, dtype=np.int64)
        # barrier + metrics bookkeeping (FlinkSkyline.java:243-248, 267)
        self.max_seen_id = np.full(p, -1, dtype=np.int64)
        self.start_time_ms: list[float | None] = [None] * p
        self.records_seen = np.zeros(p, dtype=np.int64)
        self.processing_ns: int = 0  # set-wide (see module docstring)
        # host copies of device state, invalidated by flush/load
        self._counts_cache: np.ndarray | None = None
        self._host_cache: np.ndarray | None = None
        # set by a flush: the next merge first syncs exact counts, which
        # tighten its buckets
        self._tighten_pending = False
        # the flushed state's version: a per-partition epoch, bumped by every
        # flush that merges rows into the partition (and by load_state); the
        # merge cache keys on it
        self._epoch = np.zeros(p, dtype=np.int64)
        # the epoch-keyed merge cache: {key, epoch, counts, surv, g, pts_dev,
        # pts_host}
        self._gm_cache: dict | None = None
        self.merge_cache_hits = 0
        self.merge_cache_misses = 0
        self.merge_delta_merges = 0
        self.merge_delta_rows = 0
        self.last_dirty_fraction: float | None = None
        # the tree's prune summaries, (host tensor, event) of a (P, 2d+2)
        # tensor queued at flush tails, and the epoch they describe
        self._summary: tuple | None = None
        self._summary_epoch: np.ndarray | None = None
        self.merge_tree_merges = 0
        self.merge_partitions_pruned = 0
        self.last_tree_info: dict | None = None
        # the last prefilter's witness per partition (-1: not pruned)
        self.last_prune_witness: np.ndarray | None = None
        # the flush cascade. Stage 1, the grid prefilter: the (bounds, cell
        # codes) summary queued at flush tails as ((host tensor, event),
        # (host tensor, event)), its validated host copy and the epoch it
        # describes; a stale summary is sound (a removed skyline row leaves a
        # strict dominator behind), a replaced world is not (load_state).
        # Stage 2, mixed precision: a running device int32 of bf16-certified
        # drops, read only by flush_cascade_stats.
        self._grid = None
        self._grid_host = None
        self._grid_epoch: np.ndarray | None = None
        self.prefilter_seen = 0
        self.prefilter_dropped = 0
        self._mp_resolved: torch.Tensor | None = None
        self.bf16_resolved = 0
        # the bf16 total already fed to the counters sink
        self._bf16_resolved_reported = 0
        # observability (attach_observability, set_explain): the engine's
        # kernel profiler and flight recorder, and the one-shot EXPLAIN plan
        # the next global_merge_launch claims onto its handle
        self._counters = counters
        self._profiler = None
        self._flight = None
        self._explain = None
        self.attach_observability(profiler, flight)
        # the lazy flush's path race (``_choose_lazy_path``): the profiler
        # its whole-flush walls land in, made when a race is first in play,
        # and the flushes each path took
        self._flush_prof: KernelProfiler | None = None
        self.flush_paths: dict[str, int] = {}

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # -- the stacked state ------------------------------------------------

    @property
    def sky(self) -> torch.Tensor:
        """The stacked (P, cap, d) skyline buffers on ``self.device``. A
        meshed set whose places span several devices keeps each device's
        partitions there between flush steps (``_sky_parts``, a ``Placed``);
        reading ``sky`` gathers them here, and the next meshed step splits
        the state again."""
        if self._sky_parts is not None:
            self._sky, self._sky_parts = self._sky_parts.gather(self.device), None
        return self._sky

    @sky.setter
    def sky(self, value) -> None:
        if isinstance(value, Placed):
            whole = value.on(self.device)
            if whole is None:
                self._sky, self._sky_parts = None, value
                return
            value = whole
        self._sky, self._sky_parts = value, None

    def _step_state(self):
        """The state as a flush step takes it: the resident ``Placed``
        slices a meshed step left, else the stacked tensor (a meshed step
        splits it)."""
        return self._sky_parts if self._sky_parts is not None else self._sky

    # -- observability hooks ------------------------------------------------

    def _inc(self, name: str, n: int = 1) -> None:
        if self._counters is not None:
            self._counters.inc(name, n)

    def _fnote(self, kind: str, **fields) -> None:
        if self._flight is not None:
            self._flight.note(kind, **fields)

    def attach_observability(self, profiler=None, flight=None) -> None:
        """Attach a ``telemetry.profiler.KernelProfiler`` and/or a
        ``FlightRecorder``. The profiler times every ``flush/merge_kernel``
        dispatch under its signature and is shared with the mask dispatch
        (``ops/dispatch.py`` ``register_profiler``); the flight recorder
        keeps the last flush, cascade, prune and cache decisions."""
        self._profiler = profiler
        self._flight = flight
        if profiler is not None:
            from skyline_tpu_torch.ops.dispatch import register_profiler

            register_profiler(profiler)

    def set_explain(self, plan) -> None:
        """Park the current query's ``QueryPlan`` for the next
        ``global_merge_launch`` to claim (None clears)."""
        self._explain = plan

    def _kernel(self, variant: str, n: int, mp: bool = False, cost_thunk=None):
        """The profiler's record of one merge-kernel dispatch, under the
        set's device type (a null context without a profiler)."""
        if self._profiler is None:
            return nullcontext()
        return self._profiler.record(
            variant, self.dims, n, mp=mp, backend=self.device.type,
            cost_thunk=cost_thunk,
        )

    @contextmanager
    def _merge_kernel(self, variant: str, n: int, mp: bool = False, cost_thunk=None):
        """One dispatch in the ``flush/merge_kernel`` phase under its profiler
        signature; a tracer with ``sync_device`` waits for the card inside
        both, so the phase holds the dispatch's device time."""
        with self.tracer.phase("flush/merge_kernel"), self._kernel(
            variant, n, mp, cost_thunk
        ):
            yield
            if self.tracer.sync_device and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _merge_cost_thunk(self, batch_dev, bvalid_dev, active, out_active, mp):
        """The merge step's cost at this dispatch's shapes
        (``SKYLINE_PROFILE_COST``), reckoned as the kernel bounds are: every
        pair of its three K2 passes (batch against itself, batch against
        the ``active`` skyline rows and back) compares d values; the bytes
        read the skyline prefix and the batch with their validity once and
        write the ``out_active`` rows, their validity and the counts once.
        Shapes are captured now, the numbers made on the profiler's first
        call of the signature."""
        P, B, d = batch_dev.shape
        A = int(active)

        def thunk():
            pairs = P * (B * B + 2 * B * A)
            moved = P * ((A + B) * (4 * d + 1) + int(out_active) * (4 * d + 1) + 8)
            return {"flops": float(pairs * d), "bytes_accessed": float(moved)}

        return thunk

    def _put_async(self, arr: np.ndarray) -> torch.Tensor:
        return upload_async(arr, self.device)

    # -- state versioning -------------------------------------------------

    @property
    def epoch(self) -> np.ndarray:
        """Per-partition flush epochs (monotone)."""
        return self._epoch

    @property
    def epoch_key(self) -> bytes:
        """The identity of the flushed state: equal keys mean no flush
        touched any partition in between."""
        return self._epoch.tobytes()

    def _bump_epoch(self, which) -> None:
        """Advance the epochs of the partitions in ``which`` (indices, a
        boolean mask or a slice): those a flush is about to change."""
        self._epoch[which] += 1

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        """A host copy that never aliases a CPU tensor's storage (the host
        bounds are written in place)."""
        return t.to("cpu", copy=True).numpy()

    # -- ingest -----------------------------------------------------------

    def add_batch(
        self, p: int, values: np.ndarray, max_id: int, now_ms: float
    ) -> None:
        """Buffer a routed micro-batch for partition ``p`` until the next
        flush."""
        n = values.shape[0]
        if n == 0:
            return
        if self.start_time_ms[p] is None:
            self.start_time_ms[p] = now_ms
        self.max_seen_id[p] = max(self.max_seen_id[p], int(max_id))
        self.records_seen[p] += n
        self._pending[p].append(values)
        self._pending_rows[p] += n

    @property
    def device_ingest(self) -> bool:
        return self._route is not None

    @property
    def has_unsynced_ingest(self) -> bool:
        return bool(self._chunk_stats)

    @property
    def pending_rows_total(self) -> int:
        """Un-flushed rows across both ingest paths."""
        return int(self._pending_rows.sum()) + self._dev_rows

    def _put_padded(self, arr: np.ndarray, rows: int, fill) -> torch.Tensor:
        """Upload ``arr`` padded with ``fill`` to ``rows`` leading rows."""
        if arr.shape[0] != rows:
            padded = np.full((rows, *arr.shape[1:]), fill, dtype=arr.dtype)
            padded[: arr.shape[0]] = arr
            arr = padded
        return self._put(np.ascontiguousarray(arr))

    def ingest_chunk(self, ids: np.ndarray, values: np.ndarray, now_ms: float) -> None:
        """Device-ingest twin of route-then-``add_batch``: upload one raw
        micro-batch, compute its partition ids and per-partition barrier
        stats on the device and append it to the accumulated window. The
        host barrier/metrics bookkeeping is synced lazily
        (``sync_ingest_bookkeeping``), so pure ingest never waits on the
        device."""
        n = values.shape[0]
        if n == 0:
            return
        algo, domain_max = self._route
        ids = np.asarray(ids)
        if int(ids.max()) >= 2**31:
            raise ValueError(
                "device ingest tracks record ids as int32; ids >= 2^31 "
                "need the host ingest path"
            )
        for s in range(0, n, _CHUNK_BUCKET_MAX):
            chunk = np.asarray(values[s : s + _CHUNK_BUCKET_MAX], dtype=np.float32)
            m = chunk.shape[0]
            bucket = _next_pow2(m)
            self._ensure_dev_capacity(self._dev_rows + bucket)
            stats = dw.ingest_chunk(
                self._dev_window,
                self._dev_pids,
                self._put_padded(chunk, bucket, np.inf),
                self._put_padded(
                    ids[s : s + _CHUNK_BUCKET_MAX].astype(np.int32), bucket, -1
                ),
                m,
                self._dev_rows,
                algo=algo,
                num_partitions=self.num_partitions,
                domain_max=domain_max,
            )
            self._dev_rows += m
            self._chunk_stats.append((stats, now_ms))

    def _ensure_dev_capacity(self, need: int) -> None:
        """Allocate or double the device accumulation buffers. ``need``
        includes the incoming chunk's padded bucket, so its write stays in
        bounds."""
        if self._dev_window is None:
            # pre-size so a full expected window (plus the last chunk's
            # padded bucket) never reallocates
            hint = (
                _next_pow2(self.window_capacity + _CHUNK_BUCKET_MAX)
                if self.window_capacity
                else 0
            )
            self._dev_cap = max(_next_pow2(need), hint, 131072)
            self._dev_window = torch.full(
                (self._dev_cap, self.dims), float("inf"), dtype=torch.float32,
                device=self.device,
            )
            self._dev_pids = torch.full(
                (self._dev_cap,), self.num_partitions, dtype=torch.int32,
                device=self.device,
            )
            return
        while self._dev_cap < need:
            grow = self._dev_cap
            self._dev_window = torch.cat([
                self._dev_window,
                torch.full((grow, self.dims), float("inf"), dtype=torch.float32,
                           device=self.device),
            ])
            self._dev_pids = torch.cat([
                self._dev_pids,
                torch.full((grow,), self.num_partitions, dtype=torch.int32,
                           device=self.device),
            ])
            self._dev_cap += grow

    def sync_ingest_bookkeeping(self) -> None:
        """Fold the queued per-chunk device stats into the host barrier and
        metrics state (max_seen_id, records_seen, start_time_ms) — one small
        transfer for all queued chunks; called before any barrier check,
        never on the pure-ingest path."""
        if not self._chunk_stats:
            return
        with self.tracer.phase("ingest/bookkeeping_sync"):
            stats = self._host(torch.stack([s for s, _ in self._chunk_stats]))
            for s, (_, now_ms) in zip(stats.astype(np.int64), self._chunk_stats):
                counts, maxids = s[0], s[1]
                got = counts > 0
                self.records_seen[got] += counts[got]
                np.maximum(self.max_seen_id, np.where(got, maxids, -1), out=self.max_seen_id)
                for p in np.nonzero(got)[0]:
                    if self.start_time_ms[p] is None:
                        self.start_time_ms[p] = now_ms
        self._chunk_stats = []

    def _drain_pending(self) -> list[np.ndarray]:
        """Move every partition's pending micro-batches out as one (m, d)
        array per partition (empty partitions get (0, d)), clearing the
        pending state."""
        rows = [
            (
                self._pending[p][0]
                if len(self._pending[p]) == 1
                else np.concatenate(self._pending[p], axis=0)
            )
            if self._pending[p]
            else np.empty((0, self.dims), dtype=np.float32)
            for p in range(self.num_partitions)
        ]
        self._pending = [[] for _ in range(self.num_partitions)]
        self._pending_rows[:] = 0
        return rows

    def _pad_block(self, part_rows: np.ndarray, B: int):
        """Pad one partition's (w, d) rows to a (B, d) +inf block +
        validity mask."""
        w = part_rows.shape[0]
        block = np.full((B, self.dims), np.inf, dtype=np.float32)
        block[:w] = part_rows
        return block, np.arange(B) < w, w

    def _round_batch(self, rows: list[np.ndarray], rnd: int, B: int):
        """Assemble round ``rnd``'s (P, B, d) padded batch + validity +
        per-partition widths from the drained ``rows``."""
        batch = np.full(
            (self.num_partitions, B, self.dims), np.inf, dtype=np.float32
        )
        bvalid = np.zeros((self.num_partitions, B), dtype=bool)
        widths = np.zeros(self.num_partitions, dtype=np.int64)
        for p, r in enumerate(rows):
            part_rows = r[rnd * B : (rnd + 1) * B]
            if part_rows.shape[0]:
                batch[p], bvalid[p], widths[p] = self._pad_block(part_rows, B)
        return batch, bvalid, widths

    # -- flush ----------------------------------------------------------------

    def maybe_flush(self) -> bool:
        """Flush all partitions once the largest pending buffer reaches
        ``buffer_size`` (the processBuffer threshold, FlinkSkyline.java:232,
        applied set-wide). Returns True if a flush happened. Under the lazy
        policy this never fires; under the overlap policy it fires, without
        a count sync, whenever ``overlap_rows`` rows have accumulated across
        both ingest paths."""
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
        """Merge every partition's pending rows into its running skyline:
        one batched merge step per round (incremental policy), or
        append-only SFS rounds over the sum-sorted pending windows
        (lazy/overlap — host pending rows first, then the device
        accumulation window); at d <= 2 one sort-and-sweep for every policy.

        ``tighten=False`` (overlap auto-flushes) runs the device-window
        flush without count syncs: had-old detection and buckets come from
        the host upper bounds, the cleanup's exact old counts stay a device
        tensor, and the trailing count sync of the next merge is not
        requested. Query-time flushes keep the default."""
        fault_point("flush.pre_merge")
        total = int(self._pending_rows.sum())
        if self.dims <= 2 and self.mesh is None:
            if total or self._dev_rows:
                self._flush_sweep()
            return
        if self.flush_policy in ("lazy", "overlap"):
            if total:
                self._flush_lazy()
            if self._dev_rows:
                self._flush_lazy_device(tighten)
            return
        if total:
            self._flush_incremental()

    def _flush_incremental(self) -> None:
        """Incremental flush: one common power-of-two batch bucket B for all
        partitions (heavier ones take extra rounds), one batched merge step
        per round over the live prefixes. Round r+1..r+depth are assembled
        and uploaded after round r's merge is queued, so the host work
        overlaps the card's; counts are read only when ``_count_ub`` plus
        the round's widths would outgrow the capacity (log-bounded)."""
        t0 = time.perf_counter_ns()
        mp = mixed_precision_enabled(self.device)
        total = int(self._pending_rows.sum())
        self._bump_epoch(self._pending_rows > 0)
        with self.tracer.phase("flush/assemble"):
            rows = self._drain_pending()
        rows = self._prefilter_rows(rows)
        max_rows = max(r.shape[0] for r in rows)
        B = _next_pow2(min(max_rows, max(self.buffer_size, _MIN_CAP)))
        n_rounds = -(-max_rows // B)
        self._fnote(
            "flush.dispatch", policy="incremental", rows=total, rounds=n_rounds, block=B,
        )
        depth = flush_stage_depth()
        staged: dict[int, tuple] = {}

        def _stage(r: int):
            with self.tracer.phase("flush/assemble"):
                batch, bvalid, widths = self._round_batch(rows, r, B)
            with self.tracer.phase("flush/device_put"):
                return self._put_async(batch), self._put_async(bvalid), widths

        for rnd in range(n_rounds):
            if rnd not in staged:
                staged[rnd] = _stage(rnd)
            batch_dev, bvalid_dev, widths = staged.pop(rnd)

            def _grow_bucket():
                return _next_pow2(max(int((self._count_ub + widths).max()), 1))

            grow = _grow_bucket()
            if grow > self._cap:
                # about to grow: tighten the bounds with ONE count sync
                self._count_ub = self._host(self._count_dev)
                grow = _grow_bucket()
            out_cap = max(self._cap, grow)
            sky_valid = (
                torch.arange(self._cap, device=self.device)[None, :]
                < self._count_dev[:, None]
            )
            active = min(
                self._cap, _active_bucket(max(int(self._count_ub.max()), 1))
            )
            cost_thunk = None
            if self.mesh is not None:
                # each place merges its own partitions
                variant = "meshed_merge_step"
                step = meshed_merge_step(self.mesh, self._axis, active, grow, mp)
            else:
                variant = "merge_step"
                step = functools.partial(
                    merge_step_active, active=active, out_active=grow, mp=mp
                )
                if self._profiler is not None and profile_cost_enabled():
                    cost_thunk = self._merge_cost_thunk(batch_dev, bvalid_dev, active, grow, mp)
            with self._merge_kernel(variant, out_cap, mp, cost_thunk):
                # out_active is the bucket out_cap grew from, so the step's
                # max(cap, out_active) is out_cap
                self.sky, _, self._count_dev, res = step(
                    self._step_state(), sky_valid, batch_dev, bvalid_dev
                )
                if mp:
                    self._accum_resolved(res)
            self._cap = out_cap
            self._count_ub = np.minimum(out_cap, self._count_ub + widths)
            for s in range(rnd + 1, min(rnd + 1 + depth, n_rounds)):
                if s not in staged:
                    staged[s] = _stage(s)
        self._counts_cache = None
        self._host_cache = None
        self._maybe_launch_summaries()
        self._maybe_launch_grid()
        self.processing_ns += time.perf_counter_ns() - t0

    def _flush_sweep(self) -> None:
        """d <= 2 flush, every policy: the old skylines, the host pending
        rows and the device accumulation window in ONE buffer, and each
        partition's skyline by sort + segmented prefix-min sweep
        (ops/sweep2d.py) — no pairwise dominance, no SFS rounds, exact by
        the merge law. One count sync sizes the storage between the sweep
        and the scatter (so the overlap policy's flushes sync here too, as
        in the reference). d == 1 rides as (x, 0) pairs: a constant second
        dim makes 2D dominance 1D."""
        t0 = time.perf_counter_ns()
        # the dirty set without a sync: host pending rows are known per
        # partition; a device window may touch any partition, so it dirties
        # all (an extra bump costs only cache reuse)
        self._bump_epoch(slice(None) if self._dev_rows > 0 else self._pending_rows > 0)
        P, d = self.num_partitions, self.dims
        with self.tracer.phase("flush/assemble"):
            rows = self._drain_pending()
            host_vals = np.concatenate(
                [r for r in rows if r.shape[0]] or [np.empty((0, d), np.float32)]
            )
            host_pids = np.repeat(np.arange(P, dtype=np.int32), [r.shape[0] for r in rows])
        n_host = host_vals.shape[0]
        # valid prefixes only: the device window's allocation and the sky
        # rows past the active bucket are invalid
        dev_bucket = (
            min(self._dev_cap, _next_pow2(self._dev_rows)) if self._dev_rows else 0
        )
        sky_active = min(
            self._cap, _active_bucket(max(int(self._count_ub.max()), 1))
        )
        n_in = P * sky_active + n_host + dev_bucket
        n_bucket = _next_pow2(n_in)
        dev = self.device
        ar = torch.arange(sky_active, device=dev)
        with self.tracer.phase("flush/device_put"):
            host_vals_d = self._put(np.ascontiguousarray(host_vals, dtype=np.float32))
            host_pids_d = self._put(host_pids)
        parts_v = [self.sky[:, :sky_active].reshape(P * sky_active, d), host_vals_d]
        parts_p = [
            torch.arange(P, dtype=torch.int32, device=dev).repeat_interleave(sky_active),
            host_pids_d,
        ]
        parts_ok = [
            (ar[None, :] < self._count_dev[:, None]).reshape(-1),
            torch.ones((n_host,), dtype=torch.bool, device=dev),
        ]
        if dev_bucket:
            parts_v.append(self._dev_window[:dev_bucket])
            parts_p.append(self._dev_pids[:dev_bucket])
            parts_ok.append(torch.arange(dev_bucket, device=dev) < self._dev_rows)
        pad = n_bucket - n_in
        if pad:
            parts_v.append(torch.full((pad, d), float("inf"), dtype=torch.float32, device=dev))
            parts_p.append(torch.zeros((pad,), dtype=torch.int32, device=dev))
            parts_ok.append(torch.zeros((pad,), dtype=torch.bool, device=dev))
        values = torch.cat(parts_v)
        if d == 1:
            values = torch.cat([values, torch.zeros_like(values)], dim=1)
        with self.tracer.phase("flush/sweep"):
            srows, sp, keep, rank, counts = partitioned_sweep2_core(
                values, torch.cat(parts_p), torch.cat(parts_ok), P
            )
            counts_host = self._host(counts)  # the one sync
        new_cap = max(self._cap, _next_pow2(max(int(counts_host.max()), _MIN_CAP)))
        with self.tracer.phase("flush/sweep"):
            sky, counts_dev = scatter_sweep2(srows, sp, keep, rank, counts, P, new_cap)
        self.sky = sky[:, :, :1].contiguous() if d == 1 else sky
        self._cap = new_cap
        self._count_dev = counts_dev
        self._count_ub = counts_host.copy()
        self._counts_cache = None
        self._host_cache = None
        self._dev_rows = 0
        self.processing_ns += time.perf_counter_ns() - t0

    def _vmapped_block(self, max_rows: int) -> int:
        # bigger blocks than the buffer threshold: the cross-prune work is
        # block-count invariant, so fewer rounds just save launches
        return _next_pow2(min(max_rows, max(self.buffer_size, 8192)))

    def _sequential(self, widths: np.ndarray) -> bool:
        # the batched round costs P lanes of (B x active) work per round
        # whatever the lanes carry (~P * max_rows lane-rows); per-partition
        # rounds cost ~total_rows. Under routing skew sequential wins by ~P/2.
        # A meshed set keeps the batched rounds, each place its own lanes.
        return self.mesh is None and len(widths) * int(widths.max()) > 2 * int(widths.sum())

    def _flush_lazy(self) -> None:
        """Host-ingest flush: sum-sort each partition's accumulated rows and
        merge them by the path the race picks (``_choose_lazy_path``) —
        append-only SFS rounds, each block assembled and uploaded from the
        host (batched for balanced loads, per partition under skew), or a
        survivor mask of old ∪ new from the host or the device cascade
        (``_sfs_keep_flush``). Every path appends the same rows in the same
        order; while a race is in play each flush's wall is recorded under
        its path."""
        t0 = time.perf_counter_ns()
        mp = mixed_precision_enabled(self.device)
        self._bump_epoch(self._pending_rows > 0)
        with self.tracer.phase("flush/assemble"):
            rows = self._drain_pending()
        # the prefilter before the sum sort: dropped rows skip the sort, and
        # a stable sort of the surviving subset keeps the order a drop after
        # the sort would (the same appends)
        rows = self._prefilter_rows(rows)
        # the host sort fixes the SFS append order, and with it the state's
        # row order: the reference's exact expression
        with self.tracer.phase("flush/assemble"):
            for p, r in enumerate(rows):
                if r.shape[0] > 1:
                    order = np.argsort(r.sum(axis=1), kind="stable")
                    rows[p] = r[order]
        had_old, old_counts = self._check_had_old()
        widths = np.array([r.shape[0] for r in rows], dtype=np.int64)
        total_rows = int(widths.sum())
        sequential = self._sequential(widths)
        device_variant = "sequential" if sequential else "vmapped"
        path = self._choose_lazy_path(device_variant, total_rows)
        self.flush_paths[path] = self.flush_paths.get(path, 0) + 1
        self._fnote(
            "flush.dispatch", policy=self.flush_policy, rows=total_rows,
            max_rows=int(widths.max()), sequential=sequential, path=path,
        )

        def sfs_rounds():
            if sequential:

                def one_round(p, sky_p, cnt_p, off, w, B, active):
                    with self.tracer.phase("flush/assemble"):
                        block, bvalid, _ = self._pad_block(rows[p][off : off + B], B)
                    with self.tracer.phase("flush/device_put"):
                        block_d, bvalid_d = self._put(block), self._put(bvalid)
                    with self._merge_kernel("sfs_sequential", active, mp):
                        return sfs_round_single(sky_p, cnt_p, block_d, bvalid_d, active, mp)

                return self._sfs_sequential(widths, one_round, mp=mp)
            B = self._vmapped_block(int(widths.max()))

            def batched_round(rnd, counts, active):
                with self.tracer.phase("flush/assemble"):
                    batch, bvalid, _ = self._round_batch(rows, rnd, B)
                with self.tracer.phase("flush/device_put"):
                    batch_d, bvalid_d = self._put(batch), self._put(bvalid)
                if self.mesh is not None:
                    rnd_fn = meshed_sfs_round(self.mesh, self._axis, active, mp)
                    with self._merge_kernel("meshed_sfs_round", active, mp):
                        return rnd_fn(self._step_state(), counts, batch_d, bvalid_d)
                with self._merge_kernel("sfs_vmapped", active, mp):
                    return sfs_round(self.sky, counts, batch_d, bvalid_d, active, mp)

            return self._sfs_vmapped(widths, B, batched_round, mp)

        if path in ("sorted_sfs", "device_cascade"):
            self._inc("flush." + path)
            keep_fn = sorted_sfs_keep if path == "sorted_sfs" else (
                lambda r, old: device_cascade_keep(r, old, self.device))
            with self._flush_prof.record("flush_" + path, self.dims, total_rows):
                counts = self._sfs_keep_flush(rows, keep_fn, path)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)  # the uploads land
        elif self._flush_prof is not None:
            # a race is in play: time the rounds end to end, their counts
            # read back, so the walls compare
            with self._flush_prof.record("flush_sfs_" + device_variant, self.dims, total_rows):
                counts = sfs_rounds()
                self._host(counts)
        else:
            counts = sfs_rounds()
        self._finish_lazy_flush(
            counts, had_old, old_counts,
            int(old_counts.max()) if had_old else 0, t0,
        )

    def _choose_lazy_path(self, device_variant: str, total_rows: int) -> str:
        """The host-ingest lazy flush's path: ``"sorted_sfs"`` (the host
        cascade, ``ops/sorted_sfs.py``), ``"device_cascade"``
        (``ops/device_cascade.py``) or the SFS rounds' ``device_variant``,
        resolved by the cascade table (``ops/cascade.py`` ``resolve_flush``).
        Under ``auto`` each candidate's whole-flush wall is recorded once per
        (d, N-bucket, backend) signature and the least EMA decides
        thereafter. On the CPU the host cascade and the rounds race (the
        device cascade joins only with ``SKYLINE_SORTED_SFS=off``); on a
        card the rounds and the device cascade. A meshed set keeps the
        rounds."""
        if self.mesh is not None:
            return device_variant
        if cascade.flush_chooser_active(False, self.device) and self._flush_prof is None:
            self._flush_prof = KernelProfiler(backend=self.device.type)
        return cascade.resolve_flush(
            device_variant, self.dims, total_rows, False, self._flush_prof,
            device=self.device,
        )

    def _sfs_keep_flush(self, rows: list[np.ndarray], keep_fn, variant: str):
        """A lazy flush by survivor mask: per partition with pending rows,
        ``keep_fn(rows_p, old_p)`` (``sorted_sfs_keep`` on the host or
        ``device_cascade_keep`` on the set's device; profiled as
        ``variant``) selects the rows of
        old ∪ new that survive among the new ones, and they are appended
        after the old prefix in arrival (sum) order — the rows and order
        the SFS rounds append, since the cascades only select. One exact
        count read, one download of each old prefix and one upload of each
        rebuilt buffer; ``_finish_lazy_flush``'s cleanup then runs as after
        the rounds. Returns the device counts."""
        if not int(self._count_ub.max()):
            counts_host = np.zeros(self.num_partitions, dtype=np.int64)
        else:
            counts_host = self.sky_counts().astype(np.int64)
        new_skies = []
        new_counts = []
        for p in range(self.num_partitions):
            rp = rows[p]
            sky_p = self.sky[p]
            cnt_p = self._count_dev[p]
            old_n = int(counts_host[p])
            if rp.shape[0]:
                with self.tracer.phase("flush/assemble"):
                    old = (
                        sky_p[:old_n].cpu().numpy()
                        if old_n else np.empty((0, self.dims), dtype=np.float32)
                    )
                with self._merge_kernel(variant, old_n + rp.shape[0]):
                    keep = keep_fn(rp, old)
                surv = rp[keep]
                need = old_n + surv.shape[0]
                cap_p = max(sky_p.shape[0], _next_pow2(max(need, 1)))
                with self.tracer.phase("flush/assemble"):
                    buf = np.full((cap_p, self.dims), np.inf, dtype=np.float32)
                    buf[:old_n] = old
                    buf[old_n:need] = surv
                with self.tracer.phase("flush/device_put"):
                    sky_p = self._put_async(buf)
                    cnt_p = torch.tensor(need, dtype=torch.int64, device=self.device)
                self._count_ub[p] = need
            new_skies.append(sky_p)
            new_counts.append(cnt_p)
        return self._restack_skies(new_skies, new_counts)

    def _flush_lazy_device(self, tighten: bool = True) -> None:
        """Device-ingest flush: one (pid, sum) sort with segment bounds on
        the device, then SFS rounds slicing their blocks straight from the
        sorted window (stream/device_window.py) — no host routing, assembly
        or per-block upload. With the rank cascade on, the window and the
        live skyline prefixes are ranked once and the rounds and the cleanup
        compare ranks. Barrier bookkeeping is not synced here.

        ``tighten=False``: no count syncs — had-old detection and the
        buckets come from the host upper bounds (rows past the true counts
        are +inf, so loose is correct), and the cleanup's exact old counts
        stay the pre-flush DEVICE count vector. Only the segment bounds
        (host loop control) come back."""
        t0 = time.perf_counter_ns()
        mp = mixed_precision_enabled(self.device)
        P = self.num_partitions
        n_bucket = _next_pow2(self._dev_rows)
        with self.tracer.phase("flush/sort"):
            ws, bounds_dev = dw.sort_window(
                self._dev_window, self._dev_pids, self._dev_rows, n_bucket, P,
                dw.SORT_TAIL,
            )
            bounds = self._host(bounds_dev).astype(np.int64)
        self._bump_epoch(np.diff(bounds) > 0)
        self._dev_rows = 0
        if tighten:
            had_old, old_counts = self._check_had_old()
            old_max = int(old_counts.max()) if had_old else 0
        else:
            had_old = bool((self._count_ub > 0).any())
            # the exact old counts without a sync: the pre-flush device
            # count vector (the rounds replace it, never write into it)
            old_counts = self._count_dev if had_old else None
            old_max = int(self._count_ub.max()) if had_old else 0
        rank = None
        if dw.rank_flush_enabled():
            active_old = (
                min(self._cap, _active_bucket(max(old_max, 1))) if had_old else 0
            )
            with self.tracer.phase("flush/rank"):
                sorted_dims, wr = dw.rank_window(
                    ws, self.sky, self._count_dev, n_bucket, active_old,
                    _next_pow2(n_bucket + P * active_old),
                )
            rank = (wr, sorted_dims)
        widths = np.diff(bounds)
        sequential = self._sequential(widths)
        self._fnote(
            "flush.dispatch", policy=self.flush_policy, device_window=True,
            rows=int(widths.sum()), max_rows=int(widths.max()), sequential=sequential,
        )
        # the rounds' profiler signature keys mp as the reference's does,
        # whatever the rank cascade makes of it
        variant = "sfs_rank" if rank is not None else None
        if sequential:

            def one_round(p, sky_p, cnt_p, off, w, B, active):
                start = int(bounds[p]) + off
                with self._merge_kernel(variant or "sfs_sequential", active, mp):
                    if rank is not None:
                        return (*dw.sfs_round_at_rank(
                            sky_p, cnt_p, ws, *rank, start, w, B=B, active=active
                        ), None)
                    return dw.sfs_round_at(
                        sky_p, cnt_p, ws, start, w, B=B, active=active, mp=mp
                    )

            # blocks sliced from the sorted window must fit its tail pad
            counts = self._sfs_sequential(
                widths, one_round, dw.SORT_TAIL, tighten, mp and rank is None
            )
        else:
            B = min(self._vmapped_block(int(widths.max())), dw.SORT_TAIL)
            lo, hi = bounds_dev[:-1].long(), bounds_dev[1:].long()

            def batched_round(rnd, counts, active):
                with self._merge_kernel(variant or "sfs_vmapped", active, mp):
                    offs = torch.minimum(lo + rnd * B, hi)
                    w = torch.clamp(hi - offs, 0, B)
                    if rank is not None:
                        return (*dw.sfs_round_at_rank_vmapped(
                            self.sky, counts, ws, *rank, offs, w, B=B, active=active
                        ), None)
                    return dw.sfs_round_at_vmapped(
                        self.sky, counts, ws, offs, w, B=B, active=active, mp=mp
                    )

            counts = self._sfs_vmapped(widths, B, batched_round, mp and rank is None)
        self._finish_lazy_flush(counts, had_old, old_counts, old_max, t0, rank, tighten)

    def _sfs_vmapped(self, widths: np.ndarray, B: int, batched_round, mp: bool = False):
        """Balanced-load SFS: one batched round for all partitions at a
        time, ``batched_round(rnd, counts, active) -> (sky, counts',
        resolved or None)`` over each partition's rows ``[rnd * B, (rnd + 1)
        * B)`` (``widths``: rows per partition); with ``mp`` the rounds'
        certified drops are added up. Returns the device counts vector."""
        n_rounds = -(-int(widths.max()) // B)
        counts = self._count_dev
        # lag-2 tightening: the rows-streamed bound on _count_ub grows
        # linearly while the true skyline may stay tiny; the count vector
        # from two rounds back (already drained) keeps the active bucket near
        # the true size without stalling on the latest round
        prev: list[tuple] = []  # (counts after round, widths of round)
        for rnd in range(n_rounds):
            w = np.clip(widths - rnd * B, 0, B)
            if len(prev) >= 2:
                c2, w1 = prev[-2][0], prev[-1][1]
                self._count_ub = np.minimum(
                    self._count_ub, self._host(c2) + w1
                )
            # the append writes a full B-row block at offset count, so
            # capacity must cover count + B for every partition
            need = int(self._count_ub.max()) + B
            if need > self._cap:
                self._count_ub = self._host(counts)
                need = int(self._count_ub.max()) + B
                if need > self._cap:
                    self._grow_cap(_next_pow2(need))
            active = min(
                self._cap, _active_bucket(max(int(self._count_ub.max()), 1))
            )
            self.sky, counts, res = batched_round(rnd, counts, active)
            if mp:
                self._accum_resolved(res)
            prev.append((counts, w))
            self._count_ub = np.minimum(self._cap, self._count_ub + w)
        self._count_dev = counts
        return counts

    def _seq_block_size(self, rows_p: int) -> int:
        """The large-skyline sequential block: a ~500k-row heavy partition
        runs 8 rounds at B=64k instead of 30 at 16k. Only used once the
        running count has PROVEN large — per-round work is
        B x bucket(S + B), so big blocks on a small-skyline stream multiply
        total work for nothing."""
        return _next_pow2(
            min(
                max(rows_p, 1),
                max(self.buffer_size, 16384, min(rows_p // 8, 65536)),
            )
        )

    def _pad_sky_rows(self, s: torch.Tensor, new_cap: int) -> torch.Tensor:
        add = torch.full(
            (new_cap - s.shape[0], self.dims), float("inf"),
            dtype=torch.float32, device=self.device,
        )
        return torch.cat([s, add], dim=0)

    def _restack_skies(self, new_skies: list, new_counts: list):
        """One stacked reassembly after a sequential pass (on the device),
        padded to the largest per-partition capacity reached."""
        final_cap = max(s.shape[0] for s in new_skies)
        new_skies = [
            s if s.shape[0] == final_cap else self._pad_sky_rows(s, final_cap)
            for s in new_skies
        ]
        self.sky = torch.stack(new_skies)
        self._cap = final_cap
        counts = torch.stack(new_counts)
        self._count_dev = counts
        return counts

    def _sfs_sequential(
        self, widths: np.ndarray, one_round, max_block=None, tighten=True, mp=False
    ):
        """Skew-path SFS: partitions processed one at a time with their own
        block and active buckets — total work tracks each partition's own
        rows instead of P x the heaviest. ``one_round(p, sky_p, cnt_p, off,
        w, B, active) -> (sky_p, cnt_p', resolved or None)`` runs one round
        over rows
        ``[off, off + w)`` of partition ``p`` (``widths``: rows per
        partition); blocks are capped at ``max_block``. ``tighten=False``
        seeds the per-partition bounds from the host upper bounds instead
        of a count sync, and syncs only under growth pressure. With ``mp``
        the rounds' certified drops are added up. Returns the device
        counts."""

        def block_size(rows_p: int) -> int:
            B = self._seq_block_size(rows_p)
            return B if max_block is None else min(B, max_block)

        # exact starting counts make the per-partition active buckets tight;
        # a fresh set (all upper bounds zero) provably has zero counts
        if not int(self._count_ub.max()):
            counts_host = np.zeros(self.num_partitions, dtype=np.int64)
        elif not tighten:
            counts_host = self._count_ub.copy()
        else:
            counts_host = self.sky_counts().astype(np.int64)
        # capacity grows on demand as survivor counts grow (one exact count
        # sync per doubling); start with room for existing survivors + one
        # big block
        need0 = int(counts_host.max()) + block_size(int(widths.max()))
        if need0 > self._cap and not tighten:
            # growth pressure under loose bounds: tighten with one sync only
            # now, or capacity would track the stream, not the skyline
            counts_host = self.sky_counts().astype(np.int64)
            need0 = int(counts_host.max()) + block_size(int(widths.max()))
        if need0 > self._cap:
            self._grow_cap(_next_pow2(need0))

        new_skies = []
        new_counts = []
        for p in range(self.num_partitions):
            n_p = int(widths[p])
            sky_p = self.sky[p]
            cap_p = sky_p.shape[0]
            cnt_p = self._count_dev[p]
            ub_p = int(counts_host[p])
            if n_p:
                # start at the probe block; escalate to the big block once
                # the running count proves the skyline is large
                B_big = block_size(n_p)
                B = B_big if ub_p > _PROBE_B // 2 else min(_PROBE_B, B_big)
                prev: list[tuple] = []
                off = 0
                while off < n_p:
                    if len(prev) >= 2:
                        c2, w1 = prev[-2][0], prev[-1][1]
                        ub_p = min(ub_p, int(c2) + w1)
                        # a probe round keeps <= B survivors: half a block
                        # surviving is strong evidence of a large skyline
                        if B < B_big and int(c2) > B // 2:
                            B = B_big
                    if ub_p + B > cap_p:
                        # tighten with one exact count sync, then grow with
                        # a full block of slack past the trip band
                        ub_p = min(ub_p, int(cnt_p))
                        if ub_p + 2 * B > cap_p:
                            cap_p = _next_pow2(ub_p + 2 * B)
                            sky_p = self._pad_sky_rows(sky_p, cap_p)
                    w = min(B, n_p - off)
                    active = min(cap_p, _active_bucket(max(ub_p, 1)))
                    sky_p, cnt_p, res = one_round(p, sky_p, cnt_p, off, w, B, active)
                    if mp:
                        self._accum_resolved(res)
                    prev.append((cnt_p, w))
                    ub_p = min(cap_p, ub_p + w)
                    off += w
            new_skies.append(sky_p)
            new_counts.append(cnt_p)
            self._count_ub[p] = ub_p
        return self._restack_skies(new_skies, new_counts)

    def _grow_cap(self, new_cap: int) -> None:
        """Grow the stacked skyline storage to ``new_cap`` rows (+inf
        padding, which is invalid by the count invariant); a meshed state
        grows each slice on its own device."""

        def grow(t):
            pad = torch.full(
                (t.shape[0], new_cap - self._cap, self.dims),
                float("inf"), dtype=torch.float32, device=t.device,
            )
            return torch.cat([t, pad], dim=1)

        parts = self._sky_parts
        self.sky = parts.map(grow) if parts is not None else grow(self._sky)
        self._cap = new_cap

    def _check_had_old(self):
        """Non-empty initial state needs exact old counts for the final
        old-vs-new cleanup pass (one sync; fresh windows skip it)."""
        had_old = bool((self._count_ub > 0).any())
        old_counts = self.sky_counts().astype(np.int64) if had_old else None
        if had_old and not int(old_counts.max()):
            had_old = False
        return had_old, old_counts

    def _finish_lazy_flush(
        self, counts, had_old, old_counts, old_max, t0, rank=None, tighten=True
    ) -> None:
        """Tail of the lazy flush: old-vs-new cleanup, caches, and a deferred
        count sync for the next merge's buckets. ``old_counts``: exact
        pre-flush counts, host array or device tensor; ``old_max``: a host
        bound on their max (buckets only). ``rank``: (window ranks, sorted
        universe) from the rank-cascade device flush — the cleanup then
        compares in rank space (old prefixes are universe members).
        ``tighten=False`` does not ask the next merge for the count sync."""
        if had_old:
            if not isinstance(old_counts, torch.Tensor):
                old_counts = self._put(old_counts)
            active = min(
                self._cap, _active_bucket(max(int(self._count_ub.max()), 1))
            )
            # the rounds only append, so every old count is at most its
            # partition's final count bound: the old prefixes fit ``active``.
            # ``old_max`` may exceed it when it is the loose bound of a
            # sync-free flush whose rounds tightened the bounds (the
            # reference then fails on mismatched shapes; ROADMAP.md queue 3)
            old_active = min(active, _active_bucket(max(old_max, 1)))
            with self._merge_kernel("sfs_cleanup", active):
                if rank is not None:
                    self.sky, counts = dw.sfs_cleanup_rank(
                        self.sky, counts, old_counts, rank[1], old_active, active,
                    )
                elif self.mesh is not None:
                    cl = meshed_sfs_cleanup(self.mesh, self._axis, old_active, active)
                    self.sky, counts = cl(self._step_state(), counts, old_counts)
                else:
                    self.sky, counts = sfs_cleanup(
                        self.sky, counts, old_counts, old_active, active
                    )
        self._count_dev = counts
        self._counts_cache = None
        self._host_cache = None
        if tighten:
            self._tighten_pending = True
        self._maybe_launch_summaries()
        self._maybe_launch_grid()
        self.processing_ns += time.perf_counter_ns() - t0

    # -- the flush dominance cascade (grid prefilter + mixed precision) ------

    def _accum_resolved(self, res) -> None:
        """Fold one round's bf16-certified drop counts into the running
        device int32 (no sync; read only by ``flush_cascade_stats``)."""
        s = res.sum(dtype=torch.int32)
        self._mp_resolved = s if self._mp_resolved is None else self._mp_resolved + s

    def _prefilter_on(self) -> bool:
        """The grid prefilter for this set: d >= 3, one device, the knob."""
        return cascade.applies("flush_prefilter", d=self.dims, meshed=self.mesh is not None)

    def _maybe_launch_grid(self) -> None:
        """Flush tail: queue the grid summary of the state just flushed and
        its copy to pinned host memory, so the next flush's prefilter reads
        landed bytes instead of waiting on the card."""
        if not self._prefilter_on():
            return
        active = min(self._cap, _active_bucket(max(int(self._count_ub.max()), 1)))
        bounds, ux = grid_summary_device(self.sky, self._count_dev, active)
        self._grid = (to_host_async(bounds), to_host_async(ux))
        self._grid_host = None
        self._grid_epoch = self._epoch.copy()

    def _grid_summaries(self):
        """The validated host copy of the last queued grid summary, or None
        before the first one. A partition's ladder that f32 rounding failed
        to keep strictly increasing in some dimension gets every code set to
        GRID_BINS + 1 there, so it never certifies (the certificate needs
        every dimension): no drops for that partition. An empty partition's
        NaN ladder fails the same check."""
        if self._grid is None:
            return None
        if self._grid_host is None:
            bounds = self._landed(*self._grid[0])
            ux = self._landed(*self._grid[1]).copy()
            with np.errstate(invalid="ignore"):  # the NaN ladder of an empty partition
                bad = ~np.all(np.diff(bounds, axis=1) > 0, axis=1)  # (P, d)
            if bad.any():
                ux[np.broadcast_to(bad[:, None, :], ux.shape)] = GRID_BINS + 1
            self._grid_host = (bounds, ux)
        return self._grid_host

    def _prefilter_rows(self, rows: list[np.ndarray]) -> list[np.ndarray]:
        """Stage 1 of the flush cascade: drop pending rows whose grid cell a
        representative cell of their partition's skyline strictly dominates
        (``grid_drop``), on the host, before any merge kernel.

        Sound: a row y coded ``vy`` and a representative x coded ``ux``
        with ``ux < vy`` in every dimension satisfy ``x <= bounds[ux] <
        bounds[vy] <= y``, so x strictly dominates y. x was a live skyline
        row when the summary was queued; if a later flush removed it, its
        chain of removers ends at a current row that still strictly
        dominates y, so the exact merge drops y anyway — and every pending
        row y would have pruned is strictly dominated by the same chain.
        The survivors and their order are those of the prefilter off. NaN
        rows code to -1 and are never dropped; +inf rows may be."""
        if not self._prefilter_on():
            return rows
        grid = self._grid_summaries()
        seen = int(sum(r.shape[0] for r in rows))
        dropped = 0
        if grid is not None and seen:
            bounds, ux = grid
            with self.tracer.phase("flush/prefilter"):
                for p, r in enumerate(rows):
                    if r.shape[0] == 0 or not (ux[p] <= GRID_BINS).all(axis=1).any():
                        continue  # nothing to code, or no representative can certify
                    drop = np.concatenate([
                        grid_drop(bounds[p], ux[p], r[s : s + _PREFILTER_CHUNK])
                        for s in range(0, r.shape[0], _PREFILTER_CHUNK)
                    ])
                    if drop.any():
                        dropped += int(drop.sum())
                        rows[p] = r[~drop]
        self.prefilter_seen += seen
        self.prefilter_dropped += dropped
        if seen:
            self._fnote("flush.prefilter", seen=seen, dropped=dropped)
        # both series register at the first prefiltered flush, zero included
        self._inc("flush.prefilter_dropped", dropped)
        self._inc("flush.bf16_resolved", 0)
        return rows

    def flush_cascade_stats(self) -> dict:
        """The flush cascade's counters: the grid prefilter's (host-exact)
        and the bf16 pre-drop's certified drops — a device total, read (one
        sync) here and nowhere on the flush path, and fed to the counters
        sink as a delta."""
        if self._mp_resolved is not None:
            self.bf16_resolved = int(self._mp_resolved.item())
            delta = self.bf16_resolved - self._bf16_resolved_reported
            if delta:
                self._inc("flush.bf16_resolved", delta)
                self._bf16_resolved_reported = self.bf16_resolved
        seen = self.prefilter_seen
        return {
            "prefilter_enabled": self._prefilter_on(),
            "mixed_precision": mixed_precision_enabled(self.device),
            "prefilter_seen": seen,
            "prefilter_dropped": self.prefilter_dropped,
            "prefilter_drop_fraction": self.prefilter_dropped / seen if seen else 0.0,
            "bf16_resolved": self.bf16_resolved,
        }

    # -- global merge -------------------------------------------------------

    def global_merge_stats(self, emit_points: bool = False):
        """Device-side global merge over the (flushed) stacked state.

        Returns ``(counts (P,), survivors_per_partition (P,), global_count,
        points | None)`` with ONE small device->host transfer for the stats
        (plus one bounded transfer when ``emit_points``).

        The reference's defaults, each with the same answer bytes as the
        flat pass:

        - the epoch-keyed cache (``SKYLINE_MERGE_CACHE``): an unchanged
          epoch vector answers from the cache with no kernel launch; when at
          most ``SKYLINE_DELTA_CUTOFF`` of the partitions changed, the merge
          runs over the cached global skyline and the dirty partitions;
        - at d > 2 the pruned tournament tree (``SKYLINE_MERGE_TREE``,
          ``SKYLINE_MERGE_PRUNE``): whole partitions dropped by a witness
          prefilter, the rest merged pairwise (two K2 passes a pair on a
          card) instead of one survivor-mask pass over the union.

        This is ``global_merge_launch`` then ``global_merge_harvest``; the
        engine's overlapped query sync calls the two apart."""
        return self.global_merge_harvest(self.global_merge_launch(emit_points))

    def global_merge_launch(self, emit_points: bool = False) -> _MergeHandle:
        """Launch the global merge without waiting for it: every kernel (tree
        or flat, full or delta) and the stats copy to pinned host memory are
        queued, and the handle keeps the launch-time epoch. The caller may
        flush more rows before the harvest."""
        if self._tighten_pending:
            # exact counts halve the pairwise work through tighter buckets
            self.sky_counts()
        h = _MergeHandle()
        h.emit_points = emit_points
        h.key = self.epoch_key
        h.epoch = self._epoch.copy()
        # claim the parked EXPLAIN plan (one-shot): it rides the handle, so an
        # overlapped merge annotates the query that launched it
        h.explain, self._explain = self._explain, None
        h.use_cache = cascade.merge_cache_on(self.mesh is not None)
        cache = self._gm_cache if h.use_cache else None
        if cache is not None and cache["key"] == h.key:
            # exact hit: no flush touched any partition since this result
            self.merge_cache_hits += 1
            self._inc("merge.cache_hit")
            self._fnote("merge.cache_hit", key=h.key)
            self._counts_cache = cache["counts"].copy()
            self._count_ub = cache["counts"].copy()
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
        self._inc("merge.cache_miss")
        P = self.num_partitions
        dirty = None
        dirty_mask = None
        if cache is not None:
            dirty_mask = self._epoch != cache["epoch"]
            self.last_dirty_fraction = float(dirty_mask.sum()) / P
            if cascade.delta_applies(self.last_dirty_fraction):
                dirty = dirty_mask
        elif h.use_cache:
            self.last_dirty_fraction = 1.0  # a cold miss: everything dirty
        use_tree = cascade.merge_tree_on(self.mesh is not None, self.dims)
        path = cascade.merge_path(use_tree, dirty is not None)
        self._fnote("merge.launch", path=path, dirty_fraction=self.last_dirty_fraction)
        if h.explain is not None:
            if dirty_mask is not None:
                dirty_set = np.flatnonzero(dirty_mask).tolist()
                clean_set = np.flatnonzero(~dirty_mask).tolist()
            else:
                # no cached epoch to diff against: everything recomputes
                dirty_set, clean_set = list(range(P)), []
            h.explain.merge = {
                "path": path, "cached": False, "epoch_key": h.key.hex(),
                # meaningful only when the cache plane computed it this launch
                "dirty_fraction": self.last_dirty_fraction if h.use_cache else None,
                "dirty": dirty_set, "clean": clean_set,
            }
        stats = None
        if dirty is not None:
            h.dirty = dirty
            if use_tree:
                stats = self._merge_tree_delta(cache, dirty, h)
            if stats is None:
                h.union, h.keep, stats, h.clean_total = self._merge_delta(cache, dirty)
        else:
            if use_tree:
                stats = self._merge_tree_full(h)
            if stats is None:
                # the count upper bounds need no sync (rows past a count are
                # invalid); the union's bucket from the SUMMED bounds keeps
                # the pass union-sized under routing skew, on the
                # quarter-pow2 ladder (the pass costs O(union_cap^2))
                active = min(
                    self._cap, _active_bucket(max(int(self._count_ub.max()), 1))
                )
                union_cap = _active_bucket(max(int(self._count_ub.sum()), 1))
                h.union, h.keep, stats = global_merge_stats_device(
                    self.sky, self._count_dev, active, union_cap
                )
        h.stats, h.event = to_host_async(stats)
        return h

    @staticmethod
    def _landed(host: torch.Tensor, event) -> np.ndarray:
        """The host bytes of a ``to_host_async`` copy, once it has landed."""
        if event is not None:
            event.synchronize()
        return host.numpy()

    def global_merge_harvest(self, handle: _MergeHandle):
        """Wait for an in-flight merge and return ``(counts, surv, g,
        points | None)`` — the second half of ``global_merge_stats``. The
        live count bounds are refreshed only when no flush landed between
        launch and harvest (stale counts would undersize later buckets)."""
        h = handle
        if h.cached:
            return h.result
        P = self.num_partitions
        with self.tracer.phase("query/global_stats_sync"):
            svec = self._landed(h.stats, h.event).astype(np.int64)
        counts, surv, g = svec[:P].copy(), svec[P : 2 * P].copy(), int(svec[2 * P])
        if h.dirty is not None:
            self.merge_delta_merges += 1
            drows = h.clean_total + int(counts[h.dirty].sum())
            self.merge_delta_rows += drows
            self._inc("merge.delta_rows", drows)
            if h.explain is not None:
                h.explain.merge["delta_rows"] = drows
                h.explain.merge["clean_rows"] = int(h.clean_total)
        if h.explain is not None and h.explain.merge is not None:
            h.explain.merge["skyline_size"] = g
        pts = None
        if h.use_cache:
            # compact into the cache even without points: the next delta
            # merge reads them. A capacity of 2 * next_pow2(g) lets every
            # clean slice of a later delta merge (start <= g, width <=
            # next_pow2(g)) stay in bounds. Stored under the LAUNCH key: the
            # result describes that epoch's state even if flushes landed.
            gcap = 2 * _next_pow2(max(g, 1))
            if h.root_vals is not None:
                pts_dev = tree_points_device(h.root_vals, gcap)
            else:
                pts_dev = global_points_device(h.union, h.keep, gcap)
            self._gm_cache = {
                "key": h.key, "epoch": h.epoch.copy(), "counts": counts.copy(),
                "surv": surv.copy(), "g": g, "pts_dev": pts_dev, "pts_host": None,
            }
            if h.emit_points:
                pts = self._cached_points()
        elif h.emit_points:
            out_cap = _next_pow2(max(g, 1))
            with self.tracer.phase("query/points_transfer"):
                if h.root_vals is not None:
                    pts_dev = tree_points_device(h.root_vals, out_cap)
                else:
                    pts_dev = global_points_device(h.union, h.keep, out_cap)
                pts = self._host(pts_dev)[:g]
        if self.epoch_key == h.key:
            self._counts_cache = counts.copy()
            self._count_ub = counts.copy()
        return counts, surv, g, pts

    def _merge_delta(self, cache, dirty: np.ndarray):
        """Launch the flat dirty-subset merge (``global_merge_delta_device``)
        against the cached global points: (union, keep, stats, rows of the
        clean segments)."""
        surv = cache["surv"]
        bounds = np.concatenate(([0], np.cumsum(surv))).astype(np.int64)
        seg = np.where(dirty, 0, surv)
        clean_total = int(seg.sum())
        clean_active = _active_bucket(max(int(seg.max()), 1))
        active = min(self._cap, _active_bucket(max(int(self._count_ub[dirty].max()), 1)))
        union_cap = _active_bucket(max(clean_total + int(self._count_ub[dirty].sum()), 1))
        union, keep, stats = global_merge_delta_device(
            self.sky, self._count_dev, cache["pts_dev"], bounds, active, clean_active,
            union_cap, dirty,
        )
        return union, keep, stats, clean_total

    # -- the pruned tournament-tree merge ---------------------------------------

    def _maybe_launch_summaries(self) -> None:
        """Flush tail: queue the per-partition prune summaries (small) so the
        next merge's prefilter finds them landed; only where the tree and
        the prefilter are on."""
        if cascade.merge_tree_on(self.mesh is not None, self.dims) and cascade.gate(
            "partition_prune"
        ):
            self._launch_summaries()

    def _launch_summaries(self) -> None:
        active = min(self._cap, _active_bucket(max(int(self._count_ub.max()), 1)))
        self._summary = to_host_async(
            partition_summaries_device(self.sky, self._count_dev, active)
        )
        self._summary_epoch = self._epoch.copy()

    def _tree_summaries(self) -> np.ndarray:
        """Host (P, 2d+2) prune summaries of the CURRENT epoch: usually those
        the last flush queued, launched again when the stamp is stale."""
        if self._summary_epoch is None or not np.array_equal(self._summary_epoch, self._epoch):
            self._launch_summaries()
        return self._landed(*self._summary)

    def _prune_mask(self, alive: np.ndarray) -> np.ndarray:
        """The witness prefilter (``prune_witness_mask``); keeps each
        partition's witness on ``last_prune_witness``."""
        pruned, self.last_prune_witness = prune_witness_mask(
            self._tree_summaries(), alive, self.dims
        )
        return pruned

    def _sky_leaf(self, p: int):
        w = min(self._cap, _active_bucket(max(int(self._count_ub[p]), 1)))
        vals, lpids, cnt = extract_sky_leaf(self.sky, self._count_dev, p, w)
        return vals, lpids, cnt, int(self._count_ub[p])

    def _merge_tree_full(self, h: _MergeHandle):
        """Launch the pruned tree over the current partition skylines: the
        packed stats tensor, or None for the flat pass (no live leaf)."""
        alive = self._count_ub > 0
        considered = int(alive.sum())
        npruned = 0
        leaf_mask = alive
        if cascade.gate("partition_prune") and considered > 1:
            pruned = self._prune_mask(alive)
            npruned = int(pruned.sum())
            leaf_mask = alive & ~pruned
            if h.explain is not None:
                wit = self.last_prune_witness
                h.explain.tree = {"pruned": [
                    {"partition": int(b), "witness": int(wit[b])}
                    for b in np.flatnonzero(pruned)
                ]}
        pids = np.flatnonzero(leaf_mask)
        if pids.size == 0:
            return None  # empty set: the flat pass answers the zero state
        leaves = [self._sky_leaf(int(p)) for p in pids]
        return self._run_tree(leaves, h, npruned, considered)

    def _merge_tree_delta(self, cache, dirty: np.ndarray, h: _MergeHandle):
        """The delta merge through the tree: dirty partitions feed their
        skylines, clean ones their cached global-survivor segments, in
        ascending partition order (so the root equals the flat delta's
        bytes). No prefilter: the summaries describe partition skylines,
        not cached segments."""
        surv = cache["surv"]
        bounds = np.concatenate(([0], np.cumsum(surv))).astype(np.int64)
        leaves = []
        clean_total = 0
        for p in range(self.num_partitions):
            if dirty[p]:
                if self._count_ub[p] > 0:
                    leaves.append(self._sky_leaf(p))
                continue
            sw = int(surv[p])
            if sw <= 0:
                continue
            clean_total += sw
            vals, lpids, cnt = extract_cached_leaf(
                cache["pts_dev"], int(bounds[p]), sw, p, _active_bucket(sw)
            )
            leaves.append((vals, lpids, cnt, sw))
        h.clean_total = clean_total
        if not leaves:
            return None
        return self._run_tree(leaves, h, 0, len(leaves))

    def _run_tree(self, leaves, h: _MergeHandle, npruned: int, considered: int):
        """Pair the leaves up a binary tree (neighbours pair, an odd tail
        passes up), so partition order — and the flat pass's bytes — hold
        at every level. Each node's capacity covers its children's summed
        count bounds, so the compaction never clips."""
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
        self.merge_tree_merges += 1
        self.merge_partitions_pruned += npruned
        # inc zero too: the series register at the first tree merge
        self._inc("merge.tree_levels", levels)
        self._inc("merge.partitions_pruned", npruned)
        self._fnote("merge.tree", levels=levels, pruned=npruned, considered=considered)
        self.last_tree_info = {
            "levels": levels,
            "partitions_pruned": npruned,
            "candidates_per_level": cand,
            "pruned_fraction": (npruned / considered) if considered else 0.0,
        }
        if h.explain is not None:
            # beside the prune's witness rows (full path only), the tree shape
            tree = h.explain.tree or {"pruned": []}
            tree.update(self.last_tree_info)
            tree["considered"] = considered
            h.explain.tree = tree
        return tree_stats_device(self._count_dev, root_pids, root_cnt, self.num_partitions)

    def merge_points_device(self, handle: _MergeHandle, out_cap: int) -> torch.Tensor:
        """Device buffer of a harvested merge's global skyline points,
        ``(out_cap, d)`` with rows past the true count +inf — no host
        transfer. The sharded engine's cross-chip level feeds each chip's
        root into ``tree_pair_merge`` through this. Valid only between a
        harvest and the next flush; prefers the cache buffer when it
        describes the handle's epoch, else compacts the handle's tree or
        flat result."""
        h = handle
        cache = self._gm_cache
        if cache is not None and cache["key"] == h.key:
            pts = cache["pts_dev"]
            if pts.shape[0] >= out_cap:
                return pts[:out_cap]
            return tree_points_device(pts, out_cap)
        if h.root_vals is not None:
            return tree_points_device(h.root_vals, out_cap)
        return global_points_device(h.union, h.keep, out_cap)

    def _cached_points(self) -> np.ndarray:
        """Host copy of the cached global skyline points, transferred at most
        once per cached merge."""
        c = self._gm_cache
        if c["pts_host"] is None:
            with self.tracer.phase("query/points_transfer"):
                c["pts_host"] = self._host(c["pts_dev"])[: c["g"]].copy()
        return c["pts_host"].copy()

    # -- state access ---------------------------------------------------------

    def sky_counts(self) -> np.ndarray:
        """Exact survivor counts (P,) — one device sync (cached until the
        next flush)."""
        if self._counts_cache is None:
            with self.tracer.phase("query/count_sync"):
                self._counts_cache = self._host(self._count_dev)
            self._count_ub = self._counts_cache.copy()
        self._tighten_pending = False
        return self._counts_cache

    def _host_sky(self) -> np.ndarray:
        if self._host_cache is None:
            with self.tracer.phase("query/snapshot_transfer"):
                self._host_cache = self._host(self.sky)
        return self._host_cache

    def snapshot(self, p: int) -> np.ndarray:
        """Flush pending rows and return partition ``p``'s local skyline
        (k, d) on host — the processQuery path (FlinkSkyline.java:367-403)."""
        self.flush_all()  # times itself; t0 after it avoids double-counting
        t0 = time.perf_counter_ns()
        count = int(self.sky_counts()[p])
        out = self._host_sky()[p, :count].copy()
        self.processing_ns += time.perf_counter_ns() - t0
        return out

    def skyline_host(self, p: int) -> np.ndarray:
        """Partition ``p``'s skyline pulled to host WITHOUT flushing pending
        rows."""
        count = int(self.sky_counts()[p])
        return self._host_sky()[p, :count].copy()

    def pending_rows_of(self, p: int) -> np.ndarray:
        """Partition ``p``'s un-flushed host pending rows as one (m, d)
        array (rows in the device accumulation window are not host
        pending rows; ``utils/checkpoint.py`` flushes them first)."""
        if not self._pending[p]:
            return np.empty((0, self.dims), dtype=np.float32)
        if len(self._pending[p]) == 1:
            return self._pending[p][0]
        return np.concatenate(self._pending[p], axis=0)

    def audit_state(self) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """Off-hot-path state capture for the audit plane: every
        partition's skyline plus its un-flushed pending rows, as host
        arrays. One bulk device-to-host copy (the ``_host_sky`` cache) — no
        flush, no merge, no epoch advance, so capturing for a shadow check
        never perturbs the state being checked."""
        skies = [self.skyline_host(p) for p in range(self.num_partitions)]
        pendings = [self.pending_rows_of(p) for p in range(self.num_partitions)]
        return skies, pendings

    def restore_all(self, skies: list[np.ndarray], pendings: list[np.ndarray]) -> None:
        """Checkpoint-restore every partition's skyline and pending buffer
        in one host pass and one upload.

        ``skies[p]`` rows are assumed mutually non-dominated (they came
        from ``skyline_host``). Replaces ALL existing state, including the
        barrier and metrics bookkeeping (reset to fresh; the caller
        re-applies saved values, as ``utils.checkpoint.load_engine``
        does). Every epoch advances, so no merge cached against the old
        state is reused."""
        P = self.num_partitions
        assert len(skies) == len(pendings) == P
        counts = np.array([s.shape[0] for s in skies], dtype=np.int64)
        sky = np.full((P, max(int(counts.max()), 1), self.dims), np.inf, dtype=np.float32)
        for p, s in enumerate(skies):
            sky[p, : s.shape[0]] = s
        # drops pendings and the device window, bumps every epoch
        self.load_state(sky, counts)
        self.max_seen_id[:] = -1
        self.start_time_ms = [None] * P
        self.records_seen[:] = 0
        self.processing_ns = 0
        for p, pending in enumerate(pendings):
            if pending.shape[0]:
                self._pending[p] = [np.ascontiguousarray(pending, dtype=np.float32)]
                self._pending_rows[p] = pending.shape[0]

    def state_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """The flushed state as host arrays: (sky (P, cap, d) float32 with
        +inf past each count, counts (P,) int64). Pending rows are not part
        of it."""
        return self._host_sky().copy(), self.sky_counts().copy()

    def load_state(
        self,
        sky: np.ndarray,
        counts: np.ndarray,
        max_seen_id: np.ndarray | None = None,
        records_seen: np.ndarray | None = None,
    ) -> None:
        """Replace the flushed state with per-partition skylines — e.g. the
        JAX package's ``np.asarray(pset.sky)`` and exact counts — so both
        packages can continue from identical state. This system has no
        weights: its per-partition skylines are its state.

        sky: (P, cap, d) float32 whose first ``counts[p]`` rows of each
        partition are mutually non-dominated; rows past the counts are
        ignored (stored as +inf). Pending rows (host lists and the device
        window) are dropped; the barrier bookkeeping is replaced when
        given. Every epoch advances and the merge cache is dropped."""
        sky = np.asarray(sky, dtype=np.float32)
        counts = np.asarray(counts, dtype=np.int64)
        P = self.num_partitions
        if sky.ndim != 3 or sky.shape[0] != P or sky.shape[2] != self.dims:
            raise ValueError(
                f"state of shape {sky.shape} does not fit {P} partitions of "
                f"{self.dims} dims"
            )
        if counts.shape != (P,) or (counts < 0).any() or (counts > sky.shape[1]).any():
            raise ValueError(f"counts {counts} do not fit a {sky.shape} state")
        cap = max(
            _next_pow2(max(sky.shape[1], 1)),
            _next_pow2(max(self.initial_capacity, _MIN_CAP)),
        )
        svals = np.full((P, cap, self.dims), np.inf, dtype=np.float32)
        for p in range(P):
            svals[p, : counts[p]] = sky[p, : counts[p]]
        self.sky = self._put(svals)
        self._cap = cap
        self._count_dev = self._put(counts.copy())
        self._count_ub = counts.copy()
        self._counts_cache = None
        self._host_cache = None
        self._tighten_pending = False
        self._pending = [[] for _ in range(P)]
        self._pending_rows[:] = 0
        self._dev_rows = 0
        self._chunk_stats = []
        # another world: no cached merge of the old state may be reused, and
        # the grid summary described the replaced skylines (its staleness
        # argument covers evolved state, not a swapped one)
        self._bump_epoch(slice(None))
        self._gm_cache = None
        self._grid = None
        self._grid_host = None
        self._grid_epoch = None
        if max_seen_id is not None:
            self.max_seen_id = np.asarray(max_seen_id, dtype=np.int64).copy()
        if records_seen is not None:
            self.records_seen = np.asarray(records_seen, dtype=np.int64).copy()

    @property
    def processing_ms(self) -> float:
        return self.processing_ns / 1e6


class PartitionView:
    """Per-partition facade over a ``PartitionSet`` — the engine addresses
    partitions individually while storage stays stacked. ``snapshot``
    flushes, so query results never miss pending rows."""

    __slots__ = ("_set", "partition_id")

    def __init__(self, pset: PartitionSet, p: int):
        self._set = pset
        self.partition_id = p

    @property
    def max_seen_id(self) -> int:
        return int(self._set.max_seen_id[self.partition_id])

    @max_seen_id.setter
    def max_seen_id(self, v: int) -> None:
        self._set.max_seen_id[self.partition_id] = int(v)

    @property
    def start_time_ms(self):
        return self._set.start_time_ms[self.partition_id]

    @start_time_ms.setter
    def start_time_ms(self, v) -> None:
        self._set.start_time_ms[self.partition_id] = v

    @property
    def records_seen(self) -> int:
        return int(self._set.records_seen[self.partition_id])

    @records_seen.setter
    def records_seen(self, v: int) -> None:
        self._set.records_seen[self.partition_id] = v

    @property
    def processing_ns(self) -> int:
        return self._set.processing_ns

    @property
    def processing_ms(self) -> float:
        return self._set.processing_ms

    def add_batch(self, values: np.ndarray, max_id: int, now_ms: float) -> None:
        self._set.add_batch(self.partition_id, values, max_id, now_ms)

    def snapshot(self) -> np.ndarray:
        return self._set.snapshot(self.partition_id)

    def skyline_host(self) -> np.ndarray:
        return self._set.skyline_host(self.partition_id)

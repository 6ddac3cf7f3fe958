"""Capacity buckets, the incremental merge step, the global merges (flat,
delta and pruned tournament tree) over the stacked state, and the meshed
flush steps.

Counterpart of ``skyline_tpu/stream/window.py`` (the merge step, the
merges, the flush prefilter's grid summary and the ``meshed_*`` steps).
Running skylines live on the device as padded power-of-two-capacity
buffers; compute prefixes use a finer quarter-power-of-two ladder. The bucket arithmetic is the reference's,
constant for constant, so both packages size every pass alike.

The merge step is the incremental policy's flush: one masked dominance pass
folds a micro-batch into each partition's running skyline (the reference's
BNL buffer-vs-skyline loop, SkylineLocalProcessor.processBuffer,
FlinkSkyline.java:417-444). Its cores take a leading partition dimension
``P`` where the reference used ``jax.vmap``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from skyline_tpu_torch.ops.dispatch import on_cuda, skyline_mask_auto
from skyline_tpu_torch.ops.dominance import (
    compact,
    compact_tagged,
    dominated_by,
    skyline_mask,
)
from skyline_tpu_torch.ops.dominance_kernels import dominated_by_rect, row_sums
from skyline_tpu_torch.ops.sfs import _MP_PREFIX, mp_predrop, sfs_cleanup, sfs_round
from skyline_tpu_torch.parallel.chips import gather_to, on_device
from skyline_tpu_torch.parallel.mesh import Placed
from skyline_tpu_torch.utils.buckets import next_pow2

# Reference flushes its input buffer at 5000 tuples (BUFFER_SIZE,
# FlinkSkyline.java:232); the default is the nearest power of two.
DEFAULT_BUFFER_SIZE = 4096

# The profiler's variant names (``telemetry/profiler.py``), a closed
# vocabulary for readers of its signatures (``skyline_tpu/stream/window.py``
# KERNEL_VARIANTS, the rows the port runs). Every ``flush/merge_kernel``
# site of ``stream/batched.py`` records its dispatch under one of the first
# seven into the engine's profiler; the flush_* and mask_* names are the
# dispatch race's signatures, recorded into ``PartitionSet._flush_prof`` and
# the dispatch's mask profiler.
KERNEL_VARIANTS = {
    "merge_step": "batched merge of one micro-batch into all partitions",
    "meshed_merge_step": "the merge step, each mesh place over its own partitions",
    "meshed_sfs_round": "the SFS round, each mesh place over its own partitions",
    "sfs_vmapped": "batched sort-filter-skyline flush round",
    "sfs_sequential": "single-partition SFS flush round",
    "sfs_rank": "device-window SFS round in rank space (per partition or "
                "batched)",
    "sfs_cleanup": "lazy-flush cleanup pass",
    "sorted_sfs": "host sorted-order SFS cascade, one partition's flush "
                  "(ops/sorted_sfs.py: dedup + f64 sum-sort + blocked scan)",
    "device_cascade": "device sorted dominance cascade, one partition's "
                      "flush (ops/device_cascade.py: on-device dedup + f32 "
                      "sum-key sort + blocked prefix/band scan)",
    "flush_sorted_sfs": "whole lazy flush via the host sorted cascade",
    "flush_sfs_sequential": "whole lazy flush via per-partition SFS rounds",
    "flush_sfs_vmapped": "whole lazy flush via batched SFS rounds",
    "flush_device_cascade": "whole lazy flush via the device sorted "
                            "dominance cascade",
    "sorted_sfs_mask": "skyline_mask_auto host path (concrete CPU d>2)",
    "mask_scan": "skyline_mask_auto chunked scan (the CPU fallback)",
    "mask_device_cascade": "skyline_mask_auto device sorted dominance "
                           "cascade (every device)",
    "mask_pallas": "skyline_mask_auto K3 sum-sorted tiles (the card)",
    "mask_rank_pallas": "skyline_mask_auto K7 rank-cascade tiles (the card)",
}

# Minimum buffer capacity.
_MIN_CAP = 1024

# The reference's Pallas tile constants (skyline_tpu/ops/pallas_dominance.py
# ROW_TILE/COL_TILE). The CUDA kernel needs no tile multiples, but the
# bucket ladder below is derived from them, and keeping them keeps every
# bucket — and so every pass's extent — equal to the reference's.
ROW_TILE = 512
COL_TILE = 2048


def _next_pow2(n: int) -> int:
    return next_pow2(n, min_cap=_MIN_CAP)


@functools.cache
def _ladder_min() -> int:
    return 8 * math.lcm(ROW_TILE, COL_TILE)


def _active_bucket(n: int) -> int:
    """Quarter-pow2 ladder for ACTIVE (compute-prefix) buckets:
    {1, 1.25, 1.5, 1.75} x 2^k. ``active`` sets the dominator-prefix width
    of every SFS/merge dominance pass, so the power-of-two bucket's ~1.33x
    average overshoot would be wasted pairwise work; the finer ladder cuts
    it to ~1.11x. Storage capacities stay power-of-two (``_next_pow2``).

    The ladder only runs when the pow2 bucket ``p`` is >= ``_ladder_min()``
    (16384 at the reference's tiles); below it the bucket is ``p`` itself.
    Returned values are always >= n and <= _next_pow2(n)."""
    p = _next_pow2(n)
    if p < _ladder_min():
        return p
    step = p // 8
    for num in (5, 6, 7):
        if step * num >= n:
            return step * num
    return p


def _mp_predrop(sky, sky_valid, batch, batch_valid):
    """bf16-margin pre-drop of batch rows certainly strictly dominated by a
    row of the skyline's first ``_MP_PREFIX`` rows (``mp_predrop``), shared
    by both merge cores: sky (P, S, d), sky_valid (P, S), batch (P, B, d),
    batch_valid (P, B).

    Exact: a certified row y has a valid sky row x with x < y in every
    dimension, so the sky-vs-batch pass drops y anyway, and any batch row q
    that y would have pruned satisfies x < y <= q — x strictly dominates q
    too. Returns (batch', batch_valid', resolved (P,) int32)."""
    limit = min(sky.shape[1], _MP_PREFIX)
    return mp_predrop(sky[:, :limit], sky_valid[:, :limit], batch, batch_valid)


def _merge_step_core(sky, sky_valid, batch, batch_valid, out_cap: int, mp: bool = False):
    """One windowed-BNL step for every partition, in plain PyTorch: merge a
    new batch into a running skyline and compact survivors into a fresh
    ``out_cap`` buffer. sky (P, S, d), sky_valid (P, S), batch (P, B, d),
    batch_valid (P, B).

    sky is already a skyline (mutually non-dominated):

    - a batch point survives iff it is not dominated within its batch nor by
      the running skyline (dominated dominators prune correctly by
      transitivity, so the full sky buffer is a valid dominator set);
    - a sky point survives iff no *surviving* batch point dominates it (a
      dropped batch dominator's own dominator chain ends at a kept point
      that also dominates the victim).

    ``mp`` first runs the bf16 pre-drop (``_mp_predrop``) — exact either
    way. Survivors keep their order: sky rows first, then batch rows.
    Returns (values (P, out_cap, d), valid (P, out_cap), count (P,),
    resolved (P,) int32 — the bf16-certified drops, 0 without ``mp``).
    ``out_cap`` must be >= survivor count + batch rows."""
    resolved = torch.zeros(sky.shape[0], dtype=torch.int32, device=sky.device)
    if mp:
        batch, batch_valid, resolved = _mp_predrop(sky, sky_valid, batch, batch_valid)
    keep_sky = torch.empty_like(sky_valid)
    keep_batch = torch.empty_like(batch_valid)
    for p in range(sky.shape[0]):
        local = skyline_mask(batch[p], batch_valid[p])
        keep_batch[p] = local & ~dominated_by(batch[p], sky[p], x_valid=sky_valid[p])
        keep_sky[p] = sky_valid[p] & ~dominated_by(sky[p], batch[p], x_valid=keep_batch[p])
    x = torch.cat([sky, batch], dim=1)
    keep = torch.cat([keep_sky, keep_batch], dim=1)
    return (*compact(x, keep, out_cap), resolved)


def _t(x: torch.Tensor) -> torch.Tensor:
    """(P, N, d) rows -> the kernels' contiguous (P, d, N) layout."""
    return x.transpose(1, 2).contiguous()


def _merge_step_kernel_core(
    sky, sky_valid, batch, batch_valid, out_cap: int, mp: bool = False
):
    """``_merge_step_core`` with its three dominance passes in K2
    (``dominated_by_rect``), one launch each for all partitions: the batch
    against itself, the sky against the batch, and the kept batch against
    the sky — the reference's ``_merge_step_pallas_core``. ``mp`` runs the
    pre-drop kernel first and counts the three K2 launches as ``mp``. Neither the batch (arrival order) nor the sky (merge order) is
    sum-sorted; the kernel's skip rules assume no order. On a CPU tensor
    the wrappers run their plain versions."""
    # the kernels take contiguous validity; an active-prefix slice is not
    sky_valid, batch_valid = sky_valid.contiguous(), batch_valid.contiguous()
    resolved = torch.zeros(sky.shape[0], dtype=torch.int32, device=sky.device)
    if mp:
        batch, batch_valid, resolved = _mp_predrop(sky, sky_valid, batch, batch_valid)
    sky_t, batch_t = _t(sky), _t(batch)
    batch_local = batch_valid & ~dominated_by_rect(batch_t, batch_valid, batch_t, mp=mp)
    keep_batch = batch_local & ~dominated_by_rect(sky_t, sky_valid, batch_t, mp=mp)
    keep_sky = sky_valid & ~dominated_by_rect(batch_t, keep_batch, sky_t, mp=mp)
    x = torch.cat([sky, batch], dim=1)
    keep = torch.cat([keep_sky, keep_batch], dim=1)
    return (*compact(x, keep, out_cap), resolved)


def merge_step_active(
    sky, sky_valid, batch, bvalid, active: int, out_active: int, mp: bool = False
):
    """Incremental flush step over the ACTIVE capacity prefix only: the
    dominance passes and the compaction run over ``active`` rows of each
    partition (the bucket of the current max count; rows past it are
    invalid) and compact into ``out_active`` rows (the bucket covering
    counts + this batch), then pad back out to ``max(cap, out_active)``.
    No host sync. Requires out_active >= active and out_active >= count +
    batch rows per partition (the caller's capacity bookkeeping).

    sky (P, cap, d), sky_valid (P, cap), batch (P, B, d), bvalid (P, B).
    The kernel core runs on a CUDA tensor, the plain core on a CPU tensor,
    as the reference picks its Pallas core on its accelerator; ``mp``
    threads the bf16 passes. Returns (values (P, out_cap, d), valid
    (P, out_cap), count (P,) int64, resolved (P,) int32)."""
    P, cap, d = sky.shape
    core = _merge_step_kernel_core if on_cuda(sky) else _merge_step_core
    vals, valid, cnt, res = core(
        sky[:, :active], sky_valid[:, :active], batch, bvalid, out_active, mp
    )
    out_cap = max(cap, out_active)
    if out_active < out_cap:
        vals = torch.cat([
            vals,
            torch.full((P, out_cap - out_active, d), float("inf"), dtype=vals.dtype,
                       device=vals.device),
        ], dim=1)
        valid = torch.cat([
            valid,
            torch.zeros((P, out_cap - out_active), dtype=torch.bool, device=valid.device),
        ], dim=1)
    return vals, valid, cnt, res


def _gather(segments, union_cap: int, width: int):
    """Rows of ``segments`` back to back in one (union_cap, d) buffer:
    returns (union, origin partition (union_cap,) int64, valid (union_cap,)
    bool). Each segment is (rows (w, d) with w <= ``width``, partition id,
    true row count — a device scalar or a host int). No host sync: each
    segment writes all its rows at the running device-side offset, rows
    past its true count are +inf, each write's tail is overwritten by the
    next segment's rows, and a ``width``-row scratch tail keeps every write
    in bounds."""
    first = segments[0][0]
    d, dev = first.shape[1], first.device
    u = torch.full((union_cap + width, d), float("inf"), dtype=first.dtype, device=dev)
    uo = torch.zeros((union_cap + width,), dtype=torch.int64, device=dev)
    off = torch.zeros((), dtype=torch.int64, device=dev)
    for rows, p, count in segments:
        idx = off + torch.arange(rows.shape[0], device=dev)
        u.index_copy_(0, idx, rows)
        uo.index_fill_(0, idx, p)
        off = off + count
    uv = torch.arange(union_cap, device=dev) < off
    return u[:union_cap], uo[:union_cap], uv


def gather_union(sky, counts, active: int, union_cap: int):
    """Every partition's live prefix, back to back in partition order, in
    one (union_cap, d) buffer: returns (union, origin partition (union_cap,)
    int64, valid (union_cap,) bool). No host sync: each partition writes its
    full ``active`` slice at the running device-side count offset; rows >=
    count are +inf by the storage invariant (``_gather``)."""
    segments = [(sky[p, :active], p, counts[p]) for p in range(sky.shape[0])]
    return _gather(segments, union_cap, active)


def _merge_stats(u, uo, uv, counts):
    """The survivor-mask pass over a gathered union and the packed stats
    [counts (P,), survivors_per_partition (P,), global_count] as one int64
    vector. A merge-time call site of the dispatch (the reference's call
    under ``jax.jit``): on a card K3 or K7, or the device cascade when
    forced or when measured faster; the sweep at d <= 2."""
    keep = skyline_mask_auto(u, uv, traced=True)
    surv = torch.zeros(counts.shape[0], dtype=torch.int64, device=u.device)
    surv.scatter_add_(0, uo, keep.to(torch.int64))
    stats = torch.cat([counts.to(torch.int64), surv, keep.sum().reshape(1)])
    return keep, stats


def global_merge_stats_device(sky, counts, active: int, union_cap: int):
    """Device-side finish over the stacked state: gather every partition's
    live prefix into ONE union buffer (``gather_union``), then a single
    survivor-mask pass (K3 on the card) — no host round trip of the
    buffers (GlobalSkylineAggregator's role, FlinkSkyline.java:547-608).

    ``active`` bounds each partition's copied prefix (the bucket of the max
    count); ``union_cap`` is the bucket of the summed counts — the pass runs
    over the union's size, not P x active, which matters under routing skew.

    Returns (union (union_cap, d), keep (union_cap,) bool, stats) with
    stats = [counts (P,), survivors_per_partition (P,), global_count] as one
    int64 vector, so the caller syncs ONE small transfer."""
    u, uo, uv = gather_union(sky, counts, active, union_cap)
    keep, stats = _merge_stats(u, uo, uv, counts)
    return u, keep, stats


def global_points_device(union, keep, out_cap: int):
    """Compact the global survivors (union + keep from
    ``global_merge_stats_device``) to the front of an (out_cap, d) buffer
    for one bounded transfer."""
    return compact(union, keep, out_cap)[0]


def global_merge_delta_device(
    sky, counts, gpts, clean_bounds, active: int, clean_active: int, union_cap: int,
    dirty,
):
    """Dirty-subset variant of ``global_merge_stats_device``: the union is
    ``cached global skyline ∪ dirty partitions' current skylines``, not
    every partition's prefix.

    Exact by the merge law and transitivity: a clean partition contributes
    its cached global survivors (a point culled at cache time had a
    dominator in some then-skyline, and a partition skyline loses points
    only to strict dominance by current members, so a current dominator
    exists transitively); a dirty partition contributes its whole current
    skyline (its cached survivors may be stale, so they are left out, which
    also keeps a stale copy from counting twice). The union keeps the full
    merge's order — partitions ascending, clean segments in their cached
    (storage) order — so the answer bytes equal the full merge's.

    ``dirty``: per-partition bools. ``clean_bounds``: host (P+1,) row
    offsets of each partition's segment in ``gpts`` (the cumsum of the
    cached survivor counts). ``active`` bounds the dirty slices,
    ``clean_active`` the clean ones (the bucket of the widest clean
    segment, ``_cached_rows``); every slice writes its full width at the
    device-side running offset and advances by its true width
    (``_gather``), so nothing waits for the host.

    Returns (union, keep, stats) with the full merge's shapes and
    meanings."""
    segments = []
    for p in range(sky.shape[0]):
        if dirty[p]:
            segments.append((sky[p, :active], p, counts[p]))
        else:
            lo, w = int(clean_bounds[p]), int(clean_bounds[p + 1] - clean_bounds[p])
            segments.append((_cached_rows(gpts, lo, w, clean_active), p, w))
    u, uo, uv = _gather(segments, union_cap, max(active, clean_active))
    keep, stats = _merge_stats(u, uo, uv, counts)
    return u, keep, stats


# -- the pruned tournament-tree global merge ----------------------------------
#
# Instead of one survivor-mask pass over the whole union, (1) a host witness
# prefilter over tiny per-partition summaries drops whole partitions, then
# (2) the survivors merge pairwise up a binary tree, each pair two K2 passes
# on a card. Every step keeps the flat merge's survivor order (partitions
# ascending, storage order within one), so the root's bytes equal the flat
# merge's. Orchestration is in ``stream/batched.py`` ``PartitionSet``.


def partition_summaries_device(sky, counts, active: int):
    """Per-partition prune summaries, (P, 2d + 2) packed as
    ``[min_corner (d) | witness (d) | min_sum | max_sum]``.

    ``witness`` is a live row of the partition — the first one of least
    row sum (``row_sums``, the reference's addition order, and
    ``torch.argmin``, which takes the first minimum as ``jnp.argmin``
    does). A witness that strictly dominates another partition's least
    corner strictly dominates all of that partition. Empty partitions
    report +inf everywhere (and -inf as ``max_sum``): they neither prune
    nor survive."""
    P, cap, d = sky.shape
    s = sky[:, :active]
    valid = torch.arange(active, device=sky.device)[None, :] < counts[:, None]
    inf = torch.tensor(float("inf"), dtype=sky.dtype, device=sky.device)
    min_corner = torch.where(valid[:, :, None], s, inf).amin(dim=1)
    raw = row_sums(s.transpose(1, 2))
    sums = torch.where(valid, raw, inf)
    wi = torch.argmin(sums, dim=1)
    witness = torch.gather(s, 1, wi[:, None, None].expand(P, 1, d)).reshape(P, d)
    witness = torch.where((counts > 0)[:, None], witness, inf)
    min_sum = sums.amin(dim=1)
    max_sum = torch.where(valid, raw, -inf).amax(dim=1)
    return torch.cat([min_corner, witness, min_sum[:, None], max_sum[:, None]], dim=1)


def prune_witness_mask(summaries: np.ndarray, alive: np.ndarray, d: int):
    """Host O(P²·d) witness prefilter over ``partition_summaries_device``'s
    output: partition B is pruned when some alive partition A's witness (a
    real live row, not a bound) strictly dominates B's least corner — then
    ``witness_k < min_corner_B_k <= b_k`` in the witnessing dimension and
    ``<=`` in all, so it strictly dominates every row of B. Strict dominance
    is a strict partial order, so pruning all at once is acyclic: each
    pruned partition's chain of witnesses ends at a surviving one, at least
    one alive partition survives, and the skyline is unchanged.

    Returns ``(pruned (P,) bool, witness_of (P,) int64)``: ``witness_of[b]``
    is the lowest alive partition whose witness first pruned b, -1 when b
    survives."""
    P = summaries.shape[0]
    mins = summaries[:, :d]
    wit = summaries[:, d : 2 * d]
    pruned = np.zeros(P, dtype=bool)
    witness_of = np.full(P, -1, dtype=np.int64)
    for a in np.flatnonzero(alive):
        w = wit[a]
        if not np.all(np.isfinite(w)):
            continue  # empty partition: a +inf witness prunes nothing
        dom = np.all(w[None, :] <= mins, axis=1) & np.any(w[None, :] < mins, axis=1)
        dom[a] = False  # a witness never beats its own least corner
        dom &= alive
        witness_of[dom & ~pruned] = a
        pruned |= dom
    return pruned, witness_of


# The quantized-grid flush prefilter: GRID_BINS boundary steps per
# dimension, GRID_REPS representative skyline rows per partition. The
# summary is tiny — (P, GRID_BINS + 1, d) f32 boundaries and (P, R, d)
# int32 cell codes — against the skylines it summarises.
GRID_BINS = 32
GRID_REPS = 64


# The dimension counts at which XLA's CPU code leaves the grid ladder's
# last dimension unfused (``_ladder``).
_UNFUSED_LAST_DIM = (3, 7)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add. In
    float64 the product of a small integer ``a`` and a float32 ``b`` is
    exact, TwoSum gives the sum's exact error, and rounding to odd before
    the float32 rounding keeps the double rounding from ever differing
    from one rounding."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    odd = torch.where((err != 0) & even & torch.isfinite(s), torch.nextafter(s, toward), s)
    return odd.float()


def _ladder(lo: torch.Tensor, step: torch.Tensor, d: int) -> torch.Tensor:
    """The grid's boundaries ``lo + i * step``, i = 0..GRID_BINS, (P,
    GRID_BINS + 1, d), rounded as the reference's CPU build rounds them:
    XLA contracts the expression into a fused multiply-add in every
    dimension but the last at d = 3 and d = 7, where the product and the
    sum round apart (measured on the JAX package's CPU backend; the tests
    hold the twin to it bit for bit)."""
    ladder = torch.arange(GRID_BINS + 1, dtype=lo.dtype, device=lo.device)[None, :, None]
    lo3, step3 = lo[:, None, :], step[:, None, :]
    bounds = _fma_f32(ladder, step3, lo3)
    if d in _UNFUSED_LAST_DIM:
        bounds[..., -1] = (lo3 + ladder * step3)[..., -1]
    return bounds


def grid_summary_device(sky, counts, active: int):
    """Per-partition quantized grid summary for the flush prefilter:
    ``(bounds (P, GRID_BINS + 1, d) f32, ux (P, R, d) int32)`` with
    R = min(active, GRID_REPS), the reference's operations in its order.

    ``bounds[p, :, k]`` is an ascending ladder ``lo + i * step`` over
    dimension k's finite live range (``_ladder``), shipped to the host
    verbatim so host and device quantize against the same f32 values. ``ux`` are the
    representatives' cell codes ``#(bounds < x)``: the smallest index with
    ``x <= bounds[ux]``. The host codes a pending row y as ``vy = #(bounds
    <= y) - 1`` and drops it iff ``ux < vy`` in every dimension: then
    ``x <= bounds[ux] < bounds[vy] <= y``, so the representative — a live
    skyline row — strictly dominates y (the host checks that the ladder
    increases strictly). Representatives are the first R rows of the live
    prefix; non-finite or out-of-count ones get code GRID_BINS + 1, which
    never certifies. An empty partition gives a NaN ladder, which fails
    the host's check: no drops."""
    P, cap, d = sky.shape
    dev = sky.device
    s = sky[:, :active]
    inf = torch.tensor(float("inf"), dtype=sky.dtype, device=dev)
    valid = torch.arange(active, device=dev)[None, :] < counts[:, None]
    finite = torch.isfinite(s) & valid[:, :, None]
    lo = torch.where(finite, s, inf).amin(dim=1)  # (P, d)
    hi = torch.where(finite, s, -inf).amax(dim=1)
    # step > 0 even for a single-value dimension, so the ladder increases
    # strictly whenever lo is finite and the step survives f32 addition
    floor = torch.maximum(lo.abs(), torch.ones_like(lo)) * torch.tensor(
        1e-6, dtype=sky.dtype, device=dev
    )
    step = torch.maximum((hi - lo) / GRID_BINS, floor)
    bounds = _ladder(lo, step, d)
    r = min(active, GRID_REPS)
    reps = s[:, :r]
    rep_ok = (torch.arange(r, device=dev)[None, :] < counts[:, None]) & torch.isfinite(
        reps
    ).all(dim=2)
    ux = (bounds[:, None, :, :] < reps[:, :, None, :]).sum(dim=2, dtype=torch.int32)
    ux = torch.where(rep_ok[:, :, None], ux, GRID_BINS + 1)
    return bounds, ux


def extract_sky_leaf(sky, counts, p: int, width: int):
    """Partition ``p``'s live prefix as a tree leaf: (values (width, d),
    partition ids (width,), count). ``width`` must cover the count (the
    caller buckets its upper bound); rows past the count are +inf. The
    values are a copy: a flush writes ``sky`` in place, and a leaf (or a
    one-leaf root) can outlive it while an overlapped merge is in flight."""
    vals = sky[p, :width].clone()
    pids = torch.full((width,), p, dtype=torch.int64, device=sky.device)
    return vals, pids, counts[p]


def _cached_rows(gpts, lo: int, w: int, width: int):
    """Rows [lo, lo + w) of the cached global points as a ``width``-row
    slice masked to +inf past ``w``: the rows beyond are the next
    partitions' survivors, not padding. ``gpts`` must hold ``lo + width``
    rows (the cache pads to 2 * next_pow2(g)); no slice is clamped."""
    if lo + width > gpts.shape[0]:
        raise ValueError(
            f"cached points of {gpts.shape[0]} rows cannot hold a {width}-row slice at {lo}"
        )
    tail = torch.arange(width, device=gpts.device)[:, None] >= w
    return torch.where(tail, float("inf"), gpts[lo : lo + width])


def extract_cached_leaf(gpts, lo: int, w: int, p: int, width: int):
    """A clean partition's cached global-survivor segment, rows [lo, lo +
    w) of the cached points, as a ``width``-row tree leaf for the delta
    merge (``_cached_rows``)."""
    dev = gpts.device
    pids = torch.full((width,), p, dtype=torch.int64, device=dev)
    return _cached_rows(gpts, lo, w, width), pids, torch.tensor(w, dtype=torch.int64, device=dev)


def tree_pair_merge(a, apids, acnt, b, bpids, bcnt, out_cap: int):
    """Merge two tree nodes — each already a skyline — and compact the
    survivors in [a order, b order].

    Two passes suffice: a b-row that dominates an a-row cannot itself be
    dominated by any a-row (transitivity would put two rows of one skyline
    in dominance), so every valid a-row is a correct dominator set for b,
    and the b-rows that survive are a correct dominator set for a. On a
    card both passes are K2 (``dominated_by_rect``) in the kernels' (d, N)
    layout; on the CPU the same wrapper runs its plain version.

    With leaves in ascending partition order every level keeps (partition,
    storage row) order, so the root's bytes equal the flat merge's.
    ``out_cap`` must be >= acnt + bcnt. Partition ids ride along for the
    root's per-partition survivor counts. Returns (values (out_cap, d),
    partition ids (out_cap,), count)."""
    wa, wb = a.shape[0], b.shape[0]
    av = torch.arange(wa, device=a.device) < acnt
    bv = torch.arange(wb, device=b.device) < bcnt
    at, bt = a.T.contiguous(), b.T.contiguous()
    keep_b = bv & ~dominated_by_rect(at, av, bt)
    keep_a = av & ~dominated_by_rect(bt, keep_b, at)
    vals, pids, _, cnt = compact_tagged(
        torch.cat([a, b]), torch.cat([apids, bpids]), torch.cat([keep_a, keep_b]), out_cap
    )
    return vals, pids, cnt


def tree_stats_device(counts, root_pids, root_cnt, num_partitions: int):
    """The tree root in the flat merge's stats layout ``[counts (P,) |
    survivors_per_partition (P,) | global_count]`` (int64), so the caller's
    harvest and cache are shared. Pruned and empty partitions report 0
    survivors."""
    valid = torch.arange(root_pids.shape[0], device=root_pids.device) < root_cnt
    surv = torch.zeros(num_partitions, dtype=torch.int64, device=root_pids.device)
    surv.scatter_add_(0, torch.where(valid, root_pids, 0), valid.to(torch.int64))
    return torch.cat([counts.to(torch.int64), surv, root_cnt.reshape(1).to(torch.int64)])


def tree_points_device(vals, out_cap: int):
    """The tree root's values cut or padded to ``out_cap`` rows. Rows past
    the survivor count are already +inf (the compaction, or the sky storage
    invariant for a one-leaf root), so this gives ``global_points_device``'s
    bytes."""
    w, d = vals.shape
    if out_cap <= w:
        return vals[:out_cap]
    pad = torch.full((out_cap - w, d), float("inf"), dtype=vals.dtype, device=vals.device)
    return torch.cat([vals, pad])


# -- the meshed flush steps ------------------------------------------------------
#
# The reference wraps each per-partition core in ``shard_map(vmap(core))``
# over the partition axis: every device runs its resident partitions, with no
# collective. Here the state is ``parallel/mesh.py`` ``Placed``: a slice for
# each run of places that share a device (``device_spans``), resident there.
# A step runs the batched core once a slice, on its device, over those
# places' contiguous partitions, and returns the new state in the same
# form; only the step's other inputs (the batch, the counts) cross to the
# slices' devices and its small outputs (counts, certified drops) back. A
# mesh whose places all sit on the state's device — one card, or the CPU —
# is one slice: the flat step itself. A core's in-place append writes only
# its own slice, so no device reads what another writes.


def _per_place(mesh, axis: str, core, n_out: int):
    def run(state, *ins):
        placed = state if isinstance(state, Placed) else Placed.split(mesh, state, axis)
        home = ins[0].device
        outs = []
        for span, dev, part in placed.parts:
            with on_device(dev):
                outs.append(core(part, *gather_to(dev, [t[span] for t in ins])))
        new = Placed(tuple((span, dev, o[0]) for (span, dev, _), o in zip(placed.parts, outs)))
        if len(outs) == 1:
            return (new, *outs[0][1:])
        with on_device(home):
            return (new, *(
                torch.cat(gather_to(home, [o[k] for o in outs])) for k in range(1, n_out)
            ))

    return run


@functools.lru_cache(maxsize=None)
def meshed_merge_step(mesh, axis: str, active: int, out_active: int, mp: bool = False):
    """``merge_step_active`` each place over its own partitions:
    ``step(sky, sky_valid, batch, bvalid) -> (values, valid, count,
    resolved)``, ``sky`` and ``values`` a ``Placed`` state (``sky`` may be
    one tensor, split on the way in), over the ``active`` prefix, compacted into ``out_active``
    rows and padded to ``max(cap, out_active)`` (K2 on a card, the plain
    core on the CPU). The reference's step runs over the whole capacity;
    the rows past the live counts are invalid, so the state is the same
    bytes. Cached per (mesh, axis, buckets, ``mp``)."""
    return _per_place(
        mesh, axis,
        lambda s, sv, b, bv: merge_step_active(s, sv, b, bv, active, out_active, mp), 4,
    )


@functools.lru_cache(maxsize=None)
def meshed_sfs_round(mesh, axis: str, active: int, mp: bool = False):
    """``ops.sfs.sfs_round`` each place over its own partitions — the
    lazy policy's meshed flush: ``step(sky, counts, blocks, bvalids) ->
    (sky, counts, resolved)``, ``sky`` as in ``meshed_merge_step``. Cached
    per (mesh, axis, active bucket, ``mp``)."""
    return _per_place(
        mesh, axis, lambda s, c, b, bv: sfs_round(s, c, b, bv, active, mp), 3
    )


@functools.lru_cache(maxsize=None)
def meshed_sfs_cleanup(mesh, axis: str, old_active: int, active: int):
    """``ops.sfs.sfs_cleanup`` each place over its own partitions — the
    old-vs-new prune after SFS rounds on a non-empty state:
    ``step(sky, counts, old_counts) -> (sky, counts)``, ``sky`` as in
    ``meshed_merge_step``."""
    return _per_place(
        mesh, axis, lambda s, c, oc: sfs_cleanup(s, c, oc, old_active, active), 2
    )

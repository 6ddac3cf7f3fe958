"""Capacity buckets, the incremental merge step and the flat global merge
over the stacked state.

Counterpart of the single-device part of ``skyline_tpu/stream/window.py``
(the merge step and the flat merge). Running skylines live on the device as
padded power-of-two-capacity buffers; compute prefixes use a finer
quarter-power-of-two ladder. The bucket arithmetic is the reference's,
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

import torch

from skyline_tpu_torch.ops.dispatch import on_cuda, skyline_mask_auto
from skyline_tpu_torch.ops.dominance import compact, dominated_by, skyline_mask
from skyline_tpu_torch.ops.dominance_kernels import dominated_by_rect
from skyline_tpu_torch.utils.buckets import next_pow2
from skyline_tpu_torch.utils.knobs import refuse_mixed_precision

# Reference flushes its input buffer at 5000 tuples (BUFFER_SIZE,
# FlinkSkyline.java:232); the default is the nearest power of two.
DEFAULT_BUFFER_SIZE = 4096

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

    Survivors keep their order: sky rows first, then batch rows. Returns
    (values (P, out_cap, d), valid (P, out_cap), count (P,)). ``out_cap``
    must be >= survivor count + batch rows. ``mp`` raises: the bf16
    pre-drop is not ported."""
    refuse_mixed_precision(mp)
    keep_sky = torch.empty_like(sky_valid)
    keep_batch = torch.empty_like(batch_valid)
    for p in range(sky.shape[0]):
        local = skyline_mask(batch[p], batch_valid[p])
        keep_batch[p] = local & ~dominated_by(batch[p], sky[p], x_valid=sky_valid[p])
        keep_sky[p] = sky_valid[p] & ~dominated_by(sky[p], batch[p], x_valid=keep_batch[p])
    x = torch.cat([sky, batch], dim=1)
    keep = torch.cat([keep_sky, keep_batch], dim=1)
    return compact(x, keep, out_cap)


def _t(x: torch.Tensor) -> torch.Tensor:
    """(P, N, d) rows -> the kernels' contiguous (P, d, N) layout."""
    return x.transpose(1, 2).contiguous()


def _merge_step_kernel_core(
    sky, sky_valid, batch, batch_valid, out_cap: int, mp: bool = False
):
    """``_merge_step_core`` with its three dominance passes in K2
    (``dominated_by_rect``), one launch each for all partitions: the batch
    against itself, the sky against the batch, and the kept batch against
    the sky — the reference's ``_merge_step_pallas_core``. Neither the
    batch (arrival order) nor the sky (merge order) is sum-sorted; the
    kernel's skip rules assume no order. On a CPU tensor the wrappers run
    their plain versions."""
    refuse_mixed_precision(mp)
    sky_t, batch_t = _t(sky), _t(batch)
    # the kernels take contiguous validity; an active-prefix slice is not
    sky_valid, batch_valid = sky_valid.contiguous(), batch_valid.contiguous()
    batch_local = batch_valid & ~dominated_by_rect(batch_t, batch_valid, batch_t)
    keep_batch = batch_local & ~dominated_by_rect(sky_t, sky_valid, batch_t)
    keep_sky = sky_valid & ~dominated_by_rect(batch_t, keep_batch, sky_t)
    x = torch.cat([sky, batch], dim=1)
    keep = torch.cat([keep_sky, keep_batch], dim=1)
    return compact(x, keep, out_cap)


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
    as the reference picks its Pallas core on its accelerator. Returns
    (values (P, out_cap, d), valid (P, out_cap), count (P,) int64)."""
    refuse_mixed_precision(mp)
    P, cap, d = sky.shape
    core = _merge_step_kernel_core if on_cuda(sky) else _merge_step_core
    vals, valid, cnt = core(
        sky[:, :active], sky_valid[:, :active], batch, bvalid, out_active
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
    return vals, valid, cnt


def gather_union(sky, counts, active: int, union_cap: int):
    """Every partition's live prefix, back to back in partition order, in
    one (union_cap, d) buffer: returns (union, origin partition (union_cap,)
    int64, valid (union_cap,) bool). No host sync: each partition writes its
    full ``active`` slice at the running device-side count offset; rows >=
    count are +inf by the storage invariant, each write's tail is
    overwritten by the next partition's rows, and an ``active``-row scratch
    tail keeps every write in bounds."""
    P, cap, d = sky.shape
    dev = sky.device
    scratch = union_cap + active
    u = torch.full((scratch, d), float("inf"), dtype=sky.dtype, device=dev)
    uo = torch.zeros((scratch,), dtype=torch.int64, device=dev)
    ar = torch.arange(active, device=dev)
    off = torch.zeros((), dtype=torch.int64, device=dev)
    for p in range(P):
        idx = off + ar
        u.index_copy_(0, idx, sky[p, :active])
        uo.index_fill_(0, idx, p)
        off = off + counts[p]
    uv = torch.arange(union_cap, device=dev) < off
    return u[:union_cap], uo[:union_cap], uv


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
    P = sky.shape[0]
    u, uo, uv = gather_union(sky, counts, active, union_cap)
    keep = skyline_mask_auto(u, uv)
    surv = torch.zeros(P, dtype=torch.int64, device=sky.device)
    surv.scatter_add_(0, uo, keep.to(torch.int64))
    g = keep.sum().reshape(1)
    stats = torch.cat([counts.to(torch.int64), surv, g])
    return u, keep, stats


def global_points_device(union, keep, out_cap: int):
    """Compact the global survivors (union + keep from
    ``global_merge_stats_device``) to the front of an (out_cap, d) buffer
    for one bounded transfer."""
    return compact(union, keep, out_cap)[0]

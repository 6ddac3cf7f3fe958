"""SFS (sort-filter-skyline) append rounds.

Under minimization, ``a`` dominates ``b`` implies ``sum(a) < sum(b)``; after
sorting a window by coordinate sum ascending and streaming blocks in order,
the skyline buffer becomes APPEND-ONLY: every block survivor is globally
non-dominated (nothing later can dominate it), so there is no buffer
re-pruning and no re-compaction — one forward pass of O(N·S) dominance work
(the reference's BNL loop, SkylineLocalProcessor.processBuffer,
FlinkSkyline.java:417-444, done in blocks).

Counterpart of ``skyline_tpu/ops/sfs.py``. ``sfs_round`` and
``sfs_cleanup`` take a leading partition dimension ``P`` where the
reference used ``jax.vmap``; the ``*_core`` single-partition forms are
views with P = 1. The dominance passes go through
the kernel wrappers (K1 self-prune, K2 sky-vs-block and cleanup), which run
the CUDA kernel on a card and the plain version on the CPU.

The reference's jits donate the sky buffer so an append round updates it in
place; here the append round writes the block survivors into ``sky`` in
place (``scatter_``) and returns the same tensor — callers treat the passed
buffer as updated. The cleanup compacts into a new buffer, as the
reference's does.

``mp`` (the mixed-precision flush, ``SKYLINE_MIXED_PRECISION``) first drops
the block rows a bf16 margin test certifies as strictly dominated by one of
the skyline's first ``_MP_PREFIX`` rows (``mp_predrop``, the pre-drop
kernel on a card), then runs K1 and K2 counted as their ``mp`` launches.
Both are exact: the appended rows and their order are those of
``mp=False``.
"""

from __future__ import annotations

import torch

from skyline_tpu_torch.ops.dominance import compact
from skyline_tpu_torch.ops.dominance_kernels import (
    dominated_by_any,
    dominated_by_rect,
    mp_predrop_kernel,
)

# Dominator-prefix length of the bf16 row pre-drop: block rows certainly
# strictly dominated by one of the first _MP_PREFIX skyline rows are dropped
# (masked to +inf) before the exact kernels. Sum-sorted skylines put the
# strongest dominators first, so a short prefix catches most dominated rows
# at O(B * prefix) cost.
_MP_PREFIX = 512


def _t(x: torch.Tensor) -> torch.Tensor:
    """(P, N, d) rows -> the kernels' contiguous (P, d, N) layout."""
    return x.transpose(1, 2).contiguous()


def mp_predrop(dom, dom_ok, block, bvalid):
    """The bf16 row pre-drop for all partitions: dom (P, L, d) dominator
    rows with validity dom_ok (P, L), block (P, B, d) with bvalid (P, B).
    Rows of the block a valid dominator certainly strictly dominates
    (``strictly_dominated_bf16``) leave the block: invalid and masked to
    +inf, which only moves a row's sum up, so sum-sorted callers stay
    sorted for the rows that count. Returns (block', bvalid', resolved
    (P,) int32, the certified drops). On a card one fused kernel call
    (``mp_predrop_kernel``, which reads ``dom`` in place) and one sum."""
    block, bvalid, counts = mp_predrop_kernel(dom, dom_ok, block, bvalid)
    return block, bvalid, counts.sum(dim=-1, dtype=torch.int32)


def sfs_round(sky, counts, blocks, bvalids, active: int, mp: bool = False):
    """One SFS append round for all partitions: sky (P, cap, d) buffers whose
    first ``counts[p]`` rows are a skyline, counts (P,) int64, blocks
    (P, B, d) sum-sorted ascending (invalid rows +inf at the end) with all
    sums >= any previously appended block's in this SFS pass, bvalids
    (P, B). Appends each block's survivors at ``counts[p]``, in place.
    ``active`` bounds the dominator prefix compared against — the capacity
    bucket of the current max count, so early rounds don't pay
    full-capacity passes. One launch per kernel for the whole set — right
    when partitions carry comparable row counts (every partition computes
    the full (B x active) passes whether its block is real or padding; see
    ``sfs_round_single`` for skew). ``mp``: the bf16 pre-drop against
    ``min(active, _MP_PREFIX)`` prefix rows, then K1 and K2 counted as
    their ``mp`` launches — the same appends.

    Caller guarantees counts + B <= cap (the compacted block writes B slots;
    rows past the survivor count are +inf padding landing on virgin rows).
    Returns (sky, counts', resolved (P,) int32 — bf16-certified drops, 0
    without ``mp``)."""
    sky_ok = torch.arange(active, device=sky.device)[None, :] < counts[:, None]
    resolved = torch.zeros(sky.shape[0], dtype=torch.int32, device=sky.device)
    if mp:
        limit = min(active, _MP_PREFIX)
        blocks, bvalids, resolved = mp_predrop(
            sky[:, :limit], sky_ok[:, :limit], blocks, bvalids
        )
    block_t = _t(blocks)
    keep = bvalids & ~dominated_by_any(block_t, bvalids, triangular=True, mp=mp)
    keep &= ~dominated_by_rect(_t(sky[:, :active]), sky_ok, block_t, mp=mp)
    return (*sfs_append(sky, counts, blocks, keep), resolved)


def sfs_append(sky, counts, blocks, keep):
    """Append each block's kept rows, compacted stably, at ``counts[p]`` of
    its partition's buffer, in place: sky (P, cap, d), counts (P,) int64,
    blocks (P, B, d), keep (P, B). Returns (sky, counts')."""
    P, _, d = sky.shape
    B = blocks.shape[1]
    vals, _, m = compact(blocks, keep, B)
    dst = counts[:, None] + torch.arange(B, device=sky.device)
    sky.scatter_(1, dst.unsqueeze(-1).expand(P, B, d), vals)
    return sky, counts + m


def sfs_round_core(sky_p, count, block, bvalid, active: int, mp: bool = False):
    """One partition's round: sky_p (cap, d), count () int64, block (B, d),
    bvalid (B,) -> (sky_p', count', resolved () int32), ``sky_p`` updated
    in place. Under routing skew (mr-angle at 8D anti-correlated routes ~96%
    of rows to 2 of 8 partitions) the batched round pays P lanes of work for
    one real lane; processing heavy partitions one at a time costs exactly
    their own rows."""
    sky, counts, res = sfs_round(
        sky_p[None], count.reshape(1), block[None], bvalid[None], active, mp
    )
    return sky[0], counts[0], res[0]


# the reference jits the core under this name for the skew path
sfs_round_single = sfs_round_core


def sfs_cleanup(sky, counts, old_counts, old_active: int, active: int):
    """Old-vs-new prune after SFS rounds on non-empty initial state, for all
    partitions (sky (P, cap, d), counts and old_counts (P,) int64): old rows
    (prefix ``old_counts[p]``) may be dominated by newly appended rows
    (non-dominated among themselves and not dominated BY the old rows);
    prune and re-compact stably into a new buffer.

    ``old_active``/``active`` are the capacity buckets of the old and final
    max counts (old_active <= active) — dominator and victim sets are sliced
    to them so a shrunken skyline in a grown buffer never pays
    full-capacity passes. Returns (sky', counts')."""
    new_ok = cleanup_new_rows(counts, old_counts, active)
    old_dom = dominated_by_rect(
        _t(sky[:, :active]), new_ok, _t(sky[:, :old_active])
    )
    return cleanup_compact(sky, old_counts, new_ok, old_dom)


def cleanup_new_rows(counts, old_counts, active: int):
    """(P, active) bool: the rows a flush appended, ``old_counts[p] <= row <
    counts[p]`` — the cleanup's dominators."""
    ar = torch.arange(active, device=counts.device)
    return (ar[None, :] >= old_counts[:, None]) & (ar[None, :] < counts[:, None])


def cleanup_compact(sky, old_counts, new_ok, old_dom):
    """Keep every new row and the old rows (prefix ``old_counts[p]``, the
    first ``old_dom.shape[1]`` rows) that no new row dominates; compact
    stably into a new buffer. Returns (sky', counts')."""
    P, cap, _ = sky.shape
    active, old_active = new_ok.shape[1], old_dom.shape[1]
    ar = torch.arange(old_active, device=sky.device)
    old_keep = (ar[None, :] < old_counts[:, None]) & ~old_dom
    keep = torch.zeros((P, cap), dtype=torch.bool, device=sky.device)
    keep[:, :active] = new_ok
    keep[:, :old_active] = old_keep | new_ok[:, :old_active]
    vals, _, cnt = compact(sky, keep, cap)
    return vals, cnt


def sfs_cleanup_core(s, c, old_c, old_active: int, active: int):
    """One partition's cleanup: s (cap, d), c and old_c () int64 ->
    (vals (cap, d), count)."""
    vals, cnt = sfs_cleanup(
        s[None], c.reshape(1), old_c.reshape(1), old_active, active
    )
    return vals[0], cnt[0]

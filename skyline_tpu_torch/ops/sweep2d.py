"""Exact low-dimensional skylines by sort + prefix-min sweep.

Counterpart of ``skyline_tpu/ops/sweep2d.py``. At d <= 2 the skyline needs
no pairwise dominance: sort the points lexicographically by (x, y) and a
point survives iff no earlier point dominates it, which collapses to two
comparisons against running minima — O(n log n), a few sorts and scans, no
kernel of its own (XLA in the reference too). Dominance semantics match
``ops/dominance.py`` (min-better, strict in at least one dim — duplicates
all survive).

Derivation (d = 2, ascending lexsort by (x, y)): every candidate dominator
of a point p precedes it in sort order. Split by x:

- some q with q.x < p.x dominates p iff min{q.y : q.x < p.x} <= p.y;
- some q with q.x == p.x dominates p iff p.y > the group's minimum y (the
  group's first element, since ties sort by y).

The partitioned variant sorts ONE concatenated buffer by (pid, x, y) and
resets the running minima at partition boundaries with a segmented scan, so
the whole multi-partition flush is sorts, scans and one scatter — no host
sync inside, no loop over partitions. Invalid rows ride along as +inf
(they sort last within their segment and can never dominate).

Sort order: stable sorts, least significant key first, give the
reference's ``jnp.lexsort`` order — ``-0.0`` ties ``0.0`` and NaN sorts
last in both. The running minima are NaN-propagating like ``lax.cummin``;
they may differ from the reference's in the sign of a zero, which no
comparison below can see. Stored rows keep their own bits.
"""

from __future__ import annotations

import torch


def _lexsort(keys) -> torch.Tensor:
    """Indices that sort by ``keys`` (last key primary, as ``jnp.lexsort``),
    stably: one stable sort per key, least significant first."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _starts(a: torch.Tensor) -> torch.Tensor:
    """True where ``a`` differs from its predecessor (and at 0). NaN differs
    from everything, as ``!=`` says."""
    first = torch.ones((min(1, a.shape[0]),), dtype=torch.bool, device=a.device)
    return torch.cat([first, a[1:] != a[:-1]])


def _group_start(flags: torch.Tensor) -> torch.Tensor:
    """Index of the last True of ``flags`` at or before each position
    (``flags[0]`` must be True)."""
    idx = torch.arange(flags.shape[0], device=flags.device)
    return torch.cummax(torch.where(flags, idx, 0), dim=0).values


def skyline_mask_sweep2(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Survivor mask of (n, 2) points (min-better), False on invalid rows."""
    n = x.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=x.device)
    inf = float("inf")
    xs_raw = torch.where(valid, x[:, 0], inf)
    ys_raw = torch.where(valid, x[:, 1], inf)
    order = _lexsort((ys_raw, xs_raw))
    xs, ys = xs_raw[order], ys_raw[order]
    gs_idx = _group_start(_starts(xs))
    # min y over all points with strictly smaller x: the inclusive running
    # min at the previous group's last element
    m = torch.cummin(ys, dim=0).values
    prev_min = torch.where(gs_idx > 0, m[torch.clamp(gs_idx - 1, min=0)], inf)
    dominated = (prev_min <= ys) | (ys > ys[gs_idx])
    keep = torch.empty_like(dominated)
    keep[order] = ~dominated
    return keep & valid


def skyline_mask_sweep1(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """d=1: every copy of the valid minimum survives."""
    v = torch.where(valid, x[:, 0], float("inf"))
    if v.numel() == 0:
        return valid.clone()
    return (v == v.min()) & valid


def skyline_mask_sweep(x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Dispatch by dimensionality (d <= 2 only)."""
    if valid is None:
        valid = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
    d = x.shape[1]
    if d == 1:
        return skyline_mask_sweep1(x, valid)
    if d == 2:
        return skyline_mask_sweep2(x, valid)
    raise ValueError(f"sweep skyline supports d <= 2, got {d}")


def _segmented_cummin(y: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive running min of ``y`` that restarts wherever ``seg_start``
    is True: a log-step scan over (min, segment flag) pairs, the
    reference's associative combine, with no host sync."""
    m, s = y, seg_start
    n = y.shape[0]
    step = 1
    while step < n:
        m_prev, s_prev = m[:-step], s[:-step]
        m_cur, s_cur = m[step:], s[step:]
        m = torch.cat([m[:step], torch.where(s_cur, m_cur, torch.minimum(m_prev, m_cur))])
        s = torch.cat([s[:step], s_prev | s_cur])
        step *= 2
    return m


def partitioned_sweep2_core(
    values: torch.Tensor, pids: torch.Tensor, valid: torch.Tensor, num_partitions: int
):
    """Sort + sweep phase of the partitioned 2D skyline.

    values: (N, 2); pids: (N,) partition of each row (any value on invalid
    rows); valid: (N,) bool. One lexsort by (pid, x, y), then the sweep
    recurrences with running minima reset at partition boundaries. Returns
    ``(rows_sorted (N, 2) f32, p_sorted (N,) int32 [sentinel P on invalid],
    keep (N,) bool, rank (N,) int64 survivor rank within its partition,
    counts (P,) int64)`` — callers sync ``counts`` to size the output, then
    scatter with ``scatter_sweep2``."""
    dev = values.device
    inf = float("inf")
    P = num_partitions
    pid_s = torch.where(valid, pids.to(torch.int32), P)
    xs_raw = torch.where(valid, values[:, 0], inf)
    ys_raw = torch.where(valid, values[:, 1], inf)
    order = _lexsort((ys_raw, xs_raw, pid_s))
    p, xs, ys = pid_s[order], xs_raw[order], ys_raw[order]
    seg_start = _starts(p)
    gs_idx = _group_start(seg_start | _starts(xs))
    m = _segmented_cummin(ys, seg_start)
    # min y among SAME-partition points with strictly smaller x: the
    # segmented running min at the previous x-group's last element, unless
    # the group opens its partition
    at_prev = m[torch.clamp(gs_idx - 1, min=0)]
    has_prev = ~seg_start[gs_idx] & (gs_idx > 0)
    prev_min = torch.where(has_prev, at_prev, inf)
    dominated = (prev_min <= ys) | (ys > ys[gs_idx])
    keep = ~dominated & (p < P)
    # survivor rank within its partition: the exclusive running count, less
    # the count before the partition's first row
    ones = keep.to(torch.int64)
    excl = torch.cumsum(ones, dim=0) - ones
    rank = excl - excl[_group_start(seg_start)]
    counts = torch.zeros((P + 1,), dtype=torch.int64, device=dev)
    counts.scatter_add_(0, torch.where(keep, p, P).long(), ones)
    rows = torch.stack([xs, ys], dim=1).to(torch.float32)
    return rows, p, keep, rank, counts[:P]


def scatter_sweep2(
    rows_sorted, p_sorted, keep, rank, counts, num_partitions: int, cap: int
):
    """Scatter phase: pack ``partitioned_sweep2_core`` survivors into the
    stacked ``(P, cap, 2)`` +inf-padded layout the partition set stores.
    Survivors past ``cap`` are dropped — callers size ``cap`` from the synced
    counts. Returns ``(sky, counts clipped to cap)``."""
    P = num_partitions
    dev = rows_sorted.device
    ok = keep & (rank < cap)
    # flat slot per survivor; everything else lands in one spare slot
    slot = torch.where(ok, p_sorted.long() * cap + rank, P * cap)
    flat = torch.full((P * cap + 1, 2), float("inf"), dtype=torch.float32, device=dev)
    flat[slot] = rows_sorted
    return flat[: P * cap].reshape(P, cap, 2), torch.clamp(counts, max=cap)


def partitioned_sweep2(values, pids, valid, num_partitions: int, cap: int):
    """Per-partition 2D skylines of one mixed buffer: core + scatter.
    Returns ``(sky (P, cap, 2) front-packed +inf-padded, counts (P,))``."""
    rows, p, keep, rank, counts = partitioned_sweep2_core(values, pids, valid, num_partitions)
    return scatter_sweep2(rows, p, keep, rank, counts, num_partitions, cap)

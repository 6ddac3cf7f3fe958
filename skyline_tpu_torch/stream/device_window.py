"""Device-resident ingest: routing, window assembly and SFS block slicing on
the card instead of host numpy.

Counterpart of ``skyline_tpu/stream/device_window.py``. Raw chunks upload
once as they arrive; partition ids and per-chunk barrier stats are computed
on the device (``ingest_chunk``); the flush-time (partition, coordinate-sum)
sort and segment bounds are one device pass (``sort_window``); and the SFS
rounds read their blocks straight out of the sorted device window — no host
routing, assembly or per-block upload.

With ``SKYLINE_RANK_CASCADE`` on (``rank_flush_enabled``), the flush ranks
the window and the live skyline prefixes once (``rank_window``, K4's
operations) and the rounds and the cleanup compare dense int32 ranks (K5,
K6) instead of values; rows are still appended in value space.

The reference's jits donate their buffers; here ``ingest_chunk`` writes the
window buffers in place, and the SFS rounds append to ``sky`` in place and
return it (``ops/sfs.py``). The ``*_vmapped`` forms take a leading
partition dimension where the reference used ``jax.vmap``. Every function
runs on the tensors' device: the kernels on a card, their plain versions on
the CPU.
"""

from __future__ import annotations

import torch

from skyline_tpu_torch.ops.dominance_kernels import (
    dominated_by_any_rank,
    dominated_by_rank_rect,
    row_sums,
    searchsorted_cols,
    sort_columns,
    with_rank_sum,
)
from skyline_tpu_torch.ops import cascade
from skyline_tpu_torch.ops.sfs import (
    cleanup_compact,
    cleanup_new_rows,
    sfs_append,
    sfs_round,
    sfs_round_single,
)
from skyline_tpu_torch.parallel.partitioners import partition_ids

# Padding tail appended to the sorted window, so a B-row block starting at
# any valid row offset stays inside the buffer. Must be >= the largest SFS
# block size the flush loops use.
SORT_TAIL = 65536


def ingest_chunk(
    window: torch.Tensor,
    pidbuf: torch.Tensor,
    chunk: torch.Tensor,
    ids: torch.Tensor,
    nvalid: int,
    offset: int,
    *,
    algo: str,
    num_partitions: int,
    domain_max: float,
) -> torch.Tensor:
    """Append one uploaded chunk to the device window and route it.

    window: (cap, d) +inf-padded accumulation buffer and pidbuf: (cap,)
    int32 (``num_partitions`` sentinel for invalid rows), both written in
    place at ``offset``; chunk: (B, d) +inf-padded rows; ids: (B,) int32
    record ids (-1 padding); the first ``nvalid`` rows are real.

    Returns stats (2, P) int32: per-partition [row counts, max record ids]
    of THIS chunk (int32 min where a partition got no row, as
    ``segment_max``) — the barrier bookkeeping (FlinkSkyline.java:276-283),
    synced lazily on the host only when a query needs it."""
    B = chunk.shape[0]
    valid = torch.arange(B, device=chunk.device) < nvalid
    pids = partition_ids(chunk, algo, num_partitions, domain_max)
    pids = torch.where(valid, pids, num_partitions).to(torch.int32)
    window[offset : offset + B] = chunk
    pidbuf[offset : offset + B] = pids
    seg = pids.long()
    counts = torch.zeros(num_partitions + 1, dtype=torch.int32, device=chunk.device)
    counts.scatter_add_(0, seg, valid.to(torch.int32))
    maxids = torch.full(
        (num_partitions + 1,), torch.iinfo(torch.int32).min, dtype=torch.int32,
        device=chunk.device,
    )
    maxids.scatter_reduce_(
        0, seg, torch.where(valid, ids, -1).to(torch.int32), reduce="amax"
    )
    return torch.stack([counts[:num_partitions], maxids[:num_partitions]])


def sort_window(
    window: torch.Tensor,
    pidbuf: torch.Tensor,
    nvalid: int,
    n_bucket: int,
    num_partitions: int,
    tail: int,
):
    """Flush-time shuffle: order the accumulated window by (partition id,
    coordinate sum) and return per-partition segment bounds.

    Within each partition the rows come out in ascending coordinate-sum
    order — the SFS append-only invariant (ops/sfs.py), so the flush loops
    stream contiguous blocks straight from this buffer. Two stable argsorts
    compose the two-key order, as in the reference. Rows at or past
    ``nvalid`` are forced to the sentinel pid (the buffer is reused across
    windows and may hold a larger earlier window's rows); they sort last and
    ``bounds[P]`` equals ``nvalid``.

    Returns (sorted (n_bucket + tail, d) with a +inf tail, bounds (P + 1,)
    int32)."""
    d = window.shape[1]
    dev = window.device
    w = window[:n_bucket]
    p = torch.where(
        torch.arange(n_bucket, device=dev) < nvalid, pidbuf[:n_bucket], num_partitions
    ).to(torch.int32)
    sums = torch.where(p < num_partitions, row_sums(w), float("inf"))
    o1 = torch.argsort(sums, stable=True)
    o2 = torch.argsort(p[o1], stable=True)
    order = o1[o2]
    ws = torch.cat(
        [w[order], torch.full((tail, d), float("inf"), dtype=w.dtype, device=dev)]
    )
    bounds = torch.searchsorted(
        p[order],
        torch.arange(num_partitions + 1, dtype=torch.int32, device=dev),
        out_int32=True,
    )
    return ws, bounds


def rank_flush_enabled() -> bool:
    """Rank-cascade SFS flush: on when ``SKYLINE_RANK_CASCADE`` is on — with
    the rank kernels on a card and their plain versions on the CPU (the
    counterpart of the reference's interpret mode). Read at flush time,
    through the dispatch table's ``mask_rank_pallas`` gate (the knob, else
    a tuner override), as in the reference."""
    return cascade.gate("mask_rank_pallas")


def rank_window(ws, sky, counts, n_bucket: int, active_old: int, univ_bucket: int):
    """Rank preprocessing for the rank-cascade SFS flush: the compared
    universe is the sorted window's first ``n_bucket`` rows plus every
    partition's live skyline prefix (old survivors are dominators against
    new blocks and cleanup victims, so they share the rank space — dense
    ranks are exact only over universe members), padded with +inf to
    ``univ_bucket`` rows.

    ws: (n_bucket + tail, d) sorted window; sky: (P, cap, d) with
    ``active_old`` bounding live prefixes (0 = fresh set: the window alone);
    counts: (P,) live counts.

    Returns (sorted_dims (univ_bucket, d) — each dimension of the universe
    ascending, for ranking universe members later — and ws_ranks
    (ws rows, d + 1) int32: the window rows' ranks with their sum last,
    sliceable like ``ws``)."""
    P, _, d = sky.shape
    parts = [ws[:n_bucket]]
    if active_old:
        ok = torch.arange(active_old, device=sky.device)[None, :] < counts[:, None]
        act = torch.where(ok[..., None], sky[:, :active_old], float("inf"))
        parts.append(act.reshape(P * active_old, d))
    univ = torch.cat(parts)
    pad = univ_bucket - univ.shape[0]
    if pad > 0:
        univ = torch.cat(
            [univ, torch.full((pad, d), float("inf"), dtype=univ.dtype, device=univ.device)]
        )
    sorted_t = sort_columns(univ)
    return sorted_t.T, with_rank_sum(searchsorted_cols(sorted_t, ws))


def _rank_rows(sorted_dims, rows):
    """Rank universe-member rows (N, d) against the sorted universe ->
    (N, d+1) int32 ranks plus rank sum."""
    return with_rank_sum(searchsorted_cols(sorted_dims.T, rows))


def _t(x: torch.Tensor) -> torch.Tensor:
    """(P, N, c) rows -> the kernels' contiguous (P, c, N) layout."""
    return x.transpose(1, 2).contiguous()


def _blocks_at(win, offs, widths, B: int):
    """Every partition's (B, ·) block of ``win`` at its offset, rows past
    its width masked: offs, widths (P,) int64 on the device -> (blocks
    (P, B, ·), valid (P, B)). The tail rows of a partition's last block
    belong to the NEXT partition in the sorted order."""
    ar = torch.arange(B, device=win.device)
    return win[offs[:, None] + ar], ar[None, :] < widths[:, None]


def _sfs_round_rank_core(sky, counts, blocks, block_r, bvalid, sorted_dims, active: int):
    """Rank-cascade SFS round body for all partitions: the dominance passes
    compare dense ranks, the append stays in value space. sky (P, cap, d),
    counts (P,), blocks (P, B, d), block_r (P, B, d+1) their ranks, bvalid
    (P, B). The sky's active prefix is re-ranked per round (d searchsorteds
    over ``active`` rows, amortised against the B x active pass)."""
    P, _, d = sky.shape
    blocks = torch.where(bvalid[..., None], blocks, float("inf"))
    # invalid tail rows get the largest rank in every column, sum included,
    # so they are inert like +inf values (their true ranks belong to the
    # next partition's rows, which are live universe members)
    block_r = torch.where(
        bvalid[..., None], block_r, sorted_dims.shape[0] * (d + 1)
    ).to(torch.int32)
    sky_ok = torch.arange(active, device=sky.device)[None, :] < counts[:, None]
    sky_r = _rank_rows(sorted_dims, sky[:, :active].reshape(P * active, d))
    block_rt = _t(block_r)
    keep = bvalid & ~dominated_by_any_rank(block_rt, bvalid, triangular=True)
    keep &= ~dominated_by_rank_rect(_t(sky_r.reshape(P, active, d + 1)), sky_ok, block_rt)
    return sfs_append(sky, counts, blocks, keep)


def sfs_round_at_rank(
    sky_p, count, win, wr, sorted_dims, off: int, width: int, *, B: int, active: int
):
    """Single-partition rank-cascade round over ``win[off : off + B]`` (the
    first ``width`` rows valid): sky_p (cap, d), count () int64, wr the
    window's ranks from ``rank_window``. Returns (sky_p, count'), sky_p
    updated in place."""
    bvalid = torch.arange(B, device=win.device) < width
    sky, counts = _sfs_round_rank_core(
        sky_p[None], count.reshape(1), win[off : off + B][None],
        wr[off : off + B][None], bvalid[None], sorted_dims, active,
    )
    return sky[0], counts[0]


def sfs_round_at_rank_vmapped(
    sky, counts, win, wr, sorted_dims, offs, widths, *, B: int, active: int
):
    """Rank-cascade round for all partitions, each slicing its own block of
    the shared sorted window: sky (P, cap, d), counts/offs/widths (P,) int64
    on the device."""
    blocks, bvalid = _blocks_at(win, offs, widths, B)
    block_r, _ = _blocks_at(wr, offs, widths, B)
    return _sfs_round_rank_core(sky, counts, blocks, block_r, bvalid, sorted_dims, active)


def sfs_cleanup_rank(sky, counts, old_counts, sorted_dims, old_active: int, active: int):
    """Rank-cascade twin of ``ops.sfs.sfs_cleanup``: prune old rows dominated
    by newly appended rows, comparing in rank space (old prefixes joined the
    universe in ``rank_window``). Returns (sky', counts')."""
    P, _, d = sky.shape
    new_ok = cleanup_new_rows(counts, old_counts, active)
    act_r = _t(_rank_rows(sorted_dims, sky[:, :active].reshape(P * active, d)).reshape(
        P, active, d + 1
    ))
    old_dom = dominated_by_rank_rect(act_r, new_ok, act_r[:, :, :old_active].contiguous())
    return cleanup_compact(sky, old_counts, new_ok, old_dom)


def sfs_round_at(
    sky_p, count, win, off: int, width: int, *, B: int, active: int, mp: bool = False
):
    """One partition's value-space SFS round over ``win[off : off + B]``,
    rows past ``width`` masked to +inf (inert as dominators, never
    appended): the device-window twin of ``ops.sfs.sfs_round_single``;
    ``mp`` threads the bf16 passes. Returns (sky_p, count', resolved)."""
    bvalid = torch.arange(B, device=win.device) < width
    block = torch.where(bvalid[:, None], win[off : off + B], float("inf"))
    return sfs_round_single(sky_p, count, block, bvalid, active, mp)


def sfs_round_at_vmapped(
    sky, counts, win, offs, widths, *, B: int, active: int, mp: bool = False
):
    """``sfs_round_at`` for all partitions in one pass per kernel, each
    slicing its own block of the shared sorted window: offs/widths (P,)
    int64 on the device. Returns (sky, counts', resolved (P,))."""
    blocks, bvalid = _blocks_at(win, offs, widths, B)
    blocks = torch.where(bvalid[..., None], blocks, float("inf"))
    return sfs_round(sky, counts, blocks, bvalid, active, mp)

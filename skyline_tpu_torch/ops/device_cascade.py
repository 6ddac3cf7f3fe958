"""Device-side sorted dominance cascade.

Counterpart of ``skyline_tpu/ops/device_cascade.py``: the host cascade's
sort-and-scan structure (``ops/sorted_sfs.py``) on the device, so it runs
on a card and at a merge-time call site. Steps:

1.  **Fold** ``-0.0 -> +0.0`` on a selection-only copy (equal tuples become
    bit-equal, which the dedup needs) and make every invalid or NaN row
    all-NaN: such rows never dominate, are never dominated (every NaN
    comparison is False) and sort last.
2.  **Sort** on the f32 row sum, then the folded columns (d + 1 stable
    sorts, least significant key first — torch has no ``lexsort``): the
    approximate dominance order, with exact duplicates adjacent.
3.  **Dedup** into adjacent segments: only a segment's first row (its
    representative) is a candidate; every member inherits its fate.
4.  **Certify** each row's key error: ``r = (d - 1) * 2^-23 * sum|x|``
    bounds |key - exact sum| for any summation order, so if w dominates v
    then ``key(w) - r(w) <= key(v) + r(v)``. A NaN key (a row mixing +inf
    and -inf) takes lo = -inf, hi = +inf.
5.  **Prune** the sorted candidates, in blocks, by (a) the grow-only
    buffer of survivors of earlier blocks, (b) the block itself — the full
    square, since equal f32 keys let a dominator sort after its victim — and
    (c) the later blocks whose certified ``lo`` reaches the block's ``hi``.
    With mixed precision each block's rows first meet a bf16 margin test
    against the buffer's first 512 rows, which drops rows it certifies as
    strictly dominated. Survivors append to the buffer.

Every kill is exact strict dominance by a valid non-NaN candidate, and
every dominated candidate has a surviving dominator that is in the buffer,
in its block or in its band, so the mask is ``skyline_mask``'s exactly —
and stays so under any superset of those dominators drawn from real
candidates. The mask is ``cand_ok & ~pre & ~(a) & ~(b) & ~(c)``, and (b)
and (c) read candidates only, not the buffer; so where the reference runs
them inside its ``lax.scan``, per block under ``lax.cond``, the port runs
both once for all blocks before the scan, as ONE window pass
(``cascade_windows``) in which block b's rows meet the candidate rows
``[b * block, band_end[b] * block)``: the block itself (no row strictly
dominates itself) and its band, the band's end computed on the device from
the blocks' key ranges (``_band_ends``), the candidates read row-major in
place. The scan, pre-drop and (a) with the appends, is ONE call
(``cascade_scan``) that walks the blocks in order on one thread-block
cluster, skipping a block with no row left, and keeps the buffer and its
count on the card. A call makes a fixed number of launches whatever the
block count, and reads nothing to the host.

On a card the passes are the hand-written kernels of ``csrc/cascade.cu``
(through ``ops/dominance_kernels.py``: ``cascade_windows`` and
``cascade_scan``; ``mp`` from
``SKYLINE_MIXED_PRECISION``), with the reference's accelerator sizes (block
and padding at least 1024 rows); on the CPU the same wrappers run their
plain versions, with the reference's host sizes (padding at least 64 rows,
so tiny blocks can be tested).
"""

from __future__ import annotations

import numpy as np
import torch

from skyline_tpu_torch.ops.dominance import PAD_VALUE
from skyline_tpu_torch.ops.dominance_kernels import cascade_scan, cascade_windows, row_sums
from skyline_tpu_torch.utils.buckets import next_pow2
from skyline_tpu_torch.utils.devices import resolve_device
from skyline_tpu_torch.utils.knobs import device_cascade_block, mixed_precision_enabled


def _rows_equal_prev(xs: torch.Tensor) -> torch.Tensor:
    """eq[i] = row i equals row i-1, NaN slots matching NaN slots (eq[0]
    compares with the last row and is masked by the caller)."""
    prev = torch.roll(xs, 1, dims=0)
    return torch.all((xs == prev) | (torch.isnan(xs) & torch.isnan(prev)), dim=1)


def _lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """The permutation ``jnp.lexsort(keys)`` gives: the last key primary,
    ties broken by the keys before it; stable; NaN keys last."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _band_ends(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """For each block b, one past the last later block j with ``lo[j] <=
    hi[b]`` (b + 1 when there is none), on the blocks' device: the band
    spans blocks b+1 .. end-1. One (nb, nb) compare masked to j > b and a
    max over the masked indices. Blocks in between that miss the condition
    only add real dominators."""
    j = torch.arange(lo.shape[0], device=lo.device)
    reach = (lo[None, :] <= hi[:, None]) & (j[None, :] > j[:, None])
    return torch.maximum(torch.where(reach, j[None, :] + 1, 0).amax(dim=1), j + 1)


def _cascade_core(x: torch.Tensor, valid: torch.Tensor, block: int, mp: bool) -> torch.Tensor:
    """Survivor mask over padded (n_pad, d) points; n_pad % block == 0."""
    n_pad, d = x.shape
    nb = n_pad // block
    dev = x.device
    nan = torch.full((), float("nan"), dtype=torch.float32, device=dev)

    # selection-only copy: fold -0.0, make invalid/NaN rows all-NaN
    inert = ~valid | torch.isnan(x).any(dim=1)
    xc = torch.where(inert[:, None], nan, x + 0.0)
    key = row_sums(xc)
    radius = torch.full((), (d - 1) * 2.0 ** -23, dtype=torch.float32, device=dev) * row_sums(
        xc.abs()
    )
    lo, hi = key - radius, key + radius
    lo = torch.where(torch.isnan(lo), float("-inf"), lo)
    hi = torch.where(torch.isnan(hi), float("inf"), hi)

    # the sum key primary, the folded columns as tie-breakers: exact
    # duplicates become adjacent
    perm = _lexsort([xc[:, j] for j in range(d - 1, -1, -1)] + [key])
    xs = xc[perm]
    valid_s = valid[perm]
    inert_s = inert[perm]
    iota = torch.arange(n_pad, device=dev)
    seg_start = (iota == 0) | ~_rows_equal_prev(xs)
    rep_idx = torch.cummax(torch.where(seg_start, iota, 0), dim=0).values
    cand_ok = seg_start & ~inert_s
    # non-candidates (duplicate members, inert rows) become all-NaN rows:
    # neutral both ways in every pass
    cand = torch.where(cand_ok[:, None], xs, nan).contiguous()
    lo_s = torch.where(cand_ok, lo[perm], float("inf"))
    hi_s = torch.where(cand_ok, hi[perm], float("-inf"))
    band_end = _band_ends(lo_s.reshape(nb, block).amin(dim=1),
                          hi_s.reshape(nb, block).amax(dim=1))

    # (b) and (c): block b against the candidates of blocks b ..
    # band_end[b]-1, itself (the full square) and its band, one window pass
    # (dominated rows acting as dominators are fine: transitivity)
    dominated = cascade_windows(cand, block, band_end.to(torch.int32), mp=mp)
    alive = cand_ok & ~dominated
    # (a) the scan: the pre-drop (mp) and the survivors of earlier blocks,
    # each block's survivors appended in sort order
    alive_all = cascade_scan(cand, alive, block, mp)
    # members inherit their representative's fate; valid inert (NaN) rows
    # survive
    keep_sorted = (alive_all[rep_idx] | inert_s) & valid_s
    keep = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
    keep[perm] = keep_sorted
    return keep


def device_cascade_mask(x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Survivor mask via the device cascade — ``skyline_mask``'s mask, in
    the caller's row order. On a card the scan block is at least 1024 rows
    and the padding at least 1024; on the CPU at least 64."""
    n, d = x.shape
    dev = x.device
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=dev)
    on_card = dev.type == "cuda"
    mp = mixed_precision_enabled(dev)
    blk = device_cascade_block()
    if on_card:
        blk = max(blk, 1024)
    n_pad = next_pow2(n, min_cap=1024 if on_card else 64)
    blk = min(blk, n_pad)
    x = x.to(torch.float32)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    if n_pad != n:
        x = torch.cat([x, torch.full((n_pad - n, d), PAD_VALUE, dtype=torch.float32, device=dev)])
        valid = torch.cat([valid, torch.zeros((n_pad - n,), dtype=torch.bool, device=dev)])
    return _cascade_core(x, valid, blk, mp)[:n]


def device_cascade_keep(rows: np.ndarray, old: np.ndarray, device="cuda") -> np.ndarray:
    """Keep-mask over ``rows`` of the survivors of ``old ∪ rows``, computed
    on ``device``: the rows the SFS rounds would append over the resident
    skyline ``old`` (the contract of ``sorted_sfs_keep``). Host in, host
    out."""
    dev = resolve_device(device)
    rows = np.asarray(rows, dtype=np.float32)
    old = np.asarray(old, dtype=np.float32)
    if rows.shape[0] == 0:
        return np.zeros((0,), dtype=bool)
    union = np.concatenate([old, rows], axis=0) if old.shape[0] else rows
    keep = device_cascade_mask(torch.from_numpy(np.ascontiguousarray(union)).to(dev))
    return keep.cpu().numpy()[old.shape[0] :]

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
5.  **Scan** the sorted candidates in blocks, each pruned against (a) the
    grow-only buffer of survivors of earlier blocks, (b) itself — the
    full square, since equal f32 keys let a dominator sort after its
    victim — and (c) the later blocks whose certified ``lo`` reaches this
    block's ``hi``. With mixed precision the block first drops rows a bf16
    margin test certifies as strictly dominated by the buffer's first 512
    rows. Survivors append to the buffer.

Every kill is exact strict dominance by a valid non-NaN candidate, and
every dominated candidate has a surviving dominator that is in the buffer,
in its block or in its band, so the mask is ``skyline_mask``'s exactly —
and stays so under any superset of those dominators drawn from real
candidates. The port uses that: where the reference runs ``lax.cond`` per
buffer chunk and per later block inside one static-shape scan, the port
reads each block's key range and candidate count to the host ONCE per call
and launches, per block with candidates: the pre-drop (``mp``, buffer not
empty), one K2 over the buffer's live prefix (bounded on the host by the
candidates of earlier blocks, validity ``row < count`` on the device), one
K1 over the block and one K2 over the band's whole span of later blocks.
Blocks without candidates launch nothing. The buffer count never leaves
the device.

On a card the passes are the hand-written kernels (``ops/
dominance_kernels.py``: the pre-drop kernel, K1 ``dominated_by_any`` and K2
``dominated_by_rect``, ``mp`` from ``SKYLINE_MIXED_PRECISION``), with the
reference's accelerator sizes (block and padding at least 1024 rows); on
the CPU the same wrappers run their plain versions, with the reference's
host sizes (padding at least 64 rows, so tiny blocks can be tested).
"""

from __future__ import annotations

import numpy as np
import torch

from skyline_tpu_torch.ops.dominance import PAD_VALUE, compact
from skyline_tpu_torch.ops.dominance_kernels import (
    dominated_by_any,
    dominated_by_rect,
    row_sums,
    strictly_dominated_bf16_kernel,
)
from skyline_tpu_torch.utils.buckets import next_pow2
from skyline_tpu_torch.utils.devices import resolve_device
from skyline_tpu_torch.utils.knobs import device_cascade_block, mixed_precision_enabled

# bf16 pre-drop prefix (ops.sfs._MP_PREFIX): under mp each block first drops
# rows certainly dominated by the buffer's first rows, which have the
# smallest sums and so dominate the most
_MP_PREFIX = 512


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


def _band_ends(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """For each block b, one past the last later block j with ``lo[j] <=
    hi[b]`` (b + 1 when there is none): the band spans blocks b+1 .. end-1.
    Blocks in between that miss the condition only add real dominators."""
    nb = lo.shape[0]
    end = np.arange(1, nb + 1)
    for b in range(nb - 1):
        hit = np.flatnonzero(lo[b + 1 :] <= hi[b])
        if hit.size:
            end[b] = b + 2 + hit[-1]
    return end


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
    # one float32 row each, the counts' int32 bits carried unchanged
    summary = torch.stack([
        lo_s.reshape(nb, block).amin(dim=1),
        hi_s.reshape(nb, block).amax(dim=1),
        cand_ok.reshape(nb, block).sum(dim=1, dtype=torch.int32).view(torch.float32),
    ]).cpu().numpy()  # the one host read of the call
    block_lo, block_hi = summary[0], summary[1]
    n_cand = summary[2].view(np.int32).astype(np.int64)
    band_end = _band_ends(block_lo, block_hi)

    buf = torch.full((n_pad, d), PAD_VALUE, dtype=torch.float32, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    ub = 0  # host bound on count: the candidates of earlier blocks
    alive_all = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
    ones = torch.ones((block,), dtype=torch.bool, device=dev)
    for b in np.flatnonzero(n_cand):
        s, e = int(b) * block, (int(b) + 1) * block
        blk = cand[s:e]
        blk_t = blk.T.contiguous()
        alive = cand_ok[s:e]
        if ub:
            buf_ok = torch.arange(ub, device=dev) < count
            if mp:
                # bf16 margin pre-drop against the buffer prefix (a
                # certified drop is a proof of f32 strict dominance)
                pre = min(ub, _MP_PREFIX)
                alive = alive & ~strictly_dominated_bf16_kernel(blk, buf[:pre], buf_ok[:pre])
            # (a) the survivors of earlier blocks
            alive = alive & ~dominated_by_rect(buf[:ub].T.contiguous(), buf_ok, blk_t, mp=mp)
        # (b) the block against itself, the full square
        alive = alive & ~dominated_by_any(blk_t, ones, triangular=False, mp=mp)
        # (c) the band: later blocks whose certified lo reaches this hi
        # (dominated rows acting as dominators are fine: transitivity)
        be = int(band_end[b]) * block
        if be > e:
            alive = alive & ~dominated_by_rect(
                cand[e:be].T.contiguous(), cand_ok[e:be], blk_t, mp=mp
            )
        alive_all[s:e] = alive
        # append the survivors in sort order at the device-side count
        # (count + block <= n_pad, since count <= b * block)
        vals, _, cnt = compact(blk, alive, block)
        buf.index_copy_(0, count + torch.arange(block, device=dev), vals)
        count = count + cnt
        ub += int(n_cand[b])
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

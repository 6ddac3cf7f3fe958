"""Sorted-order SFS dominance cascade for d > 2 on the host.

Counterpart of ``skyline_tpu/ops/sorted_sfs.py``: host numpy, selection
only, the reference's arithmetic step for step —

1. **dedup** of byte-identical tuples after folding ``-0.0`` into ``+0.0``
   (every copy of a tuple shares one verdict, so the north-star's all-zero
   clump collapses to one candidate; distinct rows that compare
   ``all(<=)`` are strict somewhere, so one comparison per dimension a pair
   suffices);
2. **sum-sorted scan** of the unique tuples by their float64 row sum, in
   blocks against a grow-only survivor buffer visited smallest sum first in
   1024-row chunks, victims compressed out after every chunk;
3. **in-block exact tiles** for the equal- and near-sum band.

The semantics are ``ops.dominance.skyline_mask``'s: minimization,
``all(<=) & any(<)``, duplicates all survive, NaN rows neither dominate
nor are dominated, invalid rows are excluded; rows mixing +inf and -inf
(a NaN sum) take an exact pairwise detour. No arithmetic touches the
returned rows, so mask equality is byte identity. The dispatch
(``ops/dispatch.py``, ``ops/cascade.py``) routes only concrete CPU calls
and lazy flushes on the CPU here.
"""

from __future__ import annotations

import numpy as np

from skyline_tpu_torch.utils.knobs import sorted_sfs_block

__all__ = [
    "sorted_skyline_mask_np",
    "sorted_sfs_keep",
    "sorted_sfs_block",
]


# buffer chunk width for the strongest-first compression pass; fixed —
# small enough that the (chunk × alive) tile stays cache-resident, big
# enough that the per-chunk python overhead is noise
_CHUNK = 1024


def _dominated_any(dominators: np.ndarray, victims: np.ndarray) -> np.ndarray:
    """(m,) bool: victim j is dominated by SOME dominator row.

    Caller guarantees dominators and victims are distinct-as-tuples
    normalized rows (post-dedup, -0.0 folded into +0.0), so ``all(<=)``
    between different rows implies strictness and one comparison per
    dimension suffices. The per-dimension accumulate with an early bail
    keeps the peak intermediate at one (n, m) bool tile."""
    le = dominators[:, 0:1] <= victims[None, :, 0]
    for k in range(1, dominators.shape[1]):
        if not le.any():
            break
        le &= dominators[:, k : k + 1] <= victims[None, :, k]
    return le.any(axis=0)


def _self_prune(rows: np.ndarray) -> np.ndarray:
    """(b,) bool keep-mask of one block against itself (exact dense tile;
    rows are distinct normalized tuples, see ``_dominated_any``)."""
    b = rows.shape[0]
    if b <= 1:
        return np.ones(b, bool)
    le = rows[:, 0:1] <= rows[None, :, 0]
    for k in range(1, rows.shape[1]):
        le &= rows[:, k : k + 1] <= rows[None, :, k]
    np.fill_diagonal(le, False)
    return ~le.any(axis=0)


def _scan_unique(uniq: np.ndarray) -> np.ndarray:
    """Keep-mask over distinct normalized tuples — the sorted-order SFS
    scan itself (steps 2 and 3 of the module docstring)."""
    m, _ = uniq.shape
    keep = np.zeros(m, bool)
    with np.errstate(invalid="ignore"):
        s = uniq.astype(np.float64).sum(axis=1)
    special = np.isnan(s)  # mixed ±inf rows: no usable sort key
    core = np.flatnonzero(~special)
    order = np.argsort(s[core], kind="stable")
    core = core[order]
    U = uniq[core]
    k = core.size

    buf: list[np.ndarray] = []  # survivor arrays, ascending-sum order
    B_max = sorted_sfs_block()
    B = min(1024, B_max)
    i = 0
    while i < k:
        blk = U[i : i + B]
        pos = np.arange(i, min(i + B, k))
        alive = np.ones(blk.shape[0], bool)
        # buffer pass: strongest (smallest-sum) chunks first, victims
        # compressed out as soon as anything kills them
        for barr in buf:
            for j in range(0, barr.shape[0], _CHUNK):
                if not alive.any():
                    break
                ai = np.flatnonzero(alive)
                dead = _dominated_any(barr[j : j + _CHUNK], blk[ai])
                if dead.any():
                    alive[ai[dead]] = False
            if not alive.any():
                break
        # in-block exact tile: the ambiguous equal/near-sum band
        if alive.any():
            ai = np.flatnonzero(alive)
            alive[ai[~_self_prune(blk[ai])]] = False
        if alive.any():
            buf.append(blk[alive])
            keep[core[pos[alive]]] = True
        i += B
        B = min(B * 2, B_max)

    if special.any():
        # NaN-sum rows: exact pairwise both ways against everything.
        # These rows are vanishingly rare (a row must mix +inf and -inf),
        # so the dense detour is O(|special| * m).
        spec_idx = np.flatnonzero(special)
        for si in spec_idx:
            row = uniq[si]
            others = np.delete(np.arange(m), si)
            if not _dominated_any(uniq[others], row[None, :]).any():
                keep[si] = True
        # ...and as dominators over the core survivors
        surv = np.flatnonzero(keep & ~special)
        if surv.size:
            dead = _dominated_any(uniq[spec_idx], uniq[surv])
            keep[surv[dead]] = False
    return keep


def sorted_skyline_mask_np(x, valid=None) -> np.ndarray:
    """Exact survivor mask of an (n, d) host array — byte-for-byte the
    same mask ``ops.dominance.skyline_mask`` computes, via the sorted
    cascade (see module docstring). Returns an (n,) numpy bool array."""
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    out = np.zeros(n, bool)
    if n == 0:
        return out
    if valid is None:
        vidx = np.arange(n)
    else:
        vidx = np.flatnonzero(np.asarray(valid))
        if vidx.size == 0:
            return out
    xv = x[vidx]
    # NaN rows: never dominate, never dominated -> always survive
    nanrow = np.isnan(xv).any(axis=1)
    if nanrow.any():
        out[vidx[nanrow]] = True
        xv = xv[~nanrow]
        vidx = vidx[~nanrow]
        if vidx.size == 0:
            return out
    # fold -0.0 into +0.0 so byte dedup equals numeric dedup (the only
    # IEEE pair of distinct bit patterns that compare numerically equal);
    # selection-only: the fold never reaches the caller's rows
    xv = xv + np.float32(0.0)
    uniq, inv = np.unique(xv, axis=0, return_inverse=True)
    if uniq.shape[0] == 1:
        out[vidx] = True  # all duplicates of one tuple: everything lives
        return out
    out[vidx] = _scan_unique(uniq)[inv.reshape(-1)]
    return out


def sorted_sfs_keep(rows: np.ndarray, old: np.ndarray | None = None) -> np.ndarray:
    """Flush helper: keep-mask over ``rows`` of the survivors of
    ``old ∪ rows`` restricted to ``rows`` — exactly the set the device
    SFS rounds append (new-window rows not dominated by the resident
    skyline or by any other new row; old rows dominated by new ones are
    later removed by ``sfs_cleanup``, same as the device path)."""
    rows = np.asarray(rows, dtype=np.float32)
    if old is None or old.shape[0] == 0:
        return sorted_skyline_mask_np(rows)
    old = np.asarray(old, dtype=np.float32)
    union = np.concatenate([old, rows], axis=0)
    return sorted_skyline_mask_np(union)[old.shape[0] :]

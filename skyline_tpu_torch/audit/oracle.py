"""Host oracles for the audit plane — the independent answers published
skylines are shadow-verified against.

Counterpart of ``skyline_tpu/audit/oracle.py``. Host numpy, never the
card: the oracle checks what the card computed.

Two implementations, selected by ``SKYLINE_AUDIT_ORACLE``:

- ``quadratic`` — ``ops.dominance.skyline_np``: the O(n²d) float64
  pairwise oracle the audit plane shipped with. At full sample it costs
  ~766ms/check on the bench union (194.5% tax), which is why
  SKYLINE_AUDIT_SAMPLE had to be dialed down.
- ``sorted`` (default) — this module's sorted band scan: group
  numerically-equal rows with a lexicographic sort, order group
  representatives by float64 row sum, then sweep fixed-size sum-ordered
  *bands* against the survivor set (a dominator's fixed-order float64
  sum is never greater than its victim's — rounding is monotone — so
  every cross-band domination points backward) and close each band
  with an exact both-direction pairwise tile (which covers equal-sum
  ambiguity inside the band). Full-rate shadow verification drops
  under the 100ms/check budget.

This is deliberately an independent implementation, not a port of
``ops/sorted_sfs.py`` (which the engine itself may be executing): no
dedup via ``np.unique``, no growing block schedule, no
distinct-implies-strict shortcut — every pairwise verdict here is the
full ``all(<=) & any(<)`` check in float64, like the quadratic oracle.
An oracle that shares code with the system under test can only confirm
its own bugs; tests gate the two oracles against each other
(oracle-of-the-oracle), and the quadratic one stays available behind
the knob for exactly that purpose.

Same contract as ``skyline_np``: rows in, surviving rows out (original
bytes, original relative order); duplicates all survive; NaN rows
neither dominate nor are dominated; invalidity is the caller's problem
(the auditor passes the already-published union).
"""

from __future__ import annotations

import numpy as np

from skyline_tpu_torch.utils.knobs import env_str

__all__ = ["oracle_kind", "oracle_fn", "sorted_skyline_np"]

_VCHUNK = 512  # victims per dominated-check tile (bounds the n*m*d tmp)
_DCHUNK = 2048  # dominators per survivor-sweep tile (early-exit grain)
_BAND = 1024  # candidates advanced per scan step (sum-ordered band)


def oracle_kind() -> str:
    """``SKYLINE_AUDIT_ORACLE``: which host oracle the auditor trusts."""
    v = env_str("SKYLINE_AUDIT_ORACLE", "sorted")
    return v if v in ("sorted", "quadratic") else "sorted"


def oracle_fn():
    """The selected rows-in/rows-out oracle callable."""
    if oracle_kind() == "quadratic":
        from skyline_tpu_torch.ops.dominance import skyline_np

        return skyline_np
    return sorted_skyline_np


def _any_dominates(doms: np.ndarray, victims: np.ndarray) -> np.ndarray:
    """(m,) bool: victim j is fully dominated (``all(<=) & any(<)``) by
    some dominator row. Chunked over victims to bound the broadcast."""
    out = np.zeros(victims.shape[0], bool)
    for j in range(0, victims.shape[0], _VCHUNK):
        v = victims[None, j : j + _VCHUNK, :]
        le = np.all(doms[:, None, :] <= v, axis=2)
        lt = np.any(doms[:, None, :] < v, axis=2)
        out[j : j + _VCHUNK] = (le & lt).any(axis=0)
    return out


def sorted_skyline_np(x) -> np.ndarray:
    """Skyline rows of ``x`` via the run-partitioned sorted scan."""
    rows = np.asarray(x)
    n = rows.shape[0]
    if n == 0:
        return rows[:0].copy()
    xs = rows.astype(np.float64)  # f32 -> f64 is exact; comparisons agree
    keep = np.zeros(n, bool)

    nanrow = np.isnan(xs).any(axis=1)
    keep[nanrow] = True  # NaN rows always survive
    vidx = np.flatnonzero(~nanrow)
    if vidx.size == 0:
        return rows[keep]
    xv = xs[vidx]

    # group numerically-equal rows (lexsort compares values, so -0.0 and
    # +0.0 land in one group — correct: dominance is numeric)
    order = np.lexsort(xv.T)
    xo = xv[order]
    same = np.zeros(order.size, bool)
    if order.size > 1:
        same[1:] = np.all(xo[1:] == xo[:-1], axis=1)
    gid_sorted = np.cumsum(~same) - 1
    gid = np.empty(order.size, np.int64)
    gid[order] = gid_sorted
    reps = order[~same]  # first member of each group, in lexsort order
    R = xv[reps]

    with np.errstate(invalid="ignore"):
        sums = R.sum(axis=1)
    special = np.isnan(sums)  # mixed ±inf rows: no sort key, see below
    core = np.flatnonzero(~special)
    core = core[np.argsort(sums[core], kind="stable")]

    g_alive = np.zeros(reps.size, bool)
    # survivors live in ONE doubling array, swept in _DCHUNK tiles, and
    # candidates advance in fixed-size sum-ordered bands rather than one
    # equal-sum run at a time: a per-run python loop degenerates to
    # O(runs²) interpreter overhead when nearly every row has a distinct
    # sum (anti-correlated low-d unions). Correctness doesn't need run
    # boundaries — the survivor sweep is the full both-direction check
    # (a larger-sum band member can never pass all(<=) against a
    # smaller-sum victim, so the in-band pairwise tile is exact, and a
    # dead band member's kills are covered by dominance transitivity).
    dcols = xv.shape[1]
    surv_arr = np.empty((0, dcols), np.float64)
    s_count = 0
    i = 0
    while i < core.size:
        j = min(i + _BAND, core.size)
        band = core[i:j]
        cand = R[band]
        alive = np.ones(band.size, bool)
        for lo in range(0, s_count, _DCHUNK):
            hi = min(lo + _DCHUNK, s_count)  # never sweep unfilled capacity
            alive &= ~_any_dominates(surv_arr[lo:hi], cand)
            if not alive.any():
                break
        if alive.any() and band.size > 1:
            a = np.flatnonzero(alive)
            alive[a[_any_dominates(cand, cand[a])]] = False
        if alive.any():
            new = cand[alive]
            need = s_count + new.shape[0]
            if need > surv_arr.shape[0]:
                cap = max(1024, surv_arr.shape[0])
                while cap < need:
                    cap *= 2
                grown = np.empty((cap, dcols), np.float64)
                grown[:s_count] = surv_arr[:s_count]
                surv_arr = grown
            surv_arr[s_count:need] = new
            s_count = need
            g_alive[band[alive]] = True
        i = j

    if special.any():
        spec = np.flatnonzero(special)
        for gsi in spec:  # as victims: against every other group rep
            others = np.delete(np.arange(reps.size), gsi)
            if not _any_dominates(R[others], R[gsi][None, :]).any():
                g_alive[gsi] = True
        live = np.flatnonzero(g_alive & ~special)  # ...and as dominators
        if live.size:
            dead = _any_dominates(R[spec], R[live])
            g_alive[live[dead]] = False

    keep[vidx] = g_alive[gid]
    return rows[keep]

"""Correctness canaries: known-answer micro-states for every merge path.

Counterpart of ``skyline_tpu/audit/canary.py``. Each state's
``PartitionSet`` lives on the device the caller names (the auditor passes
its engine's), so on a card the canaries launch the flush kernels and the
tree's K2.

Organic audit checks only cover the paths live traffic happens to take —
an idle deployment, or one whose workload never dirties a partition
subset, could carry a silently broken ``tree_delta`` or ``cache_hit``
path for days. Each canary here builds a tiny deterministic
``PartitionSet`` whose exact skyline is KNOWN BY CONSTRUCTION (no oracle
in the loop), steers the merge down one specific decision path, and
compares the emitted points byte-for-byte against the hand-computed
answer. The ``host`` canary closes the remaining gap by checking the
audit oracle itself (``ops.dominance.skyline_np``) against a known
answer, so a broken oracle cannot silently vouch for broken fast paths.

Known-answer construction: any set of DISTINCT points with EQUAL
coordinate sum is mutually non-dominated (componentwise ``a <= b`` with
``a != b`` forces ``sum(a) < sum(b)``), so "parents on the sum-S plane
plus strictly-dominated chaff at parent + 0.25" has skyline == parents,
exactly, in float32. Path steering uses only state shape — d=2 avoids
the tournament tree, a repeated merge hits the epoch cache, a
single-partition re-flush lands under the delta cutoff — never knob
mutation, so canaries verify the paths PRODUCTION is configured to run.

Driven by the engine owner's idle loop every ``SKYLINE_AUDIT_CANARY_S``
seconds (``Auditor.maybe_canary``) and directly via
``Auditor.run_canaries``.
"""

from __future__ import annotations

import time

import numpy as np

from skyline_tpu_torch.audit import first_diff

_P = 4  # canary partition count; 1-of-4 dirty = 0.25 < the 0.75 cutoff
_N_PARENTS = 8
_CHAFF_DELTA = 0.25


def _parents(d: int, n: int = _N_PARENTS) -> np.ndarray:
    """``n`` distinct float32 points on the sum-S plane (S = 3n): the
    exact skyline of every canary state that embeds them."""
    s = 3.0 * n
    out = np.zeros((n, d), dtype=np.float32)
    for k in range(n):
        out[k, 0] = float(k)
        if d > 1:
            out[k, 1] = float((2 * k) % n)
        if d > 2:
            # dump the remainder into the last coord; middle coords stay 0
            out[k, d - 1] = s - out[k, :2].sum()
        else:
            out[k, 1] = s - out[k, 0]
    return out


def _micro_state(d: int) -> tuple[np.ndarray, np.ndarray]:
    """(all rows, expected skyline) for one canary state: parents plus one
    strictly-dominated chaff row per parent."""
    parents = _parents(d)
    chaff = parents + np.float32(_CHAFF_DELTA)
    rows = np.concatenate([parents, chaff], axis=0)
    return np.ascontiguousarray(rows), parents


def _mk_pset(d: int, device):
    from skyline_tpu_torch.stream.batched import PartitionSet

    return PartitionSet(_P, d, buffer_size=256, device=device)


def _fill(pset, rows: np.ndarray) -> None:
    """Round-robin the rows across partitions (a chaff row usually lands
    away from its dominating parent, so it survives the partition-local
    skyline and only dies in the global merge — the interesting case)."""
    for p in range(_P):
        sub = np.ascontiguousarray(rows[p::_P])
        if sub.shape[0]:
            pset.add_batch(p, sub, max_id=rows.shape[0], now_ms=0.0)
    pset.flush_all()


def _merge_with_plan(pset) -> tuple[np.ndarray, str | None]:
    """Global merge with a throwaway EXPLAIN plan attached, so the canary
    can report which decision path the merge ACTUALLY took."""
    from skyline_tpu_torch.telemetry.explain import QueryPlan

    plan = QueryPlan("canary", "canary")
    pset.set_explain(plan)
    _, _, g, pts = pset.global_merge_stats(emit_points=True)
    taken = (plan.merge or {}).get("path")
    if pts is None:
        pts = np.empty((0, pset.dims), dtype=np.float32)
    return np.asarray(pts, dtype=np.float32), taken


def _verdict(pts: np.ndarray, expected: np.ndarray, taken) -> tuple[bool, dict]:
    diff = first_diff(pts, expected)
    return diff is None, {
        "taken": taken,
        "rows": int(np.asarray(pts).shape[0]),
        "expected_rows": int(expected.shape[0]),
        "first_diff": diff,
    }


def _canary_flat(device) -> tuple[bool, dict]:
    """d=2 keeps the tournament tree structurally out (tree needs d>2), so
    a cold merge takes the flat union pass."""
    rows, expected = _micro_state(2)
    pset = _mk_pset(2, device)
    _fill(pset, rows)
    pts, taken = _merge_with_plan(pset)
    return _verdict(pts, expected, taken)


def _canary_tree(device) -> tuple[bool, dict]:
    """d=3 cold merge: the pruned tournament tree (when enabled)."""
    rows, expected = _micro_state(3)
    pset = _mk_pset(3, device)
    _fill(pset, rows)
    pts, taken = _merge_with_plan(pset)
    return _verdict(pts, expected, taken)


def _canary_cache_hit(device) -> tuple[bool, dict]:
    """Merge twice with no flush in between: the second answer must come
    from the epoch-keyed cache, byte-identical."""
    rows, expected = _micro_state(3)
    pset = _mk_pset(3, device)
    _fill(pset, rows)
    _merge_with_plan(pset)  # warm the cache
    pts, taken = _merge_with_plan(pset)
    return _verdict(pts, expected, taken)


def _canary_tree_delta(device) -> tuple[bool, dict]:
    """Dirty exactly one of four partitions after a cached merge (0.25 <=
    the delta cutoff): the incremental ``cached global ∪ dirty skylines``
    merge, routed through the tree. The new rows are one fresh parent on
    the same sum plane (joins the skyline) plus its chaff."""
    rows, expected = _micro_state(3)
    pset = _mk_pset(3, device)
    _fill(pset, rows)
    _merge_with_plan(pset)  # prime the cache
    new_parent = np.zeros((1, 3), dtype=np.float32)
    new_parent[0, 0] = float(_N_PARENTS)  # distinct first coord
    new_parent[0, 2] = 3.0 * _N_PARENTS - new_parent[0, 0]
    extra = np.concatenate(
        [new_parent, new_parent + np.float32(_CHAFF_DELTA)], axis=0
    )
    pset.add_batch(0, np.ascontiguousarray(extra), max_id=99, now_ms=0.0)
    pset.flush_all()
    pts, taken = _merge_with_plan(pset)
    return _verdict(pts, np.concatenate([expected, new_parent]), taken)


def _canary_host(device) -> tuple[bool, dict]:
    """The audit oracles themselves against a hand-known answer — a
    broken oracle must not silently vouch for broken fast paths. Both
    the quadratic and the sorted-scan oracle must agree with the known
    answer regardless of which one SKYLINE_AUDIT_ORACLE selects."""
    from skyline_tpu_torch.audit.oracle import sorted_skyline_np
    from skyline_tpu_torch.ops.dominance import skyline_np

    rows, expected = _micro_state(3)
    for fn in (skyline_np, sorted_skyline_np):
        pts = np.asarray(fn(rows), dtype=np.float32)
        ok, detail = _verdict(pts, expected, "host")
        if not ok:
            detail = {**detail, "oracle": fn.__name__}
            return ok, detail
    return ok, detail


# every merge decision path the engine can take (stream/batched.py path
# literals + the engine's per-partition host fallback)
CANARIES: tuple[tuple[str, object], ...] = (
    ("flat", _canary_flat),
    ("tree", _canary_tree),
    ("cache_hit", _canary_cache_hit),
    ("tree_delta", _canary_tree_delta),
    ("host", _canary_host),
)


def run_canaries(telemetry, device="cuda") -> list[dict]:
    """One sweep: run every canary on ``device``, fold outcomes into the
    audit plane (counters, coverage map, verdict ring, flight + span
    rings)."""
    records = []
    for name, fn in CANARIES:
        t0 = time.perf_counter_ns()
        try:
            ok, detail = fn(device)
        except Exception as e:  # a crashing canary IS a failing canary
            ok, detail = False, {"error": repr(e), "taken": None}
        telemetry.inc("audit.checks")
        telemetry.inc("audit.canary_runs")
        if not ok:
            telemetry.inc("audit.divergence")
        telemetry.audit.record_canary(name, ok)
        rec = {"kind": "canary", "path": name, "ok": ok, **detail}
        telemetry.audit.add(rec)
        telemetry.flight.note(
            "audit.canary", path=name, ok=ok, taken=detail.get("taken")
        )
        telemetry.spans.record(
            "audit/canary", t0, time.perf_counter_ns(), tid=4,
            args={"path": name, "ok": ok},
        )
        records.append(rec)
    return records

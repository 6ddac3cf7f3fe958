"""Delta computation between consecutive skyline snapshots.

Counterpart of ``skyline_tpu/serve/deltas.py``.

A subscriber that has version V and wants the head doesn't need the full
snapshot again — skylines evolve slowly relative to their size (most
points survive each merge), so the (entered, left) set difference is the
cheap catch-up currency. Snapshots don't carry tuple ids (the engine's
device buffers hold values only — skyline membership is a property of the
point, and duplicates merge), so rows are keyed by their byte image: each
(d,) float32 row viewed as one opaque void scalar, which numpy sorts and
set-intersects with memcmp — the vectorized path, no per-row Python
objects.

``DeltaRing`` subscribes to a ``SnapshotStore`` and keeps the last
``capacity`` per-transition deltas, so ``/deltas?since=V`` answers from the
ring; a subscriber that fell further behind than the ring gets a "gone"
signal and re-baselines from a full snapshot read.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np


def _row_keys(points: np.ndarray) -> np.ndarray:
    """(n, d) float32 -> (n,) void keys (one memcmp-comparable scalar/row)."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.shape[0] == 0:
        return np.empty(0, dtype=np.dtype((np.void, max(pts.shape[1], 1) * 4)))
    return pts.view(np.dtype((np.void, pts.shape[1] * pts.itemsize))).reshape(-1)


def snapshot_delta(old_points, new_points):
    """(entered, left) between two point sets, vectorized on void row-keys.

    entered = rows of ``new`` absent from ``old``; left = rows of ``old``
    absent from ``new``. Duplicate rows within a set collapse (a skyline is
    a set; the engine never emits duplicates, but the delta law shouldn't
    depend on it).
    """
    old = np.ascontiguousarray(old_points, dtype=np.float32)
    new = np.ascontiguousarray(new_points, dtype=np.float32)
    if old.shape[0] == 0:
        return np.unique(new, axis=0) if new.shape[0] else new, old
    if new.shape[0] == 0:
        return new, np.unique(old, axis=0)
    ok, nk = _row_keys(old), _row_keys(new)
    entered = new[~np.isin(nk, ok)]
    left = old[~np.isin(ok, nk)]
    if entered.shape[0]:
        entered = np.unique(entered, axis=0)
    if left.shape[0]:
        left = np.unique(left, axis=0)
    return entered, left


def order_permutation(candidate: np.ndarray, target: np.ndarray):
    """Indices ``perm`` with ``candidate[perm]`` byte-equal to ``target``,
    or None when the row multisets differ. Duplicate rows are matched
    positionally (first unclaimed candidate slot wins) — any assignment of
    equal rows is byte-equivalent."""
    if candidate.shape != target.shape:
        return None
    from collections import defaultdict, deque as _deque

    slots: dict[bytes, _deque] = defaultdict(_deque)
    for i, k in enumerate(_row_keys(candidate)):
        slots[k.tobytes()].append(i)
    perm = np.empty(target.shape[0], dtype=np.int64)
    for j, k in enumerate(_row_keys(target)):
        q = slots.get(k.tobytes())
        if not q:
            return None
        perm[j] = q.popleft()
    return perm


def apply_delta_record(points: np.ndarray, rec: dict) -> np.ndarray:
    """Fold one WAL ``delta`` record into ``points``, reproducing the
    primary's snapshot bytes exactly when the record carries ordering info
    (``rows`` full override, or ``perm`` over [kept-in-prev-order,
    entered]); set-exact otherwise (a record without ordering info)."""
    from skyline_tpu_torch.resilience.wal import rows_from_b64

    d = int(rec["d"])
    if "rows" in rec:  # perm construction failed on the primary: full copy
        return rows_from_b64(rec["rows"], d)
    entered = rows_from_b64(rec["entered"], d)
    left = rows_from_b64(rec["left"], d)
    kept = points
    if left.shape[0] and points.shape[0]:
        kept = points[~np.isin(_row_keys(points), _row_keys(left))]
    if entered.shape[0]:
        new = np.concatenate([kept, entered]) if kept.shape[0] else entered
    else:
        new = kept
    if "perm" in rec:
        new = new[np.asarray(rec["perm"], dtype=np.int64)]
    return np.ascontiguousarray(new, dtype=np.float32)


def delta_wal_record(prev, snap) -> dict:
    """Build the WAL ``delta`` record for one publish transition.

    Inverse of :func:`apply_delta_record`: besides the (entered, left) set
    difference it carries the ordering info (``perm`` over
    [kept-in-prev-order, entered], or full ``rows`` when the multisets defy
    a permutation) so a WAL follower reproduces the snapshot BYTES, not
    just the set — one encoder, one decoder.
    """
    from skyline_tpu_torch.resilience.wal import rows_to_b64

    entered, left = snapshot_delta(
        prev.points
        if prev is not None
        else np.empty((0, snap.points.shape[1]), dtype=np.float32),
        snap.points,
    )
    rec = {
        "type": "delta",
        "from": prev.version if prev is not None else 0,
        "to": snap.version,
        "wm": snap.watermark_id,
        "ts": snap.timestamp_ms,
        "d": int(snap.points.shape[1]),
        "entered": rows_to_b64(entered),
        "left": rows_to_b64(left),
        "digest": snap.digest,
    }
    if snap.event_wm_ms is not None:
        rec["ewm"] = snap.event_wm_ms  # freshness lineage survives restart
    if snap.meta:
        rec["meta"] = snap.meta  # partial/excluded_chips survive the tail
    kept = (
        prev.points
        if prev is not None and not left.shape[0]
        else (
            prev.points[~np.isin(_row_keys(prev.points), _row_keys(left))]
            if prev is not None and prev.points.shape[0]
            else np.empty((0, snap.points.shape[1]), dtype=np.float32)
        )
    )
    candidate = np.concatenate([kept, entered]) if kept.shape[0] else entered
    perm = order_permutation(candidate, snap.points)
    if perm is None:
        rec["rows"] = rows_to_b64(snap.points)
    elif not np.array_equal(perm, np.arange(perm.shape[0])):
        rec["perm"] = perm.tolist()
    return rec


def snapshot_wal_record(snap) -> dict:
    """The ``snap`` block of a WAL ``ckpt`` barrier: the exact serve head
    (bytes, lineage, and honesty meta) a bootstrap restores from."""
    from skyline_tpu_torch.resilience.wal import rows_to_b64

    rec = {
        "version": snap.version,
        "watermark_id": snap.watermark_id,
        "timestamp_ms": snap.timestamp_ms,
        "d": int(snap.points.shape[1]),
        "rows": rows_to_b64(snap.points),
    }
    if snap.event_wm_ms is not None:
        rec["event_wm_ms"] = snap.event_wm_ms
    if snap.meta:
        # degraded heads (partial/excluded_chips) must survive a bootstrap
        # honestly — never laundered clean by recovery
        rec["meta"] = snap.meta
    return rec


class Delta:
    """One published transition: what changed going from_version -> to_version."""

    __slots__ = (
        "from_version",
        "to_version",
        "entered",
        "left",
        "_entered_json",
        "_left_json",
    )

    def __init__(self, from_version, to_version, entered, left):
        self.from_version = from_version
        self.to_version = to_version
        self.entered = entered
        self.left = left
        self._entered_json = None
        self._left_json = None

    # preserialized wire fragments, byte-identical to
    # ``json.dumps(arr.tolist()).encode()`` — memoized so the /deltas
    # handler and the SSE fanout of one transition pay the row encoding
    # once

    def entered_json(self) -> bytes:
        if self._entered_json is None:
            from skyline_tpu_torch.serve.bodystore import points_json

            self._entered_json = points_json(self.entered)
        return self._entered_json

    def left_json(self) -> bytes:
        if self._left_json is None:
            from skyline_tpu_torch.serve.bodystore import points_json

            self._left_json = points_json(self.left)
        return self._left_json


class DeltaRing:
    """Bounded ring of recent snapshot transitions.

    Attach with ``ring = DeltaRing(store)`` — it subscribes to the store's
    publish hook and computes each transition's delta on the publishing
    thread (one vectorized set-diff per publish). ``since(v)`` merges the
    transitions v -> head into one net (entered, left) pair: a point that
    entered and then left inside the span cancels out, so the merge result
    is exactly the set difference between snapshot v and the head.
    """

    def __init__(self, store=None, capacity: int = 128):
        self._ring: deque[Delta] = deque(  # guarded-by: self._lock
            maxlen=max(1, capacity)
        )
        self._lock = threading.Lock()
        self.head_version = 0  # guarded-by: self._lock
        if store is not None:
            store.on_publish(self.on_publish)

    def on_publish(self, prev, snap) -> None:
        entered, left = snapshot_delta(
            prev.points if prev is not None else np.empty((0, snap.points.shape[1]), np.float32),
            snap.points,
        )
        with self._lock:
            self._ring.append(
                Delta(prev.version if prev is not None else 0, snap.version, entered, left)
            )
            self.head_version = snap.version

    def seed(self, deltas, head_version: int) -> None:
        """Replace the ring's content with recovered transitions (WAL
        ``delta`` records) — the restart half of delta persistence: a
        subscriber holding a pre-crash version keeps catching up through
        ``since`` as if the process never died."""
        with self._lock:
            self._ring.clear()
            self._ring.extend(deltas)
            self.head_version = max(int(head_version), 0)

    def latest(self) -> Delta | None:
        """Most recent transition (None when the ring is empty). The SSE
        fanout reads this in the store's publish hook: the ring subscribes
        to the store before the server does, so at callback time the tail
        delta is the one for the snapshot just published."""
        with self._lock:
            return self._ring[-1] if self._ring else None

    @property
    def oldest_since(self) -> int | None:
        """The smallest ``since`` the ring can still answer (None = empty)."""
        with self._lock:
            return self._ring[0].from_version if self._ring else None

    def since(self, version: int):
        """Net (entered, left, to_version) from ``version`` to the head.

        Returns None when ``version`` fell behind the ring (subscriber must
        re-baseline from a snapshot). ``version >= head`` returns empty
        arrays — the caller is current.
        """
        with self._lock:
            transitions = [t for t in self._ring if t.from_version >= version]
            head = self.head_version
            covered = bool(self._ring) and self._ring[0].from_version <= version
        if version >= head:
            return (
                np.empty((0, 0), np.float32),
                np.empty((0, 0), np.float32),
                head,
            )
        if not covered:
            return None
        # merge transitions oldest-first: membership flips cancel pairwise
        state: dict[bytes, tuple[int, np.ndarray]] = {}
        for t in transitions:
            for row in t.entered:
                k = row.tobytes()
                if k in state and state[k][0] < 0:
                    del state[k]  # left earlier in the span: net no-op
                else:
                    state[k] = (1, row)
            for row in t.left:
                k = row.tobytes()
                if k in state and state[k][0] > 0:
                    del state[k]  # entered earlier in the span: net no-op
                else:
                    state[k] = (-1, row)
        entered = [r for s, r in state.values() if s > 0]
        left = [r for s, r in state.values() if s < 0]
        d = transitions[0].entered.shape[1] if transitions and transitions[0].entered.ndim == 2 else 0
        stack = lambda rows: (  # noqa: E731 — tiny local shaping helper
            np.stack(rows) if rows else np.empty((0, d), np.float32)
        )
        return stack(entered), stack(left), head

    def stats(self) -> dict:
        with self._lock:
            return {
                "ring_depth": len(self._ring),
                "ring_capacity": self._ring.maxlen,
                "head_version": self.head_version,
                "oldest_since": self._ring[0].from_version if self._ring else None,
            }

"""Audit plane backing store: the bounded ring of shadow-verification
verdicts served at ``GET /audit``.

Counterpart of ``skyline_tpu/telemetry/audit.py``. The auditor itself
comes with the snapshot store (not ported yet): until then no check is
recorded here, as the reference records none before a store is attached.
The auditor recomputes sampled published
snapshots through the independent host oracle and records one check
document per comparison here; canary sweeps additionally maintain a
per-merge-path coverage map so ``/audit`` can prove every decision path
(cache_hit / tree_delta / tree / flat / host) was exercised recently even
under idle organic traffic. Divergences pin their repro-bundle path so
the on-call can jump from the verdict straight to the offline replay
(the reference's ``python -m skyline_tpu.audit replay <bundle>``).

Ring semantics match the ExplainRecorder: ``add`` is one lock + one
deque append on the engine thread; the HTTP surfaces read via
``doc``/``by_trace`` from their own threads, and a monotonic total makes
``partial`` detectable.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class AuditRecorder:
    """Bounded ring of audit check records + canary coverage map."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._ring: deque[dict] = deque(  # guarded-by: self._lock
            maxlen=self.capacity
        )
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: self._lock
        self._divergence = 0  # guarded-by: self._lock
        self._last_divergence: dict | None = None  # guarded-by: self._lock
        self._bundles: list[str] = []  # guarded-by: self._lock
        self._canaries: dict[str, dict] = {}  # guarded-by: self._lock

    def add(self, doc: dict) -> dict:
        """Stamp + append one check record; returns it. A diverging
        record (``ok: False``) is additionally pinned as
        ``last_divergence`` and its bundle path (if frozen) retained
        beyond ring eviction — divergence evidence must outlive churn."""
        with self._lock:
            self._seq += 1
            doc["seq"] = self._seq
            doc["t_ms"] = round(time.time() * 1000.0, 1)
            self._ring.append(doc)
            if not doc.get("ok", True):
                self._divergence += 1
                self._last_divergence = doc
                bundle = doc.get("bundle")
                if bundle:
                    self._bundles.append(str(bundle))
        return doc

    def record_canary(self, path: str, ok: bool) -> None:
        """Fold one canary outcome into the per-path coverage map."""
        with self._lock:
            row = self._canaries.setdefault(
                path, {"runs": 0, "ok": 0, "last_ok": None, "last_t_ms": None}
            )
            row["runs"] += 1
            row["ok"] += int(bool(ok))
            row["last_ok"] = bool(ok)
            row["last_t_ms"] = round(time.time() * 1000.0, 1)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def latest(self) -> dict | None:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def by_trace(self, trace_id: str) -> dict | None:
        """Newest retained check for the snapshot that trace produced —
        the join key back into /explain and /trace."""
        with self._lock:
            for doc in reversed(self._ring):
                if doc.get("trace_id") == trace_id:
                    return doc
        return None

    def doc(self) -> dict:
        """The /audit verdict document (and the bench audit stamp)."""
        with self._lock:
            depth = len(self._ring)
            seq = self._seq
            last = self._ring[-1] if self._ring else None
            return {
                "ok": self._divergence == 0,
                "checks_total": seq,
                "divergence_total": self._divergence,
                "last_check": last,
                "last_divergence": self._last_divergence,
                "bundles": list(self._bundles),
                "canaries": {k: dict(v) for k, v in self._canaries.items()},
                "ring_depth": depth,
                "ring_capacity": self.capacity,
                "partial": seq > depth,
            }

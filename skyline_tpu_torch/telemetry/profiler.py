"""Per-dispatch-signature wall times — the evidence the dispatch race reads.

Counterpart of ``KernelProfiler`` and ``n_bucket`` in
``skyline_tpu/telemetry/profiler.py``. Each signature (variant, d,
N-bucket, backend, mp) accumulates its call count, total wall, an EMA of
the wall and the first call's wall. ``dispatch.choose_variant`` compares
candidates' EMAs under one signature, and ``claim_explore`` makes the
exploration of an unmeasured candidate one-shot.

The backend is the device type of the call (``"cuda"`` or ``"cpu"``), where
the reference names ``jax.default_backend()``: a process that runs both
keeps their walls apart. Times are host walls around the recorded region;
a caller that times card work synchronises inside the region.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

_EMA_ALPHA = 0.2


def n_bucket(n: int) -> int:
    """A row count bucketed to the next power of two (0 stays 0)."""
    n = int(n)
    if n <= 0:
        return 0
    b = 1
    while b < n:
        b <<= 1
    return b


def default_backend() -> str:
    """``"cuda"`` where a card is available, else ``"cpu"``."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


class _Entry:
    __slots__ = ("calls", "wall_ms", "ema_ms", "first_call_ms", "last_ms")

    def __init__(self):
        self.calls = 0
        self.wall_ms = 0.0
        self.ema_ms = 0.0
        self.first_call_ms = None
        self.last_ms = 0.0


class KernelProfiler:
    """Thread-safe registry of per-dispatch-signature walls."""

    def __init__(self, backend: str | None = None):
        """``backend``: the name signatures take when a call names none
        (``default_backend()`` if None)."""
        self._lock = threading.Lock()
        self._entries: dict[tuple, _Entry] = {}  # guarded-by: self._lock
        self._claimed: set[tuple] = set()  # guarded-by: self._lock
        self._backend = backend
        self.dispatches = 0  # guarded-by: self._lock

    def _key(self, variant: str, d: int, n: int, mp: bool, backend: str | None) -> tuple:
        if backend is None:
            if self._backend is None:
                self._backend = default_backend()
            backend = self._backend
        return (variant, int(d), n_bucket(n), backend, bool(mp))

    @contextmanager
    def record(self, variant: str, d: int, n: int, mp: bool = False, backend: str | None = None):
        """Time the enclosed region under signature (variant, d, bucket(n),
        backend, mp)."""
        key = self._key(variant, d, n, mp, backend)
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            dt_ms = (time.perf_counter_ns() - t0) / 1e6
            with self._lock:
                e = self._entries.get(key)
                if e is None:
                    e = self._entries[key] = _Entry()
                e.calls += 1
                self.dispatches += 1
                e.wall_ms += dt_ms
                e.last_ms = dt_ms
                if e.calls == 1:
                    # the first call of a signature pays the cold path
                    e.first_call_ms = dt_ms
                    e.ema_ms = dt_ms
                else:
                    e.ema_ms += _EMA_ALPHA * (dt_ms - e.ema_ms)

    def claim_explore(self, variant: str, d: int, n: int, mp: bool = False,
                      backend: str | None = None) -> bool:
        """True exactly once while the signature has no measured data: the
        first caller explores an unmeasured candidate, later ones fall back
        to measured data until its record lands (``choose_variant``)."""
        key = self._key(variant, d, n, mp, backend)
        with self._lock:
            if key in self._entries or key in self._claimed:
                return False
            self._claimed.add(key)
            return True

    def ema_ms(self, variant: str, d: int, n: int, mp: bool = False,
               backend: str | None = None):
        """The signature's EMA wall, or None if it never recorded."""
        key = self._key(variant, d, n, mp, backend)
        with self._lock:
            e = self._entries.get(key)
            return None if e is None else e.ema_ms

    def total_wall_ms(self) -> float:
        with self._lock:
            return sum(e.wall_ms for e in self._entries.values())

    def export_state(self) -> dict:
        """JSON-safe snapshot of every signature's accumulators. In-flight
        exploration claims are not exported: a claim whose record never
        landed must not outlive the process."""
        with self._lock:
            entries = [
                {
                    "variant": k[0], "d": k[1], "n_bucket": k[2],
                    "backend": k[3], "mp": k[4],
                    "calls": e.calls,
                    "wall_ms": round(e.wall_ms, 6),
                    "ema_ms": round(e.ema_ms, 6),
                    "first_call_ms": (
                        None if e.first_call_ms is None else round(e.first_call_ms, 6)
                    ),
                    "last_ms": round(e.last_ms, 6),
                }
                for k, e in self._entries.items()
            ]
        return {"version": 1, "entries": entries}

    def restore_state(self, doc) -> int:
        """Adopt signatures from an ``export_state`` document; a signature
        measured in this process is kept (fresher). Malformed rows are
        skipped. Returns the number adopted."""
        if not isinstance(doc, dict):
            return 0
        adopted = 0
        for row in doc.get("entries") or []:
            try:
                key = (
                    str(row["variant"]), int(row["d"]), int(row["n_bucket"]),
                    str(row["backend"]), bool(row["mp"]),
                )
                calls = int(row["calls"])
                wall = float(row["wall_ms"])
                ema = float(row["ema_ms"])
                first = row.get("first_call_ms")
                first = None if first is None else float(first)
                last = float(row.get("last_ms", 0.0))
            except (KeyError, TypeError, ValueError):
                continue
            if calls <= 0:
                continue
            with self._lock:
                if key in self._entries:
                    continue
                e = self._entries[key] = _Entry()
                e.calls, e.wall_ms, e.ema_ms = calls, wall, ema
                e.first_call_ms, e.last_ms = first, last
                self._claimed.discard(key)
            adopted += 1
        return adopted

    def reset_signatures(self, variants=None) -> int:
        """Drop measured entries and claims of the named variants (all when
        None), so the next race explores again. Returns the number of
        signatures dropped."""
        names = None if variants is None else set(variants)
        with self._lock:
            keys = [k for k in self._entries if names is None or k[0] in names]
            for k in keys:
                del self._entries[k]
            self._claimed = {
                k for k in self._claimed if names is not None and k[0] not in names
            }
        return len(keys)

    def snapshot_counts(self) -> dict[tuple, tuple[int, float]]:
        """{signature: (calls, wall_ms)}."""
        with self._lock:
            return {k: (e.calls, e.wall_ms) for k, e in self._entries.items()}

    def doc(self, phase_total_ms: float | None = None) -> dict:
        """Per-signature rows sorted by wall, per-variant signature counts,
        and with ``phase_total_ms`` the share of it the rows account for."""
        with self._lock:
            items = list(self._entries.items())
            dispatches = self.dispatches
        rows = []
        retraces: dict[str, int] = {}
        total = 0.0
        for (variant, d, bucket, backend, mp), e in items:
            total += e.wall_ms
            retraces[variant] = retraces.get(variant, 0) + 1
            rows.append({
                "variant": variant, "d": d, "n_bucket": bucket, "backend": backend,
                "mp": mp, "calls": e.calls, "wall_ms": round(e.wall_ms, 3),
                "ema_ms": round(e.ema_ms, 4),
                "first_call_ms": (
                    round(e.first_call_ms, 3) if e.first_call_ms is not None else None
                ),
            })
        rows.sort(key=lambda r: -r["wall_ms"])
        doc = {
            "kernels": rows,
            "signatures": len(rows),
            "dispatches": dispatches,
            "total_wall_ms": round(total, 3),
            "retraces_per_variant": retraces,
        }
        if phase_total_ms is not None:
            doc["phase_total_ms"] = round(float(phase_total_ms), 3)
            doc["attributed_share"] = (
                round(min(1.0, total / phase_total_ms), 4) if phase_total_ms > 0 else None
            )
        return doc

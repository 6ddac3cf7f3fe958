"""Per-dispatch-signature wall times, and a flight recorder of engine
decisions.

Counterpart of ``skyline_tpu/telemetry/profiler.py``. ``KernelProfiler``:
each signature (variant, d, N-bucket, backend, mp) accumulates its call
count, total wall, an EMA of the wall and the first call's wall;
``dispatch.choose_variant`` compares candidates' EMAs under one signature,
and ``claim_explore`` makes the exploration of an unmeasured candidate
one-shot. The engine wraps each ``flush/merge_kernel`` dispatch in
``record`` (two clock reads and a lock), so ``doc`` splits that phase by
signature; with a ``SpanRecorder`` each record also lands as a
``kernel/<variant>`` span on tid 2. With ``SKYLINE_PROFILE_COST`` a
dispatch site may hand ``record`` a cost thunk, run once per signature: the
reference's is XLA's ``cost_analysis()``, the port's reckons the merge
step's flops and bytes from its shapes (``PartitionSet._merge_cost_thunk``).

The backend is the device type of the call (``"cuda"`` or ``"cpu"``), where
the reference names ``jax.default_backend()``: a process that runs both
keeps their walls apart. Times are host walls around the recorded region —
on a card the host's dispatch wall, not kernel time, unless the caller
synchronises inside the region.

``FlightRecorder`` is the companion black box: a bounded ring of
structured dispatch, cascade, prune and cache decisions
(``note(kind, **fields)``), stamped with the current query's trace id.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
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
    __slots__ = ("calls", "wall_ms", "ema_ms", "first_call_ms", "cost", "last_ms")

    def __init__(self):
        self.calls = 0
        self.wall_ms = 0.0
        self.ema_ms = 0.0
        self.first_call_ms = None
        self.cost = None
        self.last_ms = 0.0


class KernelProfiler:
    """Thread-safe registry of per-dispatch-signature walls."""

    def __init__(self, spans=None, backend: str | None = None):
        """``spans``: an optional ``SpanRecorder`` for ``kernel/<variant>``
        slices. ``backend``: the name signatures take when a call names none
        (``default_backend()`` if None)."""
        self._lock = threading.Lock()
        self._entries: dict[tuple, _Entry] = {}  # guarded-by: self._lock
        self._claimed: set[tuple] = set()  # guarded-by: self._lock
        self.spans = spans
        self._backend = backend
        self.dispatches = 0  # guarded-by: self._lock

    def _key(self, variant: str, d: int, n: int, mp: bool, backend: str | None) -> tuple:
        if backend is None:
            if self._backend is None:
                self._backend = default_backend()
            backend = self._backend
        return (variant, int(d), n_bucket(n), backend, bool(mp))

    @contextmanager
    def record(self, variant: str, d: int, n: int, mp: bool = False,
               backend: str | None = None, cost_thunk=None):
        """Time the enclosed region under signature (variant, d, bucket(n),
        backend, mp). ``cost_thunk`` (optional) runs at most once per
        signature, after its first call, and returns a dict with ``flops``
        and ``bytes_accessed``."""
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
                first = e.calls == 0
                e.calls += 1
                self.dispatches += 1
                e.wall_ms += dt_ms
                e.last_ms = dt_ms
                if first:
                    # the first call of a signature pays the cold path
                    e.first_call_ms = dt_ms
                    e.ema_ms = dt_ms
                else:
                    e.ema_ms += _EMA_ALPHA * (dt_ms - e.ema_ms)
            if first and cost_thunk is not None:
                cost = self._try_cost(cost_thunk)
                if cost is not None:
                    with self._lock:
                        e.cost = cost
            if self.spans is not None:
                self.spans.record(
                    f"kernel/{variant}", t0, t0 + int(dt_ms * 1e6), tid=2,
                    args={"d": int(d), "n_bucket": key[2], "mp": bool(mp)},
                )

    @staticmethod
    def _try_cost(cost_thunk):
        """Run a cost thunk defensively: a cost estimate is best-effort and
        must never take a dispatch down. Keeps the numeric ``flops`` and
        ``bytes accessed`` / ``bytes_accessed`` entries."""
        try:
            cost = cost_thunk()
        except Exception:
            return None
        if isinstance(cost, (list, tuple)) and cost:
            cost = cost[0]
        if not isinstance(cost, dict):
            return None
        out = {}
        for k in ("flops", "bytes accessed", "bytes_accessed"):
            v = cost.get(k)
            if isinstance(v, (int, float)):
                out[k.replace(" ", "_")] = float(v)
        return out or None

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
            row = {
                "variant": variant, "d": d, "n_bucket": bucket, "backend": backend,
                "mp": mp, "calls": e.calls, "wall_ms": round(e.wall_ms, 3),
                "ema_ms": round(e.ema_ms, 4),
                "first_call_ms": (
                    round(e.first_call_ms, 3) if e.first_call_ms is not None else None
                ),
            }
            if e.cost is not None:
                row["cost"] = e.cost
            rows.append(row)
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


class FlightRecorder:
    """Bounded ring of structured engine decisions — the black box.

    ``note(kind, **fields)`` is one lock + one deque append; entries carry a
    monotonic sequence number and a wall timestamp. ``snapshot()`` and
    ``doc()`` read it; ``dump(reason)`` writes the ring to stderr as one
    JSON document.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._ring: deque[dict] = deque(maxlen=self.capacity)  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: self._lock
        # the current query's trace id; set and cleared by the engine thread
        # around trigger work — notes from other threads go unstamped
        self._trace = None

    def set_trace(self, trace_id: str | None) -> None:
        """Stamp later ``note`` entries with this trace id (None to stop)."""
        self._trace = trace_id

    def note(self, kind: str, **fields) -> None:
        # every field must be JSON-serializable; raw bytes become hex
        for k, v in fields.items():
            if isinstance(v, bytes):
                fields[k] = v.hex()
            elif not isinstance(v, (str, int, float, bool, type(None))):
                fields[k] = repr(v)
        if self._trace is not None and "trace_id" not in fields:
            fields["trace_id"] = self._trace
        with self._lock:
            self._seq += 1
            entry = {"seq": self._seq, "t_ms": round(time.time() * 1000.0, 1),
                     "kind": kind}
            entry.update(fields)
            self._ring.append(entry)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def doc(self) -> dict:
        with self._lock:
            entries = list(self._ring)
            seq = self._seq
        return {
            "entries": entries,
            "recorded_total": seq,
            "ring_capacity": self.capacity,
            "partial": seq > len(entries),
        }

    def dump(self, reason: str, stream=None) -> None:
        """Best-effort dump of the ring as one JSON line on stderr."""
        try:
            doc = self.doc()
            doc["reason"] = reason
            print(
                "skyline-flight-recorder: " + json.dumps(doc),
                file=stream if stream is not None else sys.stderr,
            )
        except Exception:
            pass

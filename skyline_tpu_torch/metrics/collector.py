"""Named monotonic counters shared by the engine and its telemetry hub.

Counterpart of ``Counters`` in ``skyline_tpu/metrics/collector.py``. The
result-CSV writer and the ``collect`` CLI of that module are not ported yet.
"""

from __future__ import annotations

import threading


class Counters:
    """Thread-safe named monotonic counters — snapshotted into ``stats`` and
    the Prometheus exposition. ``inc`` on hot paths is one lock + one dict
    add."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}  # guarded-by: self._lock

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)

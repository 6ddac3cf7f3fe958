"""Per-query spans: a bounded ring of timed phases, Perfetto-exportable.

Counterpart of ``skyline_tpu/telemetry/spans.py``.
The reference's timing decomposition is per-query *aggregates* baked into
the result JSON. Spans keep the underlying events: each phase of a query's
life (ingest micro-batch, partition-local compute, global merge, snapshot
publish, end-to-end query) is recorded with a start/duration pair and the
``trace_id`` minted when its trigger entered the engine — so one slow p99
query can be pulled out of the ring and read as a timeline instead of
inferred from totals.

Export is Chrome trace-event JSON (the ``"X"`` complete-event form), which
``chrome://tracing`` and https://ui.perfetto.dev load directly — via
``SpanRecorder.to_chrome()`` or ``write_chrome(path)``.

The ring is bounded (``capacity`` spans, oldest evicted) and recording is
one lock + one deque append; a ``SpanRecorder`` is safe to share between
threads.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

_mint_lock = threading.Lock()
_mint_seq = 0


def mint_trace_id() -> str:
    """Cheap process-unique trace id, minted at trigger ingestion."""
    global _mint_seq
    with _mint_lock:
        _mint_seq += 1
        seq = _mint_seq
    return f"{os.getpid():x}-{seq:x}"


class SpanRecorder:
    """Bounded ring of completed spans (thread-safe, oldest-evicted)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, int(capacity))
        self._ring: deque[dict] = deque(  # guarded-by: self._lock
            maxlen=self.capacity
        )
        self._lock = threading.Lock()
        self._pid = os.getpid()
        # anchor: chrome ts values are microseconds relative to recorder
        # creation; the wall anchor lets a reader place the trace in time
        self._anchor_ns = time.perf_counter_ns()
        self.anchor_epoch_ms = time.time() * 1000.0
        self.recorded = 0  # total ever recorded  # guarded-by: self._lock
        self.dropped = 0  # overwritten by ring eviction  # guarded-by: self._lock

    def record(
        self,
        name: str,
        start_ns: int,
        end_ns: int,
        trace_id: str | None = None,
        tid: int = 0,
        args: dict | None = None,
    ) -> None:
        """Record one completed span timed with ``time.perf_counter_ns()``."""
        span = {
            "name": name,
            "start_ns": int(start_ns),
            "dur_ns": max(0, int(end_ns) - int(start_ns)),
            "tid": int(tid),
        }
        if trace_id is not None:
            span["trace_id"] = trace_id
        if args:
            span["args"] = args
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1  # appending evicts the oldest span
            self._ring.append(span)
            self.recorded += 1

    @contextmanager
    def span(self, name: str, trace_id: str | None = None, tid: int = 0, **args):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.record(
                name,
                t0,
                time.perf_counter_ns(),
                trace_id=trace_id,
                tid=tid,
                args=args or None,
            )

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object ({"traceEvents": [...]}) — loadable
        by Perfetto / chrome://tracing. One "X" (complete) event per span;
        trace_id and any extra args ride in the event's ``args``."""
        events = []
        for s in self.snapshot():
            args = dict(s.get("args") or {})
            if "trace_id" in s:
                args["trace_id"] = s["trace_id"]
            events.append(
                {
                    "name": s["name"],
                    "ph": "X",
                    "ts": (s["start_ns"] - self._anchor_ns) / 1e3,
                    "dur": s["dur_ns"] / 1e3,
                    "pid": self._pid,
                    "tid": s["tid"],
                    "cat": "skyline",
                    "args": args,
                }
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "anchor_epoch_ms": self.anchor_epoch_ms,
                "spans_recorded_total": self.recorded,
                "spans_dropped_total": self.dropped,
                # dropped > 0 means the ring overwrote older spans: the trace
                # is a partial window over the most recent `capacity` spans
                "partial": self.dropped > 0,
                "ring_capacity": self.capacity,
            },
        }

    def write_chrome(self, path: str) -> int:
        """Write the Chrome trace JSON to ``path``; returns events written."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])

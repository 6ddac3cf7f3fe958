"""End-to-end freshness lineage: event-time watermarks through the pipeline.

Counterpart of ``skyline_tpu/telemetry/freshness.py``. Every ingested
micro-batch is stamped with the min/max producer event-time it carries, and
that watermark is threaded host-side through the stages a row traverses
before a reader can see it:

    ingest -> flush (device residency) -> merge (global skyline) ->
    publish (snapshot swap) -> read (/skyline response)

At each stage transition the tracker observes ``now - oldest waiting
event-time`` into a per-stage lag histogram, exported as the labeled
Prometheus family ``skyline_freshness_lag_ms{stage=...}``. The published
event watermark (newest event-time fully reflected in the live snapshot) is
what ``on_publish`` returns for the snapshot store (``serve/snapshot.py``).

Event-time source: a caller that has producer event times passes them as
``process_records(event_ms=...)``; without them the engine stamps the wall
clock at ingest (a processing-time proxy).

Everything here is host-side floats and histogram observes — nothing enters
a kernel, so skyline bytes are untouched.

Watermark semantics are monotone-max: advances never move the published
watermark backwards. One known over-advance: with overlapped merges
(``SKYLINE_QUERY_OVERLAP``), rows ingested between launch and harvest are
folded into the *merged* watermark at harvest even though the harvested
result predates them — lag can under-read by up to one merge in flight.
"""

from __future__ import annotations

import threading
import time

STAGES = ("ingest", "flush", "merge", "publish", "read")


def _now_ms() -> float:
    return time.time() * 1000.0


class _Stage:
    """Event-time window [oldest, newest] currently waiting at one stage."""

    __slots__ = ("oldest", "newest")

    def __init__(self):
        self.oldest = None
        self.newest = None

    def fold(self, lo: float, hi: float) -> None:
        if self.oldest is None or lo < self.oldest:
            self.oldest = lo
        if self.newest is None or hi > self.newest:
            self.newest = hi

    def take(self):
        """Drain the window, returning (oldest, newest) or None when empty."""
        if self.oldest is None:
            return None
        win = (self.oldest, self.newest)
        self.oldest = None
        self.newest = None
        return win


class FreshnessTracker:
    """Per-stage event-time watermarks + lag histograms.

    Single writer per stage (the engine/worker thread); ``on_read`` may be
    called from HTTP reader threads, hence the lock. When a ``Telemetry``
    hub is supplied the five stage histograms are registered on it (so they
    render on ``/metrics``); standalone use (bench legs without a hub)
    creates private histograms.
    """

    def __init__(self, telemetry=None):
        from skyline_tpu_torch.telemetry.histogram import Histogram

        self._lock = threading.Lock()
        self._hists = {}
        for stage in STAGES:
            if telemetry is not None:
                h = telemetry.histogram(
                    "freshness_lag_ms", labels=(("stage", stage),)
                )
            else:
                h = Histogram("freshness_lag_ms", labels=(("stage", stage),))
            self._hists[stage] = h
        # event-time windows waiting at each stage; guarded-by: self._lock
        self._pending = _Stage()  # ingested, not yet flushed to device
        self._flushed = _Stage()  # flushed, not yet globally merged
        self._merged = _Stage()  # merged, not yet published
        # newest event-time fully reflected in the live snapshot (monotone)
        self.published_wm = None  # guarded-by: self._lock
        self.batches = 0  # guarded-by: self._lock

    # -- stage transitions (engine/worker thread) -------------------------

    def on_ingest(self, ev_min_ms: float, ev_max_ms: float, now_ms=None) -> None:
        """A micro-batch carrying event-times [ev_min, ev_max] entered the
        engine's pending buffers."""
        now = _now_ms() if now_ms is None else now_ms
        with self._lock:
            self.batches += 1
            self._pending.fold(float(ev_min_ms), float(ev_max_ms))
            self._hists["ingest"].observe(max(0.0, now - float(ev_max_ms)))

    def on_flush(self, now_ms=None) -> None:
        """All pending rows reached device residency (flush cascade drained).
        Idempotent: a flush with nothing pending records nothing."""
        now = _now_ms() if now_ms is None else now_ms
        with self._lock:
            win = self._pending.take()
            if win is None:
                return
            self._hists["flush"].observe(max(0.0, now - win[0]))
            self._flushed.fold(*win)

    def on_merge(self, now_ms=None) -> None:
        """A global merge completed over everything flushed so far."""
        now = _now_ms() if now_ms is None else now_ms
        with self._lock:
            win = self._flushed.take()
            if win is None:
                return
            self._hists["merge"].observe(max(0.0, now - win[0]))
            self._merged.fold(*win)

    def on_publish(self, now_ms=None) -> float | None:
        """The merged result was published; returns the snapshot's event
        watermark (newest event-time fully reflected in it), or None when no
        event-stamped data has flowed yet."""
        now = _now_ms() if now_ms is None else now_ms
        with self._lock:
            win = self._merged.take()
            if win is not None:
                self._hists["publish"].observe(max(0.0, now - win[0]))
                if self.published_wm is None or win[1] > self.published_wm:
                    self.published_wm = win[1]
            return self.published_wm

    # -- read side (HTTP threads) -----------------------------------------

    def on_read(self, staleness_ms: float) -> None:
        self._hists["read"].observe(max(0.0, float(staleness_ms)))

    # -- durability -------------------------------------------------------

    def restore(self, published_wm_ms: float | None) -> None:
        """Re-seed the published watermark from recovered state (checkpoint
        barrier + WAL ``ewm``). Monotone-max like every other advance."""
        if published_wm_ms is None:
            return
        with self._lock:
            if self.published_wm is None or published_wm_ms > self.published_wm:
                self.published_wm = float(published_wm_ms)

    def stats(self) -> dict:
        with self._lock:
            wm = self.published_wm
            batches = self.batches
        out = {
            "batches": batches,
            "published_wm_ms": round(wm, 3) if wm is not None else None,
            "stages": {s: self._hists[s].snapshot() for s in STAGES},
        }
        read = self._hists["read"]
        out["read_lag_p99_ms"] = (
            round(read.quantile(0.99), 3) if read.count else 0.0
        )
        return out

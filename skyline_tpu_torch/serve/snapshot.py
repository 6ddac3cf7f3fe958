"""Versioned skyline snapshot store — the serving plane's source of truth.

Counterpart of ``skyline_tpu/serve/snapshot.py``: the same versions,
digests, dedupe, staleness and fault sites.

The engine (``stream/engine.py`` / ``stream/sliding_engine.py``) publishes
each completed global skyline here as an immutable, monotonically-versioned
``Snapshot``; readers never touch the engine. A read serves the latest
published version lock-free — publication is a single reference swap, and
snapshots are frozen (read-only numpy arrays + a content digest stamped at
publish, so a torn read is detectable as a digest mismatch, which the swap
makes impossible to begin with).

Staleness contract. Two client-specified bounds, both optional:

- ``max_age_ms``: the snapshot's publish timestamp must be within this many
  milliseconds of now.
- ``max_version_lag``: the number of ingest advances (micro-batches the
  engine has absorbed since the snapshot was cut — ``note_ingest`` calls)
  must not exceed this. Lag 0 means "exact": nothing has entered the
  engine since the snapshot. The engine bumps this counter from its data
  plane, so the bound is enforceable without any device sync.

A read that violates its bound is reported stale; the HTTP layer
(``serve/server.py``) then either rejects it (503), serves it flagged
(``allow_stale``), and/or fires a refresh merge instead of blocking on one.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from skyline_tpu_torch.resilience.faults import fault_fired, fault_point


def _now_ms() -> float:
    return time.time() * 1000.0


@dataclass(frozen=True)
class Snapshot:
    """One immutable published global skyline."""

    version: int
    watermark_id: int  # max tuple id ingested when the snapshot was cut
    timestamp_ms: float
    points: np.ndarray  # (k, d) float32, read-only
    digest: str  # sha1 of the points buffer, stamped at publish
    meta: dict = field(default_factory=dict)
    # newest producer EVENT time (ms epoch) reflected in these points —
    # the freshness lineage's published watermark (None when the engine
    # runs without the tracker); rides the WAL so restores keep lineage
    event_wm_ms: float | None = None
    # opaque identity of the engine state these points were merged from
    # (the partition-epoch key). Raw bytes, so it stays OFF to_doc/meta;
    # the audit plane compares it against the live epoch key to tell a
    # still-current snapshot from one the state has moved past. None on
    # restored snapshots (recovered bytes carry no epoch lineage).
    source_key: bytes | None = None

    @property
    def size(self) -> int:
        return int(self.points.shape[0])

    def doc_head(self) -> dict:
        """The wire doc minus ``points``. CONTRACT: ``points`` is always the
        doc's FINAL key, so ``json.dumps(doc_head())[:-1]`` + a preserialized
        ``, "points": [...]`` fragment is byte-identical to
        ``json.dumps(to_doc(include_points=True))[:-1]`` — the splice the
        body store (serve/bodystore.py) builds cached prefixes from. Meta
        keys must therefore never be named ``points``."""
        doc = {
            "version": self.version,
            "watermark_id": self.watermark_id,
            "timestamp_ms": self.timestamp_ms,
            "skyline_size": self.size,
            "digest": self.digest,
        }
        if self.event_wm_ms is not None:
            doc["event_wm_ms"] = self.event_wm_ms
        doc.update(self.meta)
        return doc

    def to_doc(self, include_points: bool = True) -> dict:
        doc = self.doc_head()
        if include_points:
            doc["points"] = self.points.tolist()
        return doc


def points_digest(points: np.ndarray) -> str:
    """Content hash of a points buffer (row order included — snapshots are
    published in the engine's canonical order, so equality is byte equality)."""
    return hashlib.sha1(np.ascontiguousarray(points).tobytes()).hexdigest()


class ReadStatus:
    """Outcome of a bounded read: the snapshot plus why/whether it's fresh."""

    __slots__ = ("snapshot", "fresh", "age_ms", "version_lag", "staleness_ms")

    def __init__(self, snapshot, fresh, age_ms, version_lag, staleness_ms=None):
        self.snapshot = snapshot
        self.fresh = fresh
        self.age_ms = age_ms
        self.version_lag = version_lag
        # event-time staleness: now - snapshot.event_wm_ms when the engine
        # publishes watermarks, else the processing-time age (the honest
        # fallback — without event stamps the publish instant is the newest
        # event knowledge we have)
        self.staleness_ms = age_ms if staleness_ms is None else staleness_ms


class SnapshotStore:
    """Single-writer (the engine thread), many-reader snapshot store.

    Writers call ``publish`` / ``note_ingest``; readers call ``latest`` /
    ``read`` / ``get``. The read path takes no lock: ``_latest`` is swapped
    atomically (one reference assignment) and every ``Snapshot`` is frozen.
    ``history`` bounds the versions kept for ``get``-by-version catch-up
    (the delta ring in ``serve/deltas.py`` subscribes via ``on_publish``).
    """

    def __init__(self, history: int = 64):
        self._latest: Snapshot | None = None  # guarded-by: self._write_lock
        self._history: deque[Snapshot] = deque(  # guarded-by: self._write_lock
            maxlen=max(1, history)
        )
        self._version = 0  # guarded-by: self._write_lock
        # _advances/_stream_watermark are deliberately NOT lock-guarded:
        # note_ingest runs on the hot ingest path and tolerates torn reads
        # (they feed monotonic lag gauges, not correctness)
        self._advances = 0  # ingest advances since the last publish
        self._stream_watermark = -1
        self._event_watermark_ms: float | None = None  # same discipline
        self._write_lock = threading.Lock()
        self._subscribers: list = []  # publish callbacks (delta ring, tests)
        self.published = 0  # guarded-by: self._write_lock
        # opaque identity of the engine state behind _latest (the partition
        # epoch key): a publish with the same key is a byte-identical repeat
        # (merge-cache hit upstream) and dedupes instead of minting a version
        self._source_key = None  # guarded-by: self._write_lock
        self.deduped = 0  # guarded-by: self._write_lock
        # True while _latest was rebuilt from the WAL (restore_state) and no
        # real publish has confirmed it yet — surfaced on /skyline so
        # clients can distinguish a recovered head from a live one
        self.restored = False  # guarded-by: self._write_lock
        self.restores = 0  # guarded-by: self._write_lock
        # outcome flag of the most recent publish (True = deduped against
        # the live snapshot): the EXPLAIN plane reads it right after its
        # own publish call on the same engine thread, so the
        # read-after-write is ordered; other readers tolerate torn reads
        self.last_publish_deduped = False  # guarded-by: self._write_lock

    # -- writer side (engine thread) --------------------------------------

    def on_publish(self, callback) -> None:
        """Register ``callback(prev: Snapshot | None, new: Snapshot)`` to run
        synchronously on the publishing thread after each swap."""
        self._subscribers.append(callback)

    def note_ingest(
        self,
        watermark_id: int | None = None,
        batches: int = 1,
        event_ms: float | None = None,
    ) -> None:
        """The engine absorbed new data: the latest snapshot is now one
        (more) version-lag unit behind. ``event_ms`` (optional) advances the
        unpublished event-time high watermark the same torn-read-tolerant
        way. Cheap — a few scalar updates."""
        self._advances += batches
        if watermark_id is not None and watermark_id > self._stream_watermark:
            self._stream_watermark = watermark_id
        if event_ms is not None and (
            self._event_watermark_ms is None
            or event_ms > self._event_watermark_ms
        ):
            self._event_watermark_ms = event_ms

    def publish(
        self,
        points: np.ndarray,
        watermark_id: int | None = None,
        now_ms: float | None = None,
        source_key=None,
        event_wm_ms: float | None = None,
        **meta,
    ) -> Snapshot:
        """Freeze ``points`` as the next version and swap it in.

        ``source_key``: optional opaque identity of the source state (the
        engine's partition-epoch key). Publishing the SAME key as the live
        snapshot is a no-op returning the existing snapshot — version
        numbering stays dense, the delta ring sees no spurious full-replace
        delta, and subscribers don't re-fire for bytes they already have.
        ``None`` (default) never dedupes."""
        fault_point("snapshot.publish")
        with self._write_lock:
            if (
                source_key is not None
                and self._latest is not None
                and self._source_key == source_key
            ):
                self.deduped += 1
                self._advances = 0
                self.last_publish_deduped = True
                return self._latest
            pts = np.ascontiguousarray(points, dtype=np.float32)
            if pts.base is None or pts is points:
                pts = pts.copy()  # never alias the engine's buffer
            if fault_fired("audit.corrupt") and pts.size:
                # divergence drill (RUNBOOK §2l): flip one byte in the
                # published body AFTER the copy so the engine's own state
                # stays sound and only the served bytes lie — exactly the
                # failure class the audit plane exists to catch. The
                # digest below is computed over the corrupted bytes, so
                # the snapshot is self-consistent and only the oracle
                # comparison can see the lie.
                pts = pts.copy()
                pts.view(np.uint8)[0] ^= 0x01
            pts.setflags(write=False)
            self._version += 1
            if watermark_id is None:
                watermark_id = self._stream_watermark
            if event_wm_ms is None:
                event_wm_ms = self._event_watermark_ms
            snap = Snapshot(
                version=self._version,
                watermark_id=int(watermark_id),
                timestamp_ms=_now_ms() if now_ms is None else now_ms,
                points=pts,
                digest=points_digest(pts),
                meta=dict(meta),
                event_wm_ms=event_wm_ms,
                source_key=source_key,
            )
            prev = self._latest
            self._history.append(snap)
            self._advances = 0
            self._latest = snap  # the atomic swap readers key off
            self._source_key = source_key
            self.published += 1
            self.restored = False  # a live publish supersedes a recovered head
            self.last_publish_deduped = False
        for cb in self._subscribers:
            cb(prev, snap)
        return snap

    def restore_state(
        self,
        points: np.ndarray,
        version: int,
        watermark_id: int = -1,
        timestamp_ms: float | None = None,
        meta: dict | None = None,
        advances: int = 0,
        event_wm_ms: float | None = None,
    ) -> Snapshot:
        """Re-seat the store from recovered state (checkpoint barrier + WAL
        deltas) WITHOUT firing subscribers: the delta ring is re-seeded
        separately from the same WAL records, so firing here would mint a
        bogus everything-entered transition. Version numbering continues
        from ``max(current, version)`` so post-restart publishes never reuse
        a version number a pre-crash subscriber already saw."""
        pts = np.ascontiguousarray(points, dtype=np.float32).copy()
        pts.setflags(write=False)
        with self._write_lock:
            self._version = max(self._version, int(version))
            snap = Snapshot(
                version=self._version,
                watermark_id=int(watermark_id),
                timestamp_ms=_now_ms() if timestamp_ms is None else timestamp_ms,
                points=pts,
                digest=points_digest(pts),
                meta=dict(meta or {}),
                event_wm_ms=event_wm_ms,
            )
            self._history.append(snap)
            self._latest = snap
            self._source_key = None  # recovered bytes never dedupe a publish
            self._advances = advances
            if event_wm_ms is not None and (
                self._event_watermark_ms is None
                or event_wm_ms > self._event_watermark_ms
            ):
                self._event_watermark_ms = event_wm_ms
            self.restored = True
            self.restores += 1
        return snap

    # -- reader side (any thread, lock-free) ------------------------------

    def latest(self) -> Snapshot | None:
        return self._latest

    def get(self, version: int) -> Snapshot | None:
        """A specific retained version (None once it ages out of history)."""
        for snap in reversed(self._history):
            if snap.version == version:
                return snap
        return None

    @property
    def head_version(self) -> int:
        return self._version

    @property
    def version_lag(self) -> int:
        """Ingest advances since the latest publish (0 = snapshot is exact)."""
        return self._advances

    @property
    def stream_watermark(self) -> int:
        return self._stream_watermark

    def read(
        self,
        max_age_ms: float | None = None,
        max_version_lag: int | None = None,
        now_ms: float | None = None,
    ) -> ReadStatus | None:
        """Bounded read of the latest snapshot; None if nothing published."""
        snap = self._latest  # one atomic load; everything below is frozen
        if snap is None:
            return None
        now = _now_ms() if now_ms is None else now_ms
        age_ms = max(0.0, now - snap.timestamp_ms)
        lag = self._advances
        fresh = True
        if max_age_ms is not None and age_ms > max_age_ms:
            fresh = False
        if max_version_lag is not None and lag > max_version_lag:
            fresh = False
        staleness = (
            max(0.0, now - snap.event_wm_ms)
            if snap.event_wm_ms is not None
            else None
        )
        return ReadStatus(snap, fresh, age_ms, lag, staleness_ms=staleness)

    def stats(self) -> dict:
        snap = self._latest
        return {
            "head_version": self._version,
            "published": self.published,
            "deduped": self.deduped,
            "restored": self.restored,
            "restores": self.restores,
            "version_lag": self._advances,
            "stream_watermark": self._stream_watermark,
            "event_watermark_ms": self._event_watermark_ms,
            "published_event_wm_ms": (
                snap.event_wm_ms if snap is not None else None
            ),
            "history_depth": len(self._history),
            "latest_size": snap.size if snap is not None else 0,
            "latest_age_ms": (
                round(max(0.0, _now_ms() - snap.timestamp_ms), 1)
                if snap is not None
                else None
            ),
        }

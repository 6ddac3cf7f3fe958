"""ChipHealth: per-chip health scoring and quarantine for the sharded
engine.

Counterpart of ``skyline_tpu/resilience/health.py``, host-only. Every chip
carries a health score in [0, 1] (1 = pristine), fed by merge outcomes:

- a completed level-1 merge recovers the score toward 1 and refreshes the
  chip's heartbeat (completed per-chip flushes refresh the heartbeat too,
  so merge-quiet but ingest-live chips never quarantine stale);
- a deadline timeout or an error (including a chip-scoped injected
  crash) halves the score and bumps a consecutive-failure counter;
- a merge wall past ``SKYLINE_CHIP_STRAGGLER_FACTOR`` times the other
  chips' median EMA decays the score gently, once a chip has more than
  three clean merges behind it (the first ones pay one-off build walls);
- a heartbeat older than ``SKYLINE_CHIP_HEARTBEAT_MS`` while ANY other
  chip is fresh quarantines on age alone (absolute age would false-alarm
  an idle but healthy fleet, so staleness is judged relatively).

A chip is **quarantined** when its consecutive failures reach
``SKYLINE_CHIP_FAIL_THRESHOLD`` or its score sinks below
``SKYLINE_CHIP_QUARANTINE_SCORE``. Quarantine is advisory state: the
sharded engine reads it at the next merge launch and fails the chip's
partition group over to a healthy owner (``ShardedPartitionSet.
maybe_failover``), after which ``heal()`` returns the slot to service.
"""

from __future__ import annotations

import threading
import time

from skyline_tpu_torch.utils.knobs import (
    chip_fail_threshold,
    chip_heartbeat_ms,
    chip_quarantine_score,
    chip_straggler_factor,
)

HEALTHY = "healthy"
QUARANTINED = "quarantined"


class _ChipRecord:
    __slots__ = (
        "status", "score", "consecutive_failures", "failures", "timeouts",
        "stragglers", "merges_ok", "wall_ema_ms", "heartbeat_s",
        "quarantine_reason", "quarantines", "heals",
    )

    def __init__(self, now_s: float):
        self.status = HEALTHY
        self.score = 1.0
        self.consecutive_failures = 0
        self.failures = 0
        self.timeouts = 0
        self.stragglers = 0
        self.merges_ok = 0
        self.wall_ema_ms: float | None = None
        self.heartbeat_s = now_s
        self.quarantine_reason: str | None = None
        self.quarantines = 0
        self.heals = 0


class ChipHealth:
    """Health scores + quarantine state for ``chips`` partition groups."""

    def __init__(self, chips: int, telemetry=None):
        self.chips = int(chips)
        self.telemetry = telemetry
        self._lock = threading.Lock()
        now = time.monotonic()
        self._rec = [_ChipRecord(now) for _ in range(self.chips)]

    # -- signal intake ----------------------------------------------------

    def note_heartbeat(self, chip: int) -> None:
        """Liveness proof between merges: the sharded facade calls this on
        every completed per-chip flush."""
        with self._lock:
            self._rec[chip].heartbeat_s = time.monotonic()

    def note_merge_ok(self, chip: int, wall_ms: float) -> None:
        """A completed level-1 merge: recover the score, refresh the
        heartbeat, fold the wall into the EMA, and decay the score instead
        when the wall marks this chip a straggler."""
        with self._lock:
            r = self._rec[chip]
            r.merges_ok += 1
            r.consecutive_failures = 0
            r.heartbeat_s = time.monotonic()
            ema = r.wall_ema_ms
            r.wall_ema_ms = wall_ms if ema is None else 0.8 * ema + 0.2 * wall_ms
            peer_emas = sorted(
                p.wall_ema_ms
                for i, p in enumerate(self._rec)
                if i != chip and p.wall_ema_ms is not None
            )
            if peer_emas and r.merges_ok > 3:
                median = peer_emas[len(peer_emas) // 2]
                if median > 0 and wall_ms > chip_straggler_factor() * median:
                    r.stragglers += 1
                    r.score *= 0.9
                    self._maybe_quarantine(
                        r, chip,
                        f"straggler: {wall_ms:.1f}ms vs fleet median "
                        f"{median:.1f}ms",
                    )
                    return
            r.score = min(1.0, r.score + 0.25 * (1.0 - r.score))

    def note_merge_timeout(self, chip: int, deadline_ms: float) -> None:
        with self._lock:
            r = self._rec[chip]
            r.timeouts += 1
            self._note_failure(r, chip, f"merge deadline {deadline_ms:.0f}ms exceeded")

    def note_merge_error(self, chip: int, err: str) -> None:
        with self._lock:
            self._note_failure(self._rec[chip], chip, f"merge error: {err}")

    def tick(self) -> None:
        """Periodic (idle-loop) pass: quarantine chips whose heartbeat went
        stale while at least one peer stayed fresh."""
        limit_s = chip_heartbeat_ms() / 1000.0
        now = time.monotonic()
        with self._lock:
            ages = [now - r.heartbeat_s for r in self._rec]
            if (min(ages) if ages else 0.0) > limit_s:
                return  # the whole fleet is idle, not one chip dead
            for chip, (r, age) in enumerate(zip(self._rec, ages)):
                if r.status == HEALTHY and age > limit_s:
                    self._quarantine(r, chip, f"heartbeat stale {age:.1f}s")

    # -- transitions ------------------------------------------------------

    def _note_failure(self, r: _ChipRecord, chip: int, reason: str) -> None:
        r.failures += 1
        r.consecutive_failures += 1
        r.score *= 0.5
        self._maybe_quarantine(r, chip, reason)

    def _maybe_quarantine(self, r: _ChipRecord, chip: int, reason: str) -> None:
        if r.status == QUARANTINED:
            return
        if r.consecutive_failures >= chip_fail_threshold() or r.score < chip_quarantine_score():
            self._quarantine(r, chip, reason)

    def _quarantine(self, r: _ChipRecord, chip: int, reason: str) -> None:
        r.status = QUARANTINED
        r.quarantine_reason = reason
        r.quarantines += 1
        tel = self.telemetry
        if tel is not None:
            tel.inc("health.quarantines")
            fl = getattr(tel, "flight", None)
            if fl is not None:
                fl.note("health.quarantine", chip=chip, reason=reason, score=round(r.score, 3))
            ops = getattr(tel, "opslog", None)
            if ops is not None:
                ops.record("chip_quarantined", chip=chip, reason=reason, score=round(r.score, 3))

    def quarantine(self, chip: int, reason: str) -> None:
        """Operator/test hook: quarantine unconditionally."""
        with self._lock:
            self._quarantine(self._rec[chip], chip, reason)

    def heal(self, chip: int) -> None:
        """Return a slot to service (after failover re-owned its group, or
        an operator cleared it): full score, fresh heartbeat. A heal out of
        quarantine is the ops journal's ``chip_failover`` marker."""
        with self._lock:
            r = self._rec[chip]
            was = r.status
            r.status = HEALTHY
            r.score = 1.0
            r.consecutive_failures = 0
            r.quarantine_reason = None
            r.heartbeat_s = time.monotonic()
            if was == QUARANTINED:
                r.heals += 1
                tel = self.telemetry
                if tel is not None:
                    tel.inc("health.heals")
                    fl = getattr(tel, "flight", None)
                    if fl is not None:
                        fl.note("health.heal", chip=chip)
                    ops = getattr(tel, "opslog", None)
                    if ops is not None:
                        ops.record("chip_failover", chip=chip)

    # -- reads ------------------------------------------------------------

    def is_quarantined(self, chip: int) -> bool:
        return self._rec[chip].status == QUARANTINED

    def quarantined(self) -> list[int]:
        return [c for c, r in enumerate(self._rec) if r.status == QUARANTINED]

    def healthy(self) -> list[int]:
        return [c for c, r in enumerate(self._rec) if r.status == HEALTHY]

    def doc(self) -> dict:
        """The ``/health`` chip block: per-chip status, score and signals."""
        now = time.monotonic()
        with self._lock:
            per_chip = [
                {
                    "chip": c,
                    "status": r.status,
                    "score": round(r.score, 4),
                    "consecutive_failures": r.consecutive_failures,
                    "failures": r.failures,
                    "timeouts": r.timeouts,
                    "stragglers": r.stragglers,
                    "merges_ok": r.merges_ok,
                    "wall_ema_ms": None if r.wall_ema_ms is None else round(r.wall_ema_ms, 3),
                    "heartbeat_age_s": round(now - r.heartbeat_s, 3),
                    "quarantine_reason": r.quarantine_reason,
                }
                for c, r in enumerate(self._rec)
            ]
            return {
                "chips": self.chips,
                "quarantined": [c for c, r in enumerate(self._rec) if r.status == QUARANTINED],
                "per_chip": per_chip,
            }

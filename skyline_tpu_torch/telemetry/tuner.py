"""Closed-loop dispatch tuner: the controller that acts on what the
workload plane measures.

Counterpart of ``skyline_tpu/telemetry/tuner.py``. The
WorkloadCharacterizer classifies the stream (uniform / correlated /
anti_correlated) and detects drift; the KernelProfiler measures every
dispatch signature's wall EMA; the SLO engine knows when latency budget is
burning. ``DispatchTuner`` acts on them against the declarative cascade
table (``ops/cascade.py``):

- **pins**: per (stage, d, N-bucket, backend, mp) signature, the winner
  by measured EMA is pinned so the race stops flapping and a restart (via
  the checkpointed state) never re-explores a losing variant. Pins obey
  the table's audit-plane hard rule — only rows with a registered
  byte-identity oracle are accepted — and only ever name rows the legacy
  env knobs would have raced anyway.
- **knob overrides**: today the delta-merge dirty-fraction cutoff, moved
  toward the observed dirty-fraction quantile (harvested from the flight
  recorder's ``merge.launch`` notes — zero hot-path coupling). Explicit
  env settings always win; moves are bounded per epoch
  (``SKYLINE_TUNER_MAX_MOVES``, ``SKYLINE_TUNER_CUTOFF_STEP``).
- **regime hysteresis**: the controller context only switches after
  ``SKYLINE_TUNER_HYSTERESIS`` consecutive epochs report the new kind —
  a single noisy epoch cannot thrash pins. On a CONFIRMED switch the
  per-regime learned state swaps in (or, first visit, the mask/flush
  profiler signatures reset so the race re-runs under the new
  distribution — EMAs measured under the old regime are evidence about
  the wrong workload).
- **SLO burn as reward**: while the SLO engine reports a breach the
  controller reverts its most recent move and freezes instead of making
  new ones — do no harm beats converge faster.

The controller is PASSIVE until at least one workload epoch has closed
and ``SKYLINE_TUNER_EPOCH_S`` has elapsed since the last controller
epoch, so unit-scale runs never see a move. All decisions land in the
flight recorder (``tuner.*`` kinds), the ``skyline_tuner_*_total``
Prometheus families, ``GET /dispatch``, and EXPLAIN plans; learned state
round-trips through the checkpoint plane (``state_doc``/``restore``).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from skyline_tpu_torch.ops import cascade

# stage -> the profiler variant names whose signatures the tuner may pin
STAGE_VARIANTS = {
    "mask": (
        "mask_pallas", "mask_rank_pallas", "mask_device_cascade",
        "sorted_sfs_mask", "mask_scan",
    ),
    "flush": (
        "flush_sorted_sfs", "flush_sfs_sequential", "flush_sfs_vmapped",
        "flush_device_cascade",
    ),
}

_CUTOFF_LO, _CUTOFF_HI = 0.05, 0.95


def _quantile(vals, q: float) -> float:
    s = sorted(vals)
    if not s:
        return 0.0
    idx = min(len(s) - 1, max(0, int(q * (len(s) - 1))))
    return s[idx]


class DispatchTuner:
    """Online controller over the cascade table's pins and overrides."""

    def __init__(
        self,
        telemetry=None,
        workload=None,
        profiler=None,
        flush_profiler=None,
        clock=time.monotonic,
    ):
        from skyline_tpu_torch.utils.knobs import (
            env_bool,
            env_float,
            env_int,
        )

        self._telemetry = telemetry
        self._workload = workload
        self._profiler = profiler
        # the flush chooser's profiler is per-PartitionSet and created
        # lazily, so the engine hands us a getter, not the object
        self._flush_profiler = flush_profiler
        self._clock = clock
        self.epoch_s = max(0.0, env_float("SKYLINE_TUNER_EPOCH_S", 5.0))
        self.hysteresis = max(1, env_int("SKYLINE_TUNER_HYSTERESIS", 2))
        self.max_moves = max(0, env_int("SKYLINE_TUNER_MAX_MOVES", 2))
        self.cutoff_step = max(
            0.01, env_float("SKYLINE_TUNER_CUTOFF_STEP", 0.1)
        )
        self.explore_on_drift = env_bool(
            "SKYLINE_TUNER_EXPLORE_ON_DRIFT", True
        )
        self._lock = threading.Lock()
        self._last_epoch_t = self._clock()  # first epoch after one cadence
        self._committed: str | None = None  # guarded-by: self._lock
        self._cand: str | None = None
        self._cand_streak = 0
        self._applied: dict[tuple, str] = {}  # pin key -> variant
        self._learned: dict[str, dict] = {}   # regime kind -> state
        self._fracs: deque[float] = deque(maxlen=128)
        self._flight_seq = 0
        self._decisions: deque[dict] = deque(maxlen=64)
        self._last_move: tuple | None = None
        self.epochs = 0
        self.moves = 0
        self.reverts = 0
        self.switches = 0
        # register the Prometheus families before the first move, not after
        self._inc("tuner.epochs", 0)
        self._inc("tuner.moves", 0)
        self._inc("tuner.pins", 0)
        self._inc("tuner.reverts", 0)
        self._inc("tuner.switches", 0)

    # -- plumbing ----------------------------------------------------------

    def _inc(self, name: str, n: int = 1) -> None:
        if self._telemetry is not None:
            self._telemetry.inc(name, n)

    def _note(self, kind: str, **fields) -> None:
        flight = getattr(self._telemetry, "flight", None)
        if flight is not None:
            flight.note(kind, **fields)

    def _decide(self, action: str, **detail) -> None:
        entry = {
            "t_ms": round(time.time() * 1000.0, 1),
            "regime": self._committed,
            "action": action,
        }
        entry.update(detail)
        self._decisions.append(entry)
        self._note("tuner." + action, **detail)

    def _profilers(self):
        out = []
        if self._profiler is not None:
            out.append(("mask", self._profiler))
        fp = (
            self._flush_profiler()
            if callable(self._flush_profiler)
            else self._flush_profiler
        )
        if fp is not None:
            out.append(("flush", fp))
        return out

    # -- the controller epoch ----------------------------------------------

    def maybe_tune(self, now: float | None = None) -> bool:
        """One bounded controller epoch, or a cheap no-op when the cadence
        has not elapsed / no workload evidence exists yet. Thread-safe;
        concurrent callers (query path + worker idle loop) coalesce."""
        if now is None:
            now = self._clock()
        with self._lock:
            if now - self._last_epoch_t < self.epoch_s:
                return False
            self._last_epoch_t = now
            return self._epoch_locked()

    def _epoch_locked(self) -> bool:
        regime = None
        if self._workload is not None:
            try:
                regime = self._workload.regime()
            except Exception:
                regime = None
        if not regime or int(regime.get("epoch", 0)) < 1:
            return False  # passive until a workload epoch closed
        self.epochs += 1
        self._inc("tuner.epochs")
        self._track_regime(str(regime.get("kind")))
        self._harvest_flight()
        if self._slo_burning():
            # do no harm: while latency budget burns, undo the newest
            # move and freeze instead of optimizing into the breach
            self._revert_last("slo_burn")
            return True
        budget = self.max_moves
        budget -= self._refresh_pins(budget)
        if budget > 0:
            budget -= self._tune_cutoff()
        return True

    def _track_regime(self, kind: str) -> None:
        if self._committed is None:
            self._committed = kind  # unguarded-ok: under _lock via _epoch_locked
            return
        if kind == self._committed:
            self._cand, self._cand_streak = None, 0
            return
        if kind == self._cand:
            self._cand_streak += 1
        else:
            self._cand, self._cand_streak = kind, 1
        if self._cand_streak < self.hysteresis:
            return
        prev, self._committed = self._committed, kind  # unguarded-ok: under _lock
        self._cand, self._cand_streak = None, 0
        self.switches += 1
        self._inc("tuner.switches")
        self._on_switch(prev, kind)

    def _on_switch(self, prev: str, kind: str) -> None:
        # bank the outgoing regime's learned state, then either restore
        # the incoming one or (first visit) restart exploration — EMAs
        # measured under the old distribution are the wrong evidence
        self._learned[prev] = {
            "pins": cascade.pins_doc(),
            "cutoff_override": cascade.override("SKYLINE_DELTA_CUTOFF"),
        }
        self._fracs.clear()
        learned = self._learned.get(kind)
        cascade.clear_pins("mask")
        cascade.clear_pins("flush")
        self._applied.clear()
        restored = 0
        if learned:
            restored = self._apply_learned(learned)
        elif self.explore_on_drift:
            for stage, prof in self._profilers():
                if hasattr(prof, "reset_signatures"):
                    prof.reset_signatures(STAGE_VARIANTS[stage])
        self._decide(
            "regime_switch", prev=prev, next=kind, restored_pins=restored,
            explored=bool(not learned and self.explore_on_drift),
        )

    def _apply_learned(self, learned: dict) -> int:
        applied = 0
        for p in learned.get("pins") or []:
            ok = cascade.pin(
                p["stage"], p["variant"], p["d"], p["n_bucket"],
                mp=p.get("mp", False), backend=p.get("backend"),
            )
            if ok:
                key = (p["stage"], int(p["d"]), int(p["n_bucket"]),
                       p.get("backend"), bool(p.get("mp", False)))
                self._applied[key] = p["variant"]
                applied += 1
        cut = learned.get("cutoff_override")
        if cut is None:
            cascade.clear_override("SKYLINE_DELTA_CUTOFF")
        else:
            cascade.set_override("SKYLINE_DELTA_CUTOFF", cut)
        return applied

    def _harvest_flight(self) -> None:
        """Pull merge dirty-fractions from the flight ring's
        ``merge.launch`` notes — observation without touching the merge
        hot path."""
        flight = getattr(self._telemetry, "flight", None)
        if flight is None:
            return
        for entry in flight.snapshot():
            if entry.get("seq", 0) <= self._flight_seq:
                continue
            self._flight_seq = max(self._flight_seq, entry.get("seq", 0))
            if entry.get("kind") != "merge.launch":
                continue
            f = entry.get("dirty_fraction")
            if isinstance(f, (int, float)) and 0.0 < float(f) < 1.0:
                self._fracs.append(float(f))

    def _slo_burning(self) -> bool:
        slo = getattr(self._telemetry, "slo", None)
        if slo is None:
            return False
        try:
            return not bool(slo.evaluate().get("ok", True))
        except Exception:
            return False

    # -- moves -------------------------------------------------------------

    def _refresh_pins(self, budget: int) -> int:
        """Pin the EMA winner for every signature where >= 2 candidates
        carry measured data and the winner differs from the applied pin.
        Consumes at most ``budget`` moves."""
        if budget <= 0:
            return 0
        made = 0
        for stage, prof in self._profilers():
            names = set(STAGE_VARIANTS[stage])
            groups: dict[tuple, list] = {}
            try:
                rows = prof.doc().get("kernels", [])
            except Exception:
                continue
            for r in rows:
                if r.get("variant") in names:
                    sig = (r["d"], r["n_bucket"], r["backend"],
                           bool(r.get("mp", False)))
                    groups.setdefault(sig, []).append(r)
            for (d, bucket, backend, mp), rs in sorted(groups.items()):
                if made >= budget:
                    return made
                if len(rs) < 2:
                    continue
                winner = min(rs, key=lambda r: r["ema_ms"])["variant"]
                key = (stage, int(d), int(bucket), backend, mp)
                prev = self._applied.get(key)
                if prev == winner:
                    continue
                if not cascade.pin(
                    stage, winner, d, bucket, mp=mp, backend=backend
                ):
                    continue  # no registered oracle: never selectable
                self._applied[key] = winner
                made += 1
                self.moves += 1
                self._inc("tuner.moves")
                self._inc("tuner.pins")
                self._last_move = ("pin", key, prev)
                self._decide(
                    "pin", stage=stage, d=int(d), n_bucket=int(bucket),
                    backend=backend, mp=mp, variant=winner, prev=prev,
                )
        return made

    def _tune_cutoff(self) -> int:
        """Move the delta-merge cutoff one bounded step toward the p75 of
        observed dirty fractions — deltas then cover the workload's
        typical partial-flush pattern without chasing outliers."""
        if len(self._fracs) < 8:
            return 0
        target = min(_CUTOFF_HI, max(_CUTOFF_LO, _quantile(self._fracs, 0.75)))
        cur = cascade.delta_cutoff()
        delta = target - cur
        if abs(delta) < self.cutoff_step / 2.0:
            return 0
        step = max(-self.cutoff_step, min(self.cutoff_step, delta))
        prev_override = cascade.override("SKYLINE_DELTA_CUTOFF")
        new = round(cur + step, 3)
        if not cascade.set_override("SKYLINE_DELTA_CUTOFF", new):
            return 0  # env-pinned: the operator's value stands
        self.moves += 1
        self._inc("tuner.moves")
        self._last_move = ("override", "SKYLINE_DELTA_CUTOFF", prev_override)
        self._decide(
            "cutoff", prev=cur, next=new, target=round(target, 3),
            samples=len(self._fracs),
        )
        return 1

    def _revert_last(self, reason: str) -> None:
        if self._last_move is None:
            return
        kind, key, prev = self._last_move
        self._last_move = None
        if kind == "override":
            if prev is None:
                cascade.clear_override(key)
            else:
                cascade.set_override(key, prev)
        else:
            stage, d, bucket, backend, mp = key
            if prev is None:
                cascade.unpin(stage, d, bucket, mp=mp, backend=backend)
                self._applied.pop(key, None)
            else:
                cascade.pin(stage, prev, d, bucket, mp=mp, backend=backend)
                self._applied[key] = prev
        self.reverts += 1
        self._inc("tuner.reverts")
        self._decide("revert", reason=reason, move=kind)

    # -- persistence + surfaces --------------------------------------------

    def state_doc(self) -> dict:
        """JSON-safe learned state for the checkpoint plane: live pins +
        overrides plus every banked regime's state, so a supervised
        restart resumes tuned instead of re-exploring."""
        with self._lock:
            learned = {
                k: {
                    "pins": list(v.get("pins") or []),
                    "cutoff_override": v.get("cutoff_override"),
                }
                for k, v in self._learned.items()
            }
            return {
                "version": 1,
                "regime": self._committed,
                "pins": cascade.pins_doc(),
                "overrides": cascade.overrides_doc(),
                "learned": learned,
                "stats": {
                    "epochs": self.epochs,
                    "moves": self.moves,
                    "reverts": self.reverts,
                    "switches": self.switches,
                },
            }

    def restore(self, doc) -> int:
        """Re-apply a ``state_doc``. Every pin re-passes the table's
        oracle rule and every override re-passes the env-pinned check —
        a checkpoint can never smuggle in a selection the live table
        would refuse. Returns the number of pins applied."""
        if not isinstance(doc, dict) or doc.get("version") != 1:
            return 0
        applied = 0
        with self._lock:
            self._committed = doc.get("regime") or self._committed
            for k, v in (doc.get("learned") or {}).items():
                if isinstance(v, dict):
                    self._learned[str(k)] = {
                        "pins": list(v.get("pins") or []),
                        "cutoff_override": v.get("cutoff_override"),
                    }
            for p in doc.get("pins") or []:
                try:
                    ok = cascade.pin(
                        p["stage"], p["variant"], p["d"], p["n_bucket"],
                        mp=p.get("mp", False), backend=p.get("backend"),
                    )
                except (KeyError, TypeError):
                    continue
                if ok:
                    key = (p["stage"], int(p["d"]), int(p["n_bucket"]),
                           p.get("backend"), bool(p.get("mp", False)))
                    self._applied[key] = p["variant"]
                    applied += 1
            for name, value in (doc.get("overrides") or {}).items():
                cascade.set_override(name, value)
            if applied or doc.get("overrides"):
                self._decide("restore", pins=applied)
        return applied

    def doc(self) -> dict:
        """The tuner block of ``GET /dispatch``."""
        with self._lock:
            return {
                "enabled": True,
                "regime": self._committed,
                "candidate": self._cand,
                "candidate_streak": self._cand_streak,
                "epoch_s": self.epoch_s,
                "hysteresis": self.hysteresis,
                "max_moves_per_epoch": self.max_moves,
                "cutoff_step": self.cutoff_step,
                "explore_on_drift": self.explore_on_drift,
                "epochs": self.epochs,
                "moves": self.moves,
                "reverts": self.reverts,
                "switches": self.switches,
                "dirty_fraction_samples": len(self._fracs),
                "decisions": list(self._decisions),
            }

    def explain_block(self) -> dict | None:
        """Compact per-query EXPLAIN annotation: the regime context the
        answer was dispatched under and the newest decision, or None
        before the controller ever acted."""
        with self._lock:
            if not self._decisions and not self._applied:
                return None
            return {
                "regime": self._committed,
                "pins": len(self._applied),
                "moves": self.moves,
                "last": self._decisions[-1] if self._decisions else None,
            }


def dispatch_doc(telemetry) -> dict:
    """The full ``GET /dispatch`` document both HTTP surfaces serve: the
    declarative table (rows, oracles, pins, overrides) plus the live
    tuner block when a controller is attached."""
    tuner = getattr(telemetry, "tuner", None) if telemetry else None
    doc = {"table": cascade.table_doc()}
    doc["tuner"] = tuner.doc() if tuner is not None else {"enabled": False}
    return doc

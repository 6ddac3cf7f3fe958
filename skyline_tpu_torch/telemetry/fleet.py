"""Per-chip fleet telemetry for the sharded streaming engine.

Counterpart of ``skyline_tpu/telemetry/fleet.py``. The sharded facade
(``distributed/sharded.py``) feeds one ``FleetStats`` and everything
downstream reads it:

- **labeled Prometheus families** ``skyline_chip_*{chip=...}``: ingest
  rows routed to each chip's partition group, flush wall-clock, the last
  level-1 local-skyline size, prune outcomes at the level-2 chip tournament
  (pruned vs survived), and the rows each surviving chip shipped across to
  the root device;
- **an imbalance index**: ``max(chip load) / mean(chip load)`` over the
  rows each chip has ingested (1.0 = perfectly balanced), plus a rolling
  skew score (mean imbalance over a bounded ring of recent merges). When
  the index *crosses* ``SKYLINE_FLEET_IMBALANCE_THRESHOLD`` a flight entry
  is noted — edge-triggered, so a persistently skewed fleet logs once per
  excursion, not once per merge;
- **the ``/fleet`` join** (``fleet_doc``): per-chip stats + the freshness
  watermark + the last EXPLAIN chip attribution, served by both HTTP
  surfaces. A flat engine's hub has no ``fleet``: ``enabled`` is false.

All of it is host-side bookkeeping around the merge: the published bytes
are the same with the plane on or off.
"""

from __future__ import annotations

import threading
from collections import deque

from skyline_tpu_torch.utils.knobs import fleet_imbalance_threshold, fleet_ring


class FleetStats:
    """Per-chip accumulators + the imbalance/skew roll-up.

    Single writer (the engine thread driving the sharded facade); ``doc``
    and ``labeled_series`` may be called from HTTP reader threads, hence
    the lock."""

    def __init__(self, chips: int, flight=None, imbalance_threshold: float | None = None,
                 ring: int | None = None):
        self.chips = int(chips)
        self._flight = flight
        self.imbalance_threshold = float(
            imbalance_threshold if imbalance_threshold is not None
            else fleet_imbalance_threshold()
        )
        cap = max(2, int(ring)) if ring is not None else fleet_ring()
        self._lock = threading.Lock()
        n = self.chips
        # per-chip monotonic accumulators  # guarded-by: self._lock
        self._ingest_rows = [0] * n
        self._flush_rows = [0] * n
        self._flush_wall_ms = [0.0] * n
        self._merge_wall_ms = [0.0] * n
        self._skyline_size = [0] * n  # last level-1 local skyline
        self._pruned = [0] * n
        self._survived = [0] * n
        self._interconnect_rows = [0] * n
        self.merges = 0
        # rolling imbalance samples, one per merge
        self._skew_ring: deque[float] = deque(maxlen=cap)
        self._above_threshold = False  # the edge trigger
        self.imbalance_events = 0

    # -- writer side (engine thread) --------------------------------------

    def note_ingest(self, chip: int, rows: int) -> None:
        with self._lock:
            self._ingest_rows[chip] += int(rows)

    def note_flush(self, chip: int, rows: int, wall_ms: float) -> None:
        with self._lock:
            self._flush_rows[chip] += int(rows)
            self._flush_wall_ms[chip] += float(wall_ms)

    def note_level1(self, chip: int, skyline_size: int, wall_ms: float) -> None:
        """Chip ``chip`` reduced its partition group to one local skyline."""
        with self._lock:
            self._skyline_size[chip] = int(skyline_size)
            self._merge_wall_ms[chip] += float(wall_ms)

    def note_level2(self, chip: int, pruned: bool, crossed_rows: int) -> None:
        """Level-2 outcome for one chip: pruned whole (its skyline never
        crossed) or survived and shipped ``crossed_rows`` to the root."""
        with self._lock:
            if pruned:
                self._pruned[chip] += 1
            else:
                self._survived[chip] += 1
                self._interconnect_rows[chip] += int(crossed_rows)

    def note_merge_done(self) -> dict:
        """Close one tournament: the imbalance index over per-chip ingest
        loads, the skew ring, and the edge-triggered flight entry when the
        index crosses the threshold. Returns the imbalance block."""
        with self._lock:
            self.merges += 1
            idx, loads = self._imbalance_locked()
            self._skew_ring.append(idx)
            skew = sum(self._skew_ring) / len(self._skew_ring)
            crossed = idx > self.imbalance_threshold
            fire = crossed and not self._above_threshold
            self._above_threshold = crossed
            if fire:
                self.imbalance_events += 1
            doc = {
                "imbalance_index": round(idx, 4),
                "skew_score": round(skew, 4),
                "threshold": self.imbalance_threshold,
                "loads": loads,
            }
        if fire and self._flight is not None:
            self._flight.note("fleet.imbalance", **doc)
        return doc

    def _imbalance_locked(self) -> tuple[float, list[int]]:
        loads = list(self._ingest_rows)
        mean = sum(loads) / max(len(loads), 1)
        idx = (max(loads) / mean) if mean > 0 else 1.0
        return idx, loads

    def _skew_locked(self, idx: float) -> float:
        return sum(self._skew_ring) / len(self._skew_ring) if self._skew_ring else idx

    # -- reader side (HTTP threads, /stats) -------------------------------

    def doc(self) -> dict:
        with self._lock:
            idx, _ = self._imbalance_locked()
            per_chip = [
                {
                    "chip": c,
                    "ingest_rows": self._ingest_rows[c],
                    "flush_rows": self._flush_rows[c],
                    "flush_wall_ms": round(self._flush_wall_ms[c], 3),
                    "merge_wall_ms": round(self._merge_wall_ms[c], 3),
                    "skyline_size": self._skyline_size[c],
                    "pruned": self._pruned[c],
                    "survived": self._survived[c],
                    "interconnect_rows": self._interconnect_rows[c],
                }
                for c in range(self.chips)
            ]
            return {
                "chips": self.chips,
                "merges": self.merges,
                "imbalance_index": round(idx, 4),
                "skew_score": round(self._skew_locked(idx), 4),
                "imbalance_threshold": self.imbalance_threshold,
                "imbalance_events": self.imbalance_events,
                "interconnect_rows_total": sum(self._interconnect_rows),
                "per_chip": per_chip,
            }

    def labeled_series(self) -> tuple[dict, dict]:
        """(labeled counters, labeled gauges) for the Prometheus renderer:
        ``{family: [(((label, value),), sample), ...]}``."""
        with self._lock:
            idx, _ = self._imbalance_locked()
            skew = self._skew_locked(idx)

            def fam(vals):
                return [((("chip", str(c)),), float(vals[c])) for c in range(self.chips)]

            counters = {
                "chip_ingest_rows": fam(self._ingest_rows),
                "chip_flush_rows": fam(self._flush_rows),
                "chip_flush_wall_ms": fam(self._flush_wall_ms),
                "chip_merge_wall_ms": fam(self._merge_wall_ms),
                "chip_pruned": fam(self._pruned),
                "chip_survived": fam(self._survived),
                "chip_interconnect_rows": fam(self._interconnect_rows),
            }
            gauges = {
                "chip_skyline_size": fam(self._skyline_size),
                "fleet_imbalance_index": [((), float(idx))],
                "fleet_skew_score": [((), float(skew))],
            }
        return counters, gauges


def fleet_doc(telemetry, stats: dict | None) -> dict:
    """The ``GET /fleet`` join both HTTP surfaces serve: per-chip stats +
    the freshness watermark + the last EXPLAIN chip attribution. Works on
    a flat (non-sharded) engine too — ``enabled`` is false and the chip
    list is empty, so probes can distinguish "plane off" from "all
    balanced"."""
    fleet = getattr(telemetry, "fleet", None) if telemetry is not None else None
    doc: dict = {"enabled": fleet is not None}
    if fleet is not None:
        doc.update(fleet.doc())
    # chip-health join: quarantine state rides /fleet so one scrape answers
    # "which chip is sick AND how loaded is the rest"
    health = getattr(telemetry, "health", None) if telemetry is not None else None
    doc["health"] = health.doc() if health is not None else None
    fr = (stats or {}).get("freshness")
    doc["freshness_wm_ms"] = fr.get("published_wm_ms") if isinstance(fr, dict) else None
    plan = telemetry.explain.latest() if telemetry is not None else None
    if isinstance(plan, dict) and plan.get("chips") is not None:
        doc["last_query"] = {
            "trace_id": plan.get("trace_id"),
            "query_id": plan.get("query_id"),
            "chips": plan.get("chips"),
            "workload": plan.get("workload"),
        }
    else:
        doc["last_query"] = None
    return doc

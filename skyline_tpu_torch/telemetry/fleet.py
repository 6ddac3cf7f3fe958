"""The ``GET /fleet`` document.

Counterpart of ``fleet_doc`` in ``skyline_tpu/telemetry/fleet.py``.
``FleetStats``, the sharded engine's per-card plane, is not ported yet
(ROADMAP queue 1 item 7), so the hub's ``fleet`` stays None and the
document is the flat worker's: ``enabled`` false, no chips.
"""

from __future__ import annotations


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

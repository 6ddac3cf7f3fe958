"""Wire formats — byte-compatible with the reference's Kafka payloads.

Data plane:    CSV lines ``"id,v1,...,vd"``        (unified_producer.py:174)
Control plane: trigger lines ``"queryId,requiredRecordCount"``
               (unified_producer.py:184; a payload with no comma parses to
               required=0 → immediate execution, query_trigger.py:21-26)
Result plane:  one JSON object per query with the reference's field names and
               order (FlinkSkyline.java:631-648), plus ``query_latency_ms``
               which the reference computes but never emits
               (FlinkSkyline.java:588; metrics_collector.py:101 reads it and
               always got 0 — fixed here) and optional ``skyline_points``
               (the reference's commented-out visualization block,
               FlinkSkyline.java:612-623).

Malformed data lines are dropped, mirroring ``ServiceTuple.fromString``
returning null + the non-null filter (ServiceTuple.java:89-104,
FlinkSkyline.java:104). Rows containing NaN/inf are also rejected so they can
never enter windows (the +inf padding convention reserves non-finite values).
"""

from __future__ import annotations

import json

import numpy as np


def parse_tuple_lines(lines, dims: int):
    """Parse data-plane CSV lines into (ids int64 (M,), values float32 (M, d)).

    Lines that are malformed (wrong field count, non-numeric, non-finite
    values) are silently dropped, like the reference's fromString-null filter.
    Returns (ids, values, n_dropped).

    Uses the C++ fast parser (skyline_tpu_torch.native) when available — ingest is
    the documented dominant cost at stream rates (pdf §5.5) — with this
    Python loop as the semantics-defining fallback.
    """
    if not isinstance(lines, list):
        lines = list(lines)
    if lines:
        from skyline_tpu_torch import native

        if native.get_lib() is not None:
            text = ("\n".join(lines)).encode("utf-8", errors="replace")
            out = native.parse_tuples_native(text, dims, max_rows=len(lines))
            if out is not None:
                return out
    ids = []
    rows = []
    dropped = 0
    for line in lines:
        line = line.strip()
        if not line:
            continue  # blank lines are skipped, not counted as malformed
        parts = line.split(",")
        if len(parts) != dims + 1:
            dropped += 1
            continue
        try:
            rid = int(parts[0])
            vals = [float(p) for p in parts[1:]]
        except ValueError:
            dropped += 1
            continue
        if not (-(2**63) <= rid < 2**63):
            # out-of-int64-range ids are malformed, not a batch-killing
            # numpy OverflowError
            dropped += 1
            continue
        if not all(np.isfinite(v) for v in vals):
            dropped += 1
            continue
        ids.append(rid)
        rows.append(vals)
    if not ids:
        return (
            np.empty((0,), dtype=np.int64),
            np.empty((0, dims), dtype=np.float32),
            dropped,
        )
    return (
        np.asarray(ids, dtype=np.int64),
        np.asarray(rows, dtype=np.float32),
        dropped,
    )


def format_tuple_line(record_id: int, values) -> str:
    return f"{record_id}," + ",".join(str(float(v)) for v in values)


def parse_trigger(payload: str):
    """Parse ``"qid,requiredCount"``; a count-less payload means required=0
    (immediate execution) per query_trigger.py:21-26 / FlinkSkyline.java:333-334."""
    parts = payload.strip().split(",")
    qid = parts[0]
    try:
        required = int(parts[1]) if len(parts) > 1 else 0
    except ValueError:
        required = 0
    return qid, required


def format_trigger(qid, required_count: int) -> str:
    return f"{qid},{required_count}"


RESULT_FIELDS = (
    "query_id",
    "record_count",
    "skyline_size",
    "optimality",
    "ingestion_time_ms",
    "local_processing_time_ms",
    "global_processing_time_ms",
    "total_processing_time_ms",
    "query_latency_ms",
)


def format_result(result: dict) -> str:
    """Serialize a result dict as the reference's JSON doc (field order kept
    for byte-level familiarity; optimality rendered with 4 decimals like the
    reference's %.4f, FlinkSkyline.java:634)."""
    out = {}
    for k in RESULT_FIELDS:
        if k in result:
            out[k] = result[k]
    if "optimality" in out:
        out["optimality"] = float(f"{out['optimality']:.4f}")
    # extension fields beyond the reference schema (partial-result marker,
    # missing_partitions, skyline_points, and trace_id — the telemetry
    # span-correlation key minted at trigger ingestion) ride along after
    # the known fields, so reference-parity consumers are untouched
    for k, v in result.items():
        if k not in out:
            out[k] = v
    return json.dumps(out)


def parse_result(line: str) -> dict:
    return json.loads(line)

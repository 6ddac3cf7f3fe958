"""Wire formats — byte-compatible with the reference's Kafka payloads.

Control plane: trigger lines ``"queryId,requiredRecordCount"``
               (unified_producer.py:184; a payload with no comma parses to
               required=0 → immediate execution, query_trigger.py:21-26)
Result plane:  one JSON object per query with the reference's field names and
               order (FlinkSkyline.java:631-648), plus ``query_latency_ms``
               and optional ``skyline_points``.

Data plane: ``format_tuple_line`` writes one ``"id,v0,v1,..."`` tuple line,
the line the serving plane's ``format=csv`` body is made of. The data-plane
CSV parser is a later slice of the port.
"""

from __future__ import annotations

import json


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
    # extension fields beyond the reference schema (skyline_points) ride
    # along after the known fields, so reference-parity consumers are
    # untouched
    for k, v in result.items():
        if k not in out:
            out[k] = v
    return json.dumps(out)

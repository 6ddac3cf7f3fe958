"""Result-JSON → CSV collector.

Parity with python/metrics_collector.py: same 10-column schema (:60-71), one
row per completed query, per-row flush (:123). The ``Latency(ms)`` column is
populated for real here because the engine actually emits
``query_latency_ms`` (the reference computes it at FlinkSkyline.java:588 but
omits it from the JSON, so the reference's column is always 0 — SURVEY.md
§3.5).

Usable as a library (``append_result_row``) against any bus, or as a CLI
(``python -m skyline_tpu_torch.metrics.collector out.csv``) against Kafka or a
JSON-lines file/stdin. The port's copy of ``skyline_tpu/metrics/collector.py``
(same schema, same rows); its CLI also takes ``--count N`` to exit after N
results, so a script can wait for a run's answer.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import threading


class Counters:
    """Thread-safe named monotonic counters — the serving plane's metric
    surface (shed / queue-depth / staleness counts, ``serve/admission.py``),
    snapshotted into ``/stats`` and the bench artifact. Deliberately tiny:
    ``inc`` on hot paths is one lock + one dict add."""

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

CSV_HEADERS = [
    "QueryID",
    "Records",
    "SkylineSize",
    "Optimality",
    "IngestTime(ms)",
    "LocalTime(ms)",
    "GlobalTime(ms)",
    "TotalTime(ms)",
    "Latency(ms)",
    "SkylinePoints",
]

# guards the isfile-check-then-write in append_result_row: two concurrent
# writers (collector CLI + an embedded worker, or two worker threads) could
# both see "no file" and both write the header
_append_lock = threading.Lock()


def result_to_row(data: dict) -> list:
    row = [
        data.get("query_id", "N/A"),
        data.get("record_count", 0),
        data.get("skyline_size", 0),
        data.get("optimality", 0.0),
        data.get("ingestion_time_ms", 0),
        data.get("local_processing_time_ms", 0),
        data.get("global_processing_time_ms", 0),
        data.get("total_processing_time_ms", 0),
        data.get("query_latency_ms", 0),
        json.dumps(data.get("skyline_points", [])),
    ]
    # trace_id (telemetry plane) rides as a trailing column ONLY when the
    # result carries one, so reference-parity consumers of the 10-column
    # schema see byte-identical output for untraced streams
    if "trace_id" in data:
        row.append(data["trace_id"])
    return row


def append_result_row(path: str, data: dict) -> None:
    """Append one result to a CSV file, writing the header on first touch."""
    with _append_lock:
        exists = os.path.isfile(path)
        with open(path, mode="a", newline="") as f:
            w = csv.writer(f)
            if not exists:
                headers = (
                    CSV_HEADERS + ["TraceID"]
                    if "trace_id" in data
                    else CSV_HEADERS
                )
                w.writerow(headers)
            w.writerow(result_to_row(data))
            f.flush()


def collect(messages, path: str, echo: bool = True, limit: int = 0) -> int:
    """Drain an iterable of result-JSON strings (or dicts) into the CSV;
    ``limit`` > 0 stops after that many."""
    n = 0
    for m in messages:
        if limit and n >= limit:
            break
        data = json.loads(m) if isinstance(m, str) else m
        append_result_row(path, data)
        if echo:
            print(
                f"[Query {data.get('query_id')}] Records: {data.get('record_count')} "
                f"| Size: {data.get('skyline_size')} "
                f"| TotalTime: {data.get('total_processing_time_ms')}ms"
            )
        n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output_csv")
    ap.add_argument("--source", choices=["kafka", "stdin"], default="kafka")
    ap.add_argument("--topic", default="output-skyline")
    ap.add_argument("--bootstrap", default="localhost:9092")
    ap.add_argument("--count", type=int, default=0,
                    help="exit after this many results (0 = run until interrupted)")
    args = ap.parse_args(argv)

    if args.source == "stdin":
        collect((ln for ln in sys.stdin if ln.strip()), args.output_csv,
                limit=args.count)
        return 0

    from skyline_tpu_torch.bridge.kafka import KafkaBus

    consumer = KafkaBus(args.bootstrap).consumer(args.topic, from_beginning=False)
    print(f"--- Listening on topic '{args.topic}' ---", file=sys.stderr)
    done = 0
    try:
        while not args.count or done < args.count:
            batch = consumer.poll()
            if batch:
                done += collect(batch, args.output_csv,
                                limit=args.count - done if args.count else 0)
    except KeyboardInterrupt:
        print("\nStopping collector...", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

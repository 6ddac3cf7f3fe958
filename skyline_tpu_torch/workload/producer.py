"""Unified producer CLI — data stream + periodic query triggers.

Parity with python/unified_producer.py: positional args
``<topic> <distribution> <dims> <d_min> <d_max> [query-topic]``
(:137-142), CSV tuple lines ``"id,v1,...,vd"`` (:174), a trigger
``"queryId,recordId"`` every QUERY_THRESHOLD records (:180-188), and a
progress print every 100k (:191-192). Differences: batched generation
(vectorized numpy instead of per-tuple faker), an optional ``--count`` bound
instead of only an infinite loop, and ``--sink stdout`` for broker-less runs
(kafka-python is optional in this environment).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from skyline_tpu_torch.bridge.wire import format_trigger
from skyline_tpu_torch.native import format_tuples_native
from skyline_tpu_torch.workload.generators import (
    QUERY_THRESHOLD,
    SIMPLE_VARIANT,
    generate,
)


def _build_sink(args):
    """Returns (send(topic, lines), send_blob(topic, blob, offsets) | None)."""
    if args.sink == "stdout":
        def send(topic, lines):
            out = sys.stdout
            for ln in lines:
                if isinstance(ln, bytes):
                    ln = ln.decode("utf-8")
                out.write(f"{topic}\t{ln}\n")
        return send, None
    from skyline_tpu_torch.bridge.kafka import KafkaBus

    bus = KafkaBus(args.bootstrap)

    def send(topic, lines):
        bus.produce_many(topic, lines)

    return send, bus.produce_blob


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("topic", nargs="?", default="input-tuples")
    ap.add_argument("distribution", nargs="?", default="uniform")
    ap.add_argument("dims", nargs="?", type=int, default=2)
    ap.add_argument("d_min", nargs="?", type=float, default=0.0)
    ap.add_argument("d_max", nargs="?", type=float, default=1000.0)
    ap.add_argument("query_topic", nargs="?", default="queries")
    ap.add_argument("--count", type=int, default=0, help="stop after N records (0 = infinite)")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--query-threshold", type=int, default=QUERY_THRESHOLD,
                    help="records per injected trigger; <= 0 disables triggers "
                         "(the reference's data-only kafka_producer.py variant)")
    ap.add_argument("--variant", choices=["unified", "simple"], default="unified",
                    help="generator math: 'unified' = unified_producer.py:50-123; "
                         "'simple' = kafka_producer.py:58-88's distinct "
                         "correlated/anti-correlated formulas (P2 parity)")
    ap.add_argument("--sink", choices=["kafka", "stdout"], default="kafka")
    ap.add_argument("--bootstrap", default="localhost:9092")
    ap.add_argument("--start-id", type=int, default=0,
                    help="first record id — resume a stream where a previous "
                         "producer stopped (the reference always restarts at "
                         "0, unified_producer.py:160, breaking barrier "
                         "monotonicity on resume)")
    ap.add_argument("--start-query-id", type=int, default=0)
    ap.add_argument("--final-trigger", action="store_true",
                    help="after a finite stream (--count > 0), send one "
                         "IMMEDIATE trigger (P3 parity: count-less payload "
                         "-> required=0, query_trigger.py:21-26). The "
                         "id-barrier form ('qid,N') can defer forever on a "
                         "finite stream when a sparse partition's few "
                         "records all predate N (the reference's heuristic "
                         "barrier, SURVEY.md §3.3 — its own producer is an "
                         "infinite loop, so it never faces stream end)")
    args = ap.parse_args(argv)

    send, send_blob = _build_sink(args)
    distribution = args.distribution
    if args.variant == "simple":
        key = distribution.lower().replace("-", "_")
        distribution = SIMPLE_VARIANT.get(key, distribution)
    rng = np.random.default_rng(args.seed)
    record_id = args.start_id
    query_id = args.start_query_id
    qt = args.query_threshold
    # next trigger fires at the next threshold multiple past start-id, so a
    # resumed stream keeps the reference's every-QUERY_THRESHOLD cadence
    next_trigger = (record_id // qt + 1) * qt if qt > 0 else 0
    next_progress = (record_id // 100_000 + 1) * 100_000

    end_id = args.start_id + args.count
    while args.count == 0 or record_id < end_id:
        n = args.batch if args.count == 0 else min(args.batch, end_id - record_id)
        vals = generate(distribution, rng, n, args.dims, args.d_min, args.d_max)
        ids = np.arange(record_id, record_id + n, dtype=np.int64)
        # integer-valued floats print without trailing .0 via int cast; the
        # C++ formatter (native/fastcsv.cpp sky_format_tuples) emits the
        # whole batch into one buffer — formatting was the producer's
        # dominant cost (np.char chain: ~69 s/1M x 8D on the dev box vs
        # ~0.1 s native)
        iv = vals.astype(np.int64)
        fmt = format_tuples_native(ids, iv)
        if fmt is not None and send_blob is not None:
            # zero-copy plane: blob + offsets go straight into RecordBatch
            # assembly (kafkalite send_blob) — no per-record bytes objects
            send_blob(args.topic, *fmt)
        elif fmt is not None:
            blob, offs = fmt
            ot = offs.tolist()
            send(args.topic, [blob[ot[i] : ot[i + 1]] for i in range(n)])
        else:
            send(
                args.topic,
                [
                    ",".join(map(str, (i, *row)))
                    for i, row in zip(ids.tolist(), iv.tolist())
                ],
            )
        record_id += n
        while args.query_threshold > 0 and record_id >= next_trigger:
            # barrier = the threshold-crossing id, NOT the batch-end id: the
            # reference fires per-record at the threshold
            # (unified_producer.py:180-188); stamping the batch tail would
            # set a barrier no partition can clear until ids pass it
            send(args.query_topic, [format_trigger(query_id, next_trigger - 1)])
            query_id += 1
            next_trigger += args.query_threshold
        if record_id >= next_progress:
            print(f"produced {record_id} records", file=sys.stderr)
            next_progress += 100_000
    if args.final_trigger and args.count > 0:
        # data is acked before this produce, so the worker's trigger-pending
        # drain ingests the whole stream before the immediate query runs
        send(args.query_topic, [str(query_id)])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

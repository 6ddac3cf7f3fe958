"""Manual query-trigger CLI.

Parity with python/query_trigger.py: sends a single trigger to the query
topic. The reference's payload is the bare algo id (1=mr-dim, 2=mr-grid,
3=mr-angle, :58-62) — a count-less payload, which parses to required=0 and
executes immediately (:21-26, 78-82). ``--required`` optionally adds a real
record-id barrier.
"""

from __future__ import annotations

import argparse
import sys

from skyline_tpu_torch.bridge.wire import format_trigger


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("query_id", nargs="?", default="1")
    ap.add_argument("--required", type=int, default=None,
                    help="record-id barrier; omitted = immediate execution")
    ap.add_argument("--topic", default="queries")
    ap.add_argument("--sink", choices=["kafka", "stdout"], default="kafka")
    ap.add_argument("--bootstrap", default="localhost:9092")
    args = ap.parse_args(argv)

    payload = (
        args.query_id
        if args.required is None
        else format_trigger(args.query_id, args.required)
    )
    if args.sink == "stdout":
        sys.stdout.write(f"{args.topic}\t{payload}\n")
    else:
        from skyline_tpu_torch.bridge.kafka import KafkaBus

        KafkaBus(args.bootstrap).produce_many(args.topic, [payload])
    print(f"sent trigger {payload!r} to {args.topic}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

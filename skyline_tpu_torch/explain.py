"""CLI for the per-query EXPLAIN plane: pretty-print one plan, diff two.

Counterpart of ``skyline_tpu/explain.py``.

The triage tool for "why did this query regress":

    python -m skyline_tpu_torch.explain http://127.0.0.1:8081/explain
    python -m skyline_tpu_torch.explain http://host:8081/explain?version=41
    python -m skyline_tpu_torch.explain plan_a.json plan_b.json   # decision diff
    curl -s host:8090/skyline?explain=1 | python -m skyline_tpu_torch.explain -

One source pretty-prints the plan (``--json`` for the raw record); two
sources print a field-level decision diff — volatile identity fields and
wall times are excluded so the output is WHAT CHANGED in the execution
plan, not run-to-run noise. Sources may be a URL (fetched), a file path,
or ``-`` (stdin); each may hold a bare plan record or any JSON document
embedding one under an ``"explain"`` key (e.g. a ``/skyline?explain=1``
body).
"""

from __future__ import annotations

import argparse
import json
import sys

from skyline_tpu_torch.telemetry.explain import format_diff, format_plan


def _load(src: str) -> dict:
    """Load one plan from a URL, file path, or '-' (stdin)."""
    if src == "-":
        text = sys.stdin.read()
    elif src.startswith(("http://", "https://")):
        from urllib.request import urlopen

        with urlopen(src, timeout=10) as resp:  # noqa: S310 — operator URL
            text = resp.read().decode()
    else:
        with open(src, encoding="utf-8") as f:
            text = f.read()
    doc = json.loads(text)
    if not isinstance(doc, dict):
        raise SystemExit(f"{src}: not a JSON object")
    # accept wrapper documents (/skyline?explain=1 bodies, saved responses)
    if "merge" not in doc and isinstance(doc.get("explain"), dict):
        doc = doc["explain"]
    if "merge" not in doc:
        raise SystemExit(
            f"{src}: no plan found (expected a QueryPlan record or a "
            f"document with an 'explain' field)"
        )
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m skyline_tpu_torch.explain",
        description=(
            "Pretty-print one per-query EXPLAIN plan, or diff the "
            "execution-plan decisions of two."
        ),
    )
    ap.add_argument(
        "source",
        help="plan source: URL (e.g. http://host:8081/explain?version=N), "
        "file path, or - for stdin",
    )
    ap.add_argument(
        "other",
        nargs="?",
        help="second plan source — print a decision diff instead",
    )
    ap.add_argument(
        "--json", action="store_true", help="emit the raw record(s) as JSON"
    )
    args = ap.parse_args(argv)

    a = _load(args.source)
    if args.other is None:
        print(json.dumps(a, indent=2) if args.json else format_plan(a))
        return 0
    b = _load(args.other)
    if args.json:
        from skyline_tpu_torch.telemetry.explain import plan_diff

        rows = plan_diff(a, b)
        print(json.dumps([
            {"field": k, "a": va, "b": vb} for k, va, vb in rows
        ], indent=2))
    else:
        print(format_diff(a, b))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The analysis gate's command line: ``python -m skyline_tpu_torch.analysis``.

The port's copy of ``skyline_tpu/analysis/__main__.py``. The default run
executes the three passes over the port's tree and prints the findings as
``file:line severity rule message``, one a line, then one summary line.
Exit codes: 0 clean (warnings allowed), 1 at least one error, 2 usage or
doc drift. ``--knob-doc`` writes ``docs/KNOBS_TORCH.md`` from the registry;
``--check-doc`` fails (exit 2) when the committed table has drifted.
``--device`` picks where the graph audit runs: ``cuda`` (the default) or
``cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

from skyline_tpu_torch.analysis.findings import errors
from skyline_tpu_torch.utils.knobs import knob_doc_markdown

PASSES = ("knobs", "graph", "locks")
KNOB_DOC = os.path.join("docs", "KNOBS_TORCH.md")


def repo_root() -> str:
    """The checkout holding the package (…/skyline_tpu_torch/analysis ->
    two levels up)."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def default_roots(base: str) -> list[str]:
    """The port's tree: the package and ``chip_smoke.py``. Tests are
    excluded — they set the environment freely and their fixtures hold
    deliberate violations."""
    roots = [os.path.join(base, rel) for rel in ("skyline_tpu_torch", "chip_smoke.py")]
    roots = [p for p in roots if os.path.exists(p)]
    return roots or [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def run_passes(passes, base: str, roots=None, dims=None, device: str = "cuda"):
    """Run the selected passes; returns (findings, per-pass summary)."""
    roots = roots or default_roots(base)
    findings = []
    summary: dict = {}
    if "knobs" in passes:
        from skyline_tpu_torch.analysis import knob_lint
        from skyline_tpu_torch.utils.knobs import KNOBS

        f = knob_lint.run(roots, base)
        findings += f
        summary["knobs"] = {"findings": len(f), "registry_size": len(KNOBS)}
    if "locks" in passes:
        from skyline_tpu_torch.analysis import lock_lint

        f = lock_lint.run(roots, base)
        findings += f
        summary["locks"] = {"findings": len(f)}
    if "graph" in passes:
        from skyline_tpu_torch.analysis import graph_audit

        f, s = graph_audit.run(**({"dims": dims} if dims else {}), device=device)
        findings += f
        summary["graph"] = s
    return findings, summary


def check_doc(base: str) -> int:
    """0 when ``docs/KNOBS_TORCH.md`` is the registry's table, else 2."""
    path = os.path.join(base, KNOB_DOC)
    try:
        with open(path, encoding="utf-8") as f:
            on_disk = f.read()
    except OSError:
        print(f"{path}:1 error knob-doc-drift {KNOB_DOC} missing — "
              "run python -m skyline_tpu_torch.analysis --knob-doc")
        return 2
    if on_disk != knob_doc_markdown():
        print(f"{KNOB_DOC}:1 error knob-doc-drift table drifted from the registry — "
              "run python -m skyline_tpu_torch.analysis --knob-doc and commit")
        return 2
    print(f"{KNOB_DOC} matches the registry")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m skyline_tpu_torch.analysis",
        description="the port's analysis gate (knob registry lint, graph audit of the "
                    "flush hot ops, lock-discipline lint)",
    )
    ap.add_argument("--root", default=None,
                    help="checkout to lint (default: the one holding the package)")
    ap.add_argument("--pass", dest="passes", default=",".join(PASSES),
                    help=f"comma-separated subset of {PASSES}")
    ap.add_argument("--dims", default=None,
                    help="comma-separated dims for the graph audit's matrix (default 2,4,8)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the graph audit runs (default cuda; no fallback)")
    ap.add_argument("--knob-doc", nargs="?", const=KNOB_DOC, default=None, metavar="PATH",
                    help="write the knob table and exit")
    ap.add_argument("--check-doc", action="store_true",
                    help=f"fail (exit 2) if {KNOB_DOC} drifted from the registry")
    args = ap.parse_args(argv)

    base = os.path.abspath(args.root) if args.root else repo_root()

    if args.knob_doc is not None:
        path = os.path.join(base, args.knob_doc)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(knob_doc_markdown())
        print(f"wrote {os.path.relpath(path, base)}")
        return 0

    if args.check_doc:
        return check_doc(base)

    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    bad = [p for p in passes if p not in PASSES]
    if bad:
        print(f"unknown pass(es) {bad}; choose from {PASSES}", file=sys.stderr)
        return 2
    dims = None
    if args.dims:
        try:
            dims = tuple(int(d) for d in args.dims.split(","))
        except ValueError:
            print(f"--dims wants comma-separated integers, got {args.dims!r}",
                  file=sys.stderr)
            return 2

    findings, summary = run_passes(passes, base, dims=dims, device=args.device)
    for f in sorted(findings, key=lambda f: (f.file, f.line, f.rule)):
        print(f.format())
    if "graph" in summary:
        g = summary["graph"]
        launched = ", ".join(f"{k} {v}" for k, v in g["launches"].items()) or "none"
        print(f"graph: {g['configs']} configurations on {g['card'] or g['device']}, dims "
              f"{g['dims']}; kernels launched: {launched}")
    n_err = len(errors(findings))
    parts = [f"{p}: {summary[p]['findings']} finding(s)" for p in passes if p in summary]
    print(
        f"analysis: {', '.join(parts)} — "
        f"{n_err} error(s), {len(findings) - n_err} warning(s)"
    )
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI for the audit plane: replay a divergence repro bundle offline.

    python -m skyline_tpu_torch.audit replay artifacts/audit/bundle-v41-1
    python -m skyline_tpu_torch.audit replay <bundle> --json
    python -m skyline_tpu_torch.audit replay <bundle> --device cpu

Counterpart of ``python -m skyline_tpu.audit``. The checkpoint loads onto
the card unless ``--device cpu`` asks for the CPU; a bundle frozen by the
JAX package replays here too (same layout, same checkpoint format).

Replay is deterministic and self-contained — the bundle carries the
checkpoint, both skylines, the EXPLAIN plan, and the knob snapshot — so
it runs on any machine with the package installed, no access to the
original deployment:

1. re-derive the published-vs-oracle diff from the frozen arrays and
   check it matches the manifest (``reproduced``: the divergence is a
   property of the evidence, not of the machine that caught it);
2. restore the checkpoint and re-run the FAST PATH (flush + global
   merge, plan attached) against a FRESH host-oracle recompute of the
   restored state (``engine_diverges``: True means the engine itself
   deterministically reproduces the bug from this state; False means
   the engine is sound and only the published bytes lied — e.g. the
   ``audit.corrupt`` drill, or snapshot-layer corruption);
3. print a decision-level diff of the bundled EXPLAIN plan vs the
   replay's plan (which merge path, which prunes, which cache state),
   plus the first differing row.

Exit 0 when the bundle's diff reproduces offline, 2 when it does not
(stale or inconsistent evidence), 1 on usage/load errors.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def replay(bundle_path: str, device: str = "cuda") -> dict:
    """Re-run one bundle with the engine on ``device``; returns the
    verdict document."""
    from skyline_tpu_torch.audit import canonical_rows, first_diff
    from skyline_tpu_torch.audit.bundle import load_bundle
    from skyline_tpu_torch.ops.dominance import skyline_np
    from skyline_tpu_torch.telemetry.explain import QueryPlan
    from skyline_tpu_torch.utils.checkpoint import load_engine

    b = load_bundle(bundle_path)
    manifest = b["manifest"]

    # 1. the frozen evidence, re-derived from scratch
    recomputed = first_diff(b["published"], b["oracle"])
    reproduced = (
        recomputed is not None and recomputed == manifest.get("first_diff")
    )

    # 2. fast path vs fresh oracle from the restored state
    engine = load_engine(b["checkpoint"], device=device)
    engine.pset.flush_all()  # fold any restored pendings in first
    replay_plan = QueryPlan("replay", "replay")
    engine.pset.set_explain(replay_plan)
    _, _, _, pts = engine.pset.global_merge_stats(emit_points=True)
    fast = (
        np.asarray(pts, dtype=np.float32)
        if pts is not None
        else np.empty((0, engine.pset.dims), dtype=np.float32)
    )
    skies, _ = engine.pset.audit_state()
    union = np.concatenate(skies, axis=0) if skies else fast
    # offline replay is the court of appeal: always the quadratic oracle,
    # independent of whatever SKYLINE_AUDIT_ORACLE picked online
    oracle_ck = np.asarray(skyline_np(union), dtype=np.float32)
    engine_diff = first_diff(fast, oracle_ck)

    # 3. does the restored state still produce the published bytes?
    state_matches_published = (
        canonical_rows(fast).tobytes()
        == canonical_rows(b["published"]).tobytes()
    )

    return {
        "bundle": bundle_path,
        "version": manifest.get("version"),
        "trace_id": manifest.get("trace_id"),
        "reproduced": bool(reproduced),
        "recomputed_first_diff": recomputed,
        "manifest_first_diff": manifest.get("first_diff"),
        "engine_diverges": engine_diff is not None,
        "engine_first_diff": engine_diff,
        "state_matches_published": bool(state_matches_published),
        "replay_plan": replay_plan.to_doc(),
        "bundled_plan": b["plan"],
    }


def _print_human(v: dict) -> None:
    print(f"bundle   {v['bundle']}")
    print(f"snapshot version {v['version']}  trace {v['trace_id']}")
    print(
        "reproduced: "
        + ("YES — published vs oracle diff matches the manifest"
           if v["reproduced"]
           else "NO — frozen evidence does not re-derive the manifest diff")
    )
    d = v["recomputed_first_diff"]
    if d is not None:
        print(
            f"  first diff at row {d['index']}: "
            f"published={d['published_row']} oracle={d['oracle_row']} "
            f"({d['published_rows']} vs {d['oracle_rows']} rows)"
        )
    if v["engine_diverges"]:
        e = v["engine_first_diff"]
        print(
            "engine: DIVERGES from the oracle on the restored state "
            f"(first diff at row {e['index']}) — deterministic engine bug"
        )
    else:
        print(
            "engine: sound on the restored state — the published bytes "
            "lied (snapshot-layer corruption"
            + ("" if v["state_matches_published"]
               else " or post-publish state drift")
            + ")"
        )
    from skyline_tpu_torch.telemetry.explain import format_diff, format_plan

    if v["bundled_plan"] is not None:
        print("-- decision diff (bundled plan vs replay) --")
        print(format_diff(v["bundled_plan"], v["replay_plan"]))
    else:
        print("-- replay plan (no bundled plan retained) --")
        print(format_plan(v["replay_plan"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m skyline_tpu_torch.audit",
        description="Replay an audit divergence repro bundle offline.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("replay", help="re-run one bundle deterministically")
    rp.add_argument("bundle", help="bundle directory (see RUNBOOK §2l)")
    rp.add_argument(
        "--json", action="store_true", help="emit the verdict as JSON"
    )
    rp.add_argument(
        "--device", default="cuda",
        help="where the restored engine runs: cuda (default) or cpu",
    )
    args = ap.parse_args(argv)

    v = replay(args.bundle, device=args.device)
    if args.json:
        print(json.dumps(v, indent=2))
    else:
        _print_human(v)
    return 0 if v["reproduced"] else 2


if __name__ == "__main__":
    raise SystemExit(main())

"""Perf-trajectory sentinel: regression watch over a whole artifact history.

The port's copy of ``skyline_tpu/telemetry/sentinel.py``, same rules, file
format, report and exit codes. It reads the whole trajectory in a
directory:

- every ``BENCH_r*.json`` in round order, the newest evaluated against a
  **rolling baseline** — the median of up to ``--window`` prior rounds on
  the same backend (rounds on another backend are not comparable: an
  outage of the card must not read as a regression);
- every ``MULTICHIP_r*.json`` as a health trajectory — the newest round
  must report ``ok`` (rc 0, not skipped);
- per-metric **direction/threshold rules**: each names a dotted path into
  the artifact's ``parsed`` block, which direction is good, and an optional
  threshold overriding the global one. ``absolute`` rules (audit
  divergence) fail on any nonzero value in the newest round, no baseline
  needed. A metric absent from the newest round or with no comparable
  history is reported ``skipped`` and never fails.

``--rules rules.json`` replaces the rules wholesale (a list of
``{"label", "path", "higher_is_better", "threshold"?, "absolute"?}``
objects, path as a list of keys).

Usage:

  python -m skyline_tpu_torch.telemetry.sentinel              # CWD trajectory
  python -m skyline_tpu_torch.telemetry.sentinel --dir /path --window 4
  python -m skyline_tpu_torch.telemetry.sentinel --rules my_rules.json

Exit codes: 0 ok (or nothing comparable), 1 regression, 2 usage error.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

# (label, path into the parsed block, higher_is_better, absolute)
DEFAULT_RULES = (
    {"label": "value", "path": ["value"], "higher_is_better": True},
    {"label": "p50_window_latency_ms", "path": ["p50_window_latency_ms"],
     "higher_is_better": False},
    {"label": "serve.read_p99_ms", "path": ["serve", "read_p99_ms"],
     "higher_is_better": False},
    # serve-load plane: the load harness's read p99 regressing
    # means the zero-copy body path is decaying back toward per-request
    # serialization; wall-clock under thread contention on the CPU
    # fallback is noisy, so only a blowup trips
    {"label": "serve_load.read_p99_ms",
     "path": ["serve_load", "read_p99_ms"], "higher_is_better": False,
     "threshold": 2.0},
    # shed fraction is structural (set by the harness's per-tenant token
    # buckets), so a creep-up means admission is shedding traffic the
    # body path used to absorb
    {"label": "serve_load.shed_fraction",
     "path": ["serve_load", "shed_fraction"], "higher_is_better": False,
     "threshold": 2.0},
    {"label": "merge_cache.hit_rate", "path": ["merge_cache", "hit_rate"],
     "higher_is_better": True},
    {"label": "merge_tree.pruned_fraction",
     "path": ["merge_tree", "pruned_fraction"], "higher_is_better": True},
    {"label": "sharded.pruned_chip_fraction",
     "path": ["sharded", "pruned_chip_fraction"], "higher_is_better": True},
    {"label": "flush_cascade.prefilter_drop_fraction",
     "path": ["flush_cascade", "prefilter_drop_fraction"],
     "higher_is_better": True},
    {"label": "freshness.read_lag_p99_ms",
     "path": ["freshness", "read_lag_p99_ms"], "higher_is_better": False,
     # read lag on the CPU fallback is noise-dominated (sub-second walls
     # against second-scale merges); only a blowup should trip
     "threshold": 2.0},
    # fleet plane: chip-load imbalance creeping up means the
    # partitioner is funneling rows to few chips
    {"label": "fleet.imbalance_index", "path": ["fleet", "imbalance_index"],
     "higher_is_better": False},
    # any shadow-verification divergence in the newest round is a
    # correctness regression outright — no baseline, no threshold
    {"label": "audit.divergence_total",
     "path": ["audit", "divergence_total"], "absolute": True},
    # replica plane: WAL tail-to-serve lag creeping up means
    # replicas are answering ever-staler reads; same noise floor caveat
    # as freshness on the CPU fallback, so only a blowup trips
    {"label": "replica.read_lag_p99_ms",
     "path": ["replica", "read_lag_p99_ms"], "higher_is_better": False,
     "threshold": 2.0},
    # cluster plane: promotion stalling means a primary crash
    # leaves the write path dark for longer; wall-clock on the CPU
    # fallback is noisy, so only a blowup trips
    {"label": "cluster.time_to_promote_ms",
     "path": ["cluster", "time_to_promote_ms"], "higher_is_better": False,
     "threshold": 2.0},
    # ops plane: a replication-lag blowup means a failover
    # would inherit that much staleness; quantile from the replica leg's
    # real tail-lag histogram, same CPU-noise threshold discipline
    {"label": "cluster.replication_lag_p99_ms",
     "path": ["cluster", "replication_lag_p99_ms"], "higher_is_better": False,
     "threshold": 2.0},
    # dispatch-tuner plane: hindsight regret of the closed-loop
    # controller vs the best static dispatch under drift. Negative when
    # adapting pays; a sustained climb means the controller is burning
    # exploration it never earns back. Wall-clock A/B on the CPU fallback
    # is noisy (and the baseline can sit near zero), so only a blowup
    # trips — the sign-safe delta here divides by |median|.
    {"label": "tuner.regret_fraction",
     "path": ["tuner", "regret_fraction"], "higher_is_better": False,
     "threshold": 2.0},
)


def _dig(doc: dict, path) -> float | None:
    cur = doc
    for k in path:
        if not isinstance(cur, dict) or k not in cur:
            return None
        cur = cur[k]
    if isinstance(cur, (int, float)) and not isinstance(cur, bool):
        return float(cur)
    return None


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    m = len(s) // 2
    return s[m] if len(s) % 2 else (s[m - 1] + s[m]) / 2.0


def load_trajectory(directory: str) -> list[tuple[str, dict]]:
    """Every BENCH round's parsed block, in round order; unreadable or
    parse-failed rounds are skipped with a note on stderr (one bad
    artifact must not blind the sentinel to the rest)."""
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "BENCH_r*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
            parsed = doc.get("parsed")
            if not isinstance(parsed, dict):
                raise ValueError("no 'parsed' block")
            out.append((path, parsed))
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"sentinel: skipping {path}: {e}", file=sys.stderr)
    return out


def check_bench(
    trajectory: list[tuple[str, dict]],
    rules,
    window: int,
    threshold: float,
) -> tuple[list[str], bool]:
    """Evaluate the newest round against the rolling baseline of up to
    ``window`` prior same-backend rounds. Returns (report, regressed)."""
    lines: list[str] = []
    if not trajectory:
        lines.append("  no BENCH_r*.json trajectory: nothing to watch")
        return lines, False
    newest_path, newest = trajectory[-1]
    backend = newest.get("backend")
    prior = [p for _, p in trajectory[:-1] if p.get("backend") == backend]
    lines.append(
        f"  newest {os.path.basename(newest_path)} ({backend}), "
        f"{len(prior)} comparable prior round(s)"
    )
    regressed = False
    for rule in rules:
        label = rule["label"]
        cur = _dig(newest, rule["path"])
        if rule.get("absolute"):
            if cur is None:
                lines.append(f"  {label:<40} skipped (absent)")
            elif cur > 0:
                lines.append(
                    f"  {label:<40} {cur:.0f}  REGRESSION (absolute)"
                )
                regressed = True
            else:
                lines.append(f"  {label:<40} 0  ok (absolute)")
            continue
        history = [v for v in (_dig(p, rule["path"]) for p in prior)
                   if v is not None]
        if cur is None or not history:
            lines.append(f"  {label:<40} skipped (absent or no history)")
            continue
        base = _median(history[-window:])
        if base == 0:
            lines.append(f"  {label:<40} skipped (zero baseline)")
            continue
        delta = (cur - base) / abs(base)
        limit = float(rule.get("threshold", threshold))
        bad = (-delta if rule["higher_is_better"] else delta) > limit
        regressed = regressed or bad
        lines.append(
            f"  {label:<40} {base:>12.2f} -> {cur:>12.2f}  ({delta:+.1%} "
            f"vs median[{min(window, len(history))}])  "
            f"{'REGRESSION' if bad else 'ok'}"
        )
    return lines, regressed


def check_multichip(directory: str) -> tuple[list[str], bool]:
    """The multichip dry-run trajectory: the newest round must be healthy."""
    lines: list[str] = []
    rounds = []
    for path in sorted(glob.glob(os.path.join(directory, "MULTICHIP_r*.json"))):
        try:
            with open(path) as f:
                rounds.append((path, json.load(f)))
        except (OSError, json.JSONDecodeError) as e:
            print(f"sentinel: skipping {path}: {e}", file=sys.stderr)
    if not rounds:
        lines.append("  no MULTICHIP_r*.json trajectory: nothing to watch")
        return lines, False
    newest_path, newest = rounds[-1]
    ok = bool(newest.get("ok")) and not newest.get("skipped")
    healthy = sum(1 for _, r in rounds if r.get("ok"))
    lines.append(
        f"  newest {os.path.basename(newest_path)}: "
        f"{'ok' if ok else 'REGRESSION (unhealthy round)'} "
        f"({healthy}/{len(rounds)} healthy rounds)"
    )
    return lines, not ok


def main(argv=None) -> int:
    from skyline_tpu_torch.utils.knobs import env_float, env_int

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=".",
                    help="directory scanned for BENCH_r*.json / "
                         "MULTICHIP_r*.json (default: CWD)")
    ap.add_argument("--window", type=int,
                    default=env_int("SKYLINE_SENTINEL_WINDOW", 4),
                    help="rolling-baseline window (median of up to N prior "
                         "comparable rounds)")
    ap.add_argument("--threshold", type=float,
                    default=env_float("SKYLINE_SENTINEL_THRESHOLD", 0.3),
                    help="default max fractional regression vs the rolling "
                         "baseline (per-rule thresholds override)")
    ap.add_argument("--rules", default=None,
                    help="JSON file replacing the built-in rule set")
    a = ap.parse_args(argv)
    if a.window < 1 or a.threshold <= 0:
        print("sentinel: --window must be >= 1 and --threshold > 0",
              file=sys.stderr)
        return 2
    rules = DEFAULT_RULES
    if a.rules:
        try:
            with open(a.rules) as f:
                rules = json.load(f)
            if not (isinstance(rules, list) and all(
                isinstance(r, dict) and "label" in r and "path" in r for r in rules
            )):
                raise ValueError("want a list of objects with 'label' and 'path'")
        except (OSError, ValueError) as e:
            print(f"sentinel: bad --rules file: {e}", file=sys.stderr)
            return 2

    print(f"sentinel: trajectory watch over {os.path.abspath(a.dir)} "
          f"(window {a.window}, threshold {a.threshold:.0%})")
    bench_lines, bench_bad = check_bench(
        load_trajectory(a.dir), rules, a.window, a.threshold
    )
    print("bench trajectory:")
    print("\n".join(bench_lines))
    mc_lines, mc_bad = check_multichip(a.dir)
    print("multichip trajectory:")
    print("\n".join(mc_lines))
    if bench_bad or mc_bad:
        print("sentinel: REGRESSION against the rolling baseline",
              file=sys.stderr)
        return 1
    print("sentinel: ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Run one cell of ``BENCHMARK.json`` and print its result as the last line.

    python3 -m skybench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits with code 1 and prints no result when no CUDA card is visible, when
fewer cards are visible than the cell asks for, or when the run's process
holds JAX or the JAX package once the window has closed. The numbers
compared with the reference are the last lines on standard error, and the
result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m skybench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, require_card: bool = True, device: str = "cuda", overrides=None) -> int:
    args = parse(argv)
    from skybench import harness

    cell = harness.load_cell(args.workload)
    if require_card:
        import torch

        if not torch.cuda.is_available():
            print("skybench: no CUDA card is visible", file=sys.stderr)
            return 1
        if torch.cuda.device_count() < cell.chips:
            print(f"skybench: the cell asks for {cell.chips} cards, "
                  f"{torch.cuda.device_count()} are visible", file=sys.stderr)
            return 1
    try:
        out = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            t_start=T_START, device=device, overrides=overrides,
        )
    except harness.ForbiddenModules as e:
        print(f"skybench: {e}", file=sys.stderr)
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"skybench: modules loaded in the run's process: {', '.join(found)}",
              file=sys.stderr)
        return 1
    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        rule = "<=" if c["rule"] == "at_most" else ">="
        print(f"check {name}: {c['value']} (limit {rule} {c['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

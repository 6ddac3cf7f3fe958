"""The two readings each compared number's limit is set from, for one cell.

    python3 -m skybench.readings --workload <cell> --seeds 1,2,... --seconds 3 \
        --control-seeds 7,8,9

The lower reading: the largest each number reads over sound runs of the
program, one ``run_cell`` per seed, in this process. The upper reading: the
smallest it reads for the control, the plain reference computed in bfloat16
(the precision below the configuration's float32) put in the program's
place, over every answer of one pool window per seed at the cell's own
sizes. Prints one JSON line per seed and a summary line.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from skybench import check, data, harness
from skybench.reference import prefix_skylines


def control_readings(name: str, seed: int, device: str, overrides: dict | None = None) -> dict:
    cell = harness.load_cell(name)
    t = {**cell.traffic, **(overrides or {})}
    dims = int(cell.config["engine"]["dims"])
    (window,) = data.window_pool(seed, cell.config["data"], dims, 1, int(t["window_rows"]))
    chunk = int(t["chunk_rows"])
    n_chunks = math.ceil(window.shape[0] / chunk)
    every = int(t["trigger_every_chunks"])
    prefixes = [k for k in range(1, n_chunks + 1) if k == n_chunks or (every and k % every == 0)]
    want = prefix_skylines(window, chunk, prefixes, device)
    got = prefix_skylines(window, chunk, prefixes, device, compare_dtype=torch.bfloat16)
    return {
        "wrong_rows": max(check.wrong_rows(got[k], want[k]) for k in prefixes),
        "size_gap": max(abs(got[k].shape[0] - want[k].shape[0]) for k in prefixes),
        "answers": len(prefixes),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m skybench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    lower: dict[str, float] = {}
    upper: dict[str, float] = {}
    for s in [int(v) for v in args.seeds.split(",") if v]:
        out = harness.run_cell(args.workload, s, args.seconds, False,
                               t_start=time.perf_counter(), device=device)
        vals = {k: c["value"] for k, c in out["checks"].items()}
        for k, v in vals.items():
            lower[k] = max(lower.get(k, v), v)
        print(json.dumps({"program_seed": s, "correct": out["correct"], "checks": vals,
                          "metrics": {k: m["value"] for k, m in out["metrics"].items()}}),
              flush=True)
    for s in [int(v) for v in args.control_seeds.split(",") if v]:
        vals = control_readings(args.workload, s, device)
        for k in ("wrong_rows", "size_gap"):
            upper[k] = min(upper.get(k, vals[k]), vals[k])
        print(json.dumps({"control_seed": s, **vals}), flush=True)
    print(json.dumps({"workload": args.workload, "device": device,
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

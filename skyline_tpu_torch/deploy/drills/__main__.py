"""CLI: ``python -m skyline_tpu_torch.deploy.drills {serve,chaos,mesh,obs,all}``."""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
import traceback

from skyline_tpu_torch.deploy.drills import DRILLS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m skyline_tpu_torch.deploy.drills",
                                 description="Run the port's operational drills.")
    ap.add_argument("drill", choices=DRILLS + ("all",))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines run (default: the card)")
    ap.add_argument("--outcomes-only", action="store_true",
                    help="assert every outcome but no wall-clock bound (the slow chip's "
                         "2,000 ms, the replica fence's time to refuse, the promotion "
                         "inside the lease TTL); for runs on a loaded host")
    args = ap.parse_args(argv)
    if not __debug__:
        # every check of a drill is an assert, and -O strips them
        print("drills: run without -O (python -O removes the drills' checks)", file=sys.stderr)
        return 2

    from skyline_tpu_torch.deploy.drills.common import reset_process_state

    names = DRILLS if args.drill == "all" else (args.drill,)
    evidence = {"device": args.device, "bounds": not args.outcomes_only, "drills": {},
                "seconds": {}}
    for name in names:
        t0 = time.perf_counter()
        reset_process_state()
        try:
            mod = importlib.import_module(f"skyline_tpu_torch.deploy.drills.{name}")
            evidence["drills"][name] = mod.main(args.device, bounds=not args.outcomes_only)
        except Exception:
            traceback.print_exc()
            print(f"[{name}-smoke] FAIL", flush=True)
            return 1
        finally:
            reset_process_state()
        evidence["seconds"][name] = time.perf_counter() - t0
    from skyline_tpu_torch.ops import dominance_kernels as dk

    # the hand-written kernels this process launched (none on the CPU)
    evidence["launches"] = {k: v for k, v in dk.LAUNCHES.items() if v}
    evidence["ok"] = True
    print(json.dumps(evidence), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

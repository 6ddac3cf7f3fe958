"""Supervised restart: exponential backoff + jitter, bounded budget.

``Supervisor`` runs one *incarnation* at a time — a caller-supplied
callable that builds a worker (which restores the latest valid checkpoint
and replays the WAL in its constructor) and runs it to completion. A
crash (``InjectedCrash`` from the fault harness, or any ``Exception``)
counts against the restart budget, sleeps ``min(cap, base * 2^(n-1))``
plus deterministic seeded jitter, and tries again; exceeding the budget
raises ``RestartBudgetExceeded``. ``KeyboardInterrupt``/``SystemExit``
propagate — the supervisor restarts crashes, not operator intent.

Two modes:

- in-process (tests, chaos harness, embedded runs): pass a factory;
  share one ``Telemetry`` hub across incarnations so
  ``resilience.restarts`` and the WAL/checkpoint counters accumulate on
  ``/metrics`` across restarts.
- subprocess (``python -m skyline_tpu_torch.resilience.supervisor -- <worker
  flags>``): each incarnation is a fresh ``bridge.worker`` process;
  non-zero exit counts as a crash, budget exhaustion exits non-zero.
  Note ``SKYLINE_FAULT_PLAN`` re-arms per process in this mode (hit
  counters are process-local), so a plan that kills every incarnation
  runs the budget out by design.
"""

from __future__ import annotations

import random
import sys
import time

from skyline_tpu_torch.resilience.faults import InjectedCrash


class RestartBudgetExceeded(RuntimeError):
    pass


class WorkerCrashed(RuntimeError):
    """A supervised subprocess exited non-zero."""

    def __init__(self, returncode: int):
        super().__init__(f"worker exited with code {returncode}")
        self.returncode = returncode


class Supervisor:
    def __init__(
        self,
        run_incarnation,
        max_restarts: int | None = None,
        backoff_base_s: float | None = None,
        backoff_cap_s: float | None = None,
        jitter_frac: float = 0.1,
        seed: int = 0,
        telemetry=None,
        sleep=time.sleep,
    ):
        """``run_incarnation(attempt)`` builds and runs one worker
        incarnation, returning its result; ``attempt`` is 0 for the first
        run. ``sleep`` is injectable so tests observe the backoff schedule
        without waiting it out."""
        from skyline_tpu_torch.utils.knobs import env_float, env_int

        self._run_incarnation = run_incarnation
        self.max_restarts = (
            env_int("SKYLINE_SUPERVISOR_MAX_RESTARTS", 5)
            if max_restarts is None else max_restarts
        )
        self.backoff_base_s = (
            env_float("SKYLINE_SUPERVISOR_BACKOFF_S", 0.5)
            if backoff_base_s is None else backoff_base_s
        )
        self.backoff_cap_s = (
            env_float("SKYLINE_SUPERVISOR_BACKOFF_CAP_S", 30.0)
            if backoff_cap_s is None else backoff_cap_s
        )
        self.jitter_frac = jitter_frac
        self.telemetry = telemetry
        self._sleep = sleep
        self._rng = random.Random(seed)
        self.restarts = 0
        self.backoffs: list[float] = []
        self.crashes: list[str] = []

    def run(self):
        attempt = 0
        while True:
            try:
                return self._run_incarnation(attempt)
            except (InjectedCrash, Exception) as e:
                crash = f"{type(e).__name__}: {e}"
                # chip attribution (RUNBOOK §2p): an injected fault carries
                # the kill point + chip it fired at; stamp them into the
                # crash line so the flight dump says WHICH chip died, not
                # just that something did
                point = getattr(e, "point", None)
                chip = getattr(e, "chip", None)
                if point is not None:
                    crash += f" [point={point}"
                    if chip is not None:
                        crash += f" chip={chip}"
                    crash += "]"
                self.crashes.append(crash)
                self.restarts += 1
                if self.telemetry is not None:
                    self.telemetry.inc("resilience.restarts")
                    # freeze the flight-recorder ring at the crash so the
                    # last dispatch decisions before death survive into
                    # the next incarnation's /debug/flight
                    fl = getattr(self.telemetry, "flight", None)
                    if fl is not None:
                        fl.dump(f"crash: {self.crashes[-1]}")
                if self.restarts > self.max_restarts:
                    raise RestartBudgetExceeded(
                        f"restart budget ({self.max_restarts}) exhausted; "
                        f"last crash: {self.crashes[-1]}"
                    ) from e
                delay = min(
                    self.backoff_cap_s,
                    self.backoff_base_s * (2.0 ** (self.restarts - 1)),
                )
                delay *= 1.0 + self.jitter_frac * self._rng.random()
                self.backoffs.append(delay)
                print(
                    f"supervisor: incarnation {attempt} crashed "
                    f"({self.crashes[-1]}); restart {self.restarts}/"
                    f"{self.max_restarts} in {delay:.3f}s",
                    file=sys.stderr,
                )
                self._sleep(delay)
                attempt += 1

    def stats(self) -> dict:
        return {
            "restarts": self.restarts,
            "max_restarts": self.max_restarts,
            "backoffs_s": [round(b, 4) for b in self.backoffs],
            "crashes": list(self.crashes),
        }


def main(argv=None):
    """Subprocess supervision CLI: everything after ``--`` is forwarded to
    ``python -m skyline_tpu_torch.bridge.worker`` verbatim. Pair with
    ``--checkpoint-dir`` so restarted incarnations actually recover."""
    import argparse
    import signal
    import subprocess

    ap = argparse.ArgumentParser(description="supervised skyline worker")
    ap.add_argument("--max-restarts", type=int, default=None)
    ap.add_argument("--backoff-s", type=float, default=None)
    ap.add_argument("--backoff-cap-s", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("worker_args", nargs=argparse.REMAINDER,
                    help="-- <bridge.worker flags>")
    a = ap.parse_args(argv)
    worker_args = a.worker_args
    if worker_args and worker_args[0] == "--":
        worker_args = worker_args[1:]

    # SIGTERM/SIGINT forward to the live worker child (which drains: final
    # checkpoint + WAL barrier) instead of killing the supervisor around it
    state = {"proc": None, "stopping": False}

    def _forward(signum, frame):
        state["stopping"] = True
        p = state["proc"]
        if p is not None and p.poll() is None:
            p.send_signal(signum)

    signal.signal(signal.SIGTERM, _forward)
    signal.signal(signal.SIGINT, _forward)

    def incarnation(attempt):
        cmd = [sys.executable, "-m", "skyline_tpu_torch.bridge.worker", *worker_args]
        proc = subprocess.Popen(cmd)
        state["proc"] = proc
        if state["stopping"]:  # signal raced the spawn: drain immediately
            proc.send_signal(signal.SIGTERM)
        rc = proc.wait()
        if rc != 0 and not state["stopping"]:
            raise WorkerCrashed(rc)
        return rc

    sup = Supervisor(
        incarnation,
        max_restarts=a.max_restarts,
        backoff_base_s=a.backoff_s,
        backoff_cap_s=a.backoff_cap_s,
        seed=a.seed,
    )
    try:
        return sup.run()
    except RestartBudgetExceeded as e:
        print(f"supervisor: giving up: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())

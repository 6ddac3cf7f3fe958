"""One-command launcher of the port's stack — the counterpart of the repo
root's ``deploy/launch.py``, with the same flags and defaults.

    python -m skyline_tpu_torch.deploy.launch --demo         # bounded end-to-end run
    python -m skyline_tpu_torch.deploy.launch                # long-running stack, Ctrl-C stops
    python -m skyline_tpu_torch.deploy.launch --demo --cpu   # the worker on the CPU

It starts, in dependency order, each as a real OS process:
  1. kafkalite broker   (``skyline_tpu_torch.bridge.kafkalite.broker``;
                         skipped with --external-broker)
  2. skyline worker     (``skyline_tpu_torch.bridge.worker``: on the card
                         unless --cpu, which passes ``--device cpu``)
  3. metrics collector  (``skyline_tpu_torch.metrics.collector``)
  4. producer           (``skyline_tpu_torch.workload.producer``; --demo
                         only, bounded)

It waits up to 120 s for the worker's ``skyline worker:`` banner and, with
--demo, up to 600 s for the result row, then exits 0. Any supervised
process that exits non-zero makes the launcher exit 1 naming its log; a
worker that cannot start on the card (no card, a kernel that does not
build) is never started again on the CPU. All children get SIGTERM, then
a kill after 5 s, on exit. Logs go to ``<log-dir>/<name>.log``. On a demo
with a stats port, the worker's last ``/stats`` document is kept in
``<log-dir>/worker_stats.json`` before the stack stops.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BANNER = "skyline worker:"
BANNER_WAIT_S = 120.0
DEMO_WAIT_S = 600.0


class Stack:
    def __init__(self, log_dir: str):
        self.procs: list[tuple[str, subprocess.Popen]] = []
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)

    def start(self, name: str, args: list[str]) -> subprocess.Popen:
        env = dict(os.environ)
        env.setdefault("PYTHONPATH", REPO_ROOT)
        with open(os.path.join(self.log_dir, f"{name}.log"), "w") as log:
            p = subprocess.Popen(
                [sys.executable, *args],
                stdout=log,
                stderr=subprocess.STDOUT,
                env=env,
                cwd=REPO_ROOT,
            )
        self.procs.append((name, p))
        print(f"[launch] {name}: pid {p.pid}", file=sys.stderr)
        return p

    def poll_crashed(self) -> str | None:
        """Non-zero exit of any supervised process (clean rc=0 exits —
        e.g. a finished producer — are not crashes)."""
        for name, p in self.procs:
            rc = p.poll()
            if rc is not None and rc != 0:
                return f"{name} exited rc={rc} (see {self.log_dir}/{name}.log)"
        return None

    def stop(self) -> None:
        for _, p in reversed(self.procs):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + 5
        for _, p in reversed(self.procs):
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def wait_for_broker(bootstrap: str, timeout_s: float = 15.0) -> None:
    import socket

    host, _, port = bootstrap.partition(":")
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            socket.create_connection((host, int(port or 9092)), timeout=1).close()
            return
        except OSError:
            time.sleep(0.2)
    raise RuntimeError(f"broker at {bootstrap} not reachable after {timeout_s}s")


def keep_worker_stats(stats_port: int, path: str) -> bool:
    """The worker's ``/stats`` on ``stats_port`` written to ``path``; False
    (and a note) when it does not answer."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{stats_port}/stats", timeout=30) as r:
            doc = json.load(r)
    except (OSError, ValueError) as e:
        print(f"[launch] worker /stats not read: {e}", file=sys.stderr)
        return False
    with open(path, "w") as f:
        json.dump(doc, f)
    return True


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bootstrap", default="127.0.0.1:19092",
                    help="broker address (non-default port so a real Kafka "
                         "on 9092 can coexist)")
    ap.add_argument("--external-broker", action="store_true",
                    help="don't start kafkalite; use an existing broker at "
                         "--bootstrap")
    ap.add_argument("--algo", default="mr-angle")
    ap.add_argument("--dims", type=int, default=2)
    ap.add_argument("--parallelism", type=int, default=4)
    ap.add_argument("--domain", type=float, default=10000.0)
    ap.add_argument("--distribution", default="anti-correlated")
    ap.add_argument("--demo", action="store_true",
                    help="bounded smoke run: produce --demo-records tuples + "
                         "one trigger, wait for the result row, then exit")
    ap.add_argument("--demo-records", type=int, default=100_000)
    ap.add_argument("--out-csv", default="deploy_logs/results.csv")
    ap.add_argument("--log-dir", default="deploy_logs")
    ap.add_argument("--cpu", action="store_true",
                    help="run the worker on the CPU (--device cpu); without "
                         "it the worker runs on the card or fails")
    ap.add_argument("--query-timeout-ms", type=float, default=0.0,
                    help="worker failure watchdog: finalize overdue queries "
                         "as partial results (0 = wait forever)")
    ap.add_argument("--flush-policy", choices=("incremental", "lazy"),
                    default="incremental")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard the worker's partition state over this many "
                         "devices (0 = single device)")
    ap.add_argument("--stats-port", type=int, default=18081,
                    help="worker live-stats port; 0 disables")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window size in tuples (0 = unbounded)")
    ap.add_argument("--slide", type=int, default=0,
                    help="slide in tuples (with --window)")
    return ap


def worker_args(args) -> list[str]:
    out = [
        "-m", "skyline_tpu_torch.bridge.worker",
        "--bootstrap", args.bootstrap, "--algo", args.algo,
        "--dims", str(args.dims), "--parallelism", str(args.parallelism),
        "--domain", str(args.domain),
        "--flush-policy", args.flush_policy,
        "--stats-port", str(args.stats_port),
    ]
    if args.query_timeout_ms:
        out += ["--query-timeout-ms", str(args.query_timeout_ms)]
    if args.mesh:
        out += ["--mesh", str(args.mesh)]
    if args.window:
        out += ["--window", str(args.window), "--slide", str(args.slide)]
    if args.cpu:
        out += ["--device", "cpu"]
    return out


def producer_args(args) -> list[str]:
    return [
        "-m", "skyline_tpu_torch.workload.producer",
        "input-tuples", args.distribution, str(args.dims),
        "0", str(int(args.domain)), "queries",
        "--count", str(args.demo_records), "--seed", "0",
        # an immediate trigger after the finite stream: an id-barrier
        # trigger can defer forever when a sparse partition's few records
        # all predate the barrier id
        "--query-threshold", "0", "--final-trigger",
        "--bootstrap", args.bootstrap,
    ]


def _fail(why: str) -> int:
    print(f"[launch] FAILED: {why}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.window > 0) != (args.slide > 0):
        ap.error("--window and --slide must be given together")
    log_dir = os.path.abspath(args.log_dir)
    csv_path = os.path.abspath(args.out_csv)

    stack = Stack(log_dir)
    try:
        if not args.external_broker:
            host, _, port = args.bootstrap.partition(":")
            stack.start(
                "broker",
                ["-m", "skyline_tpu_torch.bridge.kafkalite.broker",
                 "--host", host, "--port", port or "9092"],
            )
        wait_for_broker(args.bootstrap)
        stack.start("worker", worker_args(args))
        if os.path.isfile(csv_path):
            os.remove(csv_path)
        stack.start(
            "collector",
            ["-m", "skyline_tpu_torch.metrics.collector", csv_path,
             "--bootstrap", args.bootstrap],
        )
        # the worker's query consumer subscribes at the latest offset while
        # it is built: a trigger produced before its banner would be skipped
        worker_log = os.path.join(log_dir, "worker.log")
        ready_deadline = time.time() + BANNER_WAIT_S
        while time.time() < ready_deadline:
            crashed = stack.poll_crashed()
            if crashed:
                return _fail(crashed)
            if os.path.isfile(worker_log):
                with open(worker_log) as f:
                    if BANNER in f.read():
                        break
            time.sleep(0.2)
        else:
            return _fail(f"worker not ready within {BANNER_WAIT_S:.0f}s "
                         f"(see {log_dir}/worker.log)")

        if args.demo:
            stack.start("producer", producer_args(args))
            deadline = time.time() + DEMO_WAIT_S
            while time.time() < deadline:
                crashed = stack.poll_crashed()
                if crashed:
                    return _fail(crashed)
                if os.path.isfile(csv_path):
                    with open(csv_path) as f:
                        rows = f.read().strip().splitlines()
                    if len(rows) >= 2:
                        if args.stats_port > 0:
                            keep_worker_stats(args.stats_port,
                                              os.path.join(log_dir, "worker_stats.json"))
                        print(f"[launch] demo OK — result row: {rows[1]}", file=sys.stderr)
                        return 0
                time.sleep(0.5)
            return _fail(f"no result row within {DEMO_WAIT_S:.0f}s")

        print("[launch] stack up; Ctrl-C to stop", file=sys.stderr)
        while True:
            crashed = stack.poll_crashed()
            if crashed:
                return _fail(crashed)
            time.sleep(1.0)
    except KeyboardInterrupt:
        print("[launch] stopping", file=sys.stderr)
        return 0
    finally:
        stack.stop()


if __name__ == "__main__":
    raise SystemExit(main())

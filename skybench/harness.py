"""One run of one cell: build the cell's engine as the worker builds it,
make the window pool from the seed, warm up on one window, drive a closed
loop of windows for the measured seconds, optionally trace a few more
windows, then check a seeded sample of the answers against the plain
reference.

Everything of one configuration, one traffic mix or one metric is a file
found by name: ``configs/<config>.json`` (through ``BENCHMARK.json``),
``traffic/<mix>.json`` and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from skybench import check, data, trace
from skybench.work import window_work

ROOT = Path(__file__).resolve().parent.parent
# modules a run may not hold once its window has closed (top-level names)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "skyline_tpu")
# how long after the window closes an answer may still come
ANSWER_WAIT_S = 60.0


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_names(root: Path = ROOT) -> list[str]:
    return [w["name"] for w in load_benchmark(root)["workloads"]]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    (work,) = [w for w in bench["workloads"] if w["name"] == name]
    (conf,) = [c for c in bench["configs"] if c["name"] == work["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "skybench" / "traffic" / f"{work['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    # every per-layer metric lists its cells
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, work["chips"], config, traffic, e2e, layer)


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``metrics/<metric>.py``, or, where there
    is no such file, of the file named by the metric's name before its first
    dot: ``flush_ms.bulk`` and ``flush_ms.interactive`` both read
    ``metrics/flush_ms.py``."""
    path = root / "skybench" / "metrics" / f"{metric}.py"
    if not path.exists():
        path = path.with_name(f"{metric.split('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(f"skybench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What one run measured; the metric readers read it."""

    setup_s: float = 0.0
    elapsed_s: float = 0.0
    windows: int = 0
    rows: int = 0
    ingest_s: float = 0.0
    latencies_ms: list = field(default_factory=list)
    flush_ms: list = field(default_factory=list)
    merge_ms: list = field(default_factory=list)
    # the program's telemetry hub of each measured window: every span's
    # duration by its name, {name: [ms]}, and every counter summed, {name: n}
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    # the traced windows (--trace 1): trace.summarize's dict (device time by
    # kernel name under "kernel_s") and their work
    trace: dict | None = None
    traced_pool: list = field(default_factory=list)
    work_floor_s: float | None = None


class Driver:
    """Drives windows through fresh engines and keeps what the metrics and
    the check need."""

    def __init__(self, cell: Cell, device: str, seed: int, pool: list[np.ndarray]):
        import torch

        from skyline_tpu_torch.stream import EngineConfig

        self.torch = torch
        self.cell = cell
        self.device = device
        self.pool = pool
        self.ecfg = EngineConfig(**cell.config["engine"], device=device)
        self.mesh_chips = int(cell.config.get("mesh_chips", 1))
        self.dims = self.ecfg.dims
        t = cell.traffic
        self.chunk = int(t["chunk_rows"])
        self.every = int(t["trigger_every_chunks"])
        n = pool[0].shape[0]
        self.ids = np.arange(n, dtype=np.int64)
        self.n_chunks = math.ceil(n / self.chunk)
        self.triggers = [
            k for k in range(1, self.n_chunks + 1)
            if k == self.n_chunks or (self.every and k % self.every == 0)
        ]
        self.qid = 0
        self.due = 0
        self.missing = 0
        self.unexpected = 0
        # the seeded reservoir of measured windows whose answers are checked
        self.check_k = int(t["check_windows"])
        self.sample_rng = np.random.default_rng([seed, 1])
        self.sampled: list[tuple[int, dict]] = []
        self.seen = 0

    def engine(self, telemetry):
        if self.mesh_chips > 1:
            from skyline_tpu_torch.distributed import ShardedEngine

            return ShardedEngine(self.ecfg, chips=self.mesh_chips, telemetry=telemetry)
        from skyline_tpu_torch.stream import SkylineEngine

        return SkylineEngine(self.ecfg, telemetry=telemetry)

    def sync(self) -> None:
        if self.device != "cpu":
            for i in range(self.torch.cuda.device_count()):
                self.torch.cuda.synchronize(i)

    def window(self, p: int, run: Run | None) -> dict:
        """Pool window ``p`` through a fresh engine: chunks, triggers and
        polls as the traffic says. Returns {prefix chunks: result}."""
        from skyline_tpu_torch.telemetry import Telemetry

        rf = self.torch.profiler.record_function
        x = self.pool[p]
        hub = Telemetry()
        with rf("skybench.engine"):
            eng = self.engine(hub)
        sent: dict[str, tuple[float, int]] = {}
        answers: dict[int, dict] = {}

        def collect():
            with rf("skybench.poll"):
                got = eng.poll_results()
            t = time.perf_counter()
            for r in got:
                hit = sent.pop(str(r["query_id"]), None)
                if hit is None:
                    self.unexpected += 1
                    continue
                t0, k = hit
                answers[k] = r
                if run is not None:
                    run.latencies_ms.append((t - t0) * 1e3)
                    if eng.last_merge_ms is not None:
                        run.merge_ms.append(eng.last_merge_ms)

        for k in range(1, self.n_chunks + 1):
            lo, hi = (k - 1) * self.chunk, min(k * self.chunk, x.shape[0])
            t0 = time.perf_counter()
            with rf("skybench.ingest"):
                eng.process_records(self.ids[lo:hi], x[lo:hi])
            if run is not None:
                run.ingest_s += time.perf_counter() - t0
            collect()
            if k in self.triggers:
                self.qid += 1
                sent[str(self.qid)] = (time.perf_counter(), k)
                with rf("skybench.trigger"):
                    eng.process_trigger(f"{self.qid},0")
                if run is not None and eng.last_flush_ms is not None:
                    run.flush_ms.append(eng.last_flush_ms)
                collect()
        deadline = time.perf_counter() + ANSWER_WAIT_S
        while sent and time.perf_counter() < deadline:
            collect()
            if sent:
                time.sleep(0.01)
        with rf("skybench.sync"):
            self.sync()
        self.due += len(self.triggers)
        self.missing += len(sent)
        if run is not None:
            for sp in hub.spans.snapshot():
                run.spans.setdefault(sp["name"], []).append(sp["dur_ns"] / 1e6)
            for name, n in hub.counters.snapshot().items():
                run.counters[name] = run.counters.get(name, 0) + n
        return answers

    def keep_sample(self, p: int, answers: dict) -> None:
        """Reservoir sampling of measured windows, seeded: each of the
        ``seen`` windows is kept with the same chance."""
        self.seen += 1
        if len(self.sampled) < self.check_k:
            self.sampled.append((p, answers))
        else:
            j = int(self.sample_rng.integers(0, self.seen))
            if j < self.check_k:
                self.sampled[j] = (p, answers)


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e.__class__.__name__})"
    return "; ".join(out) or "not read"


def forbidden_modules() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def run_cell(
    name: str,
    seed: int,
    seconds: float,
    trace_on: bool,
    *,
    t_start: float,
    device: str = "cuda",
    root: Path = ROOT,
    overrides: dict | None = None,
    log=print,
) -> dict:
    """One run; returns the result's object (the last line's keys).
    ``overrides`` replaces keys of the traffic mix (smaller windows for the
    CPU tests)."""
    import torch

    cell = load_cell(name, root)
    if overrides:
        cell.traffic = {**cell.traffic, **overrides}
    t = cell.traffic
    dims = int(cell.config["engine"]["dims"])
    pool = data.window_pool(seed, cell.config["data"], dims, int(t["pool_windows"]), int(t["window_rows"]))
    log(f"# skybench: cell {name}, seed {seed}, card {card_line() if device != 'cpu' else 'cpu'}, "
        f"torch {torch.__version__} ({torch.get_num_threads()} intra-op threads), "
        f"numpy {np.__version__}, pool {len(pool)} x "
        f"{pool[0].shape}, digest {data.pool_digest(pool)}, -0.0 coordinates "
        f"{data.negative_zeros(pool)}")
    drv = Driver(cell, device, seed, pool)
    # warm-up: one pass over the pool, so every shape and every dispatch
    # signature the measured loop meets has been met once
    for p in range(len(pool)):
        drv.window(p, None)
    drv.due = drv.missing = drv.unexpected = 0
    run = Run()
    run.setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    p = 0
    window_s = []
    while True:
        tw = time.perf_counter()
        answers = drv.window(p, run)
        window_s.append(time.perf_counter() - tw)
        drv.keep_sample(p, answers)
        run.windows += 1
        run.rows += pool[p].shape[0]
        p = (p + 1) % len(pool)
        if time.perf_counter() - t0 >= seconds:
            break
    run.elapsed_s = time.perf_counter() - t0
    if trace_on:
        run.trace, run.traced_pool = traced_windows(drv, cell, p, device)
    peaks = (
        [torch.cuda.max_memory_allocated(i) for i in range(cell.chips)] if device != "cpu" else [0]
    )
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    # the last engine is gone; the reference starts from a free card
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings, floors = check_answers(drv, pool, cell, device, run.traced_pool)
    log(f"# skybench: {run.windows} windows in {run.elapsed_s:.3f} s (each min / median / max "
        f"{min(window_s):.4f} / {float(np.median(window_s)):.4f} / {max(window_s):.4f} s); "
        f"{readings['answers_checked']} "
        f"answers of {len(drv.sampled)} windows checked in {time.perf_counter() - t_check:.1f} s")
    if run.traced_pool:
        run.work_floor_s = sum(floors[q] for q in run.traced_pool)
    correct, checks = check.judge(readings)
    wrong = readings["wrong_answers"]
    metrics_doc = {}
    for m in cell.per_layer if trace_on else cell.end_to_end:
        value = reader(m["name"], root)(run)
        if value is not None:
            metrics_doc[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_doc = {
        "platform": "gpu" if device != "cpu" else "cpu",
        "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(max(peaks)),
    }
    out = {
        "correct": bool(correct),
        "attempted": drv.due,
        "failed": drv.missing + drv.unexpected + wrong,
        "metrics": metrics_doc,
        "device": dev_doc,
    }
    if trace_on and run.trace is not None:
        dev_doc["busy_s"] = run.trace["busy_s"]
        dev_doc["window_s"] = run.trace["window_s"]
        out["breakdown"] = {
            "device_ops": run.trace["device_ops"], "idle_gaps": run.trace["idle_gaps"],
        }
    out["checks"] = checks
    return out


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__(f"modules loaded in the run's process: {', '.join(found)}")
        self.found = found


def traced_windows(drv: Driver, cell: Cell, p: int, device: str):
    """``trace_windows`` more windows under ``torch.profiler``; returns
    (trace.summarize's dict, the pool windows traced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    done = []
    with profile(activities=acts, acc_events=True) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            for _ in range(int(cell.traffic["trace_windows"])):
                drv.window(p, None)
                done.append(p)
                p = (p + 1) % len(drv.pool)
    return trace.summarize(trace.export_events(prof), cell.chips), done


def check_answers(drv: Driver, pool, cell: Cell, device: str, traced: list[int]):
    """The readings of the sampled windows' answers against the reference,
    and the least work of each pool window the reference ran over."""
    from skybench.reference import prefix_skylines

    wrong_rows = size_gap = wrong_answers = checked = 0
    refs: dict[int, dict] = {}
    needed = {p for p, _ in drv.sampled} | set(traced)
    for p in sorted(needed):
        refs[p] = prefix_skylines(pool[p], drv.chunk, drv.triggers, device)
    for p, answers in drv.sampled:
        for k, want in refs[p].items():
            r = answers.get(k)
            if r is None:
                continue  # counted as missing
            w = check.wrong_rows(check.answer_points(r, drv.dims), want)
            g = abs(int(r["skyline_size"]) - want.shape[0])
            wrong_rows, size_gap = max(wrong_rows, w), max(size_gap, g)
            wrong_answers += int(w > 0 or g > 0)
            checked += 1
    floors = {
        p: window_work(pool[p].shape[0], drv.dims, refs[p][drv.n_chunks])["floor_s"]
        for p in traced
    }
    readings = {
        "wrong_rows": wrong_rows, "size_gap": size_gap, "missing_answers": drv.missing + drv.unexpected,
        "answers_checked": checked, "wrong_answers": wrong_answers,
    }
    return readings, floors

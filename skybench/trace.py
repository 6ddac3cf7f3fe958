"""The profiler's arithmetic: device busy time as the union of the intervals
in which a kernel, a copy or a set ran on a card, the traced window's
length, device time by kernel name, and the idle gaps named by what the
host was doing in them.

It reads the Chrome trace that ``torch.profiler`` exports. The window is the
``skybench.traced`` range that the harness records around the traced
windows; the host's phases are its ``skybench.<phase>`` ranges.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "skybench.traced"
PHASE = "skybench."


def export_events(prof) -> list[dict]:
    """The profiler's events, through a Chrome trace in a temporary file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
    finally:
        os.unlink(path)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def short_name(name: str) -> str:
    """A kernel's name without namespace, template arguments and parameters:
    ``void (anonymous namespace)::predrop_kernel<8, true>(...)`` ->
    ``predrop_kernel``; copies and sets keep their own names."""
    name = name.replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return base.rsplit("::", 1)[-1].removeprefix("void ").strip() or name


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: list[tuple[float, float]]) -> float:
    return sum(e - s for s, e in merge(intervals))


def gaps(busy: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no merged busy interval covers."""
    out, at = [], lo
    for s, e in merge(busy):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class _Open:
    """Finds the innermost event open at a time: the one that started
    latest among those that cover it."""

    def __init__(self, events: list[dict]):
        evs = sorted(events, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in evs]
        self.events = evs

    def at(self, t: float, reach: int = 256):
        i = bisect.bisect_right(self.starts, t)
        for j in range(i - 1, max(-1, i - 1 - reach), -1):
            ev = self.events[j]
            if ev["ts"] + ev["dur"] >= t:
                return ev
        return None


def _host_label(t: float, phases: _Open, ops: _Open) -> str:
    """What the host was doing at ``t``: the innermost harness phase and the
    innermost PyTorch op open then."""
    phase, op = phases.at(t), ops.at(t)
    head = phase["name"].removeprefix(PHASE) if phase else "outside"
    return f"{head}:{op['name'] if op else 'python'}"


def _top(seconds: dict[str, float], n: int = 10) -> list[list]:
    return [[k, v] for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:n]]


def summarize(events: list[dict], devices: int) -> dict | None:
    """{window_s, busy_s (mean over ``devices`` cards), busy_by_device,
    kernel_s: {short name: s}, device_ops, idle_gaps} of the traced window,
    or None when the trace holds no window."""
    wins = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not wins:
        return None
    lo = min(e["ts"] for e in wins)
    hi = max(e["ts"] + e["dur"] for e in wins)
    per_dev: dict[int, list[tuple[float, float]]] = {d: [] for d in range(devices)}
    kernel_s: dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if t <= s:
            continue
        dev = int(e.get("args", {}).get("device", 0))
        per_dev.setdefault(dev, []).append((s, t))
        name = short_name(e["name"])
        kernel_s[name] = kernel_s.get(name, 0.0) + (t - s) / 1e6
    busy = {d: covered(v) / 1e6 for d, v in per_dev.items()}
    used = [busy.get(d, 0.0) for d in range(devices)]
    phases = _Open([e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(PHASE) and e["name"] != WINDOW])
    ops = _Open([e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"])
    idle: dict[str, float] = {}
    all_busy = [iv for v in per_dev.values() for iv in v]
    for s, t in gaps(all_busy, lo, hi):
        name = _host_label((s + t) / 2, phases, ops)
        idle[name] = idle.get(name, 0.0) + (t - s) / 1e6
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(used) / devices,
        "busy_by_device": used,
        "kernel_s": kernel_s,
        "device_ops": _top(kernel_s),
        "idle_gaps": _top(idle),
    }

"""Per-query EXPLAIN plane: causal execution-plan records.

Counterpart of ``skyline_tpu/telemetry/explain.py``.

Five perf layers decide how each skyline answer is computed — epoch cache
vs delta vs full merge, witness-pruned tournament tree, grid prefilter,
bf16 cascade, per-(d, N, backend) kernel dispatch — but counters and the
flight ring only show them in aggregate. A ``QueryPlan`` ties ONE answer
to the decisions that produced it: the merge path taken (with the epoch
key and the dirty/clean partition sets), the tournament-tree prune set
with per-partition witness reasons and tree depth, flush-cascade stage
attribution for the batches in the query's window, the kernel dispatch
signatures and wall times (from the ``KernelProfiler`` deltas), and the
event-time watermark at publish.

Lifecycle: the engine mints a plan at trigger ingestion (beside the
trace_id), ``stream/batched.py``'s launch/tree/prune/harvest hooks
annotate it host-side (nothing enters a kernel — byte identity is
untouchable), and the engine finalizes it at result emission
into the hub's bounded ``ExplainRecorder`` ring. Plans serve as
``GET /explain[?version=|?trace_id=]`` on both HTTP surfaces, inline via
``GET /skyline?explain=1``, as ``explain/<path>`` child spans in
``/trace``, and through the ``python -m skyline_tpu_torch.explain`` CLI
(pretty-print one plan, or diff two — the "why did this query regress"
triage tool). Gated by ``SKYLINE_EXPLAIN`` (default on; idle cost is a
few counter snapshots per query, zero between queries).

Attribution windows: a plan's cascade and kernel blocks cover everything
since the PREVIOUS plan finalized — i.e. the flushes and dispatches of
this query's ingest window plus its own merge. Under overlapped merges
(``SKYLINE_QUERY_OVERLAP``) rows ingested between launch and harvest
fold into the harvesting query's window, the same one-merge-in-flight
skew the freshness lineage documents (RUNBOOK §2j/§2k).
"""

from __future__ import annotations

import threading
import time
from collections import deque

PLAN_SCHEMA = 1


class QueryPlan:
    """Mutable host-side builder for one query's execution-plan record.

    Engine-thread only until ``to_doc`` — the merge/tree hooks and the
    finalizer all run on the thread that owns the engine, so no lock.
    """

    __slots__ = (
        "trace_id", "query_id", "merge", "tree", "chips", "hosts", "cascade",
        "kernels", "publish", "timing", "workload", "tuner",
    )

    def __init__(self, trace_id: str | None, query_id: str):
        self.trace_id = trace_id
        self.query_id = query_id
        self.merge: dict | None = None
        self.tree: dict | None = None
        self.chips: dict | None = None  # sharded engine only
        self.hosts: dict | None = None  # cluster engine only
        self.cascade: dict | None = None
        self.kernels: list[dict] = []
        self.publish: dict | None = None
        self.timing: dict | None = None
        self.workload: dict | None = None  # regime tag (telemetry/workload.py)
        self.tuner: dict | None = None  # dispatch-tuner context (telemetry/tuner.py)

    def to_doc(self) -> dict:
        """Freeze into the JSON-serializable record the ring stores."""
        return {
            "schema": PLAN_SCHEMA,
            "trace_id": self.trace_id,
            "query_id": self.query_id,
            "merge": self.merge,
            "tree": self.tree,
            "chips": self.chips,
            "hosts": self.hosts,
            "cascade": self.cascade,
            "kernels": self.kernels,
            "publish": self.publish,
            "timing": self.timing,
            "workload": self.workload,
            "tuner": self.tuner,
        }


def kernel_delta(before: dict, after: dict) -> list[dict]:
    """Per-signature dispatch rows for one query window: the difference of
    two ``KernelProfiler.snapshot_counts()`` snapshots, as explain rows
    sorted by attributed wall time."""
    rows = []
    for key, (calls, wall_ms) in after.items():
        c0, w0 = before.get(key, (0, 0.0))
        if calls <= c0:
            continue
        variant, d, bucket, backend, mp = key
        rows.append({
            "variant": variant,
            "d": d,
            "n_bucket": bucket,
            "backend": backend,
            "mp": mp,
            "calls": calls - c0,
            "wall_ms": round(wall_ms - w0, 3),
        })
    rows.sort(key=lambda r: -r["wall_ms"])
    return rows


def cascade_delta(before: dict, after: dict) -> dict:
    """Flush-cascade stage attribution for one query window: the counter
    deltas between two ``flush_cascade_stats()`` snapshots."""
    out = {}
    for k in ("prefilter_seen", "prefilter_dropped", "bf16_resolved"):
        out[k] = int(after.get(k, 0)) - int(before.get(k, 0))
    out["prefilter_enabled"] = after.get("prefilter_enabled")
    out["mixed_precision"] = after.get("mixed_precision")
    return out


class ExplainRecorder:
    """Bounded ring of finalized query plans — the /explain backing store.

    ``add`` is one lock + one deque append (the engine thread); the HTTP
    surfaces read via ``latest``/``by_version``/``by_trace`` from their
    own threads. Ring semantics match the FlightRecorder: capacity-bounded
    with a monotonic total so ``partial`` is detectable.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._ring: deque[dict] = deque(  # guarded-by: self._lock
            maxlen=self.capacity
        )
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: self._lock

    def add(self, doc: dict) -> dict:
        """Stamp + append one finalized plan document; returns it."""
        with self._lock:
            self._seq += 1
            doc["seq"] = self._seq
            doc["t_ms"] = round(time.time() * 1000.0, 1)
            self._ring.append(doc)
        return doc

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def latest(self) -> dict | None:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def by_version(self, version: int) -> dict | None:
        """Newest retained plan whose publish landed on snapshot
        ``version`` (deduped publishes can map several plans to one
        version; the newest is the one that produced the current bytes)."""
        with self._lock:
            for doc in reversed(self._ring):
                pub = doc.get("publish")
                if pub is not None and pub.get("version") == version:
                    return doc
        return None

    def by_trace(self, trace_id: str) -> dict | None:
        with self._lock:
            for doc in reversed(self._ring):
                if doc.get("trace_id") == trace_id:
                    return doc
        return None

    def doc(self) -> dict:
        """Ring summary for /stats and the bench explain stamp."""
        with self._lock:
            depth = len(self._ring)
            seq = self._seq
        return {
            "depth": depth,
            "recorded_total": seq,
            "ring_capacity": self.capacity,
            "partial": seq > depth,
        }


# -- presentation (CLI + tests) ---------------------------------------------


def format_plan(doc: dict) -> str:
    """Human-readable rendering of one plan record (the CLI's output)."""
    lines = [
        f"query {doc.get('query_id')}  trace {doc.get('trace_id')}"
        f"  seq {doc.get('seq')}",
    ]
    m = doc.get("merge") or {}
    lines.append(
        f"  merge path={m.get('path')}  cached={m.get('cached', False)}"
        f"  dirty_fraction={m.get('dirty_fraction')}"
    )
    if m.get("epoch_key"):
        lines.append(f"    epoch_key {m['epoch_key'][:24]}…")
    if m.get("dirty") is not None:
        lines.append(
            f"    dirty partitions {m['dirty']}  clean {m.get('clean')}"
        )
    if m.get("delta_rows"):
        lines.append(
            f"    delta rows {m['delta_rows']} "
            f"(clean segment {m.get('clean_rows', 0)})"
        )
    t = doc.get("tree")
    if t is not None:
        lines.append(
            f"  tree levels={t.get('levels')} considered={t.get('considered')}"
            f" pruned={t.get('partitions_pruned')}"
            f" candidates/level={t.get('candidates_per_level')}"
        )
        for pr in t.get("pruned") or []:
            lines.append(
                f"    p{pr['partition']} pruned by witness of "
                f"p{pr['witness']}"
            )
    ch = doc.get("chips")
    if ch is not None:
        lines.append(
            f"  chips n={ch.get('chips')} group_size={ch.get('group_size')}"
            f" alive={ch.get('alive')} survivors={ch.get('survivors')}"
            f" cross_levels={ch.get('levels')}"
        )
        dg = ch.get("degraded")
        if dg is not None:
            lines.append(
                f"    DEGRADED: excluded chips {dg.get('excluded_chips')}"
                f" completeness>={dg.get('completeness_bound')}"
                f" reasons={dg.get('reasons')}"
            )
        for pr in ch.get("pruned") or []:
            lines.append(
                f"    chip {pr['chip']} pruned by witness of chip "
                f"{pr['witness']}"
            )
        for pc in ch.get("per_chip") or []:
            lines.append(
                f"    chip {pc['chip']}: skyline={pc['skyline']}"
                f" records={pc['records']} pending={pc['pending']}"
                f"{' PRUNED' if pc.get('pruned') else ''}"
            )
    c = doc.get("cascade")
    if c is not None:
        lines.append(
            f"  cascade prefilter {c.get('prefilter_dropped')}/"
            f"{c.get('prefilter_seen')} dropped, bf16_resolved "
            f"{c.get('bf16_resolved')}"
        )
    for k in doc.get("kernels") or []:
        lines.append(
            f"  kernel {k.get('variant')} d={k.get('d')}"
            f" n={k.get('n_bucket')} {k.get('backend')}"
            f"{' mp' if k.get('mp') else ''}: {k.get('calls')} call(s)"
            f" {k.get('wall_ms')} ms"
        )
    w = doc.get("workload")
    if w is not None:
        lines.append(
            f"  workload kind={w.get('kind')} rho={w.get('rho')}"
            f" epoch={w.get('epoch')} drift_total={w.get('drift_total')}"
        )
    t = doc.get("tuner")
    if t is not None:
        last = t.get("last") or {}
        lines.append(
            f"  tuner regime={t.get('regime')} pins={t.get('pins')}"
            f" moves={t.get('moves')}"
            + (f" last={last.get('action')}" if last else "")
        )
    p = doc.get("publish")
    if p is not None:
        lines.append(
            f"  publish version={p.get('version')} deduped={p.get('deduped')}"
            f" event_wm_ms={p.get('event_wm_ms')}"
        )
    tm = doc.get("timing")
    if tm is not None:
        lines.append(
            f"  timing local={tm.get('local_ms')}ms"
            f" global={tm.get('global_ms')}ms"
            f" latency={tm.get('latency_ms')}ms"
        )
    return "\n".join(lines)


def _flatten(doc, prefix=""):
    out = {}
    if isinstance(doc, dict):
        for k, v in doc.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(doc, list) and doc and isinstance(doc[0], dict):
        for i, v in enumerate(doc):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = doc
    return out


def plan_diff(a: dict, b: dict) -> list[tuple[str, object, object]]:
    """Field-level diff of two plan records as ``(path, old, new)`` rows —
    volatile identity fields (seq/t_ms/trace ids/wall times) excluded so
    the diff shows DECISION changes, not run-to-run noise."""
    skip = ("seq", "t_ms", "trace_id", "query_id")
    fa, fb = _flatten(a), _flatten(b)
    rows = []
    for key in sorted(set(fa) | set(fb)):
        head = key.split(".")[0]
        if head in skip or key.endswith(("wall_ms", "_ms")):
            continue
        va, vb = fa.get(key), fb.get(key)
        if va != vb:
            rows.append((key, va, vb))
    return rows


def format_diff(a: dict, b: dict) -> str:
    rows = plan_diff(a, b)
    if not rows:
        return "plans are decision-identical (only timings/ids differ)"
    width = max(len(k) for k, _, _ in rows)
    return "\n".join(f"{k.ljust(width)}  {va!r} -> {vb!r}" for k, va, vb in rows)

"""EXPLAIN against the JAX package's, on the CPU: ``QueryPlan``,
``kernel_delta`` and ``cascade_delta``, the ``ExplainRecorder`` ring,
``format_plan``, ``plan_diff`` and ``format_diff`` on the same inputs; the
engine's plans on one stream through every merge path the port runs (tree,
cache hit, tree delta, flat, delta, host) equal the JAX engine's with
timings and trace ids excluded, and so does ``format_plan`` of each; the
``python -m skyline_tpu_torch.explain`` CLI prints what the reference's
prints, from a file, stdin and a local URL. Exact comparisons; the lazy
flush pinned to the SFS rounds on both sides."""

import http.server
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu.telemetry import Telemetry as JaxTelemetry
from skyline_tpu.telemetry import explain as jax_explain
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.telemetry import Telemetry
from skyline_tpu_torch.telemetry import explain

from test_torch_observability import process_state, rounds_only, untimed  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _plan_doc(version=1, path="flat", kernels=2, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "schema": 1, "trace_id": f"t-{seed}", "query_id": f"q{seed}", "seq": seed,
        "t_ms": 1.5,
        "merge": {"path": path, "cached": path == "cache_hit", "epoch_key": "00ff" * 16,
                  "dirty_fraction": 0.25, "dirty": [0, 2], "clean": [1, 3],
                  "delta_rows": 12, "clean_rows": 7, "skyline_size": 40},
        "tree": {"pruned": [{"partition": 3, "witness": 1}], "levels": 2, "considered": 4,
                 "partitions_pruned": 1, "candidates_per_level": [3, 2, 1],
                 "pruned_fraction": 0.25},
        "chips": None, "hosts": None,
        "cascade": {"prefilter_seen": 100, "prefilter_dropped": 9, "bf16_resolved": 0,
                    "prefilter_enabled": True, "mixed_precision": False},
        "kernels": [{"variant": f"v{i}", "d": 4, "n_bucket": 1024, "backend": "cpu",
                     "mp": bool(i % 2), "calls": i + 1,
                     "wall_ms": float(rng.uniform(0, 5))} for i in range(kernels)],
        "publish": {"version": version, "deduped": False, "event_wm_ms": 5.0},
        "timing": {"local_ms": 1.0, "global_ms": 2.0, "total_ms": 3.0, "latency_ms": 4.0},
        "workload": {"kind": "uniform", "rho": 0.01, "epoch": 2, "drift_total": 0},
        "tuner": {"regime": "uniform", "pins": 1, "moves": 2,
                  "last": {"action": "pin", "t_ms": 1.0}},
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_format_and_diff_match_reference(seed):
    a = _plan_doc(version=1, path="tree", kernels=seed + 1, seed=seed)
    b = _plan_doc(version=2, path="cache_hit", kernels=3, seed=seed + 10)
    b["tree"] = None
    b["cascade"]["prefilter_dropped"] = 3
    for doc in (a, b):
        assert explain.format_plan(doc) == jax_explain.format_plan(doc)
    assert explain.plan_diff(a, b) == jax_explain.plan_diff(a, b)
    assert explain.format_diff(a, b) == jax_explain.format_diff(a, b)
    assert explain.format_diff(a, a) == jax_explain.format_diff(a, a)
    assert explain.format_plan({}) == jax_explain.format_plan({})


def test_deltas_match_reference():
    rng = np.random.default_rng(4)
    keys = [(f"v{i}", 4, 1 << i, "cpu", bool(i % 2)) for i in range(6)]
    before = {k: (int(c), float(w)) for k, c, w in zip(keys[:4], rng.integers(0, 5, 4),
                                                       rng.uniform(0, 9, 4))}
    after = {k: (before.get(k, (0, 0.0))[0] + int(c), before.get(k, (0, 0.0))[1] + float(w))
             for k, c, w in zip(keys, rng.integers(0, 3, 6), rng.uniform(0, 9, 6))}
    assert explain.kernel_delta(before, after) == jax_explain.kernel_delta(before, after)
    c0 = {"prefilter_seen": 10, "prefilter_dropped": 2, "bf16_resolved": 1}
    c1 = {"prefilter_seen": 50, "prefilter_dropped": 7, "bf16_resolved": 4,
          "prefilter_enabled": True, "mixed_precision": False}
    assert explain.cascade_delta(c0, c1) == jax_explain.cascade_delta(c0, c1)
    assert explain.cascade_delta({}, c1) == jax_explain.cascade_delta({}, c1)


def test_recorder_matches_reference():
    a, b = explain.ExplainRecorder(3), jax_explain.ExplainRecorder(3)
    for rec in (a, b):
        for i in range(5):
            doc = _plan_doc(version=i // 2, seed=i)
            doc.pop("seq")
            rec.add(doc)
    assert untimed(a.snapshot()) == untimed(b.snapshot())
    assert a.doc() == b.doc() == {"depth": 3, "recorded_total": 5, "ring_capacity": 3,
                                  "partial": True}
    assert untimed(a.by_version(1)) == untimed(b.by_version(1))
    assert a.by_version(0) is None and a.by_trace("t-4")["query_id"] == "q4"
    assert untimed(a.latest()) == untimed(b.latest())
    plan, jplan = explain.QueryPlan("t", "q"), jax_explain.QueryPlan("t", "q")
    assert plan.to_doc() == jplan.to_doc()


# -- the engine's plans ---------------------------------------------------------


def _both(**kw):
    tels = Telemetry(), JaxTelemetry()
    return (SkylineEngine(EngineConfig(**kw, device="cpu"), telemetry=tels[0]),
            JaxEngine(JaxConfig(**kw), telemetry=tels[1]))


def _ingest(engines, ids, x, chunk=500):
    for s in range(0, x.shape[0], chunk):
        for e in engines:
            e.process_records(ids[s : s + chunk], x[s : s + chunk])


def _trigger(engines, payload):
    out = []
    for e in engines:
        e.process_trigger(payload)
        out.append(e.poll_results())
    return out


def _formatted(doc):
    """A plan with its timings and trace id blanked, its kernel rows
    (sorted by wall) in signature order, for ``format_plan``."""
    doc = json.loads(json.dumps(doc))
    doc["trace_id"] = None
    doc["timing"] = None
    for k in doc.get("kernels") or []:
        k["wall_ms"] = 0.0
    doc["kernels"] = untimed(doc)["kernels"]
    return doc


def _assert_same_plans(eng, jax_eng):
    got, want = eng.telemetry.explain.snapshot(), jax_eng.telemetry.explain.snapshot()
    assert untimed(got) == untimed(want)
    for a, b in zip(got, want):
        assert explain.format_plan(_formatted(a)) == jax_explain.format_plan(_formatted(b))
        assert a["trace_id"] is not None and a["merge"] is not None
    for i in range(1, len(got)):
        # each plan's decisions against the one before, as the CLI diffs two
        assert explain.format_diff(_formatted(got[i - 1]), _formatted(got[i])) == \
            jax_explain.format_diff(_formatted(want[i - 1]), _formatted(want[i]))
    assert eng.stats()["explain"] == jax_eng.stats()["explain"]
    return got


@pytest.mark.parametrize("tree", ["1", "0"])
def test_engine_plans_every_merge_path(tree, monkeypatch, rounds_only):
    """Tree (or flat), cache hit, then a delta after rows routed to one
    partition (mr-dim: a small first coordinate lands on partition 0)."""
    monkeypatch.setenv("SKYLINE_MERGE_TREE", tree)
    kw = dict(parallelism=4, dims=4, domain_max=1000.0, algo="mr-dim",
              emit_skyline_points=True)
    both = _both(**kw)
    rng = np.random.default_rng(7)
    x = rng.uniform(1, 999, size=(3000, 4)).astype(np.float32)
    _ingest(both, np.arange(3000), x)
    _trigger(both, "q1,0")
    _trigger(both, "q2,0")
    small = rng.uniform(1, 999, size=(64, 4)).astype(np.float32)
    small[:, 0] = rng.uniform(1, 0.8 * 1000.0 / 8, size=64)
    _ingest(both, np.arange(3000, 3064), small)
    (r3,), _ = _trigger(both, "q3,0")
    plans = _assert_same_plans(*both)
    first = "tree" if tree == "1" else "flat"
    assert [p["merge"]["path"] for p in plans] == [first, "cache_hit", first.replace(
        "flat", "delta") if tree == "0" else "tree_delta"]
    assert plans[2]["merge"]["dirty"] == [0] and plans[2]["merge"]["delta_rows"] >= 1
    assert plans[2]["merge"]["skyline_size"] == r3["skyline_size"]
    assert plans[2]["cascade"]["prefilter_seen"] == 64
    assert plans[0]["kernels"] and (plans[0]["tree"] is not None) == (tree == "1")
    names = [s["name"] for s in both[0].telemetry.spans.snapshot()]
    assert f"explain/{first}" in names and "explain/cache_hit" in names


@pytest.mark.parametrize("policy", ["lazy", "incremental"])
def test_engine_host_path_plans(policy, rounds_only):
    """Pending barriers answer on the host: the plan's path is ``host``."""
    both = _both(parallelism=4, dims=3, domain_max=1000.0, flush_policy=policy,
                 ingest="host")
    rng = np.random.default_rng(3)
    _ingest(both, np.arange(800), rng.uniform(1, 999, size=(800, 3)).astype(np.float32))
    assert _trigger(both, "q1,801") == [[], []]
    _ingest(both, np.arange(800, 1200), rng.uniform(1, 999, size=(400, 3)).astype(np.float32))
    (r,), _ = [e.poll_results() for e in both]
    plans = _assert_same_plans(*both)
    assert plans[-1]["merge"] == {"path": "host", "cached": False,
                                  "skyline_size": r["skyline_size"]}


def test_engine_explain_off_records_nothing(monkeypatch, rounds_only):
    monkeypatch.setenv("SKYLINE_EXPLAIN", "0")
    both = _both(dims=3)
    _ingest(both, np.arange(500), np.random.default_rng(1).uniform(
        1, 999, size=(500, 3)).astype(np.float32))
    _trigger(both, "q,0")
    for e in both:
        assert len(e.telemetry.explain) == 0 and "explain" not in e.stats()
        assert e.telemetry.counters.get("explain.records") == 0


# -- the CLI ------------------------------------------------------------------------


def _cli(module, args, stdin=None):
    return subprocess.run([sys.executable, "-m", module, *args], input=stdin,
                          capture_output=True, text=True, timeout=120, cwd=ROOT)


def _same_cli(args, stdin=None):
    got = _cli("skyline_tpu_torch.explain", args, stdin)
    want = _cli("skyline_tpu.explain", args, stdin)
    assert (got.returncode, got.stdout) == (want.returncode, want.stdout), got.stderr
    return got


def test_cli_matches_reference(tmp_path):
    pa, pb, bad = tmp_path / "a.json", tmp_path / "b.json", tmp_path / "bad.json"
    pa.write_text(json.dumps(_plan_doc(version=1, path="tree")))
    pb.write_text(json.dumps(_plan_doc(version=2, path="cache_hit", seed=3)))
    bad.write_text(json.dumps({"hello": 1}))
    assert "merge path=tree" in _same_cli([str(pa)]).stdout
    assert json.loads(_same_cli([str(pa), "--json"]).stdout)["merge"]["path"] == "tree"
    assert "'tree' -> 'cache_hit'" in _same_cli([str(pa), str(pb)]).stdout
    rows = json.loads(_same_cli([str(pa), str(pb), "--json"]).stdout)
    assert {"field": "merge.path", "a": "tree", "b": "cache_hit"} in rows
    wrapper = json.dumps({"version": 1, "explain": _plan_doc()})
    assert "merge path=flat" in _same_cli(["-"], stdin=wrapper).stdout
    r = _same_cli([str(bad)])
    assert r.returncode != 0 and "no plan found" in r.stderr


def test_cli_reads_a_url(tmp_path):
    """A plan served over HTTP on this machine's loopback."""
    body = json.dumps({"explain": _plan_doc(path="delta")}).encode()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/explain"
        r = _same_cli([url])
        assert r.returncode == 0 and "merge path=delta" in r.stdout
    finally:
        server.shutdown()
        server.server_close()

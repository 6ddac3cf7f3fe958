"""The port's audit plane (``skyline_tpu_torch/audit/``) against the JAX
package's, on the CPU: ``canonical_rows`` / ``first_diff`` and the host
oracles; the engine's organic checks under every flush policy with records
equal to the JAX engine's (timings aside); the moved-state skip; the
deterministic sampling gate and the canary interval; the five canaries
with the JAX package's ``taken`` paths; a broken or crashing canary caught;
the ``corrupt@audit.corrupt:1`` drill through detection, bundle and the
port's offline replay; a bundle frozen by the JAX package replayed by the
port; the ``StatsServer``'s ``GET /audit`` doc; ``SKYLINE_AUDIT=0``.
Comparisons are exact.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from skyline_tpu import audit as jax_audit
from skyline_tpu.audit import canary as jax_canary
from skyline_tpu.analysis.registry import knob as jax_knob
from skyline_tpu.audit import oracle as jax_oracle
from skyline_tpu.metrics.httpstats import StatsServer as JaxStatsServer
from skyline_tpu.ops import cascade as jax_cascade
from skyline_tpu.ops import dispatch as jax_dispatch
from skyline_tpu.resilience import faults as jax_faults
from skyline_tpu.serve import SnapshotStore as JaxStore
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu.telemetry import Telemetry as JaxTelemetry
from skyline_tpu.telemetry import spans as jax_spans
from skyline_tpu_torch.audit import Auditor, canary, canonical_rows, first_diff
from skyline_tpu_torch.audit import oracle
from skyline_tpu_torch.metrics.httpstats import StatsServer
from skyline_tpu_torch.ops import cascade, dispatch
from skyline_tpu_torch.resilience import faults
from skyline_tpu_torch.serve import SnapshotStore
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.telemetry import Telemetry, spans
from skyline_tpu_torch.utils.knobs import KNOBS

from conftest import gen_points, host_oracle, points_digest_of

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def process_state(monkeypatch):
    """Process-global state of both packages: the mask profiler, the
    cascade pins and overrides, the trace-id sequence, the fault plan; the
    tuner kept off its cadence."""
    monkeypatch.setenv("SKYLINE_TUNER_EPOCH_S", "3600")
    for mod_dispatch, mod_cascade, mod_spans in (
        (dispatch, cascade, spans), (jax_dispatch, jax_cascade, jax_spans)
    ):
        monkeypatch.setattr(mod_dispatch, "_MASK_PROFILER", None)
        monkeypatch.setattr(mod_spans, "_mint_seq", 0)
        mod_cascade.clear_pins()
    yield
    faults.clear()
    jax_faults.clear()


def _get(url, timeout=5):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def _cfg(d=3, **kw):
    base = dict(parallelism=4, dims=d, domain_max=1000.0, buffer_size=256,
                emit_skyline_points=True)
    base.update(kw)
    return base


def _mk_engine(tel, d=3, **kw):
    eng = SkylineEngine(EngineConfig(**_cfg(d, **kw), device="cpu"), telemetry=tel)
    eng.attach_snapshots(SnapshotStore())
    return eng


def _mk_jax_engine(tel, d=3, **kw):
    eng = JaxEngine(JaxConfig(**_cfg(d, **kw)), telemetry=tel)
    eng.attach_snapshots(JaxStore())
    return eng


def _drive_one(eng, rng, n=1200, d=3, qid="q0"):
    x = (gen_points(rng, n, d, "uniform") * 999.0 + 1.0).astype(np.float32)
    eng.process_records(np.arange(n), x, now_ms=0.0)
    eng.process_trigger(f"{qid},0", now_ms=1.0)
    return x, eng.poll_results()


def _untimed(rec):
    return {k: v for k, v in rec.items() if k != "t_ms"}


# -- comparison units and oracles -------------------------------------------------


def test_canonical_rows_and_first_diff_match_jax(rng):
    a = gen_points(rng, 50, 3, "anti")
    perm = a[rng.permutation(50)]
    assert canonical_rows(perm).tobytes() == jax_audit.canonical_rows(perm).tobytes()
    assert first_diff(a, perm) is None
    b = a.copy()
    b[7, 1] += 1.0
    assert first_diff(a, b) == jax_audit.first_diff(a, b) is not None
    assert first_diff(a, a[:40]) == jax_audit.first_diff(a, a[:40])
    assert first_diff(a[:0], a[:3]) == jax_audit.first_diff(a[:0], a[:3])
    assert canonical_rows(a[:1]).tobytes() == a[:1].tobytes()


@pytest.mark.parametrize("kind", ["uniform", "anti", "corr"])
def test_sorted_oracle_matches_jax_and_quadratic(rng, kind):
    x = gen_points(rng, 1500, 4, kind)
    x[::97] = x[::89][: x[::97].shape[0]]  # duplicates survive together
    x[5, 2] = np.nan
    x[6] = [np.inf, -np.inf, 1.0, 2.0]
    got = oracle.sorted_skyline_np(x)
    assert got.tobytes() == jax_oracle.sorted_skyline_np(x).tobytes()
    assert canonical_rows(got).tobytes() == canonical_rows(
        oracle.oracle_fn()(x)).tobytes()


def test_oracle_knob_selects_quadratic(monkeypatch):
    monkeypatch.setenv("SKYLINE_AUDIT_ORACLE", "quadratic")
    assert oracle.oracle_kind() == "quadratic" == jax_oracle.oracle_kind()
    monkeypatch.setenv("SKYLINE_AUDIT_ORACLE", "bogus")
    assert oracle.oracle_kind() == "sorted"


# -- organic checks, equal to the JAX engine's ---------------------------------------


POLICIES = [
    dict(flush_policy="incremental", d=3),
    dict(flush_policy="incremental", d=2),
    dict(flush_policy="lazy", d=4, ingest="host"),
    dict(flush_policy="lazy", d=8, ingest="device"),
    dict(flush_policy="overlap", d=3, ingest="host", overlap_rows=400),
]


@pytest.mark.parametrize("pol", POLICIES, ids=lambda p: f"{p['flush_policy']}-d{p['d']}-{p.get('ingest', 'host')}")
def test_organic_checks_every_policy_equal_jax(monkeypatch, rng, pol):
    monkeypatch.setenv("SKYLINE_SORTED_SFS", "off")
    monkeypatch.setenv("SKYLINE_DEVICE_CASCADE", "off")
    pol = dict(pol)
    d = pol.pop("d")
    windows = [gen_points(rng, 900, d, "anti") for _ in range(2)]
    runs = []
    for mk, Tel in ((_mk_jax_engine, JaxTelemetry), (_mk_engine, Telemetry)):
        for mod in (spans, jax_spans):
            mod._mint_seq = 0
        tel = Tel()
        eng = mk(tel, d=d, **pol)
        base = 0
        for w, x in enumerate(windows):
            ids = np.arange(base, base + x.shape[0], dtype=np.int64)
            base += x.shape[0]
            for s in range(0, x.shape[0], 450):
                eng.process_records(ids[s : s + 450], x[s : s + 450], now_ms=float(w))
            eng.process_trigger(f"q{w},0", now_ms=float(w) + 0.5)
            eng.process_trigger(f"r{w},0", now_ms=float(w) + 0.7)  # a dedupe
            eng.poll_results()
        runs.append((tel, eng))
    (jtel, jeng), (tel, eng) = runs
    recs = [_untimed(r) for r in tel.audit.snapshot()]
    assert recs == [_untimed(r) for r in jtel.audit.snapshot()]
    assert len(recs) == 4 and all(r["ok"] for r in recs)
    assert tel.counters.get("audit.checks") == jtel.counters.get("audit.checks") == 4
    assert eng.snapshots.stats()["deduped"] == jeng.snapshots.stats()["deduped"]
    snap = eng.snapshots.latest()
    assert snap.digest == jeng.snapshots.latest().digest == points_digest_of(snap.points)


def test_engine_organic_check_passes_and_joins_trace(monkeypatch):
    monkeypatch.delenv("SKYLINE_AUDIT_SAMPLE", raising=False)
    tel = Telemetry()
    eng = _mk_engine(tel)
    assert eng.auditor is not None
    x, results = _drive_one(eng, np.random.default_rng(3))
    assert len(results) == 1
    doc = tel.audit.doc()
    assert doc["ok"] is True and doc["checks_total"] == 1
    check = doc["last_check"]
    assert check["kind"] == "organic" and check["first_diff"] is None
    assert check["trace_id"] == results[0]["trace_id"]
    snap = eng.snapshots.latest()
    assert check["digest"] == snap.digest == points_digest_of(snap.points)
    assert canonical_rows(snap.points).tobytes() == host_oracle(x).tobytes()
    span = [s for s in tel.spans.snapshot() if s["name"] == "audit/check"]
    assert span and span[-1]["trace_id"] == check["trace_id"]
    notes = [e for e in tel.flight.snapshot() if e["kind"] == "audit.check"]
    assert notes and notes[-1]["trace_id"] == check["trace_id"]
    assert eng.stats()["audit"]["checks_total"] == 1


def test_moved_state_skips_instead_of_fabricating_as_jax():
    outs = []
    for mk, Tel in ((_mk_jax_engine, JaxTelemetry), (_mk_engine, Telemetry)):
        tel = Tel()
        eng = mk(tel)
        rng = np.random.default_rng(7)
        _drive_one(eng, rng)
        x = (gen_points(rng, 200, 3, "uniform") * 999.0 + 1.0).astype(np.float32)
        eng.process_records(np.arange(2000, 2200), x, now_ms=2.0)
        eng.pset.flush_all()
        assert eng.auditor.check() is None
        skips = [e["reason"] for e in tel.flight.snapshot() if e["kind"] == "audit.skip"]
        outs.append((tel.counters.get("audit.skips"), tel.counters.get("audit.checks"), skips))
    assert outs[0] == outs[1] == (1, 1, ["state_moved"])


def test_sampling_accumulator_is_deterministic(monkeypatch):
    eng = _mk_engine(Telemetry())
    ran = []
    monkeypatch.setattr(eng.auditor, "check", lambda q=None: ran.append(q))
    eng.auditor.sample = 0.25
    for i in range(8):
        eng.auditor.maybe_check(i)
    assert ran == [3, 7]
    eng.auditor.sample = 0.0
    eng.auditor.maybe_check(99)
    assert len(ran) == 2
    eng.auditor.sample = 1.0
    eng.auditor.maybe_check(100)
    assert ran[-1] == 100


def test_sample_knob_audits_every_third_answer(monkeypatch, rng):
    monkeypatch.setenv("SKYLINE_AUDIT_SAMPLE", "0.34")
    tel = Telemetry()
    eng = _mk_engine(tel)
    for w in range(6):
        _drive_one(eng, rng, n=300, qid=f"q{w}")
    assert tel.counters.get("audit.checks") == 2


def test_canary_interval_gating():
    tel = Telemetry()
    aud = _mk_engine(tel).auditor
    aud.canary_interval_s = 300.0
    assert aud.maybe_canary(now_s=0.0) is False
    assert aud.maybe_canary(now_s=299.0) is False
    assert aud.maybe_canary(now_s=301.0) is True
    assert tel.counters.get("audit.canary_runs") == 5
    aud.canary_interval_s = 0.0
    assert aud.maybe_canary(now_s=9999.0) is False


# -- canaries -------------------------------------------------------------------------


def test_canaries_cover_every_merge_path_as_jax(monkeypatch):
    for knob in ("SKYLINE_MERGE_TREE", "SKYLINE_MERGE_CACHE", "SKYLINE_MERGE_PRUNE"):
        monkeypatch.delenv(knob, raising=False)
    assert [n for n, _ in canary.CANARIES] == [n for n, _ in jax_canary.CANARIES]
    tel, jtel = Telemetry(), JaxTelemetry()
    records = canary.run_canaries(tel, device="cpu")
    jrecords = jax_canary.run_canaries(jtel)
    assert [_untimed(r) for r in records] == [_untimed(r) for r in jrecords]
    assert {r["path"]: r["taken"] for r in records} == {
        "flat": "flat", "tree": "tree", "cache_hit": "cache_hit",
        "tree_delta": "tree_delta", "host": "host"}
    assert all(r["ok"] and r["first_diff"] is None for r in records)
    assert tel.counters.snapshot() == jtel.counters.snapshot()
    cov = tel.audit.doc()["canaries"]
    assert set(cov) == {r["path"] for r in records}
    assert all(v["last_ok"] for v in cov.values())


def test_auditor_runs_canaries_on_the_engines_device(monkeypatch):
    seen = []
    real = canary._mk_pset
    monkeypatch.setattr(canary, "_mk_pset", lambda d, device: seen.append(device) or real(d, device))
    eng = _mk_engine(Telemetry())
    assert all(r["ok"] for r in eng.auditor.run_canaries())
    assert seen and all(torch.device(s) == eng.device for s in seen)


def test_canary_catches_a_broken_merge(monkeypatch):
    def broken(device):
        ok, detail = canary._canary_flat(device)
        detail["first_diff"] = {"index": 0}
        return False, detail

    monkeypatch.setattr(canary, "CANARIES", (("flat", broken),) + tuple(canary.CANARIES[1:]))
    tel = Telemetry()
    records = canary.run_canaries(tel, device="cpu")
    assert records[0]["ok"] is False
    assert tel.counters.get("audit.divergence") == 1
    assert tel.audit.doc()["canaries"]["flat"]["last_ok"] is False
    monkeypatch.setattr(
        canary, "CANARIES",
        (("flat", lambda device: (_ for _ in ()).throw(RuntimeError("boom"))),),
    )
    tel2 = Telemetry()
    recs = canary.run_canaries(tel2, device="cpu")
    assert recs[0]["ok"] is False and "boom" in recs[0]["error"]
    assert tel2.counters.get("audit.divergence") == 1


# -- divergence drill, bundles and replay ----------------------------------------------


def _replay(bundle, *extra):
    r = subprocess.run(
        [sys.executable, "-m", "skyline_tpu_torch.audit", "replay", bundle,
         "--device", "cpu", *extra],
        capture_output=True, text=True, timeout=180, cwd=REPO,
    )
    return r


def test_corrupt_drill_divergence_bundle_and_port_replay(monkeypatch, tmp_path):
    monkeypatch.setenv("SKYLINE_AUDIT_DIR", str(tmp_path))
    faults.install_plan(faults.FaultPlan.parse("corrupt@audit.corrupt:1"))
    try:
        tel = Telemetry()
        eng = _mk_engine(tel)
        _, results = _drive_one(eng, np.random.default_rng(11))
        assert len(results) == 1
    finally:
        faults.clear()
    assert tel.counters.get("audit.checks") == 1
    assert tel.counters.get("audit.divergence") == 1
    doc = tel.audit.doc()
    assert doc["ok"] is False and doc["divergence_total"] == 1
    check = doc["last_divergence"]
    notes = [e for e in tel.flight.snapshot() if e["kind"] == "audit.divergence"]
    assert notes and notes[-1]["trace_id"] == check["trace_id"]
    slo = tel.slo.evaluate()
    assert slo["slos"]["audit_divergence"]["breach"] is True and slo["ok"] is False
    bundle = check["bundle"]
    assert bundle and bundle.startswith(str(tmp_path)) and doc["bundles"] == [bundle]
    for fname in ("manifest.json", "checkpoint.npz", "published.npy",
                  "oracle.npy", "explain.json"):
        assert os.path.exists(os.path.join(bundle, fname)), fname
    assert not os.path.exists(os.path.join(bundle, "wal"))
    with open(os.path.join(bundle, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["schema"] == 1 and manifest["trace_id"] == check["trace_id"]
    assert manifest["first_diff"] == check["first_diff"] and manifest["has_explain"]
    knobs = {k["name"]: k for k in manifest["knobs"]}
    assert knobs["SKYLINE_AUDIT_DIR"]["value"] == str(tmp_path)
    assert knobs["SKYLINE_MERGE_TREE"]["default"] is True
    published = np.load(os.path.join(bundle, "published.npy"))
    assert first_diff(published, np.load(os.path.join(bundle, "oracle.npy"))) == manifest["first_diff"]
    r = _replay(bundle, "--json")
    assert r.returncode == 0, r.stderr
    verdict = json.loads(r.stdout)
    assert verdict["reproduced"] is True and verdict["engine_diverges"] is False
    assert verdict["recomputed_first_diff"] == manifest["first_diff"]
    assert verdict["replay_plan"]["merge"]["path"]
    r2 = _replay(bundle)
    assert r2.returncode == 0
    assert "reproduced: YES" in r2.stdout and "engine: sound" in r2.stdout


def test_jax_bundle_replays_in_the_port(monkeypatch, tmp_path):
    """A bundle the JAX package froze (its checkpoint npz included) replays
    in the port with the JAX package's own verdict."""
    from skyline_tpu.audit.__main__ import replay as jax_replay
    from skyline_tpu_torch.audit.__main__ import replay

    monkeypatch.setenv("SKYLINE_AUDIT_DIR", str(tmp_path))
    jax_faults.install_plan(jax_faults.FaultPlan.parse("corrupt@audit.corrupt:1"))
    try:
        tel = JaxTelemetry()
        _drive_one(_mk_jax_engine(tel), np.random.default_rng(13))
    finally:
        jax_faults.clear()
    bundle = tel.audit.doc()["last_divergence"]["bundle"]
    v = replay(bundle, device="cpu")
    jv = jax_replay(bundle)
    keys = ("reproduced", "engine_diverges", "recomputed_first_diff",
            "manifest_first_diff", "engine_first_diff", "state_matches_published")
    assert {k: v[k] for k in keys} == {k: jv[k] for k in keys}
    assert v["reproduced"] and not v["engine_diverges"]
    assert v["replay_plan"]["merge"]["path"] == jv["replay_plan"]["merge"]["path"]


# -- the HTTP surface and the gate -----------------------------------------------------


def test_statsserver_audit_endpoint_matches_jax():
    docs = []
    for Server, Tel in ((StatsServer, Telemetry), (JaxStatsServer, JaxTelemetry)):
        tel = Tel()
        tel.audit.add({"kind": "organic", "ok": True, "trace_id": "t-a"})
        tel.audit.record_canary("flat", True)
        srv = Server(lambda: {}, port=0, telemetry=tel)
        try:
            base = f"http://127.0.0.1:{srv.port}"
            status, body = _get(f"{base}/audit")
            doc = json.loads(body)
            assert status == 200 and doc["ok"] is True and doc["checks_total"] == 1
            assert doc["canaries"]["flat"]["runs"] == 1
            status, one = _get(f"{base}/audit?trace_id=t-a")
            assert status == 200 and json.loads(one)["trace_id"] == "t-a"
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(f"{base}/audit?trace_id=t-nope")
            assert ei.value.code == 404
            missing = json.load(ei.value)
            docs.append((_untimed_doc(doc), _untimed_doc(missing)))
        finally:
            srv.close()
    assert docs[0] == docs[1]
    srv = StatsServer(lambda: {}, port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"http://127.0.0.1:{srv.port}/audit")
        assert ei.value.code == 404
    finally:
        srv.close()


def _untimed_doc(doc):
    if isinstance(doc, dict):
        return {k: _untimed_doc(v) for k, v in doc.items() if not k.endswith("t_ms")}
    if isinstance(doc, list):
        return [_untimed_doc(v) for v in doc]
    return doc


def test_audit_disabled_by_knob(monkeypatch):
    monkeypatch.setenv("SKYLINE_AUDIT", "0")
    tel = Telemetry()
    eng = _mk_engine(tel)
    assert eng.auditor is None
    _, results = _drive_one(eng, np.random.default_rng(2))
    assert len(results) == 1
    assert tel.counters.get("audit.checks") == 0
    assert "audit" not in eng.stats()


def test_auditor_needs_a_hub_and_checks_nothing_without_a_store(rng):
    assert SkylineEngine(EngineConfig(dims=3, device="cpu")).auditor is None
    tel = Telemetry()
    eng = SkylineEngine(EngineConfig(dims=3, device="cpu"), telemetry=tel)
    assert isinstance(eng.auditor, Auditor)
    _drive_one(eng, rng, n=300)
    assert eng.auditor.check() is None
    assert tel.counters.get("audit.checks") == 0


# -- the knob registry that bundles record -----------------------------------------

_READERS = {"env_bool", "env_int", "env_float", "env_str", "_mode"}


def _knob_reads():
    """Every read of a ``SKYLINE_*`` or ``BENCH_*`` knob in the port's sources, as
    ``(name, default, where)``: ``default`` is the read site's literal
    default (None when it passes none; ``"auto"`` for the ``auto|on|off``
    modes; ``...`` when the default is computed)."""
    import ast
    import pathlib

    root = pathlib.Path(REPO) / "skyline_tpu_torch"
    reads = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and str(node.args[0].value).startswith(("SKYLINE_", "BENCH_"))):
                continue
            fn = node.func.attr if isinstance(node.func, ast.Attribute) else getattr(
                node.func, "id", None)
            if fn not in _READERS and not (fn == "get" and "environ" in ast.unparse(node.func)):
                continue
            if fn == "_mode":
                default = "auto"
            elif len(node.args) < 2:
                default = None
            else:
                arg = node.args[1]
                computed = any(isinstance(n, (ast.Name, ast.Call, ast.Attribute))
                               for n in ast.walk(arg))
                default = ... if computed else eval(ast.unparse(arg), {"__builtins__": {}})
            reads.append((node.args[0].value, default, f"{path.relative_to(REPO)}:{node.lineno}"))
    return reads


def test_knob_registry_lists_exactly_the_knobs_the_port_reads():
    read = {name for name, _, _ in _knob_reads()}
    listed = [k.name for k in KNOBS]
    assert len(set(listed)) == len(listed)
    assert set(listed) == read, (sorted(set(listed) - read), sorted(read - set(listed)))


@pytest.mark.parametrize("name", [k.name for k in KNOBS])
def test_knob_default_matches_reference_and_every_read_site(name):
    """One source of truth in effect: each registry default is the
    reference registry's, and every read site that spells a literal
    default spells that one (a computed default is listed as None)."""
    default = {k.name: k.default for k in KNOBS}[name]
    ref = jax_knob(name).default
    assert (type(default), default) == (type(ref), ref)
    sites = [(d, w) for n, d, w in _knob_reads() if n == name]
    assert sites
    for site_default, where in sites:
        want = None if site_default is ... else site_default
        assert (type(want), want) == (type(default), default), where

"""Chip fault tolerance of the port's sharded engine on the CPU against the
JAX package's: deadline-bounded level-1 merges, honest degraded answers,
``ChipHealth`` quarantine and online partition-group failover.

- The grid: crash, slow and hang (scoped to chip 1) x chips in {2, 4} x d
  in {2, 4, 8}, with the reference's plans and deadlines
  (``tests/test_chip_failover.py``): the degraded answer (points,
  ``excluded_chips``, ``completeness_bound``, ``excluded_records``) equals
  the JAX set's and is the host oracle's skyline of the surviving chips'
  records; the chip quarantines and fails over; the first post-heal answer
  equals the flat uninterrupted run's; ``failovers``, ``sharded_stats()``
  and the health docs equal the JAX set's (time-valued fields aside).
- The abandoned attempt that bows out, the failover lock wait, the retry
  wall, the flush heartbeat, an unscoped crash as process death, the
  failover window, no healthy owner, and the knob.
- ``ChipHealth``: the same scores, states and docs as the JAX class on the
  same call sequences.
- The engine: the partial marker on the result and the snapshot, the audit
  skip, the degraded counters, EXPLAIN, the post-heal answer, a degraded
  publish that never dedupes, and ``/health`` on both HTTP surfaces
  against the JAX server's.

Tolerance: exact bytes; wall-clock fields (``*_ms``, ``*_s``) excluded.
"""

from __future__ import annotations

import json
import threading
import urllib.request

import numpy as np
import pytest

from skyline_tpu.distributed import ShardedEngine as JaxShardedEngine
from skyline_tpu.distributed import ShardedPartitionSet as JaxShardedSet
from skyline_tpu.resilience import faults as jfaults
from skyline_tpu.resilience.health import ChipHealth as JaxChipHealth
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.telemetry import Telemetry as JaxTelemetry
from skyline_tpu_torch.audit import canonical_rows
from skyline_tpu_torch.audit.oracle import oracle_fn
from skyline_tpu_torch.distributed import ShardedEngine, ShardedPartitionSet
from skyline_tpu_torch.resilience.chip_wal import ChipWalPlane
from skyline_tpu_torch.resilience.faults import FaultPlan, InjectedCrash, clear, install_plan
from skyline_tpu_torch.resilience.health import ChipHealth
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream.batched import PartitionSet
from skyline_tpu_torch.telemetry import Telemetry

from conftest import assert_same_merge, gen_points, merge_state
from test_torch_observability import process_state, untimed  # noqa: F401

P = 4  # divisible by every chip count in the grid


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    clear()
    jfaults.clear()
    yield
    clear()
    jfaults.clear()


def _join_abandoned(timeout: float = 15.0) -> None:
    """Wait out watchdog attempts the deadline abandoned (a slow or hang
    clause leaves its thread finishing late)."""
    for t in threading.enumerate():
        if "-merge" in t.name and t.name.startswith("chip"):
            t.join(timeout=timeout)


def _feed(ps, x: np.ndarray) -> None:
    pids = np.arange(x.shape[0]) % P
    for p in range(P):
        rows = np.ascontiguousarray(x[pids == p])
        if rows.shape[0]:
            ps.add_batch(p, rows, max_id=x.shape[0], now_ms=0.0)
    ps.flush_all()


def _both(chips, d, health=True):
    """A port set on the CPU and a JAX set, each with its ChipHealth."""
    sp = ShardedPartitionSet(P, d, 64, chips=chips, device="cpu")
    jsp = JaxShardedSet(P, d, 64, chips=chips)
    hs = (ChipHealth(chips), JaxChipHealth(chips)) if health else (None, None)
    if health:
        sp.attach_health(hs[0])
        jsp.attach_health(hs[1])
    return (sp, hs[0]), (jsp, hs[1])


def _install(spec: str) -> None:
    install_plan(FaultPlan.parse(spec))
    jfaults.install_plan(jfaults.FaultPlan.parse(spec))


def _clear() -> None:
    clear()
    jfaults.clear()


def _stats(pset) -> dict:
    doc = untimed(pset.sharded_stats())
    doc.pop("devices")
    return doc


def _health(h) -> dict:
    return untimed(h.doc())


_KIND_OF = {2: "uniform", 4: "correlated", 8: "anti"}


@pytest.mark.parametrize("action", ["crash", "slow", "hang"])
@pytest.mark.parametrize("chips", [2, 4])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_failover_grid_matches_jax(monkeypatch, d, chips, action):
    kind = _KIND_OF[d]
    x = gen_points(np.random.default_rng(d * chips), 400, d, kind)
    pids = np.arange(x.shape[0]) % P
    G = P // chips
    flat = PartitionSet(P, d, buffer_size=64, device="cpu")
    _feed(flat, x)
    base = merge_state(flat)
    (sp, health), (jsp, jhealth) = _both(chips, d)
    for s in (sp, jsp):
        _feed(s, x)
        # warm merge with the deadline off
        assert_same_merge(base, merge_state(s), ctx="pre-fault")
    monkeypatch.setenv("SKYLINE_CHIP_MERGE_DEADLINE_MS", "500")
    monkeypatch.setenv("SKYLINE_CHIP_MERGE_RETRIES", "0")
    monkeypatch.setenv("SKYLINE_FAULT_SLOW_MS", "2000")
    degraded = []
    for s in (sp, jsp):
        _install(f"{action}@sharded.chip_merge#1:1")
        s._gm_cache = None  # same epoch: force the level-1 pass to rerun
        degraded.append(merge_state(s))
        _clear()
        _join_abandoned()
    ctx = f"kind={kind} d={d} chips={chips} action={action}"
    assert_same_merge(degraded[1], degraded[0], ctx=f"degraded {ctx}")
    partial, jpartial = sp.last_partial, jsp.last_partial
    assert partial is not None and partial["excluded_chips"] == [1]
    assert {k: v for k, v in partial.items() if k != "reasons"} == {
        k: v for k, v in jpartial.items() if k != "reasons"}
    assert 0.0 < partial["completeness_bound"] < 1.0
    assert partial["excluded_records"] == int((pids // G == 1).sum())
    oracle = np.asarray(oracle_fn()(x[pids // G != 1]), dtype=np.float32)
    assert canonical_rows(degraded[0][3]).tobytes() == canonical_rows(oracle).tobytes(), ctx
    assert health.quarantined() == jhealth.quarantined() == [1]
    assert _health(health) == _health(jhealth)
    monkeypatch.delenv("SKYLINE_CHIP_MERGE_DEADLINE_MS")
    assert sp.maybe_failover() == jsp.maybe_failover() == [1]
    assert health.quarantined() == []
    lf = sp.last_failover
    assert lf["chip"] == 1 and lf["owner"] == jsp.last_failover["owner"] != 1
    assert sp.devices[1] == sp.devices[lf["owner"]]
    post = merge_state(sp)
    assert sp.last_partial is None
    assert_same_merge(base, post, ctx=f"post-heal {ctx}")
    assert_same_merge(merge_state(jsp), post, ctx=f"post-heal jax {ctx}")
    assert sp.failovers == jsp.failovers == 1
    assert _stats(sp) == _stats(jsp)
    assert _health(health) == _health(jhealth)


def test_abandoned_attempt_bows_out_after_deadline(monkeypatch):
    x = gen_points(np.random.default_rng(1), 200, 2, "uniform")
    sp = ShardedPartitionSet(P, 2, 64, chips=2, device="cpu")
    _feed(sp, x)
    merge_state(sp)
    monkeypatch.setenv("SKYLINE_CHIP_MERGE_DEADLINE_MS", "300")
    monkeypatch.setenv("SKYLINE_CHIP_MERGE_RETRIES", "0")
    monkeypatch.setenv("SKYLINE_FAULT_SLOW_MS", "1200")
    install_plan(FaultPlan.parse("slow@sharded.chip_merge#1:1"))
    sp._gm_cache = None
    chip = sp._chips[1]
    before = chip.merge_cache_hits + chip.merge_cache_misses
    sp.global_merge_stats()
    assert sp.last_partial is not None
    clear()
    _join_abandoned()
    assert chip.merge_cache_hits + chip.merge_cache_misses == before, (
        "the abandoned attempt ran the merge after the deadline excluded it")


def test_failover_waits_out_chip_lock_then_defers(monkeypatch):
    x = gen_points(np.random.default_rng(2), 200, 2, "uniform")
    (sp, health), _ = _both(2, 2)
    _feed(sp, x)
    health.quarantine(1, "drill")
    monkeypatch.setenv("SKYLINE_CHIP_FAILOVER_LOCK_MS", "100")
    assert sp._chip_locks[1].acquire(timeout=1.0)  # a merge "in flight"
    try:
        assert sp.maybe_failover() == []
        assert health.quarantined() == [1] and sp.failovers == 0
    finally:
        sp._chip_locks[1].release()
    assert sp.maybe_failover() == [1]
    assert health.quarantined() == [] and sp.failovers == 1


def test_bounded_wall_excludes_retry_backoff(monkeypatch):
    """The wall fed to ChipHealth is the winning attempt's own, not the
    retry's backoff sleep."""
    x = gen_points(np.random.default_rng(3), 200, 2, "uniform")
    sp = ShardedPartitionSet(P, 2, 64, chips=2, device="cpu")
    _feed(sp, x)
    merge_state(sp)
    health = ChipHealth(2)
    sp.attach_health(health)
    monkeypatch.setenv("SKYLINE_CHIP_MERGE_DEADLINE_MS", "5000")
    monkeypatch.setenv("SKYLINE_CHIP_MERGE_RETRIES", "1")
    monkeypatch.setenv("SKYLINE_CHIP_MERGE_BACKOFF_MS", "500")
    install_plan(FaultPlan.parse("crash@sharded.chip_merge#1:1"))
    sp._gm_cache = None
    sp.global_merge_stats()
    clear()
    assert sp.last_partial is None  # the retry rescued the answer
    rec = health.doc()["per_chip"][1]
    assert rec["merges_ok"] >= 1 and rec["wall_ema_ms"] is not None
    assert rec["wall_ema_ms"] < 400, f"backoff leaked into the scored wall: {rec['wall_ema_ms']}"


def test_hedged_merges_under_thread_stress(monkeypatch):
    """Eight chips, every level-1 merge hedged (a second attempt always
    races the first), the switch interval shortened: each of 12 merges
    equals the flat answer and runs each chip's own merge exactly once —
    a hedge that merged a group again, or an update lost between the
    watchdog threads, breaks the count."""
    import sys

    x = gen_points(np.random.default_rng(9), 800, 3, "anti")
    Pw = 8
    flat = PartitionSet(Pw, 3, buffer_size=64, device="cpu")
    sp = ShardedPartitionSet(Pw, 3, 64, chips=8, device="cpu")
    for s in (flat, sp):
        for p in range(Pw):
            s.add_batch(p, np.ascontiguousarray(x[p::Pw]), max_id=800, now_ms=0.0)
        s.flush_all()
    base = merge_state(flat)
    monkeypatch.setenv("SKYLINE_CHIP_MERGE_DEADLINE_MS", "20000")
    monkeypatch.setenv("SKYLINE_CHIP_HEDGE_MS", "0.001")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i in range(12):
            sp._gm_cache = None
            assert_same_merge(base, merge_state(sp), ctx=f"merge {i}")
            assert sp.last_partial is None
            for chip in sp._chips:
                assert chip.merge_cache_hits + chip.merge_cache_misses == i + 1
    finally:
        sys.setswitchinterval(old)
    _join_abandoned()
    assert not [t for t in threading.enumerate() if "-merge" in t.name and t.is_alive()]


def test_flush_refreshes_health_heartbeat():
    x = gen_points(np.random.default_rng(4), 200, 2, "uniform")
    (sp, health), _ = _both(2, 2)
    for r in health._rec:
        r.heartbeat_s -= 100.0  # a long-idle fleet
    _feed(sp, x)
    for rec in health.doc()["per_chip"]:
        assert rec["heartbeat_age_s"] < 50.0


def test_unscoped_crash_in_bounded_merge_is_process_death(monkeypatch):
    x = gen_points(np.random.default_rng(5), 200, 2, "uniform")
    sp = ShardedPartitionSet(P, 2, 64, chips=2, device="cpu")
    _feed(sp, x)
    merge_state(sp)
    monkeypatch.setenv("SKYLINE_CHIP_MERGE_DEADLINE_MS", "500")
    install_plan(FaultPlan.parse("crash@sharded.chip_merge:1"))
    sp._gm_cache = None
    with pytest.raises(InjectedCrash):
        sp.global_merge_stats()
    assert sp.degraded_merges == 0


def test_failover_window_reports_chip_tail(tmp_path):
    x = gen_points(np.random.default_rng(6), 200, 2, "uniform")
    (sp, health), _ = _both(2, 2)
    plane = ChipWalPlane(str(tmp_path), chips=2, fsync="off")
    sp.attach_chip_wal(plane)
    _feed(sp, x)
    merge_state(sp)  # a seq-1 barrier on both journals
    plane.note_flush(1, 7, "deadbeef")
    win = plane.failover_window(1)
    assert win == {"common_seq": 1, "records": 1, "replay_flushes": 1, "replay_rows": 7,
                   "last_epoch": "deadbeef"}
    health.quarantine(1, "test")
    assert sp.maybe_failover() == [1]
    assert sp.last_failover["wal_window"]["replay_rows"] == 7
    plane.close()


@pytest.mark.parametrize("knob", [False, True])
def test_failover_stalls_without_owner_or_when_disabled(monkeypatch, knob):
    if knob:
        monkeypatch.setenv("SKYLINE_CHIP_FAILOVER", "0")
    (sp, health), _ = _both(2, 2)
    health.quarantine(1, "test")
    if not knob:
        health.quarantine(0, "test")
    assert sp.maybe_failover() == []
    assert sp.failovers == 0
    assert 1 in health.quarantined()
    if knob:
        health.quarantine(0, "test")
    with pytest.raises(RuntimeError, match="no healthy owner"):
        sp.failover(1)


# -- ChipHealth against the JAX class ---------------------------------------------------------


def _sequence(h, kind: str) -> None:
    if kind == "errors":
        h.note_merge_error(1, "boom")
        h.note_merge_error(1, "boom again")
        h.heal(1)
        h.note_merge_timeout(0, 250.0)
    elif kind == "recover":
        h.note_merge_error(0, "hiccup")
        h.heal(0)
        for _ in range(4):
            h.note_merge_ok(0, 5.0)
            h.note_merge_ok(1, 5.0)
    elif kind == "straggler":
        h.note_merge_ok(1, 5.0)
        h.note_merge_ok(0, 500.0)  # a cold-start wall: gated
        for _ in range(3):
            h.note_merge_ok(0, 5.0)
            h.note_merge_ok(1, 5.0)
        for _ in range(6):
            h.note_merge_ok(0, 500.0)
    elif kind == "stale":
        for r in h._rec:
            r.heartbeat_s -= 10.0
        h.tick()  # the whole fleet idle: nobody quarantines
        h.note_heartbeat(0)
        h.tick()


@pytest.mark.parametrize("kind", ["errors", "recover", "straggler", "stale"])
def test_health_matches_jax(monkeypatch, kind):
    monkeypatch.setenv("SKYLINE_CHIP_FAIL_THRESHOLD", "2")
    monkeypatch.setenv("SKYLINE_CHIP_STRAGGLER_FACTOR", "4.0")
    monkeypatch.setenv("SKYLINE_CHIP_HEARTBEAT_MS", "1000")
    tel, jtel = Telemetry(), JaxTelemetry()
    h, jh = ChipHealth(2, telemetry=tel), JaxChipHealth(2, telemetry=jtel)
    _sequence(h, kind)
    _sequence(jh, kind)
    assert _health(h) == _health(jh)
    assert h.quarantined() == jh.quarantined() and h.healthy() == jh.healthy()
    assert tel.counters.snapshot() == jtel.counters.snapshot()
    assert untimed(tel.flight.snapshot()) == untimed(jtel.flight.snapshot())
    if kind == "stale":
        assert h.quarantined() == [1]
    if kind == "straggler":
        assert h.doc()["per_chip"][0]["stragglers"] >= 1


# -- the engine ---------------------------------------------------------------------------


def _drive(engine, x, qid, lo, hi):
    engine.process_records(np.arange(lo, hi, dtype=np.int64), x[lo:hi])
    engine.process_trigger(f"{qid},0")
    out = []
    for _ in range(200):
        out.extend(engine.poll_results())
        if out:
            return out
    raise AssertionError("engine produced no result")


def _engines(d, audit=True):
    from skyline_tpu.serve import SnapshotStore as JaxStore
    from skyline_tpu_torch.serve import SnapshotStore

    kw = dict(parallelism=P, dims=d, buffer_size=64, domain_max=1.0, emit_skyline_points=True)
    eng = ShardedEngine(EngineConfig(**kw, device="cpu"), chips=2, telemetry=Telemetry())
    eng.attach_snapshots(SnapshotStore(history=8))
    jeng = JaxShardedEngine(JaxConfig(**kw), chips=2, telemetry=JaxTelemetry())
    jeng.attach_snapshots(JaxStore(history=8))
    return eng, jeng, kw


def test_engine_degraded_answer_marked_and_audited_like_jax(monkeypatch):
    monkeypatch.setenv("SKYLINE_AUDIT_SAMPLE", "1.0")
    d = 4
    eng, jeng, kw = _engines(d)
    x = gen_points(np.random.default_rng(7), 600, d, "uniform")
    results = {}
    for e in (eng, jeng):
        r1 = _drive(e, x, 0, 0, 300)[-1]
        assert "partial" not in r1
    checks = int(eng.telemetry.counters.get("audit.checks"))
    monkeypatch.setenv("SKYLINE_CHIP_MERGE_DEADLINE_MS", "500")
    monkeypatch.setenv("SKYLINE_CHIP_MERGE_RETRIES", "0")
    for e in (eng, jeng):
        _install("hang@sharded.chip_merge#1:1")
        results[e is eng] = _drive(e, x, 1, 300, 600)[-1]
        _clear()
        _join_abandoned()
    r2 = results[True]
    assert untimed(r2) == untimed(results[False])
    assert r2["partial"] is True and r2["excluded_chips"] == [1]
    assert 0.0 < r2["completeness_bound"] < 1.0
    snap = eng.snapshots.latest()
    assert snap.meta.get("partial") is True and snap.meta.get("excluded_chips") == [1]
    tel = eng.telemetry
    assert int(tel.counters.get("audit.checks")) == checks
    assert eng.auditor.check() is None and jeng.auditor.check() is None
    assert int(tel.counters.get("audit.skips")) >= 1
    assert int(tel.counters.get("audit.divergence")) == 0
    assert int(tel.counters.get("degraded_answers")) == 1
    assert int(tel.counters.get("queries.answered")) == 2
    assert "skyline_degraded_answers_total 1" in tel.render_prometheus()
    stats = eng.stats()
    assert stats["sharded"]["degraded_merges"] == 1
    assert stats["sharded"]["health"]["quarantined"] == [1]
    plan = tel.explain.latest()
    assert plan["chips"]["degraded"]["excluded_chips"] == [1]
    assert plan["merge"]["partial"] is True
    from skyline_tpu_torch.telemetry.explain import format_plan

    assert "DEGRADED: excluded chips [1]" in format_plan(plan)
    jplan = jeng.telemetry.explain.latest()
    drop = ("reasons",)
    assert untimed({k: v for k, v in plan["chips"]["degraded"].items() if k not in drop}) == \
        untimed({k: v for k, v in jplan["chips"]["degraded"].items() if k not in drop})
    monkeypatch.delenv("SKYLINE_CHIP_MERGE_DEADLINE_MS")
    base = SkylineEngine(EngineConfig(**kw, device="cpu"))
    _drive(base, x, 0, 0, 300)
    want = _drive(base, x, 1, 300, 600)[-1]
    r3 = _drive(eng, x, 2, 600, 600)[-1]
    jr3 = _drive(jeng, x, 2, 600, 600)[-1]
    assert "partial" not in r3 and untimed(r3) == untimed(jr3)
    assert r3["skyline_points"] == want["skyline_points"]
    assert eng.pset.failovers == 1 and eng.health.quarantined() == []
    assert int(tel.counters.get("health.quarantines")) == 1
    assert int(tel.counters.get("health.heals")) == 1
    assert tel.counters.snapshot() == jeng.telemetry.counters.snapshot()


def test_degraded_publish_never_dedupes(monkeypatch):
    eng, jeng, _ = _engines(2)
    x = gen_points(np.random.default_rng(8), 300, 2, "uniform")
    versions = []
    for e in (eng, jeng):
        _drive(e, x, 0, 0, 300)
        v1 = e.snapshots.latest().version
        monkeypatch.setenv("SKYLINE_CHIP_MERGE_DEADLINE_MS", "500")
        monkeypatch.setenv("SKYLINE_CHIP_MERGE_RETRIES", "0")
        monkeypatch.setenv("SKYLINE_FAULT_SLOW_MS", "2000")
        _install("slow@sharded.chip_merge#1:1")
        e.pset._gm_cache = None
        _drive(e, x, 1, 300, 300)  # same epoch, degraded remerge
        _clear()
        _join_abandoned()
        monkeypatch.delenv("SKYLINE_CHIP_MERGE_DEADLINE_MS")
        snap = e.snapshots.latest()
        assert snap.version > v1 and snap.meta.get("partial") is True
        versions.append((v1, snap.version))
    assert versions[0] == versions[1]


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
        return json.loads(resp.read())


def test_health_endpoints_match_jax_server():
    """/health on the serving plane and the stats server: the chip block
    with a ChipHealth on the hub, ``{"ok": true, "enabled": false}``
    without — the JAX serving plane's replies."""
    from skyline_tpu.serve import SnapshotStore as JaxStore
    from skyline_tpu.serve.server import SkylineServer as JaxServer
    from skyline_tpu_torch.metrics.httpstats import StatsServer
    from skyline_tpu_torch.serve import SnapshotStore
    from skyline_tpu_torch.serve.server import SkylineServer

    tel, jtel = Telemetry(), JaxTelemetry()
    tel.health, jtel.health = ChipHealth(2, telemetry=tel), JaxChipHealth(2, telemetry=jtel)
    tel.health.quarantine(1, "drill")
    jtel.health.quarantine(1, "drill")
    srv = SkylineServer(SnapshotStore(history=2), telemetry=tel)
    jsrv = JaxServer(JaxStore(history=2), telemetry=jtel)
    stats = StatsServer(lambda: {}, 0, telemetry=tel)
    try:
        doc = _get(srv.port, "/health")
        assert doc["enabled"] is True and doc["ok"] is False and doc["quarantined"] == [1]
        assert doc["per_chip"][1]["status"] == "quarantined"
        assert untimed(doc) == untimed(_get(jsrv.port, "/health"))
        assert untimed(_get(stats.port, "/health")) == untimed(doc)
    finally:
        srv.close()
        jsrv.close()
        stats.close()

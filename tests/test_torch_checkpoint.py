"""The port's engine checkpoints (``skyline_tpu_torch/utils/checkpoint.py``)
and the state capture behind them against the JAX package's, on the CPU:
``save_engine`` / ``load_engine`` round trips under every flush policy and
ingest, giving the uninterrupted engine's next answer; npz files written
by the JAX package load into the port and the port's into the JAX
package, each followed by the same next answer; ``audit_state`` and
``pending_rows_of`` equal to the JAX set's; ``restore_all``; flat
checkpoints restored onto the sharded and cluster engines and onto a
device mesh. Also the fault-plan grammar
(``resilience/faults.py``) and its sites in the flush and the checkpoint
writer. Comparisons are exact.
"""

import json

import numpy as np
import pytest
import torch

from skyline_tpu.ops import cascade as jax_cascade
from skyline_tpu.ops import dispatch as jax_dispatch
from skyline_tpu.resilience import faults as jax_faults
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu.stream.batched import PartitionSet as JaxPartitionSet
from skyline_tpu.utils import checkpoint as jax_ckpt
from skyline_tpu_torch.audit import canonical_rows
from skyline_tpu_torch.ops import cascade, dispatch
from skyline_tpu_torch.resilience import faults
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream.batched import PartitionSet
from skyline_tpu_torch.utils import checkpoint as ckpt

from conftest import gen_points

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def process_state(monkeypatch):
    monkeypatch.setenv("SKYLINE_SORTED_SFS", "off")
    monkeypatch.setenv("SKYLINE_DEVICE_CASCADE", "off")
    for mod_dispatch, mod_cascade in ((dispatch, cascade), (jax_dispatch, jax_cascade)):
        monkeypatch.setattr(mod_dispatch, "_MASK_PROFILER", None)
        mod_cascade.clear_pins()
    yield
    faults.clear()
    jax_faults.clear()


def _cfg(d, **kw):
    base = dict(parallelism=2, dims=d, domain_max=1.0, buffer_size=256,
                emit_skyline_points=True)
    base.update(kw)
    return base


def _feed(eng, x, base, chunk=300):
    ids = np.arange(base, base + x.shape[0], dtype=np.int64)
    for s in range(0, x.shape[0], chunk):
        eng.process_records(ids[s : s + chunk], x[s : s + chunk], now_ms=1.0)


def _answer(eng, qid):
    eng.process_trigger(f"{qid},0", now_ms=2.0)
    (res,) = eng.poll_results()
    return res["skyline_size"], np.asarray(res["skyline_points"], np.float32).tobytes()


POLICIES = [
    dict(flush_policy="incremental", d=3),
    dict(flush_policy="incremental", d=2),
    dict(flush_policy="lazy", d=4, ingest="host"),
    dict(flush_policy="lazy", d=8, ingest="device"),
    dict(flush_policy="overlap", d=3, ingest="host", overlap_rows=400),
]
IDS = [f"{p['flush_policy']}-d{p['d']}-{p.get('ingest', 'host')}" for p in POLICIES]


def _split(pol):
    pol = dict(pol)
    return pol.pop("d"), pol


@pytest.mark.parametrize("pol", POLICIES, ids=IDS)
def test_round_trip_gives_the_uninterrupted_answer(rng, tmp_path, pol):
    """The restored engine answers the saved engine's next answer byte for
    byte, and the never-checkpointed engine's as a set (a device-ingest
    save flushes its window first, which may reorder equal answers)."""
    d, kw = _split(pol)
    a, b = gen_points(rng, 900, d, "anti"), gen_points(rng, 700, d, "anti")
    whole = SkylineEngine(EngineConfig(**_cfg(d, **kw), device="cpu"))
    _feed(whole, a, 0)
    _feed(whole, b, 900)
    size, pts = _answer(whole, "q")
    first = SkylineEngine(EngineConfig(**_cfg(d, **kw), device="cpu"))
    _feed(first, a, 0)
    path = str(tmp_path / "e.npz")
    ckpt.save_engine(first, path, extra_meta={"offset": 900})
    eng, meta = ckpt.load_engine(path, with_meta=True, device="cpu")
    assert meta["extra"] == {"offset": 900}
    assert eng.records_in == 900 and eng.config == first.config
    assert eng.pset.records_seen.tolist() == first.pset.records_seen.tolist()
    assert eng.pset.max_seen_id.tolist() == first.pset.max_seen_id.tolist()
    for e in (first, eng):
        _feed(e, b, 900)
    got = _answer(eng, "q")
    assert got == _answer(first, "q")
    rows = lambda buf: canonical_rows(np.frombuffer(buf, np.float32).reshape(-1, d))  # noqa: E731
    assert got[0] == size and rows(got[1]).tobytes() == rows(pts).tobytes()


@pytest.mark.parametrize("pol", POLICIES, ids=IDS)
def test_npz_loads_both_ways_with_the_same_next_answer(rng, tmp_path, pol):
    d, kw = _split(pol)
    a, b = gen_points(rng, 900, d, "anti"), gen_points(rng, 700, d, "anti")
    jeng = JaxEngine(JaxConfig(**_cfg(d, **kw)))
    eng = SkylineEngine(EngineConfig(**_cfg(d, **kw), device="cpu"))
    for e in (jeng, eng):
        _feed(e, a, 0)
    jpath, path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_ckpt.save_engine(jeng, jpath)
    ckpt.save_engine(eng, path)
    # the same arrays and meta (the CRC included) from either writer
    with np.load(jpath) as jz, np.load(path) as z:
        assert sorted(jz.files) == sorted(z.files)
        for k in z.files:
            if k != "__meta__":
                assert jz[k].tobytes() == z[k].tobytes(), k
        jmeta = json.loads(bytes(jz["__meta__"]))
        meta = json.loads(bytes(z["__meta__"]))
    drop = ("processing_ns", "crc32")
    strip = lambda m: {  # noqa: E731 — the per-process CPU clock aside
        k: ([{f: v for f, v in p.items() if f not in drop} for p in v]
            if k == "partitions" else v)
        for k, v in m.items() if k not in drop
    }
    assert strip(meta) == strip(jmeta)
    # JAX -> port and port -> JAX, then the same next answer everywhere
    port_from_jax = ckpt.load_engine(jpath, device="cpu")
    jax_from_port = jax_ckpt.load_engine(path)
    answers = []
    for e in (port_from_jax, jax_from_port, eng, jeng):
        _feed(e, b, 900)
        answers.append(_answer(e, "n"))
    assert answers[0] == answers[1] == answers[2] == answers[3]


def test_inflight_queries_survive_the_checkpoint_both_ways(rng, tmp_path):
    """A query waiting on a barrier (required id not yet seen) rides the
    checkpoint, in either direction, and answers after the restore."""
    x = gen_points(rng, 600, 3, "uniform")
    jeng = JaxEngine(JaxConfig(**_cfg(3)))
    eng = SkylineEngine(EngineConfig(**_cfg(3), device="cpu"))
    for e in (jeng, eng):
        _feed(e, x[:400], 0)
        e.process_trigger("late,550", now_ms=3.0)
        assert e.inflight_queries == 1
    jax_ckpt.save_engine(jeng, str(tmp_path / "j.npz"))
    ckpt.save_engine(eng, str(tmp_path / "p.npz"))
    out = []
    for e in (ckpt.load_engine(str(tmp_path / "j.npz"), device="cpu"),
              jax_ckpt.load_engine(str(tmp_path / "p.npz"))):
        assert e.inflight_queries == 1
        _feed(e, x[400:], 400)
        (res,) = e.poll_results()
        out.append((res["query_id"], res["skyline_size"], res["skyline_points"]))
    assert out[0] == out[1]


@pytest.mark.parametrize("placement", [dict(mesh_chips=2), dict(cluster_hosts=2), dict(mesh=2)])
def test_sharded_and_cluster_restores_raise(rng, tmp_path, placement):
    """A flat checkpoint restores onto the sharded engine (``mesh_chips``),
    onto the cluster engine (``cluster_hosts``) and onto a two-place
    device mesh (``mesh``) with the JAX package's next answer."""
    from skyline_tpu.parallel import make_mesh as jax_mesh
    from skyline_tpu_torch.cluster import ClusterEngine
    from skyline_tpu_torch.distributed import ShardedEngine
    from skyline_tpu_torch.parallel import make_mesh

    eng = SkylineEngine(EngineConfig(**_cfg(3), device="cpu"))
    _feed(eng, gen_points(rng, 300, 3, "uniform"), 0)
    path = str(tmp_path / "e.npz")
    ckpt.save_engine(eng, path)
    port_kw, jax_kw = dict(placement), dict(placement)
    if "mesh" in placement:
        port_kw["mesh"] = make_mesh(placement["mesh"], device="cpu")
        jax_kw["mesh"] = jax_mesh(placement["mesh"])
    tail = gen_points(rng, 200, 3, "anti")
    out = []
    for e in (ckpt.load_engine(path, device="cpu", **port_kw),
              jax_ckpt.load_engine(path, **jax_kw)):
        _feed(e, tail, 300)
        out.append(_answer(e, "q"))
    want = (ClusterEngine if "cluster_hosts" in placement
            else SkylineEngine if "mesh" in placement else ShardedEngine)
    restored = ckpt.load_engine(path, device="cpu", **port_kw)
    assert type(restored) is want
    if "mesh" in placement:
        assert restored.mesh == port_kw["mesh"] and restored.stats()["meshed"]
    if "cluster_hosts" in placement:
        assert restored.pset.hosts == 2 and restored.pset._member_chips == [1, 1]
    assert out[0] == out[1]


def test_crc_mismatch_raises(rng, tmp_path):
    eng = SkylineEngine(EngineConfig(**_cfg(3), device="cpu"))
    _feed(eng, gen_points(rng, 300, 3, "uniform"), 0)
    path = str(tmp_path / "e.npz")
    ckpt.save_engine(eng, path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    key = next(k for k in sorted(arrays) if k != "__meta__" and arrays[k].size)
    arrays[key] = arrays[key] + 1.0  # keep the stale meta CRC
    np.savez_compressed(path, **arrays)
    with pytest.raises(ValueError, match="CRC"):
        ckpt.load_engine(path, device="cpu")


# -- the state capture --------------------------------------------------------------


def _fill_both(rng, d, P=4, policy="incremental", n=900, flush_part=True):
    x = gen_points(rng, n, d, "anti")
    sets = (PartitionSet(P, d, 128, flush_policy=policy, device="cpu"),
            JaxPartitionSet(P, d, 128, flush_policy=policy))
    for s in sets:
        for p in range(P):
            s.add_batch(p, np.ascontiguousarray(x[p::P][: n // (2 * P)]), max_id=p, now_ms=0.0)
        if flush_part:
            s.flush_all()
        for p in range(P):
            s.add_batch(p, np.ascontiguousarray(x[p::P][n // (2 * P):]), max_id=n, now_ms=0.0)
    return sets


@pytest.mark.parametrize("policy,d", [("incremental", 3), ("lazy", 5), ("incremental", 2)])
def test_audit_state_equals_the_jax_sets(rng, policy, d):
    pset, jset = _fill_both(rng, d, policy=policy)
    epoch = pset.epoch_key
    skies, pend = pset.audit_state()
    jskies, jpend = jset.audit_state()
    assert [s.tobytes() for s in skies] == [s.tobytes() for s in jskies]
    assert [p.tobytes() for p in pend] == [p.tobytes() for p in jpend]
    assert any(p.shape[0] for p in pend)
    assert pset.epoch_key == epoch  # no flush, no epoch advance
    for p in range(pset.num_partitions):
        assert pset.pending_rows_of(p).tobytes() == jset.pending_rows_of(p).tobytes()


def test_restore_all_equals_the_jax_sets(rng):
    pset, jset = _fill_both(rng, 3)
    skies, pend = jset.audit_state()
    for s in (pset, jset):
        s.restore_all(skies, pend)
    assert pset.max_seen_id.tolist() == jset.max_seen_id.tolist() == [-1] * 4
    assert pset.records_seen.tolist() == [0] * 4
    for s in (pset, jset):
        s.flush_all()
    got, _ = pset.audit_state()
    want, _ = jset.audit_state()
    assert [s.tobytes() for s in got] == [s.tobytes() for s in want]
    assert pset.global_merge_stats(emit_points=True)[3].tobytes() == np.asarray(
        jset.global_merge_stats(emit_points=True)[3]).tobytes()


# -- the fault-plan grammar and its sites ----------------------------------------


@pytest.mark.parametrize("spec", [
    "crash@flush.pre_merge:3",
    "flush.pre_merge:2,exit@kafka.poll:7",
    "corrupt@audit.corrupt:1, slow@sharded.chip_merge#2:1",
    "hang@wal.pre_fsync:4,,",
])
def test_fault_plan_parses_as_jax(spec):
    plan, jplan = faults.FaultPlan.parse(spec), jax_faults.FaultPlan.parse(spec)
    assert repr(plan) == repr(jplan)
    assert [(c.action, c.base, c.chip, c.nth) for c in plan.clauses] == [
        (c.action, c.base, c.chip, c.nth) for c in jplan.clauses]
    assert faults.KILL_POINTS == jax_faults.KILL_POINTS


@pytest.mark.parametrize("spec", [
    "", "boom@flush.pre_merge:1", "crash@no.such_point:1", "crash@flush.pre_merge",
    "crash@flush.pre_merge:0", "crash@sharded.chip_merge#x:1", "crash@sharded.chip_merge#-1:1",
])
def test_fault_plan_rejects_as_jax(spec):
    with pytest.raises(ValueError):
        jax_faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError):
        faults.FaultPlan.parse(spec)


def test_scoped_clause_counts_its_own_hits_as_jax():
    spec = "corrupt@sharded.chip_merge#1:2,corrupt@sharded.chip_merge:3"
    plans = (faults.FaultPlan.parse(spec), jax_faults.FaultPlan.parse(spec))
    fired = [[pl.hit("sharded.chip_merge", chip=c) for c in (0, 1, 1, 0)] for pl in plans]
    assert fired[0] == fired[1] == [False, False, True, False]
    assert plans[0].hits == plans[1].hits
    assert plans[0].hits["sharded.chip_merge"] == 4 and plans[0].hits["sharded.chip_merge#1"] == 2
    assert plans[0].last_fired == plans[1].last_fired and plans[0].exhausted()


def test_install_from_env_parses_once(monkeypatch):
    monkeypatch.setenv("SKYLINE_FAULT_PLAN", "crash@flush.pre_merge:2")
    plan = faults.install_from_env()
    assert plan is faults.active_plan() and faults.install_from_env() is plan
    monkeypatch.setenv("SKYLINE_FAULT_PLAN", "crash@kafka.poll:1")
    assert faults.install_from_env() is plan
    faults.clear()
    assert faults.active_plan() is None
    monkeypatch.delenv("SKYLINE_FAULT_PLAN")
    assert faults.install_from_env() is None


def test_flush_pre_merge_site_fires_on_the_nth_flush(rng):
    pset = PartitionSet(2, 3, 64, device="cpu")
    faults.install_plan(faults.FaultPlan.parse("crash@flush.pre_merge:2"))
    pset.add_batch(0, gen_points(rng, 10, 3, "uniform"), max_id=9, now_ms=0.0)
    pset.flush_all()
    with pytest.raises(faults.InjectedCrash) as ei:
        pset.flush_all()
    assert ei.value.point == "flush.pre_merge"
    assert not isinstance(ei.value, Exception)  # a process death, not an error


def test_checkpoint_pre_replace_keeps_the_previous_file(rng, tmp_path):
    eng = SkylineEngine(EngineConfig(**_cfg(3), device="cpu"))
    _feed(eng, gen_points(rng, 300, 3, "uniform"), 0)
    path = str(tmp_path / "e.npz")
    ckpt.save_engine(eng, path)
    before = open(path, "rb").read()
    _feed(eng, gen_points(rng, 300, 3, "uniform"), 300)
    faults.install_plan(faults.FaultPlan.parse("crash@checkpoint.pre_replace:1"))
    with pytest.raises(faults.InjectedCrash):
        ckpt.save_engine(eng, path)
    assert open(path, "rb").read() == before
    assert ckpt.load_engine(path, device="cpu").records_in == 300

"""The port's sharded engine (``skyline_tpu_torch/distributed``) on the CPU
against the JAX package's ``ShardedEngine`` and the port's flat engine.

- The grid: kind in {uniform, correlated, anti} x d in {2, 4, 8} x chips in
  {1, 2, 4} x policy in {incremental, lazy} (and overlap at one point), P =
  4, 450 rows in the reference's chunked feed (``_feed_pset``, buffer 64):
  the port's ``ShardedPartitionSet(device="cpu")`` gives the JAX set's
  merge state (counts, survivors, size, point bytes and order) and the
  port's flat ``PartitionSet``'s, with equal ``sharded_stats()`` (the
  device names aside); every intermediate query too.
- The chip prune fires with the JAX set's counts; ``SKYLINE_CHIP_PRUNE=0``
  turns it off with the same bytes.
- The engine: results, ``stats()`` with its ``sharded`` block, the hub's
  counters and the EXPLAIN ``chips`` block equal the JAX engine's, timings
  aside (``untimed``); the audit plane checks the sharded answer.
- ``ChipWalPlane``: the same segment bytes as the JAX writer on the same
  calls; a torn fan-out ignored and a divergence raised, by both readers.
- The awkward rows (+-inf, NaN, -0.0 against +0.0, mixed and duplicate
  rows) at chips 2 and 4, P = 8, under the three policies, against the JAX
  set.
- Checkpoints across topologies, both ways and through the JAX package's
  npz, with the same next answer; a sharded checkpoint onto the cluster
  engine.
- The worker with ``mesh_chips`` (``tests/test_torch_worker.py`` holds the
  output lines and journals against the JAX worker's) under the chaos
  drill: a chip crash under the ``Supervisor`` replays to the flat
  uninterrupted worker's answer.
- Placement helpers, validation, and the import boundary.

Tolerance: exact bytes everywhere.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from skyline_tpu.distributed import ShardedEngine as JaxShardedEngine
from skyline_tpu.distributed import ShardedPartitionSet as JaxShardedSet
from skyline_tpu.resilience import faults as jfaults
from skyline_tpu.resilience.chip_wal import ChipWalPlane as JaxChipWalPlane
from skyline_tpu.resilience.chip_wal import verify_chip_barriers as jax_verify
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.telemetry import Telemetry as JaxTelemetry
from skyline_tpu_torch.bridge import MemoryBus, SkylineWorker
from skyline_tpu_torch.bridge.wire import format_trigger, format_tuple_line
from skyline_tpu_torch.distributed import ShardedEngine, ShardedPartitionSet
from skyline_tpu_torch.parallel.chips import chip_devices, chip_of, gather_to
from skyline_tpu_torch.resilience import ResilienceConfig
from skyline_tpu_torch.resilience.chip_wal import (
    ChipWalPlane,
    discover_chips,
    read_chip_records,
    verify_chip_barriers,
)
from skyline_tpu_torch.resilience.faults import FaultPlan, active_plan, clear, install_plan
from skyline_tpu_torch.resilience.supervisor import Supervisor
from skyline_tpu_torch.resilience.wal import WalReplayError, list_segments
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream.batched import PartitionSet
from skyline_tpu_torch.telemetry import Telemetry
from skyline_tpu_torch.workload.generators import uniform

from conftest import assert_same_merge, gen_points, merge_state
from test_torch_observability import process_state, untimed  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
P = 4  # divisible by every chip count in the grid


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    clear()
    jfaults.clear()
    yield
    clear()
    jfaults.clear()


@pytest.fixture
def rounds_only(monkeypatch):
    """The lazy flush pinned to the SFS rounds on both sides (the race
    chooses by measured walls; the answers never depend on it)."""
    monkeypatch.setenv("SKYLINE_SORTED_SFS", "off")
    monkeypatch.setenv("SKYLINE_DEVICE_CASCADE", "off")


def _feed_pset(pset, x: np.ndarray, chunk: int = 97) -> None:
    """The reference's ingest sequence: deterministic routing, chunked
    adds, the set's own flush cadence after every chunk."""
    n = x.shape[0]
    pids = np.arange(n) % P
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        for p in range(P):
            rows = np.ascontiguousarray(x[lo:hi][pids[lo:hi] == p])
            if rows.shape[0]:
                pset.add_batch(p, rows, max_id=hi, now_ms=0.0)
        pset.maybe_flush()
    pset.flush_all()


def _stats(pset) -> dict:
    doc = pset.sharded_stats()
    doc.pop("devices")  # "cpu" here, the JAX package's device names there
    return doc


def _port(chips, d, policy="incremental", **kw):
    return ShardedPartitionSet(P, d, 64, chips=chips, flush_policy=policy, device="cpu", **kw)


# -- the grid ------------------------------------------------------------------------


@pytest.mark.parametrize("chips", [1, 2, 4])
@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("kind", ["uniform", "correlated", "anti"])
def test_sharded_grid_matches_jax_and_flat(kind, d, chips):
    x = gen_points(np.random.default_rng(d), 450, d, kind)
    for policy in ("incremental", "lazy"):
        flat = PartitionSet(P, d, buffer_size=64, flush_policy=policy, device="cpu")
        _feed_pset(flat, x)
        want = merge_state(flat)
        jax_set = JaxShardedSet(P, d, 64, chips=chips, flush_policy=policy)
        _feed_pset(jax_set, x)
        sp = _port(chips, d, policy)
        _feed_pset(sp, x)
        ctx = f"kind={kind} d={d} chips={chips} policy={policy}"
        got = merge_state(sp)
        assert_same_merge(merge_state(jax_set), got, ctx=ctx + " vs jax")
        assert_same_merge(want, got, ctx=ctx + " vs flat")
        assert _stats(sp) == _stats(jax_set), ctx
        assert sp.epoch_key == jax_set.epoch_key


@pytest.mark.parametrize("chips,policy", [(2, "incremental"), (4, "lazy"), (2, "overlap")])
def test_every_intermediate_query_matches(chips, policy):
    """Identity at every query, not only at the end (flush cadence and the
    facade cache in play), and a repeated query is an exact cache hit."""
    d = 4
    x = gen_points(np.random.default_rng(5), 600, d, "uniform")
    kw = dict(flush_policy=policy, overlap_rows=200)
    flat = PartitionSet(P, d, buffer_size=64, device="cpu", **kw)
    jax_set = JaxShardedSet(P, d, 64, chips=chips, **kw)
    sp = ShardedPartitionSet(P, d, 64, chips=chips, device="cpu", **kw)
    pids = np.arange(x.shape[0]) % P
    for lo in range(0, x.shape[0], 150):
        hi = lo + 150
        for ps in (flat, jax_set, sp):
            for p in range(P):
                rows = np.ascontiguousarray(x[lo:hi][pids[lo:hi] == p])
                if rows.shape[0]:
                    ps.add_batch(p, rows, max_id=hi, now_ms=0.0)
            ps.flush_all()
        got = merge_state(sp)
        assert_same_merge(merge_state(jax_set), got, ctx=f"jax after {hi} rows")
        assert_same_merge(merge_state(flat), got, ctx=f"flat after {hi} rows")
    again = merge_state(sp)
    assert_same_merge(merge_state(jax_set), again, ctx="cache hit")
    assert sp.merge_cache_hits == jax_set.merge_cache_hits >= 1
    assert _stats(sp) == _stats(jax_set)


# -- the chip prune ----------------------------------------------------------------------


def _skewed(rng, d=2):
    """Partition 0 near the origin, the rest in the dominated upper
    quadrant: chip 0's witness strictly dominates the other chips'
    least corners."""
    x = rng.random((448, d)).astype(np.float32) * 0.4 + 0.55
    x[::P] = rng.random((112, d)).astype(np.float32) * 0.05 + 0.01
    return x


@pytest.mark.parametrize("prune", [True, False])
def test_chip_prune_matches_jax(monkeypatch, prune):
    if not prune:
        monkeypatch.setenv("SKYLINE_CHIP_PRUNE", "0")
    x = _skewed(np.random.default_rng(0))
    flat = PartitionSet(P, 2, buffer_size=64, device="cpu")
    _feed_pset(flat, x)
    jax_set = JaxShardedSet(P, 2, 64, chips=4)
    _feed_pset(jax_set, x)
    sp = _port(4, 2)
    _feed_pset(sp, x)
    got = merge_state(sp)
    assert_same_merge(merge_state(flat), got, ctx="vs flat")
    assert_same_merge(merge_state(jax_set), got, ctx="vs jax")
    stats = _stats(sp)
    assert stats == _stats(jax_set)
    if prune:
        assert stats["chips_pruned"] > 0 and stats["chips_considered"] == 4
        pruned = {e["chip"] for e in stats["last"]["pruned"]}
        assert pruned and not (set(stats["last"]["survivors"]) & pruned)
        assert all(e["witness"] not in pruned for e in stats["last"]["pruned"])
    else:
        assert stats["chips_pruned"] == 0


# -- the awkward rows (ROADMAP queue 3's gaps) ------------------------------------------


def _feed_p8(pset, x: np.ndarray, chunk: int = 97) -> None:
    """``_feed_pset`` over P = 8 partitions."""
    n = x.shape[0]
    pids = np.arange(n) % 8
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        for p in range(8):
            rows = np.ascontiguousarray(x[lo:hi][pids[lo:hi] == p])
            if rows.shape[0]:
                pset.add_batch(p, rows, max_id=hi, now_ms=0.0)
        pset.maybe_flush()
    pset.flush_all()


@pytest.mark.parametrize("policy", ["incremental", "lazy", "overlap"])
@pytest.mark.parametrize("chips", [2, 4])
@pytest.mark.parametrize("rows", ["inf", "nan", "signed_zero", "mixed", "duplicates"])
def test_awkward_rows_match_jax(rounds_only, rows, chips, policy):
    """+-inf, NaN, -0.0 against +0.0, a mix of them and duplicate rows, P =
    8: the port's sharded set gives the JAX set's merge state, sharded stats
    (the chip witness included) and per-partition skyline sizes."""
    from test_torch_cluster import _awkward_rows

    d = 3
    x = _awkward_rows(rows, d)
    jax_set = JaxShardedSet(8, d, 64, chips=chips, flush_policy=policy)
    sp = ShardedPartitionSet(8, d, 64, chips=chips, flush_policy=policy, device="cpu")
    for s in (jax_set, sp):
        _feed_p8(s, x)
    ctx = f"rows={rows} chips={chips} policy={policy}"
    got = merge_state(sp)
    assert_same_merge(merge_state(jax_set), got, ctx=ctx)
    assert _stats(sp) == _stats(jax_set), ctx
    assert sp.sky_counts().tolist() == jax_set.sky_counts().tolist()
    assert sp.epoch_key == jax_set.epoch_key


# -- the engine ----------------------------------------------------------------------


def _run_engine(engine, x, qid="0"):
    ids = np.arange(x.shape[0], dtype=np.int64)
    for lo in range(0, x.shape[0], 128):
        engine.process_records(ids[lo : lo + 128], x[lo : lo + 128])
    engine.process_trigger(f"{qid},0")
    return engine.poll_results()


def _sharded_stats(eng) -> dict:
    doc = untimed(eng.stats(include_skyline_counts=True))
    doc["sharded"].pop("devices")
    return doc


@pytest.mark.parametrize("policy", ["incremental", "lazy"])
@pytest.mark.parametrize("chips,d", [(2, 4), (4, 2), (4, 8)])
def test_engine_matches_jax_with_stats_and_explain(rounds_only, monkeypatch, policy, chips, d):
    monkeypatch.setenv("SKYLINE_AUDIT_SAMPLE", "1.0")
    kw = dict(parallelism=2, dims=d, buffer_size=64, domain_max=1.0, emit_skyline_points=True,
              flush_policy=policy)
    x = gen_points(np.random.default_rng(chips + d), 500, d, "correlated")
    from skyline_tpu.serve import SnapshotStore as JaxStore
    from skyline_tpu_torch.serve import SnapshotStore

    jax_eng = JaxShardedEngine(JaxConfig(**kw), chips=chips, telemetry=JaxTelemetry())
    jax_eng.attach_snapshots(JaxStore(history=4))
    eng = ShardedEngine(EngineConfig(**kw, device="cpu"), chips=chips, telemetry=Telemetry())
    eng.attach_snapshots(SnapshotStore(history=4))
    flat = SkylineEngine(EngineConfig(**kw, device="cpu"))
    got, want = _run_engine(eng, x), _run_engine(jax_eng, x)
    assert untimed(got) == untimed(want)
    assert untimed(got) == untimed(_run_engine(flat, x))
    assert _sharded_stats(eng) == _sharded_stats(jax_eng)
    st = eng.stats()
    assert st["sharded"]["chips"] == chips and st["sharded"]["merges"] >= 1
    assert st["audit"]["checks_total"] >= 1 and st["audit"]["divergence_total"] == 0
    assert eng.telemetry.counters.snapshot() == jax_eng.telemetry.counters.snapshot()
    plan, jax_plan = eng.telemetry.explain.latest(), jax_eng.telemetry.explain.latest()
    assert plan["merge"]["path"] == "sharded_tree"
    assert untimed(plan["chips"]) == untimed(jax_plan["chips"])
    assert untimed(plan["merge"]) == untimed(jax_plan["merge"])
    from skyline_tpu_torch.telemetry.explain import format_plan

    assert f"chips n={chips}" in format_plan(plan)


def test_engine_rejects_device_ingest_and_syncs_every_chip():
    with pytest.raises(ValueError, match="ingest"):
        ShardedEngine(EngineConfig(parallelism=2, dims=2, ingest="device", device="cpu"), chips=2)
    eng = ShardedEngine(EngineConfig(parallelism=2, dims=2, device="cpu"), chips=2)
    assert eng.pset.devices == [eng.device] * 2
    assert isinstance(eng.health.doc(), dict) and eng.telemetry is None
    eng._sync_devices()  # nothing to wait for on the CPU


# -- the chip journals ------------------------------------------------------------------


def _write_plane(cls, d: str):
    plane = cls(d, chips=3, fsync="off")
    plane.note_flush(0, 10, "e0")
    plane.note_flush(2, 5, "e2")
    plane.merge_barrier(1, "g1", ["a", "b", "c"], [5, 0, 2])
    plane.merge_barrier(2, "g2", ["a", "b", "c"], [5, 1, 2])
    plane.checkpoint_barrier({"type": "ckpt", "data_off": 7, "query_off": 1})
    plane.note_flush(1, 3, "e1")
    win = plane.failover_window(1)
    stats = plane.stats()
    plane.close()
    return win, stats


def test_chip_wal_bytes_match_jax(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    got, jgot = _write_plane(ChipWalPlane, a), _write_plane(JaxChipWalPlane, b)
    assert got[0] == jgot[0]
    assert untimed(got[1]) == untimed(jgot[1])
    assert discover_chips(a) == 3
    for c in range(3):
        segs = [Path(p).read_bytes() for _, p in list_segments(str(Path(a) / f"chip-{c:02d}"))]
        jsegs = [Path(p).read_bytes() for _, p in list_segments(str(Path(b) / f"chip-{c:02d}"))]
        assert segs == jsegs and segs
    assert read_chip_records(a, 3) == read_chip_records(b, 3)
    assert verify_chip_barriers(a) == jax_verify(b)


def test_chip_wal_torn_fanout_and_divergence_match_jax(tmp_path):
    for root, cls, verify in ((tmp_path / "p", ChipWalPlane, verify_chip_barriers),
                              (tmp_path / "j", JaxChipWalPlane, jax_verify)):
        torn, bad = str(root / "torn"), str(root / "bad")
        plane = cls(torn, chips=2, fsync="off")
        plane.merge_barrier(1, "g1", ["a", "b"], [1, 1])
        plane.close()
        again = cls(torn, chips=2, fsync="off")
        again._writers[0].append({"type": "chip-barrier", "seq": 2, "chip": 0, "chips": 2,
                                  "epoch": "g2", "chip_epoch": "a2", "g": 1})
        again.close()
        assert verify(torn) == {"chips": 2, "common_seq": 1, "epoch": "g1", "agree": True}
        plane = cls(bad, chips=2, fsync="off")
        for c, epoch in ((0, "gX"), (1, "gY")):
            plane._writers[c].append({"type": "chip-barrier", "seq": 1, "chip": c, "chips": 2,
                                      "epoch": epoch, "chip_epoch": "a", "g": 1})
        plane.close()
        with pytest.raises(Exception, match="divergence") as err:
            verify(bad)
        assert type(err.value).__name__ == "WalReplayError"
    assert issubclass(WalReplayError, Exception)


def test_merge_barriers_match_jax(tmp_path):
    """The facade's barriers: one fan-out per full merge, the chip epochs
    and chip skyline counts the JAX facade writes."""
    x = gen_points(np.random.default_rng(3), 300, 3, "uniform")
    sets = []
    for root, cls, set_cls, kw in (("p", ChipWalPlane, ShardedPartitionSet, {"device": "cpu"}),
                                   ("j", JaxChipWalPlane, JaxShardedSet, {})):
        sp = set_cls(P, 3, 64, chips=2, **kw)
        plane = cls(str(tmp_path / root), chips=2, fsync="off")
        sp.attach_chip_wal(plane)
        _feed_pset(sp, x[:150])
        merge_state(sp)
        _feed_pset(sp, x[150:])
        merge_state(sp)
        plane.close()
        sets.append(read_chip_records(str(tmp_path / root), 2))
    assert sets[0] == sets[1]
    assert [r["type"] for r in sets[0][0]].count("chip-barrier") == 2


# -- checkpoints across topologies ----------------------------------------------------------


def test_checkpoint_roundtrips_across_topologies(tmp_path):
    from skyline_tpu.utils import checkpoint as jax_ckpt
    from skyline_tpu_torch.utils import checkpoint as ckpt

    d = 4
    kw = dict(parallelism=2, dims=d, buffer_size=64, domain_max=1.0, emit_skyline_points=True)
    x = gen_points(np.random.default_rng(4), 400, d, "uniform")
    tail = gen_points(np.random.default_rng(9), 200, d, "anti")
    eng = ShardedEngine(EngineConfig(**kw, device="cpu"), chips=2)
    ids = np.arange(400, dtype=np.int64)
    for lo in range(0, 400, 128):
        eng.process_records(ids[lo : lo + 128], x[lo : lo + 128])
    base = merge_state(eng.pset)
    path = str(tmp_path / "sharded.npz")
    ckpt.save_engine(eng, path)
    flat = ckpt.load_engine(path, device="cpu")
    assert type(flat) is SkylineEngine
    wide = ckpt.load_engine(path, mesh_chips=4, device="cpu")
    assert isinstance(wide, ShardedEngine) and wide.mesh_chips == 4
    jax_flat = jax_ckpt.load_engine(path)
    jax_wide = jax_ckpt.load_engine(path, mesh_chips=4)
    for e in (flat, wide, jax_flat, jax_wide):
        assert e.records_in == eng.records_in == 400
        assert_same_merge(base, merge_state(e.pset), ctx=type(e).__name__)
    # the flat port checkpoint and a JAX sharded one boot a sharded port engine
    flat_path, jax_path = str(tmp_path / "flat.npz"), str(tmp_path / "jax.npz")
    ckpt.save_engine(flat, flat_path)
    jax_ckpt.save_engine(jax_wide, jax_path)
    restored = [ckpt.load_engine(flat_path, mesh_chips=2, device="cpu"),
                ckpt.load_engine(jax_path, mesh_chips=4, device="cpu")]
    for e in restored:
        assert isinstance(e, ShardedEngine)
        assert_same_merge(base, merge_state(e.pset), ctx="restored")
    # the same next answer as the JAX engine's
    tids = np.arange(400, 600, dtype=np.int64)
    answers = []
    for e in (*restored, jax_wide, wide, flat):
        e.process_records(tids, tail)
        e.process_trigger("q,0")
        answers.append(untimed(e.poll_results()))
    assert all(a == answers[2] for a in answers)


def test_checkpoint_mesh_and_cluster_restores_raise(tmp_path):
    from skyline_tpu_torch.resilience.checkpoints import CheckpointManager
    from skyline_tpu_torch.utils import checkpoint as ckpt

    eng = ShardedEngine(EngineConfig(parallelism=2, dims=3, device="cpu"), chips=2)
    path = str(tmp_path / "e.npz")
    ckpt.save_engine(eng, path)
    # a sharded checkpoint restores onto the cluster engine (2 hosts of 2
    # chips: the same partition state) and onto a device mesh
    cl = ckpt.load_engine(path, device="cpu", cluster_hosts=2, mesh_chips=2)
    assert type(cl).__name__ == "ClusterEngine" and cl.pset._member_chips == [2, 2]
    assert cl.pset.sky_counts().tolist() == eng.pset.sky_counts().tolist()
    from skyline_tpu_torch.parallel import make_mesh

    meshed = ckpt.load_engine(path, mesh=make_mesh(2, device="cpu"))
    assert type(meshed).__name__ == "SkylineEngine" and meshed.mesh is not None
    assert meshed.pset.sky_counts().tolist() == eng.pset.sky_counts().tolist()
    mgr = CheckpointManager(str(tmp_path / "m"))
    mgr.save(eng)
    engine, _meta, _path = mgr.restore_latest(mesh_chips=4, device="cpu")
    assert isinstance(engine, ShardedEngine) and engine.mesh_chips == 4


# -- the chaos drill: a chip crash under the supervisor -------------------------------------


def _feed_bus(bus, rows, start_id=0):
    bus.produce_many("input-tuples",
                     [format_tuple_line(start_id + i, row) for i, row in enumerate(rows)])


def _drive_to_result(worker, bus, out, shared, chunk=64):
    idle = 0
    while True:
        if worker.step(max_records=chunk):
            idle = 0
            continue
        if not shared["trigger_sent"]:
            bus.produce("queries", format_trigger(0, 0))
            shared["trigger_sent"] = True
            continue
        shared["lines"].extend(out.poll())
        if shared["lines"]:
            return json.loads(shared["lines"][-1])
        idle += 1
        assert idle < 500, "worker went idle without producing a result"


_CFG = dict(parallelism=2, dims=4, domain_max=10000.0, buffer_size=128,
            emit_skyline_points=True, device="cpu")


@pytest.mark.parametrize("chips,plan", [
    (2, "crash@sharded.chip_merge:1"),
    (4, "crash@sharded.chip_merge:3,crash@kafka.poll:7"),
])
def test_chaos_chip_crash_replays_to_flat_answer(tmp_path, chips, plan):
    rows = uniform(np.random.default_rng(0), 400, 4, 0, 10000)
    base_bus = MemoryBus()
    _feed_bus(base_bus, rows)
    base_w = SkylineWorker(base_bus, EngineConfig(**_CFG))
    base = _drive_to_result(base_w, base_bus, base_bus.consumer("output-skyline"),
                            {"trigger_sent": False, "lines": []})
    base_w.close()

    bus = MemoryBus()
    _feed_bus(bus, rows)
    out = bus.consumer("output-skyline", from_beginning=True)
    telem = Telemetry()
    shared = {"trigger_sent": False, "lines": []}
    holder = {}
    install_plan(FaultPlan.parse(plan))

    def incarnation(attempt):
        w = SkylineWorker(bus, EngineConfig(**_CFG), mesh_chips=chips, telemetry=telem,
                          resilience=ResilienceConfig(checkpoint_dir=str(tmp_path),
                                                      wal_fsync="batch"))
        holder["w"] = w
        return _drive_to_result(w, bus, out, shared)

    sup = Supervisor(incarnation, max_restarts=8, backoff_base_s=0.0, backoff_cap_s=0.0,
                     telemetry=telem, sleep=lambda s: None)
    try:
        doc = sup.run()
        stats = holder["w"].stats()
    finally:
        clear()
        holder["w"].close()
    w = holder["w"]
    assert sup.restarts >= 1, "the fault plan never fired"
    assert active_plan() is None
    assert w.engine.records_in == 400 and isinstance(w.engine, ShardedEngine)
    assert doc["skyline_size"] == base["skyline_size"]
    assert np.asarray(doc["skyline_points"], np.float32).tobytes() == np.asarray(
        base["skyline_points"], np.float32).tobytes()
    cw = stats["resilience"]["chip_wal"]
    assert cw["chips"] == chips and cw["barriers_written"] >= 1
    v = verify_chip_barriers(w._wal_dir, chips)
    assert v["agree"] and v["common_seq"] is not None
    assert w._recovered is not None and w._recovered["wal_records"] > 0


# -- placement and validation --------------------------------------------------------------


def test_chip_devices_ownership_and_gather():
    import torch

    assert chip_devices(4, "cpu") == [torch.device("cpu")] * 4
    assert chip_of(0, 2) == chip_of(1, 2) == 0 and chip_of(2, 2) == chip_of(3, 2) == 1
    with pytest.raises(ValueError):
        chip_devices(0, "cpu")
    t = torch.arange(3)
    (same,) = gather_to(torch.device("cpu"), [t])
    assert same is t
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            chip_devices(2)


def test_sharded_set_validates_like_jax():
    for kw in (dict(chips=3), dict(chips=0)):
        with pytest.raises(ValueError) as port:
            ShardedPartitionSet(4, 2, 64, device="cpu", **kw)
        with pytest.raises(ValueError) as ref:
            JaxShardedSet(4, 2, 64, **kw)
        assert str(port.value) == str(ref.value)


def test_import_boundary():
    """``import skyline_tpu_torch.distributed`` (and the chip planes) in a
    fresh interpreter imports neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "import skyline_tpu_torch, skyline_tpu_torch.distributed\n"
        "import skyline_tpu_torch.resilience.health, skyline_tpu_torch.telemetry.fleet\n"
        "import skyline_tpu_torch.parallel.chips, skyline_tpu_torch.resilience.chip_wal\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'skyline_tpu.'))"
        " or m == 'skyline_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)

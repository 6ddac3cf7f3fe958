"""The port's cluster plane (``skyline_tpu_torch/cluster``) on the CPU
against the JAX package's.

- The lease plane: ``LeasePlane``, ``FencedWalWriter``, ``LeaseKeeper``,
  ``ClusterSupervisor`` and ``ClusterStatus`` driven through the same
  scenario in both packages (deterministic clocks): the same records,
  verdicts and counters, and the same WAL segment bytes, fencing tokens
  included. A deposed primary's post-fence append raises
  ``WalFencedError`` and is counted; a raced post-fence frame is skipped by
  every reader; a fenced barrier is rejected before its rotation; the
  supervisor promotes the most caught-up replica under a raised fence, and
  the promoted head equals an independent fold of the durable WAL (the JAX
  replica's, reading the port's files).
- The host tournament: ``ClusterPartitionSet`` over hosts x chips_per_host
  in {(1,1), (2,1), (2,2), (4,2), (8,1)} x the incremental, lazy and
  overlap policies, P = 8: the JAX set's merge state (counts, survivors,
  size, point bytes and order) and ``cluster_stats()``, and the flat
  ``PartitionSet``'s; every intermediate query and a cache hit; the host
  prune and its knob; the awkward rows (+-inf, NaN, -0.0 against +0.0,
  mixed and duplicate rows) at hosts 2 and 4.
- Elastic rebalance: ``migrate`` to another chip count, the facade's
  pending bookkeeping, the migration budget, the slice checkpoint (the JAX
  package's npz both ways) and its CRC check, the quarantined host.
- ``ClusterEngine``: results, ``stats()["cluster"]``, EXPLAIN's ``hosts``
  block and the host-labeled families against the JAX engine; device ingest
  refused; ``/cluster`` and ``/cluster/overview`` on both HTTP surfaces.
- The worker with ``cluster_hosts``: output lines and WAL records against
  the JAX worker's, the lease taken and refused to a second primary,
  demotion on a raised fence.

Sharded members run on the CPU as ``tests/test_torch_sharded.py`` runs
them (``device="cpu"``: every chip group on the CPU). Tolerance: exact
bytes everywhere.
"""

from __future__ import annotations

import json
import os
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import skyline_tpu.cluster as jcluster
import skyline_tpu.resilience.wal as jwal
import skyline_tpu.serve as jserve
import skyline_tpu_torch.cluster as tcluster
import skyline_tpu_torch.resilience.wal as twal
import skyline_tpu_torch.serve as tserve
from skyline_tpu.resilience import faults as jfaults
from skyline_tpu.serve.replica import SkylineReplica as JaxReplica
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.telemetry import Telemetry as JaxTelemetry
from skyline_tpu_torch.cluster import (
    ClusterEngine,
    ClusterPartitionSet,
    ClusterStatus,
    ClusterSupervisor,
    FencedWalWriter,
    LeaseKeeper,
    LeaseLostError,
    LeasePlane,
    WalFencedError,
)
from skyline_tpu_torch.resilience import faults as tfaults
from skyline_tpu_torch.serve.replica import SkylineReplica
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream.batched import PartitionSet
from skyline_tpu_torch.telemetry import Telemetry

from conftest import assert_same_merge, gen_points, merge_state, parse_prometheus_text
from test_torch_observability import untimed

P = 8  # divisible by every host x chip combination in the grid
GRID = ((1, 1), (2, 1), (2, 2), (4, 2), (8, 1))
POLICIES = ("incremental", "lazy", "overlap")

PKG = {
    "jax": SimpleNamespace(c=jcluster, wal=jwal, serve=jserve, faults=jfaults,
                           Telemetry=JaxTelemetry, Replica=JaxReplica),
    "port": SimpleNamespace(c=tcluster, wal=twal, serve=tserve, faults=tfaults,
                            Telemetry=Telemetry, Replica=SkylineReplica),
}


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


@pytest.fixture
def rounds_only(monkeypatch):
    """The lazy flush pinned to the SFS rounds on both sides (the race
    chooses by measured walls; the answers never depend on it)."""
    monkeypatch.setenv("SKYLINE_SORTED_SFS", "off")
    monkeypatch.setenv("SKYLINE_DEVICE_CASCADE", "off")


def _feed_pset(pset, x: np.ndarray, chunk: int = 97) -> None:
    """The reference's ingest sequence: deterministic routing, chunked adds,
    the set's own flush cadence after every chunk."""
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


def _skewed(rng, d=2):
    """Host 0's witness strictly dominates every other host's least corner:
    a dense near-origin cluster routed to partition 0, the rest dominated."""
    x = rng.random((448, d)).astype(np.float32) * 0.4 + 0.55
    x[::P] = rng.random((56, d)).astype(np.float32) * 0.05 + 0.01
    return x


def _port(hosts, d, chips=1, policy="incremental", **kw):
    return ClusterPartitionSet(P, d, 64, hosts=hosts, chips_per_host=chips,
                               flush_policy=policy, device="cpu", **kw)


def _jax(hosts, d, chips=1, policy="incremental"):
    return jcluster.ClusterPartitionSet(P, d, 64, hosts=hosts, chips_per_host=chips,
                                        flush_policy=policy)


def _flat(d, policy="incremental"):
    return PartitionSet(P, d, buffer_size=64, flush_policy=policy, device="cpu")


# -- the lease plane ----------------------------------------------------------------


def _lease_scenario(kind, d):
    """Acquire, refuse, re-acquire, expire, renew, deposition: every record
    and verdict."""
    c = PKG[kind].c
    clock = {"now": 1000.0}
    plane = c.LeasePlane(d, clock=lambda: clock["now"])
    out = [plane.acquire("a", ttl_ms=500.0).doc(), plane.acquire("b", ttl_ms=500.0)]
    rec = plane.acquire("a", ttl_ms=500.0)
    out.append(rec.doc())
    clock["now"] += 10_000.0
    rec3 = plane.acquire("b", ttl_ms=500.0)
    out += [rec3.doc(), plane.renew(rec3).doc(), plane.doc()]
    for stale in (rec,):
        with pytest.raises(c.LeaseLostError, match="epoch") as e:
            plane.renew(stale)
        out.append(str(e.value))
    out.append(plane.raise_fence(rec3.epoch + 1))
    with pytest.raises(c.LeaseLostError, match="fence") as e:
        plane.renew(rec3)
    out += [str(e.value), plane.raise_fence(1), plane.read_fence(), plane.fence_doc()["min_epoch"],
            c.LeasePlane(d).read_fence()]
    out.append(json.loads(open(os.path.join(d, "lease.json")).read()))
    return out


def test_lease_plane_matches_jax(tmp_path):
    port = _lease_scenario("port", str(tmp_path / "port"))
    ref = _lease_scenario("jax", str(tmp_path / "jax"))
    assert port == ref
    assert port[0]["epoch"] == 1 and port[1] is None and port[2]["epoch"] == 2
    assert port[3]["holder"] == "b" and port[3]["epoch"] == 3
    # the fence never lowers, and a fresh plane reads it from the file
    assert port[-5] == port[-4] == port[-2] == 4


def test_each_package_honours_the_others_lease_and_fence(tmp_path):
    d = str(tmp_path)
    clock = {"now": 0.0}
    jplane = jcluster.LeasePlane(d, clock=lambda: clock["now"])
    rec = jplane.acquire("jax-primary", ttl_ms=500.0)
    tplane = LeasePlane(d, clock=lambda: clock["now"])
    assert tplane.acquire("port", ttl_ms=500.0) is None
    assert tplane.read_lease() == LeasePlane(d).read_lease()
    assert tplane.read_lease().doc() == rec.doc()
    tplane.raise_fence(rec.epoch + 1)
    with pytest.raises(jcluster.LeaseLostError):
        jplane.renew(rec)
    assert jplane.fence_doc() == tplane.fence_doc()


def _fenced_scenario(kind, d):
    """A fenced writer's appends, the rejection after a raise (and of its
    barrier), the counters and the durable frames."""
    pk = PKG[kind]
    telem = pk.Telemetry()
    plane = pk.c.LeasePlane(d)
    rec = plane.acquire("primary-0", ttl_ms=1000.0)
    w = pk.c.FencedWalWriter(d, rec.epoch, plane=plane, fsync="off", telemetry=telem)
    w.append({"type": "delta", "i": 0})
    w.flush(force=True)
    plane.raise_fence(rec.epoch + 1)
    errs = []
    for call in (lambda: w.append({"type": "delta", "i": 1}),
                 lambda: w.barrier({"type": "ckpt"})):
        with pytest.raises(pk.c.WalFencedError) as e:
            call()
        errs.append(str(e.value))
    w.close()
    recs, torn = pk.wal.read_records(d)
    st = w.stats()
    series = parse_prometheus_text(telem.render_prometheus())
    segs = [(os.path.basename(p), open(p, "rb").read()) for _, p in pk.wal.list_segments(d)]
    return (errs, recs, torn, w.fenced_writes, st["fenced_writes"], st["epoch"],
            dict(telem.counters.snapshot())["cluster.fenced_writes"],
            series["skyline_cluster_fenced_writes_total"], segs)


def test_fenced_append_rejected_counted_and_bytes_match_jax(tmp_path):
    port = _fenced_scenario("port", str(tmp_path / "port"))
    assert port == _fenced_scenario("jax", str(tmp_path / "jax"))
    errs, recs, torn, fenced, _, epoch, counted, series, _ = port
    assert "behind" in errs[0] and torn == 0
    deltas = [r for r in recs if r.get("type") == "delta"]
    assert [r["i"] for r in deltas] == [0], "a fenced frame must not land"
    assert all(r["fence"] == epoch for r in deltas)
    assert fenced == counted == 2 and series[0][1] == 2.0


def test_stale_fence_fault_verb_fires(tmp_path):
    d = str(tmp_path)
    plane = LeasePlane(d)
    rec = plane.acquire("primary-0", ttl_ms=1000.0)
    w = FencedWalWriter(d, rec.epoch, plane=plane, fsync="off")
    plane.raise_fence(rec.epoch + 1)
    tfaults.install_plan(tfaults.FaultPlan.parse("crash@wal.stale_fence:1"))
    with pytest.raises(tfaults.InjectedCrash):
        w.append({"type": "delta", "i": 0})
    tfaults.clear()
    with pytest.raises(WalFencedError):
        w.append({"type": "delta", "i": 0})
    w.close()


def _race_scenario(kind, d):
    """The check-then-write race from both sides: a stale-epoch frame landed
    after the fence is skipped by replay and by a live tailer; an append
    whose pre-check saw the old fence is reported rejected; a deposed
    barrier never clobbers the promoted writer's segment."""
    pk = PKG[kind]
    plane = pk.c.LeasePlane(d)
    rec = plane.acquire("primary-0", ttl_ms=1000.0)
    w = pk.c.FencedWalWriter(d, rec.epoch, plane=plane, fsync="off")
    w.append({"type": "delta", "i": 0})
    pk.c.LeasePlane(d).raise_fence(rec.epoch + 1)
    pk.wal.WalWriter.append(w, {"type": "delta", "i": 1, "fence": rec.epoch})
    real = plane.read_fence
    state = {"calls": 0}

    def stale_once():
        state["calls"] += 1
        return 0 if state["calls"] == 1 else real()

    plane.read_fence = stale_once
    try:
        with pytest.raises(pk.c.WalFencedError, match="raced"):
            w.append({"type": "delta", "i": 3})
    finally:
        del plane.read_fence
    w2 = pk.c.FencedWalWriter(d, rec.epoch + 1, plane=pk.c.LeasePlane(d), fsync="off")
    w2.append({"type": "delta", "i": 2})
    seg2 = os.path.join(d, "wal-%08d.log" % w2.stats()["segment_seq"])
    size2 = os.path.getsize(seg2)
    with pytest.raises(pk.c.WalFencedError):
        w.barrier({"type": "ckpt"})
    assert os.path.getsize(seg2) == size2
    recs, torn = pk.wal.read_records(d)
    t = pk.wal.WalTailer(d, "t0")
    got = t.poll()
    skipped = t.stats()["stale_frames_skipped"]
    t.close()
    w.close()
    w2.close()
    return ([r["i"] for r in recs if r["type"] == "delta"], torn,
            [r["i"] for r in got if r["type"] == "delta"], skipped, w.fenced_writes)


def test_raced_post_fence_frames_skipped_and_reported_like_jax(tmp_path):
    port = _race_scenario("port", str(tmp_path / "port"))
    assert port == _race_scenario("jax", str(tmp_path / "jax"))
    assert port == ([0, 2], 0, [0, 2], 2, 2)


def test_fence_cache_sees_same_size_same_mtime_raise(tmp_path):
    d = str(tmp_path)
    reader = LeasePlane(d)
    fence_path = str(tmp_path / "fence.json")
    LeasePlane(d).raise_fence(3)
    os.utime(fence_path, ns=(1, 1))
    assert reader.read_fence() == 3
    size_before = os.path.getsize(fence_path)
    LeasePlane(d).raise_fence(5)
    os.utime(fence_path, ns=(1, 1))
    assert os.path.getsize(fence_path) == size_before
    assert reader.read_fence() == 5


class _StubReplica:
    """The supervisor-facing replica surface, without a WAL."""

    def __init__(self, rid: str, head: int):
        self.replica_id = rid
        self.role = "replica"
        self.store = SimpleNamespace(head_version=head)

    def promote(self, epoch: int) -> dict:
        self.role = "primary"
        return {"head_version": self.store.head_version, "head_digest": None}

    def demote(self) -> None:
        self.role = "replica"


def _rival_scenario(kind, d):
    pk = PKG[kind]
    clock = {"now": 0.0}
    r0, r1 = _StubReplica("r0", 5), _StubReplica("r1", 3)
    sup = pk.c.ClusterSupervisor(d, [r0, r1], lease_ttl_ms=500.0, clock=lambda: clock["now"])
    doc = sup.tick()
    pk.c.LeasePlane(d).raise_fence(doc["epoch"] + 1)
    clock["now"] = 100.0
    doc2 = sup.tick()
    out = [untimed(doc), untimed(doc2), sup.promotions, sorted(r.role for r in (r0, r1))]
    sdoc = sup.doc()
    sdoc["last_promotion"] = untimed(sdoc["last_promotion"])
    return out + [sdoc]


def test_supervisor_tick_survives_rival_fence_like_jax(tmp_path):
    port = _rival_scenario("port", str(tmp_path / "port"))
    assert port == _rival_scenario("jax", str(tmp_path / "jax"))
    doc, doc2, promotions, roles = port[:4]
    assert doc["holder"] == "r0" and doc2["epoch"] > doc["epoch"] + 1
    assert promotions == 2 and roles == ["primary", "replica"]


def test_lease_keeper_renews_on_cadence(tmp_path, monkeypatch):
    clock = {"now": 0.0}
    plane = LeasePlane(str(tmp_path), clock=lambda: clock["now"])
    keeper = LeaseKeeper(plane, "w0", ttl_ms=300.0, renew_ms=100.0)
    assert keeper.acquire() is not None and keeper.epoch == 1
    assert keeper.maybe_renew() is False
    clock["now"] = 150.0
    assert keeper.maybe_renew() is True and keeper.record.renewed_ms == 150.0
    plane.raise_fence(5)
    clock["now"] = 300.0
    with pytest.raises(LeaseLostError):
        keeper.maybe_renew()
    # the knobs: the TTL and the renew cadence (a third of the TTL by default)
    monkeypatch.setenv("SKYLINE_CLUSTER_LEASE_TTL_MS", "900")
    k2 = LeaseKeeper(plane, "w1")
    assert (k2.ttl_ms, k2.renew_ms) == (900.0, 300.0)
    monkeypatch.setenv("SKYLINE_CLUSTER_LEASE_RENEW_MS", "50")
    j2 = jcluster.LeaseKeeper(jcluster.LeasePlane(str(tmp_path)), "w1")
    assert (LeaseKeeper(plane, "w1").renew_ms, j2.renew_ms) == (50.0, 50.0)
    assert ClusterSupervisor(str(tmp_path), []).lease_ttl_ms == 900.0


# -- the promotion drill --------------------------------------------------------------


def _promotion_drill(kind, d, rows):
    """The lease expires; the most caught-up replica is promoted under a
    raised fence; the deposed writer's next append is rejected and
    counted."""
    pk = PKG[kind]
    clock = {"now": 0.0}
    telem = pk.Telemetry()
    plane = pk.c.LeasePlane(d, clock=lambda: clock["now"])
    lease = plane.acquire("primary-0", ttl_ms=500.0)
    writer = pk.c.FencedWalWriter(d, lease.epoch, plane=plane, fsync="off")
    store = pk.serve.SnapshotStore()

    def shadow(prev, snap):
        writer.append(pk.serve.delta_wal_record(prev, snap))
        writer.flush(force=True)

    store.on_publish(shadow)
    for i in range(1, 6):
        store.publish(rows[: i * 8], watermark_id=i * 8, now_ms=1000.0 + i)
    writer.barrier({"type": "ckpt", "snap": pk.serve.snapshot_wal_record(store.latest())})
    store.publish(rows[:44], watermark_id=44, now_ms=1010.0)
    r0 = pk.Replica(d, replica_id="r0", start=False)
    r1 = pk.Replica(d, replica_id="r1", start=False)
    try:
        r0.bootstrap()
        while r0.apply_available():
            pass
        sup = pk.c.ClusterSupervisor(d, [r0, r1], lease_ttl_ms=500.0, telemetry=telem,
                                     clock=lambda: clock["now"])
        assert sup.tick() is None
        clock["now"] = 10_000.0
        doc = sup.tick()
        assert doc["time_to_promote_ms"] >= 0.0
        roles = (r0.role, r0.promoted_epoch, r1.role)
        with pytest.raises(pk.c.WalFencedError):
            writer.append({"type": "delta", "i": 99})
        with pytest.raises(pk.c.LeaseLostError):
            plane.renew(lease)
        clock["now"] = 10_100.0
        renewed = (sup.tick(), plane.read_lease().renewed_ms)
        sdoc = sup.doc()
        sdoc["last_promotion"] = untimed(sdoc["last_promotion"])
        segs = [(os.path.basename(p), open(p, "rb").read())
                for _, p in pk.wal.list_segments(d)]
        return dict(
            doc=untimed(doc), roles=roles, renewed=renewed, sdoc=sdoc,
            fenced=writer.fenced_writes, promotions=sup.promotions,
            counted=dict(telem.counters.snapshot())["cluster.promotions"],
            head=(store.head_version, store.latest().digest), segs=segs,
        )
    finally:
        r0.close()
        r1.close()
        writer.close()


def test_promotion_drill_matches_jax_and_an_independent_fold(tmp_path):
    rows = np.random.default_rng(5).random((44, 3)).astype(np.float32)
    port = _promotion_drill("port", str(tmp_path / "port"), rows)
    ref = _promotion_drill("jax", str(tmp_path / "jax"), rows)
    assert port == ref
    doc = port["doc"]
    assert doc["holder"] == "r0" and doc["deposed"] == "primary-0" and doc["epoch"] == 2
    assert port["roles"] == ("primary", doc["epoch"], "replica")
    assert (doc["head_version"], doc["head_digest"]) == port["head"]
    assert port["fenced"] == 1 and port["promotions"] == port["counted"] == 1
    assert port["renewed"] == (None, 10_100.0)
    assert {m["id"]: m["role"] for m in port["sdoc"]["members"]} == {
        "r0": "primary", "r1": "replica"}
    # the promoted head IS an independent fold of the durable WAL: the JAX
    # replica reading the port's files
    probe = JaxReplica(str(tmp_path / "port"), replica_id="probe", start=False)
    try:
        probe.bootstrap()
        while probe.apply_available():
            pass
        assert probe.store.latest().digest == doc["head_digest"]
        assert probe.store.head_version == doc["head_version"]
    finally:
        probe.close()


def test_cluster_status_doc_and_host_series(tmp_path):
    out = {}
    for kind in PKG:
        pk = PKG[kind]
        telem = pk.Telemetry()
        st = pk.c.ClusterStatus(node_id="n0", role="primary")
        st.lease_cb = lambda: {"fence": 3}
        st.coordinator_cb = lambda: {"last": {"per_host": [
            {"host": 0, "records": 5, "pruned": False, "skyline": 2},
            {"host": 1, "records": 7, "pruned": True, "skyline": 0}]}}
        st.telemetry = telem
        telem.inc("cluster.fenced_writes", 2)
        doc = st.doc()
        assert doc["enabled"] and doc["fence"] == 3 and doc["fenced_writes"] == 2
        series = st.labeled_series()
        bad = pk.c.ClusterStatus()
        bad.lease_cb = lambda: 1 / 0
        assert "lease_error" in bad.doc()
        out[kind] = (doc, series, bad.labeled_series())
    assert out["port"] == out["jax"]


# -- the host tournament ---------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", ["uniform", "correlated", "anti"])
def test_cluster_grid_matches_jax_and_flat(kind, policy, rounds_only):
    d = 4
    x = gen_points(np.random.default_rng(7), 600, d, kind)
    flat = _flat(d, policy)
    _feed_pset(flat, x)
    want = merge_state(flat)
    for hosts, chips in GRID:
        ctx = f"kind={kind} hosts={hosts} chips={chips} policy={policy}"
        jp = _jax(hosts, d, chips, policy)
        _feed_pset(jp, x)
        cp = _port(hosts, d, chips, policy)
        _feed_pset(cp, x)
        got = merge_state(cp)
        assert_same_merge(merge_state(jp), got, ctx=ctx + " vs jax")
        assert_same_merge(want, got, ctx=ctx + " vs flat")
        assert cp.cluster_stats() == jp.cluster_stats(), ctx
        assert cp.epoch_key == jp.epoch_key
        assert cp.flush_cascade_stats() == jp.flush_cascade_stats(), ctx
        assert cp.last_tree_info == jp.last_tree_info, ctx


def test_every_intermediate_query_and_the_cache_hit():
    d = 4
    x = gen_points(np.random.default_rng(8), 600, d, "uniform")
    sets = [_flat(d), _port(4, d, chips=2), _jax(4, d, chips=2)]
    n = x.shape[0]
    pids = np.arange(n) % P
    for lo in range(0, n, 150):
        hi = min(lo + 150, n)
        for ps in sets:
            for p in range(P):
                rows = np.ascontiguousarray(x[lo:hi][pids[lo:hi] == p])
                if rows.shape[0]:
                    ps.add_batch(p, rows, max_id=hi, now_ms=0.0)
            ps.flush_all()
        flat, port, ref = (merge_state(s) for s in sets)
        assert_same_merge(flat, port, ctx=f"after {hi} rows")
        assert_same_merge(ref, port, ctx=f"after {hi} rows, jax")
    again = merge_state(sets[1])
    assert_same_merge(merge_state(sets[0]), again, ctx="cache hit")
    merge_state(sets[2])
    assert sets[1].merge_cache_hits >= 1
    assert sets[1].cluster_stats() == sets[2].cluster_stats()


def test_host_prune_fires_ships_nothing_and_keeps_the_bytes():
    d = 2
    x = _skewed(np.random.default_rng(9), d)
    flat = _flat(d)
    _feed_pset(flat, x)
    cp, jp = _port(4, d, chips=2), _jax(4, d, chips=2)
    for s in (cp, jp):
        _feed_pset(s, x)
    assert_same_merge(merge_state(flat), merge_state(cp), ctx="pruned")
    merge_state(jp)
    stats = cp.cluster_stats()
    assert stats == jp.cluster_stats()
    assert stats["hosts_pruned"] > 0 and 0.0 < stats["host_pruned_fraction"] <= 0.75
    info = stats["last"]
    pruned_ids = {e["host"] for e in info["pruned"]}
    for e in info["pruned"]:
        assert e["witness"] not in pruned_ids
        assert info["per_host"][e["host"]]["pruned"]
    assert not (set(info["survivors"]) & pruned_ids)
    assert info["rows_saved"] > 0 and stats["rows_saved"] > 0


def test_host_prune_knob_disables(monkeypatch):
    monkeypatch.setenv("SKYLINE_CLUSTER_HOST_PRUNE", "0")
    d = 2
    x = _skewed(np.random.default_rng(10), d)
    flat = _flat(d)
    _feed_pset(flat, x)
    cp, jp = _port(4, d), _jax(4, d)
    for s in (cp, jp):
        _feed_pset(s, x)
    assert_same_merge(merge_state(flat), merge_state(cp), ctx="no prune")
    merge_state(jp)
    assert cp.cluster_stats()["hosts_pruned"] == 0
    assert cp.cluster_stats() == jp.cluster_stats()


AWKWARD = ("inf", "nan", "signed_zero", "mixed", "duplicates")


def _awkward_rows(kind: str, d: int, n: int = 400) -> np.ndarray:
    """Rows at the hazards of the value comparisons: +-inf, NaN, -0.0 against
    +0.0, a mix of them, and duplicates."""
    rng = np.random.default_rng(100 + AWKWARD.index(kind))
    x = (rng.integers(0, 6, (n, d)) / 4.0).astype(np.float32)
    if kind == "inf":
        x[rng.random((n, d)) < 0.1] = np.inf
        x[rng.random((n, d)) < 0.05] = -np.inf
    elif kind == "nan":
        x[rng.random((n, d)) < 0.08] = np.nan
    elif kind == "signed_zero":
        x[rng.random((n, d)) < 0.4] = 0.0
        x[rng.random((n, d)) < 0.3] = -0.0
    elif kind == "mixed":
        r = rng.random((n, d))
        x[r < 0.05] = np.inf
        x[(r >= 0.05) & (r < 0.1)] = np.nan
        x[(r >= 0.1) & (r < 0.3)] = -0.0
        x[(r >= 0.3) & (r < 0.35)] = -np.inf
    elif kind == "duplicates":
        x = np.repeat(x[: n // 8], 8, axis=0)
        rng.shuffle(x)
    return np.ascontiguousarray(x)



@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("hosts", [2, 4])
@pytest.mark.parametrize("rows", AWKWARD)
def test_awkward_rows_match_jax(rows, hosts, policy, rounds_only):
    d = 3
    x = _awkward_rows(rows, d)
    jp, cp = _jax(hosts, d, policy=policy), _port(hosts, d, policy=policy)
    for s in (jp, cp):
        _feed_pset(s, x)
    ctx = f"rows={rows} hosts={hosts} policy={policy}"
    got = merge_state(cp)
    assert_same_merge(merge_state(jp), got, ctx=ctx)
    assert cp.cluster_stats() == jp.cluster_stats(), ctx
    assert cp.sky_counts().tolist() == jp.sky_counts().tolist()


# -- elastic rebalance -------------------------------------------------------------------


def test_migrate_to_another_chip_count_keeps_the_next_answer():
    d = 4
    x = gen_points(np.random.default_rng(11), 500, d, "uniform")
    y = gen_points(np.random.default_rng(12), 200, d, "uniform")
    flat = _flat(d)
    _feed_pset(flat, x)
    base = merge_state(flat)
    _feed_pset(flat, y)
    after = merge_state(flat)
    docs = []
    for cp in (_port(2, d), _jax(2, d)):
        _feed_pset(cp, x)
        assert_same_merge(base, merge_state(cp), ctx="pre-migration")
        doc = cp.migrate(1, chips=2, reason="drill")
        assert doc["host"] == 1 and doc["chips"] == 2 and doc["source_fenced"]
        assert cp._member_chips == [1, 2] and cp.fenced_sources == 1
        assert_same_merge(base, merge_state(cp), ctx="post-migration")
        # ingest keeps routing to the new member
        _feed_pset(cp, y)
        assert_same_merge(after, merge_state(cp), ctx="post-ingest")
        assert doc.pop("wall_ms") >= 0
        docs.append((doc, dict(cp.cluster_stats(), last_migration=None)))
    assert docs[0] == docs[1] and docs[0][1]["migrations"] == 1


def test_migration_drains_the_facades_pending_rows():
    d = 2
    rows = gen_points(np.random.default_rng(13), 96, d, "uniform")
    for cp in (_port(2, d), _jax(2, d)):
        for p in range(P):
            cp.add_batch(p, rows[p * 12 : (p + 1) * 12], max_id=100, now_ms=0.0)
        assert cp.pending_rows_total == 96
        cp.migrate(1)
        G = cp.group_size
        assert int(cp._pending_rows[G:].sum()) == 0
        assert int(cp._pending_rows[:G].sum()) == 48 == cp.pending_rows_total


def test_migration_budget_exhausts(monkeypatch):
    monkeypatch.setenv("SKYLINE_CLUSTER_MIGRATION_BUDGET", "2")
    msgs = []
    for cp in (_port(2, 2), _jax(2, 2)):
        _feed_pset(cp, gen_points(np.random.default_rng(14), 100, 2, "uniform"))
        cp.migrate(0)
        cp.migrate(1)
        with pytest.raises(RuntimeError, match="budget") as e:
            cp.migrate(0)
        msgs.append(str(e.value))
        assert cp.cluster_stats()["migration_budget"] == 2
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_slice_checkpoint_restores_on_another_host(tmp_path, writer, reader):
    """Host 1's group checkpointed (either package's npz), then restored into
    another facade's empty host 1 at another chip count: the next answer is
    the flat engine's."""
    d = 4
    x = gen_points(np.random.default_rng(15), 500, d, "uniform")
    flat = _flat(d)
    _feed_pset(flat, x)
    base = merge_state(flat)
    make = {"port": _port, "jax": _jax}
    src = make[writer](2, d, chips=2)
    _feed_pset(src, x)
    path = str(tmp_path / "slice.npz")
    src.checkpoint_slice(1, path)
    dst = make[reader](2, d, chips=2)
    skies, pendings = src.audit_state()
    G = src.group_size
    empty = [np.empty((0, d), dtype=np.float32)] * G
    dst.restore_all(list(skies[:G]) + empty, list(pendings[:G]) + empty)
    doc = dst.restore_slice(1, path, chips=1)
    assert doc["source_fenced"] and doc["chips"] == 1 and doc["from"] == path
    assert dst._member_chips == [2, 1]
    assert_same_merge(base, merge_state(dst), ctx=f"{writer} slice into {reader}")


def test_slice_checkpoint_files_match_jax_and_detect_corruption(tmp_path):
    d = 2
    x = gen_points(np.random.default_rng(16), 200, d, "uniform")
    for kind, cp in (("port", _port(2, d)), ("jax", _jax(2, d))):
        _feed_pset(cp, x)
        cp.checkpoint_slice(0, str(tmp_path / f"{kind}.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    path = str(tmp_path / "port.npz")
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k].copy() for k in z.files}
    sky = next(k for k in arrays if k.startswith("sky_") and arrays[k].shape[0])
    arrays[sky][0, 0] += 1.0
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    for cp in (_port(2, d), _jax(2, d)):
        with pytest.raises(ValueError, match="CRC"):
            cp.restore_slice(0, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        _port(4, d).restore_slice(0, str(tmp_path / "jax.npz"))


def test_quarantined_host_migrates_through_the_health_hook():
    from skyline_tpu_torch.resilience.health import ChipHealth

    cp = _port(2, 2)
    _feed_pset(cp, gen_points(np.random.default_rng(17), 200, 2, "uniform"))
    base = merge_state(cp)
    health = ChipHealth(2)
    cp.attach_health(health)
    health.quarantine(1, "drill")
    assert 1 in health.quarantined()
    assert cp.maybe_failover() == [1]
    assert 1 not in health.quarantined()
    stats = cp.cluster_stats()
    assert stats["migrations"] == 1 and stats["last_migration"]["reason"] == "quarantined"
    assert "health" in stats
    assert_same_merge(base, merge_state(cp), ctx="post-quarantine")


def test_cluster_pset_validates_shape_like_jax():
    for kw in (dict(hosts=3), dict(hosts=0), dict(hosts=2, chips_per_host=3),
               dict(hosts=2, chips_per_host=0)):
        msgs = []
        for cls, extra in ((ClusterPartitionSet, dict(device="cpu")),
                           (jcluster.ClusterPartitionSet, {})):
            with pytest.raises(ValueError) as e:
                cls(P, 2, 64, **kw, **extra)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_cluster_facade_keeps_every_member_on_its_device():
    cp = _port(4, 3, chips=2)
    assert [str(d) for d in cp.devices] == ["cpu"] and str(cp.root_device) == "cpu"
    if not __import__("torch").cuda.is_available():
        # the default device is the card: without one it raises, never
        # falling back to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ClusterPartitionSet(P, 3, 64, hosts=2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ClusterEngine(EngineConfig(parallelism=4, dims=3), hosts=2)


# -- the engine and its surfaces ----------------------------------------------------------


def _run_engine(engine, x, trigger="0,0"):
    ids = np.arange(x.shape[0], dtype=np.int64)
    for lo in range(0, x.shape[0], 128):
        engine.process_records(ids[lo : lo + 128], x[lo : lo + 128])
    engine.process_trigger(trigger)
    out = []
    for _ in range(200):
        out.extend(engine.poll_results())
        if out:
            break
    return out


@pytest.mark.parametrize("hosts,chips", [(4, 2), (2, 1)])
def test_cluster_engine_matches_jax_and_flat(hosts, chips):
    d = 4
    cfg = dict(parallelism=4, dims=d, buffer_size=64, domain_max=1.0, emit_skyline_points=True)
    x = gen_points(np.random.default_rng(18), 500, d, "uniform")
    base = _run_engine(SkylineEngine(EngineConfig(**cfg, device="cpu")), x)
    telem, jtelem = Telemetry(), JaxTelemetry()
    eng = ClusterEngine(EngineConfig(**cfg, device="cpu"), hosts=hosts, chips_per_host=chips,
                        telemetry=telem)
    ref = jcluster.ClusterEngine(JaxConfig(**cfg), hosts=hosts, chips_per_host=chips,
                                 telemetry=jtelem)
    got = _run_engine(eng, x)
    want = _run_engine(ref, x)
    assert [untimed(r) for r in got] == [untimed(r) for r in want]
    assert [untimed(r) for r in got] == [untimed(r) for r in base]
    stats, jstats = eng.stats(), ref.stats()
    assert untimed(stats["cluster"]) == untimed(jstats["cluster"])
    assert stats["cluster"]["hosts"] == hosts and stats["cluster"]["merges"] >= 1
    per_host = stats["cluster"]["last"]["per_host"]
    assert len(per_host) == hosts and sum(r["records"] for r in per_host) == 500
    plan, jplan = telem.explain.latest(), jtelem.explain.latest()
    assert plan["merge"]["path"] == "cluster_tree" and plan["hosts"]["hosts"] == hosts
    assert plan["hosts"] == jplan["hosts"]
    assert untimed(plan["merge"]) == untimed(jplan["merge"])
    cdoc = telem.cluster.doc()
    assert cdoc["enabled"] and cdoc["hosts"]["hosts"] == hosts
    series = parse_prometheus_text(telem.render_prometheus())
    jseries = parse_prometheus_text(jtelem.render_prometheus())
    for fam in ("skyline_host_records_total", "skyline_host_pruned_total",
                "skyline_host_skyline_size"):
        assert series[fam] == jseries[fam], fam
    assert {lab["host"] for lab, _ in series["skyline_host_records_total"]} == {
        str(h) for h in range(hosts)}
    # a repeated trigger is an exact hit at the host level
    _run_engine(eng, x[:0], trigger="1,0")
    assert eng.pset.cluster_stats()["cache"]["hits"] >= 1


def test_cluster_engine_rejects_device_ingest_like_jax():
    msgs = []
    for make in (lambda: ClusterEngine(EngineConfig(parallelism=4, dims=2, ingest="device",
                                                    device="cpu"), hosts=2),
                 lambda: jcluster.ClusterEngine(JaxConfig(parallelism=4, dims=2,
                                                          ingest="device"), hosts=2)):
        with pytest.raises(ValueError, match="ingest") as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_stats_server_cluster_endpoints():
    from skyline_tpu_torch.metrics.httpstats import StatsServer
    from skyline_tpu_torch.telemetry.clusterview import ClusterView

    telem = Telemetry()
    srv = StatsServer(lambda: {"ok": 1}, port=0, telemetry=telem)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/cluster", timeout=10) as r:
            assert json.load(r) == {"ok": True, "enabled": False}
        status = ClusterStatus(node_id="n0", role="primary")
        status.lease_cb = lambda: {"fence": 3}
        telem.cluster = status
        with urllib.request.urlopen(base + "/cluster", timeout=10) as r:
            doc = json.load(r)
        assert doc["enabled"] and doc["node"] == "n0"
        assert doc["role"] == "primary" and doc["fence"] == 3
        # the overview: this very server as the one member (self-scrape)
        telem.clusterview = ClusterView([base])
        with urllib.request.urlopen(base + "/cluster/overview", timeout=30) as r:
            ov = json.load(r)
        assert ov["enabled"] and ov["fleet"]["size"] == 1 and ov["fleet"]["live"] == 1
        assert ov["members"][0]["role"] == "primary" and ov["findings"] == []
    finally:
        srv.close()


def test_serve_plane_cluster_endpoints(tmp_path, monkeypatch):
    """Replicas serve ``/cluster`` and ``/cluster/overview`` too."""
    from skyline_tpu_torch.resilience.wal import WalWriter

    d = str(tmp_path)
    w = WalWriter(d, fsync="off")
    w.append({"type": "delta", "from": 0, "to": 1, "d": 2, "entered": "", "left": "",
              "keep": [], "wm": 1})
    w.close()
    r = SkylineReplica(d, replica_id="r0", start=False)
    try:
        url = f"http://127.0.0.1:{r.port}"
        with urllib.request.urlopen(url + "/cluster", timeout=10) as resp:
            assert json.load(resp) == {"ok": True, "enabled": False}
        with urllib.request.urlopen(url + "/cluster/overview", timeout=10) as resp:
            assert json.load(resp) == {"ok": True, "enabled": False}
        r.telemetry.cluster = ClusterStatus(node_id="r0", role="replica")
        with urllib.request.urlopen(url + "/cluster", timeout=10) as resp:
            doc = json.load(resp)
        assert doc["enabled"] and doc["role"] == "replica"
        # members from the knob; the replica lists itself
        monkeypatch.setenv("SKYLINE_CLUSTERVIEW_MEMBERS", url)
        with urllib.request.urlopen(url + "/cluster/overview", timeout=30) as resp:
            ov = json.load(resp)
        assert ov["fleet"]["live"] == 1 and ov["members"][0]["role"] == "replica"
    finally:
        r.close()


def test_overview_aggregation_and_findings_match_jax():
    """The pure aggregation core on injected member docs (a split brain and
    a primary under the fleet fence), and the CLI's exit codes."""
    from skyline_tpu.telemetry import clusterview as jview
    from skyline_tpu_torch.telemetry import clusterview as tview

    hist = "\n".join(f'skyline_replica_tail_lag_ms_bucket{{le="{le}"}} {c}'
                     for le, c in (("1", 2), ("10", 8), ("+Inf", 10)))
    members = [
        {"url": "a", "ok": True, "healthz": {"ok": True, "role": "primary"},
         "cluster": {"enabled": True, "role": "primary", "node": "a",
                     "lease": {"epoch": 1}, "fence": 1,
                     "hosts": {"hosts": 4, "hosts_considered_total": 8,
                               "hosts_pruned_total": 2, "migrations": 1}},
         "metrics": {"skyline_snapshot_store_head_version": 9.0,
                     "skyline_cluster_fenced_writes_total": 3.0}},
        {"url": "b", "ok": True, "healthz": {"ok": True, "role": "primary"},
         "cluster": {"enabled": True, "role": "primary", "lease": {"epoch": 3}, "fence": 3},
         "metrics": {"skyline_snapshot_store_head_version": 7.0},
         "ops": {"enabled": True, "total": 4, "writers": 1}},
        {"url": "c", "ok": True, "healthz": {"ok": True, "role": "replica"},
         "metrics": dict(tview.parse_prometheus(hist),
                         skyline_snapshot_store_head_version=5.0)},
        {"url": "d", "ok": False, "error": "URLError: refused"},
    ]
    port = tview.overview_from_members(members, now_ms=1.0)
    assert port == jview.overview_from_members(members, now_ms=1.0)
    assert {f["name"] for f in port["findings"]} == {"multiple_primaries",
                                                     "primary_below_fence"}
    assert port["members"][2]["replication_lag_versions"] == 4
    assert tview.parse_prometheus(hist) == jview.parse_prometheus(hist)
    assert tview.hist_quantile(tview.parse_prometheus(hist), "skyline_replica_tail_lag_ms",
                               0.99) == jview.hist_quantile(
        jview.parse_prometheus(hist), "skyline_replica_tail_lag_ms", 0.99)
    assert tview.main([]) == 2
    assert tview.main(["http://127.0.0.1:9", "--timeout-s", "0.2"]) == 0


def test_clusterview_knobs(monkeypatch):
    from skyline_tpu_torch.telemetry.clusterview import ClusterView, overview_doc

    assert overview_doc(Telemetry()) == {"ok": True, "enabled": False}
    monkeypatch.setenv("SKYLINE_CLUSTERVIEW_TIMEOUT_S", "0.5")
    monkeypatch.setenv("SKYLINE_CLUSTERVIEW_OPS_TAIL", "7")
    cv = ClusterView(["http://127.0.0.1:9", ""])
    assert (cv.members, cv.timeout_s, cv.ops_tail) == (["http://127.0.0.1:9"], 0.5, 7)
    monkeypatch.setenv("SKYLINE_CLUSTERVIEW_MEMBERS", "http://127.0.0.1:9")
    doc = overview_doc(Telemetry())
    assert doc["enabled"] and doc["fleet"]["live"] == 0 and doc["members"][0]["ok"] is False


# -- the worker -----------------------------------------------------------------------------


def test_worker_with_cluster_hosts_matches_jax(tmp_path, monkeypatch):
    """``cluster_hosts`` with crash safety: the same output lines and WAL
    records as the JAX worker (the fencing token in every frame), the lease
    held, ``/cluster`` answering, and a second primary refused."""
    import test_torch_worker as tw

    monkeypatch.setattr(tw.jworker, "time", tw.PinnedClock())
    monkeypatch.setattr(tw.tworker, "time", tw.PinnedClock())
    monkeypatch.setenv("SKYLINE_CLUSTER_LEASE_TTL_MS", "600000")
    rows = gen_points(np.random.default_rng(19), 900, 3, "anti") * 10000.0
    lines = tw.lines_of(rows)
    cfg = dict(parallelism=4, dims=3, domain_max=10000.0, buffer_size=128)
    outs = {}
    for kind in ("port", "jax"):
        out, w = tw.drive(kind, lines, cfg, chunk=200, res_dir=tmp_path / kind,
                          cluster_hosts=2, mesh_chips=2, stats_port=0)
        assert type(w.engine).__name__ == "ClusterEngine"
        recs, _ = (twal if kind == "port" else jwal).read_records(str(tmp_path / kind / "wal"))
        outs[kind] = ([tw.untimed(x) for x in out],
                      [{k: v for k, v in r.items() if k != "ts"} for r in recs])
        assert {r.get("fence") for r in recs} == {1}
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][0]) == 1
    # the same stream through a flat worker: the same answer
    flat, _ = tw.drive("port", lines, cfg, chunk=200)
    assert [tw.untimed(x) for x in flat] == outs["port"][0]


def test_worker_lease_refuses_a_second_primary_and_demotes(tmp_path, monkeypatch):
    import test_torch_worker as tw

    monkeypatch.setenv("SKYLINE_CLUSTER_LEASE_TTL_MS", "600000")
    res = tw.ResilienceConfig(checkpoint_dir=str(tmp_path), wal_fsync="off")
    bus = tw.MemoryBus()
    cfg = EngineConfig(parallelism=2, dims=2, device="cpu")
    w = tw.tworker.SkylineWorker(bus, cfg, cluster_hosts=2, resilience=res, stats_port=0)
    try:
        lease = w.stats()["resilience"]["lease"]
        assert lease["epoch"] == 1 and not lease["deposed"]
        assert lease["lease"]["holder"] == w._lease_keeper.holder
        with urllib.request.urlopen(f"http://127.0.0.1:{w.stats_server.port}/cluster",
                                    timeout=10) as r:
            doc = json.load(r)
        assert doc["enabled"] and doc["role"] == "primary" and doc["hosts"]["hosts"] == 2
        with pytest.raises(ValueError, match="refusing to start a second primary"):
            tw.tworker.SkylineWorker(tw.MemoryBus(), cfg, cluster_hosts=2,
                                     resilience=tw.ResilienceConfig(
                                         checkpoint_dir=str(tmp_path), wal_fsync="off"))
        # a supervisor elsewhere fences past us: the next renewal demotes
        LeasePlane(os.path.join(str(tmp_path), "wal")).raise_fence(5)
        w._lease_keeper.record.renewed_ms -= 1e9  # the renewal is due
        assert w.step() == 0
        assert w._deposed and w.telemetry.cluster.role == "deposed"
        assert dict(w.telemetry.counters.snapshot())["cluster.demotions"] == 1
        with pytest.raises(WalFencedError):
            w._wal.append({"type": "delta", "i": 0})
        assert w._wal.fenced_writes == 1
        w.run_forever(stop_after_idle_s=0.0)  # exits at once, no final checkpoint
        assert w._ckpt_mgr.list() == []
    finally:
        w.close()

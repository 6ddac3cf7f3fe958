"""The chaos drill: ``scripts/chaos_smoke.sh`` on the port, its five legs.

1. ``crash``: a supervised worker (WAL + checkpoints, in-memory bus) under
   ``crash@kafka.poll:4,crash@flush.pre_merge:3`` (or
   ``SKYLINE_FAULT_PLAN``) ends byte-identical to an uninterrupted run of
   the same 600-row stream, with ``records_in == n``, restarts >= 1,
   ``wal.replayed`` > 0, ``checkpoint.saved`` >= 1 and
   ``skyline_resilience_restarts_total`` in the exposition.
2. ``audit``: ``corrupt@audit.corrupt:1`` flips a byte of a published
   snapshot; the audit plane counts one divergence, freezes a complete
   bundle, joins the flight ring, and the offline replay
   (``python -m skyline_tpu_torch.audit replay``) reproduces the diff and
   acquits the engine.
3. ``chip``: a 2-chip sharded engine under a 500 ms merge deadline, chip 1
   slowed by 2,000 ms and then killed: a degraded answer marked partial
   (the slow one inside 2,000 ms), quarantine, online failover, and a
   healed answer byte-identical to the uninterrupted one.
4. ``replica``: two WAL-tailing replicas, one fenced at 300 ms, track a
   primary byte for byte; the primary dies: the generous replica serves
   monotonically aging answers, the fenced one answers 503; the primary
   restarts and both reconverge through the tail with no re-bootstrap.
5. ``promotion``: a lease-holding primary goes dark; the cluster
   supervisor fences its epoch and promotes a replica inside the lease
   TTL, the promoted head serves the deposed primary's bytes, the zombie's
   append is rejected at the WAL layer, the deposed node rejoins demoted,
   and the ops journal alone reads ``lease_expired -> fence_raised ->
   promoted -> zombie_append_rejected -> demoted`` in seq order.

Every wait is polled with a deadline. ``bounds=False`` keeps every
outcome but drops the wall-clock bounds (the slow chip's 2,000 ms, the
fence's time to refuse, the promotion inside the TTL): the CPU tests run
that way under a loaded host, the card run holds the bounds.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np

from skyline_tpu_torch.deploy.drills.common import (
    env_scope,
    http,
    port_engine_config,
    say,
    sha256,
    wait_until,
)

CRASH_PLAN = "crash@kafka.poll:4,crash@flush.pre_merge:3"
# an incarnation that has not answered by then fails (and is restarted
# within the budget); the 600-row stream answers in well under a second
ANSWER_WAIT_S = 120.0
REPLICA_FENCE_MS = 300.0
# the reference's fenced replica is read 550 ms after the kill (four reads
# 50 ms apart, then 350 ms): the 503 must come by then
REPLICA_REFUSE_BY_MS = 550.0
PROMOTION_TTL_MS = 600.0


def port_ns(device: str) -> SimpleNamespace:
    from skyline_tpu_torch.bridge import MemoryBus, SkylineWorker
    from skyline_tpu_torch.bridge.wire import format_trigger, format_tuple_line
    from skyline_tpu_torch.cluster import (
        ClusterSupervisor,
        FencedWalWriter,
        LeasePlane,
        WalFencedError,
    )
    from skyline_tpu_torch.distributed import ShardedEngine
    from skyline_tpu_torch.resilience import ResilienceConfig
    from skyline_tpu_torch.resilience import faults
    from skyline_tpu_torch.resilience.supervisor import Supervisor
    from skyline_tpu_torch.resilience.wal import WalWriter
    from skyline_tpu_torch.serve import SkylineServer, SnapshotStore, delta_wal_record
    from skyline_tpu_torch.serve.replica import SkylineReplica
    from skyline_tpu_torch.serve.snapshot import points_digest
    from skyline_tpu_torch.stream import SkylineEngine
    from skyline_tpu_torch.telemetry import Telemetry
    from skyline_tpu_torch.telemetry.opslog import OpsLog, read_ops
    from skyline_tpu_torch.utils.knobs import env_str
    from skyline_tpu_torch.workload.generators import anti_correlated

    return SimpleNamespace(
        MemoryBus=MemoryBus, SkylineWorker=SkylineWorker, format_trigger=format_trigger,
        format_tuple_line=format_tuple_line, EngineConfig=port_engine_config(device),
        SkylineEngine=SkylineEngine, ShardedEngine=ShardedEngine,
        ResilienceConfig=ResilienceConfig, FaultPlan=faults.FaultPlan,
        install_plan=faults.install_plan, clear=faults.clear, Supervisor=Supervisor,
        Telemetry=Telemetry, anti_correlated=anti_correlated, WalWriter=WalWriter,
        SkylineServer=SkylineServer, SnapshotStore=SnapshotStore,
        delta_wal_record=delta_wal_record, SkylineReplica=SkylineReplica,
        points_digest=points_digest, ClusterSupervisor=ClusterSupervisor,
        FencedWalWriter=FencedWalWriter, LeasePlane=LeasePlane, WalFencedError=WalFencedError,
        OpsLog=OpsLog, read_ops=read_ops,
        fault_plan=env_str("SKYLINE_FAULT_PLAN") or CRASH_PLAN,
        replay_cmd=[sys.executable, "-m", "skyline_tpu_torch.audit", "replay"],
        replay_flags=["--device", device])


# -- 1. supervised crash/restart --------------------------------------------------


def _sha1_digest(doc):
    pts = np.asarray(doc["skyline_points"], dtype=np.float32)
    return doc["skyline_size"], hashlib.sha1(pts.tobytes()).hexdigest()


def _supervised(ns, rows, resilience, plan, telem):
    bus = ns.MemoryBus()
    bus.produce_many("input-tuples", [ns.format_tuple_line(i, r) for i, r in enumerate(rows)])
    out = bus.consumer("output-skyline", from_beginning=True)
    shared = {"sent": False, "lines": [], "w": None}
    if plan:
        ns.install_plan(ns.FaultPlan.parse(plan))

    def incarnation(attempt):
        # the crashed incarnation is abandoned without close(): the
        # in-process stand-in for a killed worker process
        w = ns.SkylineWorker(
            bus,
            ns.EngineConfig(parallelism=2, dims=3, domain_max=10000.0, buffer_size=128,
                            emit_skyline_points=True),
            resilience=resilience, telemetry=telem)
        shared["w"] = w
        deadline = time.monotonic() + ANSWER_WAIT_S
        while True:
            if time.monotonic() > deadline:
                raise AssertionError(f"no answer within {ANSWER_WAIT_S:.0f} s")
            if w.step(max_records=64):
                continue
            if not shared["sent"]:
                bus.produce("queries", ns.format_trigger(0, 0))
                shared["sent"] = True
                continue
            shared["lines"].extend(out.poll())
            if shared["lines"]:
                return json.loads(shared["lines"][-1])

    sup = ns.Supervisor(incarnation, max_restarts=6, backoff_base_s=0.0, backoff_cap_s=0.0,
                        telemetry=telem, sleep=lambda s: None)
    try:
        doc = sup.run()
        if resilience is not None:
            shared["w"].checkpoint_now()  # the shutdown barrier
    finally:
        ns.clear()
        shared["w"].close()
    return doc, shared["w"], sup


def crash_leg(ns, bounds: bool = True) -> dict:
    n = 600
    rows = ns.anti_correlated(np.random.default_rng(11), n, 3, 0, 10000)
    base_doc, _, base_sup = _supervised(ns, rows, None, None, ns.Telemetry())
    assert base_sup.restarts == 0
    telem = ns.Telemetry()  # shared across incarnations: counters accumulate
    ckpt = tempfile.mkdtemp(prefix="skyline-chaos-ckpt-")
    try:
        # interval 0: no periodic checkpoints, every recovery is WAL replay
        res = ns.ResilienceConfig(checkpoint_dir=ckpt, checkpoint_interval_s=0.0,
                                  wal_fsync="batch")
        doc, w, sup = _supervised(ns, rows, res, ns.fault_plan, telem)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    assert sup.restarts >= 1, "the fault plan never fired"
    assert w.engine.records_in == n, (w.engine.records_in, n)
    assert _sha1_digest(doc) == _sha1_digest(base_doc), (
        f"supervised {_sha1_digest(doc)} != uninterrupted {_sha1_digest(base_doc)}")
    counts = telem.counters.snapshot()
    assert counts["resilience.restarts"] == sup.restarts, counts
    assert counts.get("wal.replayed", 0) > 0, counts
    assert counts.get("checkpoint.saved", 0) >= 1, counts
    assert "skyline_resilience_restarts_total" in telem.render_prometheus(), (
        "restart counter missing from /metrics exposition")
    size, sha = _sha1_digest(doc)
    say("chaos", f"byte-identity ok: skyline_size={size} sha1={sha[:12]} "
        f"across {sup.restarts} injected crash(es)")
    say("chaos", f"counters ok: restarts={counts['resilience.restarts']} "
        f"wal.replayed={counts['wal.replayed']} checkpoint.saved={counts['checkpoint.saved']}")
    say("chaos", "PASS")
    return {"plan": ns.fault_plan, "skyline_size": size, "sha1": sha,
            "records_in": int(w.engine.records_in), "restarts": sup.restarts,
            "wal_replayed": counts["wal.replayed"], "checkpoint_saved": counts["checkpoint.saved"]}


# -- 2. audit divergence and offline replay ---------------------------------------


def audit_leg(ns, bounds: bool = True) -> dict:
    audit_dir = tempfile.mkdtemp(prefix="skyline-chaos-audit-")
    try:
        with env_scope(SKYLINE_AUDIT_DIR=audit_dir):
            ns.install_plan(ns.FaultPlan.parse("corrupt@audit.corrupt:1"))
            try:
                tel = ns.Telemetry()
                eng = ns.SkylineEngine(
                    ns.EngineConfig(parallelism=2, dims=3, domain_max=10000.0,
                                    emit_skyline_points=True),
                    telemetry=tel)
                eng.attach_snapshots(ns.SnapshotStore())
                x = ns.anti_correlated(np.random.default_rng(29), 1500, 3, 0, 10000)
                eng.process_records(np.arange(len(x)), x, now_ms=0.0)
                eng.process_trigger("q0,0", now_ms=1.0)
                eng.poll_results()
            finally:
                ns.clear()
            counts = tel.counters.snapshot()
            assert counts.get("audit.checks") == 1, counts
            assert counts.get("audit.divergence") == 1, counts
            doc = tel.audit.doc()
            assert doc["ok"] is False and doc["bundles"], doc
            bundle = doc["bundles"][0]
            files = ("manifest.json", "checkpoint.npz", "published.npy", "oracle.npy",
                     "explain.json")
            for fname in files:
                assert os.path.exists(os.path.join(bundle, fname)), (bundle, fname)
            notes = [e for e in tel.flight.snapshot() if e["kind"] == "audit.divergence"]
            assert notes and notes[-1]["trace_id"] == doc["last_divergence"]["trace_id"]
            r = subprocess.run([*ns.replay_cmd, bundle, "--json", *ns.replay_flags],
                               capture_output=True, text=True, timeout=300)
            assert r.returncode == 0, (r.returncode, r.stderr[-2000:])
            verdict = json.loads(r.stdout)
            assert verdict["reproduced"] is True, verdict
            assert verdict["engine_diverges"] is False, verdict
            published = np.load(os.path.join(bundle, "published.npy"))
            oracle = np.load(os.path.join(bundle, "oracle.npy"))
    finally:
        shutil.rmtree(audit_dir, ignore_errors=True)
    say("chaos", "audit drill ok: divergence detected, bundle frozen, replay reproduced "
        "the diff (engine acquitted)")
    return {"checks": counts["audit.checks"], "divergence": counts["audit.divergence"],
            "bundle_files": sorted(files), "reproduced": verdict["reproduced"],
            "engine_diverges": verdict["engine_diverges"],
            "published_sha256": sha256(np.ascontiguousarray(published).tobytes()),
            "oracle_sha256": sha256(np.ascontiguousarray(oracle).tobytes())}


# -- 3. chip fault tolerance ------------------------------------------------------


def chip_leg(ns, bounds: bool = True) -> dict:
    n, d = 2000, 3
    x = ns.anti_correlated(np.random.default_rng(5), n, d, 0, 10000)
    ids = np.arange(n)

    def build():
        return ns.ShardedEngine(
            ns.EngineConfig(parallelism=2, dims=d, domain_max=10000.0, buffer_size=256,
                            emit_skyline_points=True),
            chips=2, telemetry=ns.Telemetry())

    def answer(eng, q):
        eng.process_trigger(f"{q},0")
        (res,) = eng.poll_results()
        return res

    def pts_bytes(res):
        return np.asarray(res["skyline_points"], np.float32).tobytes()

    base = build()
    base.process_records(ids, x)
    truth = pts_bytes(answer(base, "t"))
    ev = {"truth_sha256": sha256(truth)}
    for action in ("slow", "crash"):
        eng = build()
        eng.process_records(ids, x)
        warm = answer(eng, "warm")  # first-call walls land before the deadline
        assert pts_bytes(warm) == truth
        with env_scope(SKYLINE_CHIP_MERGE_DEADLINE_MS="500", SKYLINE_CHIP_MERGE_RETRIES="0",
                       SKYLINE_FAULT_SLOW_MS="2000"):
            ns.install_plan(ns.FaultPlan.parse(f"{action}@sharded.chip_merge#1:1"))
            eng.pset._gm_cache = None  # same epoch: force the level-1 rerun
            t0 = time.perf_counter()
            deg = answer(eng, "fault")
            wall_ms = (time.perf_counter() - t0) * 1000.0
            ns.clear()
            for t in threading.enumerate():  # drain the abandoned slow attempt
                if t.name.startswith("chip1-merge"):
                    t.join(timeout=30)
        assert deg.get("partial") is True, f"{action}: answer not marked partial"
        assert deg["excluded_chips"] == [1], deg["excluded_chips"]
        assert 0.0 < deg["completeness_bound"] < 1.0, deg["completeness_bound"]
        if action == "slow" and bounds:
            # the deadline was honored: the answer did not wait out the stall
            assert wall_ms < 2000.0, f"slow drill took {wall_ms:.0f}ms"
        assert eng.health.quarantined() == [1]
        assert int(eng.telemetry.counters.get("degraded_answers")) == 1
        assert "skyline_degraded_answers_total 1" in eng.telemetry.render_prometheus()
        eng.pset._gm_cache = None
        healed = answer(eng, "heal")  # the merge launch runs the failover first
        assert "partial" not in healed
        assert eng.pset.failovers == 1 and eng.health.quarantined() == []
        assert pts_bytes(healed) == truth, f"{action}: post-heal answer diverged"
        lf = eng.pset.last_failover
        ev[action] = {"partial": True, "excluded_chips": deg["excluded_chips"],
                      "completeness_bound": deg["completeness_bound"],
                      "degraded_sha256": sha256(pts_bytes(deg)),
                      "failovers": eng.pset.failovers, "owner": lf["owner"],
                      "healed_sha256": sha256(pts_bytes(healed)), "wall_ms": wall_ms}
        say("chaos", f"chip drill ok: {action}@chip1 -> degraded ({wall_ms:.0f}ms, marked "
            f"partial) -> quarantined -> failover (owner={lf['owner']}, "
            f"{lf['wall_ms']:.1f}ms) -> healed byte-identical")
    return ev


# -- 4. read replicas across a primary's death and restart ------------------------


def _csv(port: int):
    status, body, headers = http(f"http://127.0.0.1:{port}/skyline?format=csv")
    assert status == 200, status
    return body, headers


def _staleness(port: int):
    status, body, _ = http(f"http://127.0.0.1:{port}/skyline?points=0")
    return status, json.loads(body)


def replica_leg(ns, bounds: bool = True, fence_ms: float = REPLICA_FENCE_MS) -> dict:
    wal_dir = tempfile.mkdtemp(prefix="skyline-replica-drill-")
    rng = np.random.default_rng(23)
    writer = ns.WalWriter(wal_dir, fsync="off")

    def shadow(prev, snap):
        writer.append(ns.delta_wal_record(prev, snap))
        writer.flush(force=True)

    store = ns.SnapshotStore()
    store.on_publish(shadow)
    primary = ns.SkylineServer(store, port=0)
    rep_a = ns.SkylineReplica(wal_dir, replica_id="rep-a", poll_interval_s=0.005, start=True)
    rep_b = ns.SkylineReplica(wal_dir, replica_id="rep-b", poll_interval_s=0.005,
                              max_stale_ms=fence_ms, start=True)
    ev = {"versions": []}
    try:
        # burst: every version byte-identical on both replicas
        for v in range(1, 7):
            store.publish(rng.random((96, 4)).astype(np.float32))
            assert rep_a.wait_for_version(v, timeout_s=10.0)
            assert rep_b.wait_for_version(v, timeout_s=10.0)
            pb, ph = _csv(primary.port)
            for rep in (rep_a, rep_b):
                rb, rh = _csv(rep.port)
                assert rh["X-Skyline-Version"] == ph["X-Skyline-Version"]
                assert sha256(rb) == sha256(pb), f"replica bytes diverged @v{v}"
            ev["versions"].append(sha256(pb))
        # ---- kill the primary ----
        writer.close()
        primary.close()
        t_kill = time.monotonic()
        stales = []
        for _ in range(4):
            # each read waits until the answer has aged past the last one
            def older():
                code, doc = _staleness(rep_a.port)
                assert code == 200, code
                if not stales or doc["staleness_ms"] > stales[-1]:
                    return doc["staleness_ms"]
                return None

            stales.append(wait_until(older, 10.0, "the generous replica's answer aging"))
        assert stales == sorted(stales) and stales[-1] > stales[0], stales

        def refused():
            code, doc = _staleness(rep_b.port)
            return (code, doc) if code == 503 else None

        code, doc = wait_until(refused, 10.0, "the fenced replica's 503")
        refuse_ms = (time.monotonic() - t_kill) * 1000.0
        assert code == 503 and doc["stale"] is True, (code, doc)
        if bounds:
            assert refuse_ms <= REPLICA_REFUSE_BY_MS, (
                f"the {fence_ms:.0f} ms fence refused only {refuse_ms:.0f} ms after the kill")
        # the generous replica still answers 200 past the fence
        assert _staleness(rep_a.port)[0] == 200
        ev.update(aging=True, fenced_status=code, fenced_stale=doc["stale"],
                  refuse_ms=refuse_ms)
        # ---- the primary restarts: a fresh WAL incarnation, the same chain ----
        writer2 = ns.WalWriter(wal_dir, fsync="off")

        def shadow2(prev, snap):
            writer2.append(ns.delta_wal_record(prev, snap))
            writer2.flush(force=True)

        store._subscribers = [shadow2]
        try:
            for _ in range(7, 10):
                store.publish(rng.random((96, 4)).astype(np.float32))
            assert rep_a.wait_for_version(9, timeout_s=10.0)
            assert rep_b.wait_for_version(9, timeout_s=10.0)
            for rep in (rep_a, rep_b):
                assert rep.rebootstraps == 0 and rep.bootstraps == 1
                assert rep.store.latest().points.tobytes() == store.latest().points.tobytes(), \
                    "post-restart divergence"
            code = wait_until(lambda: _staleness(rep_b.port)[0] == 200, 10.0,
                              "the fence clearing with fresh data")
            ev.update(reconverged_digest=ns.points_digest(store.latest().points),
                      head_version=store.head_version, rebootstraps=0, bootstraps=1)
        finally:
            writer2.close()
    finally:
        rep_a.close()
        rep_b.close()
        shutil.rmtree(wal_dir, ignore_errors=True)
    say("chaos", "replica drill ok: 6 versions byte-identical on 2 replicas -> primary "
        "killed -> honest aging + fenced 503 -> restart -> reconverged via tail "
        "(no re-bootstrap)")
    return ev


# -- 5. promotion and the ops journal's causal chain ------------------------------

CHAIN = ("lease_expired", "fence_raised", "promoted", "zombie_append_rejected", "demoted")


def promotion_leg(ns, bounds: bool = True) -> dict:
    wal_dir = tempfile.mkdtemp(prefix="skyline-promo-drill-")
    rng = np.random.default_rng(31)
    ttl = PROMOTION_TTL_MS
    plane = ns.LeasePlane(wal_dir)
    lease = plane.acquire("primary-0", ttl_ms=ttl)
    ops = ns.OpsLog(wal_dir, process_id="worker-drill-1", fsync="off")
    ops.record("lease_acquired", epoch=lease.epoch, holder=lease.holder)
    writer = ns.FencedWalWriter(wal_dir, lease.epoch, plane=plane, fsync="off", opslog=ops)

    def shadow(prev, snap):
        writer.append(ns.delta_wal_record(prev, snap))
        writer.flush(force=True)

    store = ns.SnapshotStore()
    store.on_publish(shadow)
    primary = ns.SkylineServer(store, port=0)
    rep_a = ns.SkylineReplica(wal_dir, replica_id="rep-a", poll_interval_s=0.005, start=True,
                              opslog=ops)
    rep_b = ns.SkylineReplica(wal_dir, replica_id="rep-b", poll_interval_s=0.005, start=True,
                              opslog=ops)
    writer2 = None
    try:
        for v in range(1, 7):
            store.publish(rng.random((96, 4)).astype(np.float32))
            lease = plane.renew(lease)
            assert rep_a.wait_for_version(v, timeout_s=10.0)
            assert rep_b.wait_for_version(v, timeout_s=10.0)
        pbytes, phead = _csv(primary.port)
        # ---- the primary goes dark: no more renewals, no more publishes ----
        primary.close()
        dark_t0 = time.perf_counter()
        sup = ns.ClusterSupervisor(wal_dir, [rep_a, rep_b], lease_ttl_ms=ttl, opslog=ops)
        doc = wait_until(sup.tick, 20 * ttl / 1000.0, "a promotion within 20x the lease TTL",
                         every_s=0.02)
        dark_ms = (time.perf_counter() - dark_t0) * 1000.0
        promoted = rep_a if doc["holder"] == "rep-a" else rep_b
        follower = rep_b if promoted is rep_a else rep_a
        assert doc["deposed"] == "primary-0", doc
        assert doc["epoch"] > lease.epoch, (doc["epoch"], lease.epoch)
        if bounds:
            assert doc["time_to_promote_ms"] < ttl, doc["time_to_promote_ms"]
        assert doc["head_digest"] == ns.points_digest(store.latest().points)
        rbytes, rhead = _csv(promoted.port)
        assert promoted.role == "primary"
        assert rhead["X-Skyline-Version"] == phead["X-Skyline-Version"]
        assert sha256(rbytes) == sha256(pbytes), "promoted head diverged"
        # the deposed epoch is fenced at the WAL layer: probe the writer, not
        # store.publish (which would advance the zombie's version chain)
        try:
            writer.append({"type": "delta", "probe": True})
            raise AssertionError("deposed primary's post-fence append landed")
        except ns.WalFencedError:
            pass
        assert writer.fenced_writes == 1, writer.fenced_writes
        assert sup.tick() is None
        assert not plane.read_lease().expired(time.time() * 1000.0)
        # ---- the new epoch writes; the deposed node rejoins demoted ----
        writer2 = ns.FencedWalWriter(wal_dir, doc["epoch"], plane=plane, fsync="off")

        def shadow2(prev, snap):
            writer2.append(ns.delta_wal_record(prev, snap))
            writer2.flush(force=True)

        store._subscribers = [shadow2]
        head = store.head_version
        rejoin = ns.SkylineReplica(wal_dir, replica_id="primary-0-rejoined",
                                   poll_interval_s=0.005, start=True)
        try:
            promoted.demote()
            assert promoted.role == "replica"
            for _ in range(head + 1, head + 3):
                store.publish(rng.random((96, 4)).astype(np.float32))
            for rep in (promoted, follower, rejoin):
                assert rep.wait_for_version(head + 2, timeout_s=10.0), rep.replica_id
                assert rep.store.latest().points.tobytes() == \
                    store.latest().points.tobytes(), f"{rep.replica_id} diverged after rejoin"
        finally:
            rejoin.close()
        # ---- the whole story from the durable ops journal alone ----
        recs = ns.read_ops(wal_dir)["records"]
        chain = [r for r in recs if r["type"] in CHAIN]
        assert [r["type"] for r in chain] == list(CHAIN), [r["type"] for r in chain]
        seqs = [r["seq"] for r in chain]
        assert seqs == sorted(seqs), f"causal chain out of seq order: {seqs}"
        by = {r["type"]: r for r in chain}
        new_epoch = doc["epoch"]
        assert by["lease_expired"]["epoch"] == lease.epoch < new_epoch
        assert by["fence_raised"]["fence"] == new_epoch
        assert "cut_seq" in by["fence_raised"], by["fence_raised"]
        assert by["promoted"]["epoch"] == new_epoch
        assert by["promoted"]["holder"] == doc["holder"]
        assert by["zombie_append_rejected"]["fence"] == new_epoch
        assert by["zombie_append_rejected"]["epoch"] == lease.epoch
        assert by["demoted"]["replica"] == doc["holder"]
        ev = {"holder": doc["holder"], "deposed": doc["deposed"], "old_epoch": lease.epoch,
              "epoch": new_epoch, "head_digest": doc["head_digest"],
              "promoted_csv_sha256": sha256(rbytes), "fenced_writes": writer.fenced_writes,
              "chain": [r["type"] for r in chain], "seqs": seqs,
              "rejoined_digest": ns.points_digest(store.latest().points),
              "time_to_promote_ms": doc["time_to_promote_ms"], "dark_ms": dark_ms}
        say("chaos", f"promotion drill ok: primary dark -> fenced + promoted {doc['holder']} "
            f"(epoch {doc['epoch']}, promote {doc['time_to_promote_ms']:.1f}ms, dark "
            f"{dark_ms:.0f}ms) -> HTTP byte-identical -> zombie append rejected -> rejoined "
            f"demoted, reconverged at the new epoch; causal chain {'->'.join(CHAIN)} "
            f"reconstructed from the ops journal alone, seqs {seqs}")
    finally:
        rep_a.close()
        rep_b.close()
        if writer2 is not None:
            writer2.close()
        writer.close()
        ops.close()
        shutil.rmtree(wal_dir, ignore_errors=True)
    return ev


LEGS = (("crash", crash_leg), ("audit", audit_leg), ("chip", chip_leg),
        ("replica", replica_leg), ("promotion", promotion_leg))


def main(device: str, bounds: bool = True) -> dict:
    from skyline_tpu_torch.deploy.drills.common import reset_process_state

    ns = port_ns(device)
    out = {}
    for name, leg in LEGS:
        reset_process_state()
        out[name] = leg(ns, bounds)
    return out

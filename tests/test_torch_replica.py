"""The port's read replicas (``skyline_tpu_torch/serve/replica.py``) on the
CPU against the JAX package's ``SkylineReplica``.

- A primary-shaped pipeline (a ``SnapshotStore`` whose publish hook shadows
  every transition into a WAL, as the worker does), driven with the same
  seeded rows and clock in both packages: the WAL segment bytes agree; each
  package's replica folds either package's WAL to the primary's snapshot
  bytes, digest and meta at every common version, over HTTP too.
- The honesty contract: the staleness fence (503 with Retry-After, never
  overridden by ``allow_stale``); ``restored``, ``partial`` and
  ``excluded_chips`` carried through a bootstrap.
- Failure handling, each against the JAX replica on the same WAL bytes: a
  torn live tail holds; corruption, a segment gone, a digest mismatch and a
  chain break re-bootstrap from the newest barrier and converge; a tail
  crash is supervised.
- The worker's in-process ``replicas`` and the ``--replica-of`` CLI,
  against the JAX worker's; the audit bundle's ``wal/`` copy against the
  JAX bundle's.
- The import boundary: ``skyline_tpu_torch.serve.replica`` imports neither
  ``jax`` nor ``skyline_tpu``.

Tolerance: exact bytes everywhere.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import struct
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import skyline_tpu.resilience.wal as jwal
import skyline_tpu.serve as jserve
import skyline_tpu_torch.resilience.wal as twal
import skyline_tpu_torch.serve as tserve
from skyline_tpu.resilience import faults as jfaults
from skyline_tpu.serve.replica import ReplicaDivergence as JaxDivergence
from skyline_tpu.serve.replica import SkylineReplica as JaxReplica
from skyline_tpu.telemetry import Telemetry as JaxTelemetry
from skyline_tpu_torch.resilience import faults as tfaults
from skyline_tpu_torch.serve.replica import ReplicaDivergence, SkylineReplica
from skyline_tpu_torch.telemetry import Telemetry

REPO = Path(__file__).resolve().parents[1]

PKG = {
    "jax": dict(wal=jwal, serve=jserve, Replica=JaxReplica, Divergence=JaxDivergence,
                faults=jfaults, Telemetry=JaxTelemetry),
    "port": dict(wal=twal, serve=tserve, Replica=SkylineReplica, Divergence=ReplicaDivergence,
                 faults=tfaults, Telemetry=Telemetry),
}


@pytest.fixture
def t0():
    """The publish clock a test's primaries start from: shared by both
    packages' primaries, so their WAL bytes agree, and taken when the test
    starts, so no replica's staleness fence trips."""
    return float(int(time.time() * 1000.0))


@pytest.fixture(autouse=True)
def _clear_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _get(url, timeout=10):
    """(status, json doc, headers); an HTTPError gives its status."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.load(r), dict(r.headers)
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, (json.loads(body) if body else {}), dict(e.headers)


def _get_raw(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read(), dict(r.headers)


class Primary:
    """A primary-shaped publish pipeline of one package: a snapshot store
    whose publish hook shadows every transition into a WAL."""

    def __init__(self, kind, directory, t0, **writer_kw):
        m = PKG[kind]
        self.m = m
        self.writer = m["wal"].WalWriter(str(directory), fsync="off", **writer_kw)
        self.store = m["serve"].SnapshotStore()
        self.store.on_publish(self._shadow)
        self.clock = t0

    def _shadow(self, prev, snap):
        self.writer.append(self.m["serve"].delta_wal_record(prev, snap))
        self.writer.flush(force=True)

    def publish(self, pts, **meta):
        self.clock += 10.0
        return self.store.publish(pts, watermark_id=self.store.head_version + 1,
                                  now_ms=self.clock, **meta)

    def barrier(self):
        rec = {"type": "ckpt"}
        snap = self.store.latest()
        if snap is not None:
            rec["snap"] = self.m["serve"].snapshot_wal_record(snap)
        self.writer.barrier(rec)

    def close(self):
        self.writer.close()


def _rows(seed, n, d):
    return [np.random.default_rng(seed + i).random((n, d)).astype(np.float32)
            for i in range(12)]


def _segments(directory):
    return [(Path(p).name, Path(p).read_bytes()) for _, p in twal.list_segments(str(directory))]


def _head(rep):
    snap = rep.store.latest()
    return (rep.store.head_version, snap.points.tobytes(), snap.digest, snap.meta,
            snap.watermark_id, snap.timestamp_ms)


def _drain(rep):
    while rep.apply_available():
        pass


# -- byte identity: WAL, fold, HTTP ------------------------------------------------


def test_wal_bytes_and_every_fold_match_jax(tmp_path, t0):
    """The same publishes in both packages write the same WAL segments; each
    package's replica folds each package's WAL to the primary's head at
    every version, bootstrapping from the barrier."""
    rows = _rows(3, 30, 3)
    prims = {k: Primary(k, tmp_path / k, t0) for k in PKG}
    for p in prims.values():
        for r in rows[:3]:
            p.publish(r)
        p.barrier()
        for r in rows[3:5]:
            p.publish(r)
    assert _segments(tmp_path / "jax") == _segments(tmp_path / "port")
    reps = {(rk, wk): PKG[rk]["Replica"](str(tmp_path / wk), replica_id=f"{rk}-{wk}",
                                          start=False)
            for rk in PKG for wk in PKG}
    try:
        for rep in reps.values():
            rep.bootstrap()
            assert rep.store.head_version == 5 and rep.store.restored
        heads = {k: _head(r) for k, r in reps.items()}
        assert len(set(map(repr, heads.values()))) == 1
        assert heads[("port", "port")][1] == prims["port"].store.latest().points.tobytes()
        for r in rows[5:9]:
            for p in prims.values():
                p.publish(r)
            for rep in reps.values():
                assert rep.apply_available() == 1
            want = prims["jax"].store.latest()
            for rep in reps.values():
                snap = rep.store.latest()
                assert rep.store.head_version == want.version
                assert snap.points.tobytes() == want.points.tobytes()
                assert snap.digest == want.digest
                assert not rep.store.restored
        assert _segments(tmp_path / "jax") == _segments(tmp_path / "port")
        assert {r.records_applied for r in reps.values()} == {4}
    finally:
        for rep in reps.values():
            rep.close()
        for p in prims.values():
            p.close()


def test_http_bytes_identical_to_primary_and_jax(tmp_path, t0):
    rows = _rows(5, 50, 4)
    out = {}
    for kind in PKG:
        m = PKG[kind]
        p = Primary(kind, tmp_path / kind, t0)
        srv = m["serve"].SkylineServer(p.store, port=0)
        rep = m["Replica"](str(tmp_path / kind), start=False)
        try:
            for r in rows[:3]:
                p.publish(r)
                rep.apply_available()
            _, pb, ph = _get_raw(f"http://127.0.0.1:{srv.port}/skyline?format=csv")
            _, rb, rh = _get_raw(f"http://127.0.0.1:{rep.port}/skyline?format=csv")
            assert ph["X-Skyline-Version"] == rh["X-Skyline-Version"] == "3"
            assert hashlib.sha256(pb).digest() == hashlib.sha256(rb).digest()
            assert ph["X-Skyline-Digest"] == rh["X-Skyline-Digest"]
            code, doc, _ = _get(f"http://127.0.0.1:{rep.port}/healthz")
            assert code == 200 and doc["role"] == "replica"
            out[kind] = (rb, rh["X-Skyline-Digest"])
        finally:
            rep.close()
            srv.close()
            p.close()
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_chain_break_raises_divergence(tmp_path, kind, t0):
    m = PKG[kind]
    p = Primary(kind, tmp_path, t0)
    p.publish(_rows(1, 10, 3)[0])
    rep = m["Replica"](str(tmp_path), start=False)
    try:
        rep.apply_available()
        with pytest.raises(m["Divergence"], match="version chain break"):
            rep._apply({"type": "delta", "from": 7, "to": 8, "wm": -1, "d": 3,
                        "entered": "", "left": ""})
        assert isinstance(m["Divergence"]("x"), m["wal"].WalError)
    finally:
        rep.close()
        p.close()


# -- the honesty contract -----------------------------------------------------------


def test_staleness_fence_refuses_with_503_like_jax(tmp_path, t0):
    docs = {}
    for kind in PKG:
        m = PKG[kind]
        p = Primary(kind, tmp_path / kind, t0)
        p.store.publish(_rows(2, 10, 3)[0], now_ms=time.time() * 1000.0 - 60_000.0)
        rep = m["Replica"](str(tmp_path / kind), start=False, max_stale_ms=100.0)
        try:
            rep.apply_available()
            url = f"http://127.0.0.1:{rep.port}/skyline"
            code, doc, headers = _get(url)
            assert code == 503 and doc["stale"] is True and doc["role"] == "replica"
            assert doc["staleness_ms"] > doc["max_stale_ms"] == 100.0
            assert "Retry-After" in headers
            # allow_stale bounds the client's tolerance, never the replica's
            code2, doc2, _ = _get(url + "?allow_stale=1&max_age_ms=600000")
            assert code2 == 503 and doc2["error"] == "staleness fence exceeded"
            assert rep.server.admission.counters.snapshot()["fence_rejected"] == 2
            code3, health, _ = _get(f"http://127.0.0.1:{rep.port}/healthz")
            assert code3 == 200 and health["role"] == "replica"
            # a fresh publish clears the fence
            p.store.publish(_rows(2, 10, 3)[1])
            rep.apply_available()
            code4, fresh, _ = _get(url)
            assert code4 == 200 and fresh["staleness_ms"] <= 100.0
            docs[kind] = (sorted(doc), sorted(doc2), headers["Retry-After"], sorted(fresh))
        finally:
            rep.close()
            p.close()
    assert docs["port"] == docs["jax"]


def test_restored_partial_and_excluded_chips_carried_through(tmp_path, t0):
    rows = _rows(4, 10, 3)
    got = {}
    for kind in PKG:
        m = PKG[kind]
        p = Primary(kind, tmp_path / kind, t0)
        p.publish(rows[0])
        p.publish(rows[1], partial=True, excluded_chips=[1, 3])
        rep = m["Replica"](str(tmp_path / kind), start=False)
        try:
            rep.apply_available()
            assert rep.store.latest().meta == {"partial": True, "excluded_chips": [1, 3]}
            code, doc, _ = _get(f"http://127.0.0.1:{rep.port}/skyline?points=0")
            assert code == 200 and doc["partial"] is True and doc["excluded_chips"] == [1, 3]
            p.barrier()
            rep2 = m["Replica"](str(tmp_path / kind), start=False, replica_id="rep2")
            try:
                rep2.bootstrap()
                assert rep2.store.latest().meta == {"partial": True, "excluded_chips": [1, 3]}
                _, doc2, _ = _get(f"http://127.0.0.1:{rep2.port}/skyline?points=0")
                assert doc2["partial"] is True and doc2["restored"] is True
                head2 = _head(rep2)
            finally:
                rep2.close()
            p.publish(rows[2])
            rep.apply_available()
            assert rep.store.latest().meta == {}
            got[kind] = (head2, _head(rep), {k: doc[k] for k in ("partial", "excluded_chips",
                                                                 "version", "restored")
                                             if k in doc})
        finally:
            rep.close()
            p.close()
    assert got["port"] == got["jax"]


# -- failure handling -----------------------------------------------------------------


def _corrupt_tail(directory):
    """A full-length frame with a bad CRC appended to the live segment."""
    _, path = twal.list_segments(str(directory))[-1]
    payload = b'{"type":"delta"}'
    with open(path, "ab") as f:
        f.write(struct.pack("<II", len(payload), 0xBAD) + payload)


def _torn_tail(directory):
    """Half a frame header at the live tail: the writer mid-append."""
    _, path = twal.list_segments(str(directory))[-1]
    with open(path, "ab") as f:
        f.write(b"\x10\x00")


FAILURES = ("torn_tail", "corruption", "segment_gone", "digest_mismatch", "chain_break")


def _failure_run(kind, directory, failure, t0):
    """One replica (not started: driven step by step) through one failure
    kind: publishes, the failure, a recovery barrier and a publish past it.
    Returns what the replica saw at each step."""
    m = PKG[kind]
    rows = _rows(11, 20, 3)
    p = Primary(kind, directory, t0)
    rep = m["Replica"](str(directory), replica_id="r", start=False, poll_interval_s=0.001)
    steps = []
    try:
        for r in rows[:3]:
            p.publish(r)
        rep.bootstrap()
        steps.append(("boot", _head(rep)))
        if failure == "torn_tail":
            _torn_tail(directory)
            assert rep.apply_available() == 0  # a tear holds position
            steps.append(("held", _head(rep), rep.rebootstraps))
            p.barrier()
            p.publish(rows[3])
            err = None
            try:
                _drain(rep)
            except m["wal"].WalError as e:
                err = type(e).__name__
            steps.append(("after_tear", err))
        elif failure == "corruption":
            _corrupt_tail(directory)
            with pytest.raises(m["wal"].WalTailCorruption):
                rep.apply_available()
            steps.append(("raised", "WalTailCorruption"))
        elif failure == "segment_gone":
            # a newer segment appears and the tailer's own is pruned under it
            seq = rep._tailer.stats()["segment_seq"]
            p.barrier()
            os.unlink(dict(m["wal"].list_segments(str(directory)))[seq])
            with pytest.raises(m["wal"].WalSegmentGone):
                _drain(rep)
            steps.append(("raised", "WalSegmentGone"))
        elif failure == "digest_mismatch":
            rec = dict(m["serve"].delta_wal_record(p.store.latest(), p.store.latest()))
            rec.update({"from": p.store.head_version, "to": p.store.head_version + 1,
                        "digest": "0" * 40})
            p.writer.append(rec)
            p.writer.flush(force=True)
            with pytest.raises(m["Divergence"], match="digest mismatch"):
                rep.apply_available()
            steps.append(("raised", "digest"))
        elif failure == "chain_break":
            rec = dict(m["serve"].delta_wal_record(None, p.store.latest()))
            rec.update({"from": 99, "to": 100})
            p.writer.append(rec)
            p.writer.flush(force=True)
            with pytest.raises(m["Divergence"], match="version chain break"):
                rep.apply_available()
            steps.append(("raised", "chain"))
        if failure != "torn_tail":
            # the supervised loop's fallback: count it, re-bootstrap from the
            # newest barrier once the primary writes one past the damage
            p.barrier()
            rep._rebootstrap(RuntimeError(failure))
            steps.append(("rebootstrapped", _head(rep), rep.rebootstraps, rep.bootstraps))
            p.publish(rows[8])
            _drain(rep)
        want = p.store.latest()
        assert rep.store.head_version == want.version
        assert rep.store.latest().points.tobytes() == want.points.tobytes()
        assert rep.store.latest().digest == want.digest
        steps.append(("converged", _head(rep), rep.stats()["replica"]["rebootstraps"]))
    finally:
        rep.close()
        p.close()
    return steps


@pytest.mark.parametrize("failure", FAILURES)
def test_rebootstrap_on_failure_converges_like_jax(tmp_path, failure, t0):
    port = _failure_run("port", tmp_path / "port", failure, t0)
    ref = _failure_run("jax", tmp_path / "jax", failure, t0)
    assert port == ref


def test_supervised_loop_rebootstraps_on_corruption(tmp_path, t0):
    """The live (started) replica: corruption under the tailer re-bootstraps
    while the last verified head keeps serving; the primary's next barrier
    lands past the damage and the replica converges."""
    p = Primary("port", tmp_path, t0)
    rows = _rows(6, 20, 3)
    for r in rows[:3]:
        p.publish(r)
    rep = SkylineReplica(str(tmp_path), poll_interval_s=0.005, start=True)
    try:
        assert rep.wait_for_version(3, timeout_s=10.0)
        _corrupt_tail(tmp_path)
        deadline = time.monotonic() + 10.0
        while rep.rebootstraps == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rep.rebootstraps >= 1 and "WalTailCorruption" in rep.last_error
        code, doc, _ = _get(f"http://127.0.0.1:{rep.port}/skyline?points=0")
        assert code == 200 and doc["version"] == 3
        p.barrier()
        p.publish(rows[3])
        assert rep.wait_for_version(4, timeout_s=10.0)
        assert rep.store.latest().points.tobytes() == p.store.latest().points.tobytes()
    finally:
        rep.close()
        p.close()


def test_tail_crash_is_supervised(tmp_path, t0):
    p = Primary("port", tmp_path, t0)
    rows = _rows(7, 10, 3)
    p.publish(rows[0])
    tfaults.install_plan(tfaults.FaultPlan.parse("crash@replica.tail:1"))
    rep = SkylineReplica(str(tmp_path), poll_interval_s=0.005, backoff_base_s=0.01, start=True)
    try:
        p.publish(rows[1])
        assert rep.wait_for_version(2, timeout_s=10.0)
        assert rep.supervisor.stats()["restarts"] >= 1
        assert rep.store.latest().points.tobytes() == p.store.latest().points.tobytes()
    finally:
        rep.close()
        p.close()


def test_labeled_series_stats_and_hub_withdrawal(tmp_path, t0):
    """The replica's labeled families and stats block have the JAX
    replica's keys; a replica sharing a hub withdraws on close."""
    docs = {}
    for kind in PKG:
        m = PKG[kind]
        p = Primary(kind, tmp_path / kind, t0)
        p.publish(_rows(8, 10, 3)[0])
        hub = m["Telemetry"]()
        rep = m["Replica"](str(tmp_path / kind), replica_id="r0", start=False, telemetry=hub,
                           primary_head_cb=lambda s=p.store: s.head_version)
        assert rep in hub.replication
        rep.apply_available()
        counters, gauges = rep.labeled_series()
        st = rep.stats()["replica"]
        st.pop("wal_dir")
        st["tailer"] = sorted(st["tailer"])
        prom = [ln for ln in hub.render_prometheus().splitlines() if "replica" in ln
                and not ln.startswith("#") and "lag_ms" not in ln]
        rep.close()
        assert rep not in hub.replication
        docs[kind] = (counters, {k: v for k, v in gauges.items() if k != "replica_lag_ms"}, st,
                      prom)
        p.close()
    assert docs["port"] == docs["jax"]


def test_promote_and_demote_round_trip(tmp_path, t0):
    p = Primary("port", tmp_path, t0)
    rows = _rows(9, 12, 2)
    p.publish(rows[0])
    rep = SkylineReplica(str(tmp_path), replica_id="r0", start=False)
    try:
        info = rep.promote(epoch=7)
        assert rep.role == "primary" and rep.server.role == "primary"
        assert info == {"head_version": 1, "head_digest": p.store.latest().digest}
        assert rep.stats()["replica"]["promoted_epoch"] == 7
        rep.demote()
        assert rep.role == "replica" and rep.server.role == "replica"
        assert rep.promoted_epoch is None
        p.publish(rows[1])
        assert rep.wait_for_version(p.store.head_version, timeout_s=10.0)
        assert rep.store.latest().points.tobytes() == p.store.latest().points.tobytes()
    finally:
        rep.close()
        p.close()


# -- the worker's replicas and the replica CLI ---------------------------------------


def _worker_run(kind, tmp_path, replicas=2):
    """A worker with the serving plane, crash safety and ``replicas`` read
    replicas, over two windows of seeded rows: per version, the primary's
    head and each replica's (points, digest, meta)."""
    import test_torch_worker as tw

    rng = np.random.default_rng(21)
    bus = tw.JBus() if kind == "jax" else tw.MemoryBus()
    res = (tw.JRes if kind == "jax" else tw.ResilienceConfig)(
        checkpoint_dir=str(tmp_path / kind), wal_fsync="off")
    serve_cfg = PKG[kind]["serve"].ServeConfig()
    w = tw.make(kind, bus, dict(parallelism=2, algo="mr-angle", dims=3, domain_max=10000.0,
                                buffer_size=512),
                serve_port=0, serve_config=serve_cfg, resilience=res, replicas=replicas)
    seen = []
    try:
        assert len(w.replicas) == replicas
        for window in range(2):
            pts = rng.random((400, 3)).astype(np.float32) * 10000.0
            bus.produce_many("input-tuples", tw.lines_of(pts, start=window * 400))
            bus.produce("queries", f"q{window},0")
            while w.step() > 0:
                pass
            store = w.serve_server.store
            head = store.latest()
            for rep in w.replicas:
                assert rep.wait_for_version(store.head_version, timeout_s=20.0)
                snap = rep.store.get(store.head_version)
                assert snap.points.tobytes() == head.points.tobytes()
                assert snap.digest == head.digest
                _, rb, rh = _get_raw(f"http://127.0.0.1:{rep.port}/skyline?format=csv")
                _, pb, ph = _get_raw(f"http://127.0.0.1:{w.serve_server.port}/skyline"
                                     "?format=csv")
                assert rb == pb and rh["X-Skyline-Digest"] == ph["X-Skyline-Digest"]
                code, doc, _ = _get(f"http://127.0.0.1:{rep.port}/healthz")
                assert code == 200 and doc["role"] == "replica"
            seen.append((store.head_version, head.points.tobytes(), head.digest,
                         [r.store.head_version for r in w.replicas]))
        stats = w.stats()
        assert stats["resilience"]["wal"]["appends"] > 0
    finally:
        w.close()
    return seen


def test_worker_replicas_track_every_publish_like_jax(tmp_path):
    # the event clock stays real: a pinned one would age every snapshot past
    # the replicas' staleness fence (the compared bytes carry no time)
    port = _worker_run("port", tmp_path)
    ref = _worker_run("jax", tmp_path)
    assert port == ref and len(port) == 2
    # the port's WAL, read as files, folds under the JAX replica to the
    # port primary's last head
    rep = JaxReplica(str(tmp_path / "port" / "wal"), replica_id="probe", start=False)
    try:
        rep.bootstrap()
        _drain(rep)
        assert rep.store.head_version == port[-1][0]
        assert rep.store.latest().points.tobytes() == port[-1][1]
        assert rep.store.latest().digest == port[-1][2]
    finally:
        rep.close()


def test_worker_replicas_need_resilience_and_serve(tmp_path):
    import test_torch_worker as tw

    for kw in (dict(), dict(serve_port=0)):
        errs = []
        for kind in PKG:
            bus = tw.JBus() if kind == "jax" else tw.MemoryBus()
            with pytest.raises(ValueError) as e:
                tw.make(kind, bus, dict(dims=2), replicas=1, **kw)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def _serving_port(log: Path, proc, timeout_s=60.0) -> int:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        text = log.read_text() if log.exists() else ""
        for line in text.splitlines():
            if "serving on" in line:
                return int(line.split("serving on ")[1].split(" ")[0].rsplit(":", 1)[1])
        if proc.poll() is not None:
            raise AssertionError(f"replica exited {proc.returncode}: {text}")
        time.sleep(0.05)
    raise AssertionError(f"no 'serving on' line: {log.read_text()}")


def test_replica_of_cli_serves_the_wal_like_jax(tmp_path, t0):
    """``python -m <package>.bridge.worker --replica-of <wal_dir> --serve 0``:
    each package's standalone replica serves the same CSV bytes and digest
    from the same WAL, answers ``/healthz`` as a replica, and drains rc 0 on
    SIGTERM (withdrawing its retention ack)."""
    p = Primary("port", tmp_path / "wal", t0)
    for r in _rows(12, 40, 3)[:4]:
        p.publish(r)
    p.barrier()
    p.publish(_rows(13, 40, 3)[0])
    p.close()
    # the fence out of reach: the compared bytes carry no time, and two
    # interpreters starting one after the other may take longer than its 30 s
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               SKYLINE_REPLICA_MAX_STALE_MS="1e9")
    bodies = {}
    for pkg in ("skyline_tpu_torch", "skyline_tpu"):
        log = tmp_path / f"{pkg}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", f"{pkg}.bridge.worker", "--replica-of",
                 str(tmp_path / "wal"), "--serve", "0"],
                stdout=f, stderr=f, env=env, cwd=str(tmp_path))
        try:
            port = _serving_port(log, proc, timeout_s=120.0)
            # a replica serves before its tail thread has folded the WAL:
            # until then /skyline answers 503 (no snapshot yet) or an older
            # version, so wait for version 5 — long enough for a loaded host
            deadline = time.monotonic() + 120.0
            while True:
                code, doc, _ = _get(f"http://127.0.0.1:{port}/healthz")
                try:
                    status, body, headers = _get_raw(f"http://127.0.0.1:{port}/skyline?format=csv")
                except urllib.error.HTTPError as e:
                    status, body, headers = e.code, e.read(), dict(e.headers)
                if status == 200 and headers.get("X-Skyline-Version") == "5":
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"{pkg} replica: /skyline {status}, version "
                        f"{headers.get('X-Skyline-Version')} after 120 s: {log.read_text()}"
                    )
                time.sleep(0.05)
            assert code == 200 and doc["role"] == "replica"
            acks = list((tmp_path / "wal").glob("tail-*.ack"))
            assert acks
            bodies[pkg] = (body, headers["X-Skyline-Version"], headers["X-Skyline-Digest"])
        finally:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        assert rc == 0, log.read_text()
        assert not list((tmp_path / "wal").glob("tail-*.ack"))
    assert bodies["skyline_tpu_torch"] == bodies["skyline_tpu"]
    assert bodies["skyline_tpu_torch"][1] == "5"


def test_audit_bundle_wal_copy_matches_jax(tmp_path, monkeypatch):
    """A worker with crash safety points its auditor at the WAL; a
    divergence bundle's ``wal/`` copy holds the same segment bytes in both
    packages (the same stream, the clocks pinned)."""
    import test_torch_worker as tw

    monkeypatch.setattr(tw.jworker, "time", tw.PinnedClock())
    monkeypatch.setattr(tw.tworker, "time", tw.PinnedClock())
    copies = {}
    for kind in PKG:
        rng = np.random.default_rng(31)
        bus = tw.JBus() if kind == "jax" else tw.MemoryBus()
        res = (tw.JRes if kind == "jax" else tw.ResilienceConfig)(
            checkpoint_dir=str(tmp_path / kind), wal_fsync="off")
        w = tw.make(kind, bus, dict(parallelism=2, dims=3, domain_max=10000.0),
                    resilience=res, telemetry=PKG[kind]["Telemetry"]())
        try:
            aud = w.engine.auditor
            assert aud.wal_dir == str(tmp_path / kind / "wal")
            pts = rng.random((300, 3)).astype(np.float32) * 10000.0
            bus.produce_many("input-tuples", tw.lines_of(pts))
            bus.produce("queries", "q,0")
            while w.step() > 0:
                pass
            if kind == "jax":
                from skyline_tpu.audit.bundle import freeze_bundle
            else:
                from skyline_tpu_torch.audit.bundle import freeze_bundle
            store = PKG[kind]["serve"].SnapshotStore()
            snap = store.publish(np.zeros((1, 3), dtype=np.float32), now_ms=1.0)
            path = freeze_bundle(w.engine, snap, snap.points, None,
                                 out_dir=str(tmp_path / f"bundle-{kind}"), seq=1,
                                 wal_dir=aud.wal_dir)
            wal = Path(path) / "wal"
            manifest = json.loads((Path(path) / "manifest.json").read_text())
            copies[kind] = (sorted((f.name, f.read_bytes()) for f in wal.iterdir()),
                            manifest["wal_segments"])
        finally:
            w.close()
    assert copies["port"] and copies["port"] == copies["jax"]


def test_replica_and_cluster_import_no_jax():
    code = (
        "import sys\n"
        "import skyline_tpu_torch.serve.replica, skyline_tpu_torch.cluster\n"
        "import skyline_tpu_torch.telemetry.clusterview\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'skyline_tpu' or m.startswith('skyline_tpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

"""The port's serving plane (``skyline_tpu_torch/serve/``) against the JAX
package's, on the CPU: snapshot versions, frozen points, staleness and
dedupe; deltas against brute force and the JAX functions, the ring's
cancellation and its 410; the WAL record encoders; the token bucket and
the query gate; HTTP codes, headers and bodies against the JAX server's for
the same store contents; every snapshot the engine publishes under each
flush policy (version, size, watermark, digest, delta bytes, JSON and CSV
bodies) equal to the JAX engine's; a forced ``POST /query`` through the
bridge loop with the JAX engine's answer; 32 concurrent readers during
ingest with zero torn reads; the sliding engine's versions; the unported
branches raise; and the import boundary. Comparisons are exact bytes.

Timestamps are the only volatile bytes of a snapshot: the engine tests fix
the store's clock (``snapshot._now_ms``) and the batches' event times in
both packages, so whole bodies compare.
"""

import itertools
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from skyline_tpu import serve as jserve
from skyline_tpu.ops import cascade as jax_cascade
from skyline_tpu.ops import dispatch as jax_dispatch
from skyline_tpu.ops import skyline_np
from skyline_tpu.serve import bodystore as jbs
from skyline_tpu.serve import snapshot as jsnapshot
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu.stream.sliding_engine import SlidingEngine as JaxSlidingEngine
from skyline_tpu.telemetry import Telemetry as JaxTelemetry
from skyline_tpu.telemetry import spans as jax_spans
from skyline_tpu.workload.generators import anti_correlated, correlated, uniform
from skyline_tpu_torch import serve
from skyline_tpu_torch.bridge.wire import format_tuple_line
from skyline_tpu_torch.ops import cascade, dispatch
from skyline_tpu_torch.serve import (
    AdmissionController,
    DeltaRing,
    QueryBridge,
    SkylineServer,
    SnapshotStore,
    TokenBucket,
    apply_delta_record,
    delta_wal_record,
    snapshot_delta,
    snapshot_wal_record,
)
from skyline_tpu_torch.serve import bodystore as bs
from skyline_tpu_torch.serve import snapshot
from skyline_tpu_torch.serve.snapshot import points_digest
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream.sliding_engine import SlidingEngine
from skyline_tpu_torch.telemetry import Telemetry, spans

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def process_state(monkeypatch):
    monkeypatch.setenv("SKYLINE_TUNER_EPOCH_S", "3600")
    monkeypatch.setenv("SKYLINE_SORTED_SFS", "off")
    monkeypatch.setenv("SKYLINE_DEVICE_CASCADE", "off")
    for mod_dispatch, mod_cascade, mod_spans in (
        (dispatch, cascade, spans), (jax_dispatch, jax_cascade, jax_spans)
    ):
        monkeypatch.setattr(mod_dispatch, "_MASK_PROFILER", None)
        monkeypatch.setattr(mod_spans, "_mint_seq", 0)
        mod_cascade.clear_pins()


def _get(url, timeout=10):
    """(status, json_doc, headers) — HTTPError surfaces as its status."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.load(r), dict(r.headers)
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, (json.loads(body) if body else {}), dict(e.headers)


def _raw(url, method="GET", timeout=10):
    """(status, body bytes, headers) of one request."""
    req = urllib.request.Request(url, method=method, data=b"{}" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _as_set(points):
    return {tuple(r) for r in np.asarray(points, np.float32).tolist()}


def _brute_delta(old, new):
    o, n = _as_set(old), _as_set(new)
    return n - o, o - n


# -- the snapshot store -----------------------------------------------------------


def test_snapshot_versions_history_and_docs_match_jax(rng):
    store, jstore = SnapshotStore(history=4), jserve.SnapshotStore(history=4)
    assert store.latest() is None and store.read() is None
    for i in range(6):
        pts = rng.uniform(0, 1, size=(8, 3))
        snap = store.publish(pts, watermark_id=i, now_ms=10.0 * i, query_id=f"q{i}")
        jsnap = jstore.publish(pts, watermark_id=i, now_ms=10.0 * i, query_id=f"q{i}")
        assert snap.version == i + 1 and snap.to_doc() == jsnap.to_doc()
        assert snap.digest == points_digest(snap.points) == jsnapshot.points_digest(jsnap.points)
    assert store.latest().version == store.head_version == 6
    assert store.get(6).version == 6 and store.get(3).version == 3
    assert store.get(1) is None and store.get(2) is None
    st, jst = store.stats(), jstore.stats()
    st.pop("latest_age_ms"), jst.pop("latest_age_ms")
    assert st == jst


def test_snapshot_is_frozen_and_never_aliases_the_engine_buffer(rng):
    store = SnapshotStore()
    src = rng.uniform(0, 1, size=(5, 2)).astype(np.float32)
    snap = store.publish(src)
    src[:] = -1.0
    assert float(snap.points.min()) >= 0.0
    assert snap.digest == points_digest(snap.points)
    with pytest.raises(ValueError):
        snap.points[0, 0] = 99.0


def test_source_key_dedupes_and_restore_continues_versions_as_jax(rng):
    outs = []
    for Store in (SnapshotStore, jserve.SnapshotStore):
        store, seen = Store(), []
        store.on_publish(lambda prev, snap: seen.append(snap.version))
        a = rng.uniform(0, 1, size=(4, 2))
        s1 = store.publish(a, source_key=b"k1", now_ms=1.0)
        s2 = store.publish(a + 1, source_key=b"k1", now_ms=2.0)
        dedup = (s2 is s1, store.last_publish_deduped, store.deduped)
        store.publish(a, source_key=b"k2", now_ms=3.0)
        r = store.restore_state(a, version=9, watermark_id=5, timestamp_ms=4.0, meta={"m": 1})
        after = store.publish(a, now_ms=5.0)
        outs.append((dedup, seen, r.version, store.restores, after.version, store.restored))
    assert outs[0] == outs[1] == ((True, True, 1), [1, 2, 10], 9, 1, 10, False)


def test_staleness_bounds_age_and_version_lag(rng):
    store = SnapshotStore()
    store.publish(rng.uniform(0, 1, size=(4, 2)), now_ms=1000.0)
    rs = store.read(max_age_ms=500.0, max_version_lag=0, now_ms=1200.0)
    assert rs.fresh and rs.age_ms == 200.0 and rs.version_lag == 0
    rs = store.read(max_age_ms=500.0, now_ms=2000.0)
    assert not rs.fresh and rs.age_ms == 1000.0
    store.note_ingest(watermark_id=10)
    store.note_ingest(watermark_id=20, event_ms=1500.0)
    rs = store.read(max_version_lag=1, now_ms=1100.0)
    assert not rs.fresh and rs.version_lag == 2
    assert store.read(max_version_lag=2, now_ms=1100.0).fresh
    assert store.stream_watermark == 20
    store.publish(rng.uniform(0, 1, size=(4, 2)), now_ms=1500.0)
    rs = store.read(max_version_lag=0, now_ms=1600.0)
    assert rs.fresh and rs.snapshot.watermark_id == 20
    assert rs.snapshot.event_wm_ms == 1500.0 and rs.staleness_ms == 100.0
    assert store.read(now_ms=1e12).fresh


# -- deltas -----------------------------------------------------------------------------


@pytest.mark.parametrize("gen", [uniform, correlated, anti_correlated])
def test_snapshot_delta_matches_bruteforce_and_jax(rng, gen):
    d = 3
    x, y = gen(rng, 800, d, 0, 10000), gen(rng, 800, d, 0, 10000)
    old = skyline_np(x).astype(np.float32)
    new = skyline_np(np.concatenate([x, y])).astype(np.float32)
    entered, left = snapshot_delta(old, new)
    je, jl = jserve.snapshot_delta(old, new)
    assert entered.tobytes() == je.tobytes() and left.tobytes() == jl.tobytes()
    we, wl = _brute_delta(old, new)
    assert _as_set(entered) == we and _as_set(left) == wl
    e2, l2 = snapshot_delta(old, old)
    assert e2.shape[0] == 0 and l2.shape[0] == 0
    e3, l3 = snapshot_delta(np.empty((0, d), np.float32), new)
    assert _as_set(e3) == _as_set(new) and l3.shape[0] == 0


def test_delta_ring_merges_span_with_cancellation(rng):
    store = SnapshotStore()
    ring = DeltaRing(store, capacity=16)
    a = np.asarray([[1.0, 1.0], [2.0, 0.5]], np.float32)
    b = np.asarray([[1.0, 1.0], [0.2, 3.0]], np.float32)
    for pts in (a, b, a):
        store.publish(pts)
    entered, left, head = ring.since(1)
    assert head == 3 and entered.shape[0] == 0 and left.shape[0] == 0
    entered, left, head = ring.since(2)
    we, wl = _brute_delta(b, a)
    assert _as_set(entered) == we and _as_set(left) == wl
    e, l, h = ring.since(3)
    assert h == 3 and e.shape[0] == 0 and l.shape[0] == 0


def test_delta_ring_signals_gone_and_matches_jax(rng):
    store, jstore = SnapshotStore(), jserve.SnapshotStore()
    ring, jring = DeltaRing(store, capacity=2), jserve.DeltaRing(jstore, capacity=2)
    for _ in range(5):
        pts = rng.uniform(0, 1, size=(6, 2))
        store.publish(pts)
        jstore.publish(pts)
    assert ring.oldest_since == jring.oldest_since == 3
    assert ring.since(1) is None and ring.since(2) is None
    for v in (3, 4, 5):
        got, jgot = ring.since(v), jring.since(v)
        assert [a.tobytes() for a in got[:2]] == [a.tobytes() for a in jgot[:2]]
        assert got[2] == jgot[2] == 5
    we, wl = _brute_delta(store.get(3).points, store.get(5).points)
    got = ring.since(3)
    assert _as_set(got[0]) == we and _as_set(got[1]) == wl
    assert ring.stats() == jring.stats()


def test_wal_records_match_jax_and_replay_the_bytes(rng):
    prev_pts = None
    store, jstore = SnapshotStore(), jserve.SnapshotStore()
    for i, (kind, n) in enumerate([("u", 30), ("u", 30), ("dup", 0), ("perm", 0), ("u", 0)]):
        if kind == "u":
            pts = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
        elif kind == "dup":
            pts = np.concatenate([prev_pts[:10], prev_pts[:10]])
        else:
            pts = prev_pts[::-1].copy()
        prev, jprev = store.latest(), jstore.latest()
        snap = store.publish(pts, now_ms=float(i), partial=bool(i % 2))
        jsnap = jstore.publish(pts, now_ms=float(i), partial=bool(i % 2))
        rec, jrec = delta_wal_record(prev, snap), jserve.delta_wal_record(jprev, jsnap)
        assert rec == jrec
        assert snapshot_wal_record(snap) == jserve.snapshot_wal_record(jsnap)
        base = prev.points if prev is not None else np.empty((0, 3), np.float32)
        assert apply_delta_record(base, rec).tobytes() == snap.points.tobytes()
        assert apply_delta_record(base, rec).tobytes() == jserve.apply_delta_record(base, rec).tobytes()
        prev_pts = pts


def _signed_zero_windows(rng, d=3):
    """Snapshots whose rows mix +0.0 and -0.0: zero vectors in several
    signed-zero byte images (duplicates by value, distinct by bytes), rows
    with one signed zero among finite values, and finite rows, in the
    shuffled orders an engine publishes."""
    zeros = np.zeros((2 ** d, d), np.float32)
    for i in range(2 ** d):
        for j in range(d):
            if i >> j & 1:
                zeros[i, j] = -0.0
    mixed = rng.uniform(1, 5, size=(6, d)).astype(np.float32)
    mixed[::2, 0] = -0.0
    mixed[1::2, 0] = 0.0
    finite = rng.uniform(0, 9, size=(5, d)).astype(np.float32)
    picks = [
        np.concatenate([zeros[[0, 1, 1]], finite[:2]]),
        np.concatenate([zeros[[1, 2, 0]], mixed[:3], finite[:1]]),
        np.concatenate([zeros[[3, 0]], mixed[1:5]]),
        zeros[[0, 0, 0]],
        zeros[[7]],
        np.concatenate([zeros, mixed, finite]),
        np.concatenate([mixed[::-1], zeros[::-1]]),
    ]
    return [p[rng.permutation(p.shape[0])] for p in picks]


def test_signed_zero_deltas_ring_bodies_and_digest_match_jax(rng):
    """Rows that are equal by value but not by bytes (+0.0 / -0.0): every
    delta, every ring span, every WAL record and every wire body is the
    JAX package's byte for byte. The reference collapses each delta with
    ``np.unique`` (by value) after matching rows by bytes, so from an empty
    baseline ``[[0.0], [-0.0]]`` enters as one row: a client that applies
    deltas by bytes cannot rebuild such a snapshot's row set (ROADMAP
    queue 3); the port keeps that law."""
    d = 3
    e, left = snapshot_delta(np.empty((0, 1), np.float32), np.asarray([[0.0], [-0.0]], np.float32))
    je, jl = jserve.snapshot_delta(np.empty((0, 1), np.float32),
                                   np.asarray([[0.0], [-0.0]], np.float32))
    assert e.tobytes() == je.tobytes() and e.shape == (1, 1) and left.shape == jl.shape == (0, 1)
    store, jstore = SnapshotStore(), jserve.SnapshotStore()
    ring, jring = DeltaRing(store, capacity=16), jserve.DeltaRing(jstore, capacity=16)
    windows = _signed_zero_windows(rng, d)
    prev = np.empty((0, d), np.float32)
    for i, pts in enumerate(windows):
        got, jgot = snapshot_delta(prev, pts), jserve.snapshot_delta(prev, pts)
        assert [a.tobytes() for a in got] == [a.tobytes() for a in jgot], i
        assert [a.shape for a in got] == [a.shape for a in jgot], i
        last, jlast = store.latest(), jstore.latest()
        snap = store.publish(pts, watermark_id=i, now_ms=float(i))
        jsnap = jstore.publish(pts, watermark_id=i, now_ms=float(i))
        assert snap.digest == jsnap.digest == jsnapshot.points_digest(pts)
        assert snap.points.tobytes() == pts.tobytes()
        assert json.dumps(snap.to_doc()) == json.dumps(jsnap.to_doc())
        for inc in (True, False):
            assert bs.json_prefix(snap, inc) == jbs.json_prefix(jsnap, inc)
        assert bs.csv_body(snap) == jbs.csv_body(jsnap)
        rec, jrec = delta_wal_record(last, snap), jserve.delta_wal_record(jlast, jsnap)
        assert rec == jrec
        assert apply_delta_record(prev, rec).tobytes() == pts.tobytes()
        prev = pts
    for v in range(1, len(windows) + 1):
        got, jgot = ring.since(v), jring.since(v)
        assert [a.tobytes() for a in got[:2]] == [a.tobytes() for a in jgot[:2]], v
        assert [a.shape for a in got[:2]] == [a.shape for a in jgot[:2]], v
        assert got[2] == jgot[2] == len(windows)


# -- admission ----------------------------------------------------------------------


def test_token_bucket_sheds_past_burst_and_reports_retry_after():
    tb = TokenBucket(rate=10.0, burst=3)
    admitted = [tb.try_acquire()[0] for _ in range(5)]
    assert admitted[:3] == [True, True, True] and admitted[3] is False
    ok, retry = tb.try_acquire()
    assert not ok and retry > 0
    assert all(TokenBucket(0.0, 1).try_acquire()[0] for _ in range(100))


def test_query_gate_bounds_concurrency_plus_queue():
    ctrl = AdmissionController(max_concurrent_queries=1, max_query_queue=1)
    gate = ctrl.queries
    assert gate.enter() and gate.enter()
    assert not gate.enter()
    assert ctrl.counters.get("queries_shed") == 1
    gate.leave()
    assert gate.enter() and gate.depth == 2


def test_tenant_admission_matches_jax():
    docs = []
    for Ctrl in (AdmissionController, jserve.AdmissionController):
        ctrl = Ctrl(tenant_rate=0.001, tenant_burst=2, max_tenants=2)
        outs = [ctrl.admit_read(tenant=t)[0] for t in "aaabbbccc"] + [ctrl.admit_read()[0]]
        stats = ctrl.stats()
        stats.pop("query_deadline_ms")
        docs.append((outs, stats))
    assert docs[0] == docs[1]
    assert docs[0][1]["tenants"]["__other__"] == {"admitted": 2, "shed": 1}


# -- HTTP against the JAX server --------------------------------------------------------


def _pair(**kw):
    """A port and a JAX store, ring and server with the same knobs."""
    out = []
    for mod in (serve, jserve):
        store = mod.SnapshotStore()
        ring = mod.DeltaRing(store, capacity=2)
        out.append((store, mod.SkylineServer(store, deltas=ring, port=0, **kw)))
    return out


VOLATILE = (b', "age_ms":', b', "staleness_ms": ')


def _stable(body):
    for cut in VOLATILE:
        body = body.split(cut)[0]
    return body


def _same_reply(paths, servers, method="GET"):
    for path in paths:
        replies = []
        for _, srv in servers:
            code, body, hdr = _raw(f"http://127.0.0.1:{srv.port}{path}", method)
            hdr = {k: v for k, v in hdr.items()
                   if k not in ("X-Skyline-Staleness-Ms", "Content-Length")}
            replies.append((code, _stable(body), hdr))
        assert replies[0] == replies[1], path
    return replies[0]


def test_http_codes_headers_and_bodies_match_jax(rng):
    (store, srv), (jstore, jsrv) = pair = _pair()
    try:
        assert _same_reply(["/healthz", "/skyline", "/deltas?since=0", "/nope",
                            "/fleet", "/health", "/cluster", "/ops",
                            "/cluster/overview", "/explain", "/audit",
                            "/skyline?max_age_ms=bogus", "/deltas"], pair)[0] == 400
        for i in range(5):
            pts = skyline_np(uniform(rng, 300, 2, 0, 10000)).astype(np.float32)
            for st in (store, jstore):
                st.publish(pts, watermark_id=299 + i, now_ms=1000.0 + i, query_id=f"q{i}")
        code, body, hdr = _same_reply(
            ["/skyline", "/skyline?points=0", "/skyline?format=csv",
             "/skyline?max_version_lag=0", "/deltas?since=4", "/deltas?since=3",
             "/deltas?since=1", "/deltas?since=x", "/skyline?explain=1",
             "/subscribe?since=x", "/query"], pair)
        assert code == 404  # GET /query: POST only
        code, body, hdr = _raw(f"http://127.0.0.1:{srv.port}/skyline?format=csv")
        _raw(f"http://127.0.0.1:{jsrv.port}/skyline?format=csv")  # the same counters
        snap = store.latest()
        assert hdr["X-Skyline-Version"] == "5" and hdr["X-Skyline-Digest"] == snap.digest
        assert body.decode().splitlines()[0] == format_tuple_line(0, snap.points[0])
        for _, s in pair:
            code, doc, _ = _get(f"http://127.0.0.1:{s.port}/deltas?since=1")
            assert code == 410 and doc["resync"] and doc["oldest_since"] == 3
        assert _same_reply(["/query"], pair, method="POST")[0] == 503  # no bridge
        sd, jsd = (json.loads(_raw(f"http://127.0.0.1:{s.port}/stats")[1]) for _, s in pair)
        for d in (sd, jsd):
            d["snapshot_store"].pop("latest_age_ms")
        assert sd == jsd
    finally:
        for _, s in pair:
            s.close()


def test_http_stale_read_rejected_unless_allowed(rng):
    store = SnapshotStore()
    srv = SkylineServer(store, bridge=QueryBridge(), port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        store.publish(rng.uniform(0, 1, size=(4, 2)))
        store.note_ingest(watermark_id=7)
        code, doc, _ = _get(f"{base}/skyline?max_version_lag=0")
        assert code == 503 and doc["version_lag"] == 1
        code, doc, _ = _get(f"{base}/skyline?max_version_lag=0&allow_stale=1&refresh=1")
        assert code == 200 and doc["stale"] and doc["refresh_triggered"]
        assert srv.bridge.depth == 1
        assert srv.admission.counters.get("stale_reads") == 2
        assert srv.admission.counters.get("stale_rejected") == 1
    finally:
        srv.close()


def test_http_read_shedding_emits_429_with_retry_after(rng):
    store = SnapshotStore()
    store.publish(rng.uniform(0, 1, size=(4, 2)))
    srv = SkylineServer(store, admission=AdmissionController(read_rate=1.0, read_burst=2), port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        got = [_get(f"{base}/skyline?points=0") for _ in range(6)]
        codes = [c for c, _, _ in got]
        assert codes.count(200) == 2 and codes.count(429) == 4
        assert int(got[codes.index(429)][2]["Retry-After"]) >= 1
        st = srv.admission.stats()
        assert st["reads_shed"] == 4 and st["reads_served"] == 2
    finally:
        srv.close()


def test_http_query_gate_sheds_and_deadline_expires(rng):
    store = SnapshotStore()
    store.publish(rng.uniform(0, 1, size=(4, 2)))
    srv = SkylineServer(
        store, bridge=QueryBridge(),
        admission=AdmissionController(max_concurrent_queries=1, max_query_queue=0,
                                      query_deadline_ms=600.0),
        port=0,
    )
    try:
        base = f"http://127.0.0.1:{srv.port}"
        results = {}

        def post(tag):
            code, body, _ = _raw(f"{base}/query", "POST")
            results[tag] = (code, json.loads(body or b"{}"))

        t1 = threading.Thread(target=post, args=("first",))
        t1.start()
        time.sleep(0.2)
        post("second")
        t1.join(timeout=10)
        assert results["second"][0] == 429
        assert results["first"][0] == 503 and "deadline" in results["first"][1]["error"]
        st = srv.admission.stats()
        assert st["queries_shed"] == 1 and st["queries_timed_out"] == 1
    finally:
        srv.close()


def test_server_that_cannot_bind_raises(rng):
    store = SnapshotStore()
    srv = SkylineServer(store, port=0)
    try:
        with pytest.raises(OSError):
            SkylineServer(store, port=srv.port)
    finally:
        srv.close()


def test_unported_branches_raise(monkeypatch):
    with pytest.raises(ImportError, match="item 6"):
        serve.SkylineReplica  # noqa: B018
    from skyline_tpu_torch.telemetry.clusterview import overview_doc

    assert overview_doc(Telemetry()) == {"ok": True, "enabled": False}
    monkeypatch.setenv("SKYLINE_CLUSTERVIEW_MEMBERS", "http://127.0.0.1:1")
    with pytest.raises(NotImplementedError, match="item 8"):
        overview_doc(Telemetry())
    store = SnapshotStore()
    tel = Telemetry()
    srv = SkylineServer(store, port=0, telemetry=tel)
    try:
        with pytest.raises(Exception):  # the connection closes: no doc answered
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/cluster/overview", timeout=5).read()
        monkeypatch.delenv("SKYLINE_CLUSTERVIEW_MEMBERS")
        tel.opslog = object()
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/ops", timeout=5).read()
    finally:
        srv.close()


# -- the engine's publishes against the JAX engine's --------------------------------------


def _fixed_clocks(monkeypatch):
    for mod in (snapshot, jsnapshot):
        ticks = itertools.count()
        monkeypatch.setattr(mod, "_now_ms", lambda t=ticks: 1.0e12 + 10.0 * next(t))


def _served_engine(mod_engine, cfg, store_mod, bodystore_mod, tel):
    eng = mod_engine(cfg, telemetry=tel)
    store = store_mod.SnapshotStore()
    published = []
    store.on_publish(lambda prev, snap: published.append(snap))
    ring = store_mod.DeltaRing(store)
    body = bodystore_mod.BodyStore(None).attach(store)
    eng.attach_snapshots(store)
    return eng, store, ring, body, published


def _publish_record(snap, ring, body):
    tail = ring.latest()
    return (snap.version, snap.size, snap.watermark_id, snap.digest, snap.event_wm_ms,
            tail.entered.tobytes(), tail.left.tobytes(),
            body.get(snap.version, bs.FMT_JSON_POINTS),
            body.get(snap.version, bs.FMT_JSON_NOPOINTS),
            body.get(snap.version, bs.FMT_CSV))


ENGINE_GRID = [
    dict(flush_policy="incremental", dims=3),
    dict(flush_policy="incremental", dims=2),
    dict(flush_policy="lazy", dims=8, ingest="device"),
    dict(flush_policy="lazy", dims=4, ingest="host"),
    dict(flush_policy="overlap", dims=3, ingest="host", overlap_rows=400),
]


@pytest.mark.parametrize("pol", ENGINE_GRID, ids=lambda p: f"{p['flush_policy']}-d{p['dims']}-{p.get('ingest', 'host')}")
def test_engine_publishes_equal_the_jax_engines(monkeypatch, rng, pol):
    _fixed_clocks(monkeypatch)
    d = pol["dims"]
    windows = [anti_correlated(rng, 900, d, 0, 1000) for _ in range(2)]
    runs = []
    for Engine, Config, store_mod, body_mod, Tel, extra in (
        (JaxEngine, JaxConfig, jserve, jbs, JaxTelemetry, {}),
        (SkylineEngine, EngineConfig, serve, bs, Telemetry, {"device": "cpu"}),
    ):
        for mod in (spans, jax_spans):
            mod._mint_seq = 0
        cfg = Config(parallelism=2, domain_max=1000.0, buffer_size=256, **pol, **extra)
        eng, store, ring, body, published = _served_engine(Engine, cfg, store_mod, body_mod, Tel())
        records, base = [], 0
        for w, x in enumerate(windows):
            for s in range(0, x.shape[0], 450):
                ids = np.arange(base + s, base + min(s + 450, x.shape[0]), dtype=np.int64)
                eng.process_records(ids, x[s : s + 450], now_ms=0.0,
                                    event_ms=(5.0e11 + base + s, 5.0e11 + base + s + 1))
            base += x.shape[0]
            for qid in (f"q{w}", f"r{w}"):  # the repeat dedupes on the device path
                eng.process_trigger(f"{qid},0", now_ms=1.0)
                eng.poll_results()
                records.append(_publish_record(store.latest(), ring, body))
        runs.append((records, store.stats(), [s.meta for s in published]))
    assert runs[0][0] == runs[1][0]
    assert runs[0][2] == runs[1][2]
    for st in (runs[0][1], runs[1][1]):
        st.pop("latest_age_ms")
    assert runs[0][1] == runs[1][1]


def test_emit_points_off_still_publishes_points(rng):
    eng = SkylineEngine(EngineConfig(dims=3, device="cpu"))
    store = SnapshotStore()
    eng.attach_snapshots(store)
    x = anti_correlated(rng, 600, 3, 0, 1000)
    eng.process_records(np.arange(600), x)
    eng.process_trigger("q,0")
    (res,) = eng.poll_results()
    assert "skyline_points" not in res
    assert store.latest().size == res["skyline_size"] > 0
    assert store.version_lag == 0 and store.stream_watermark == 599


def _bridge_loop(eng, bridge, stop, leftovers):
    """The engine owner's loop: inject forced queries, poll, fulfil."""
    while not stop.is_set():
        bridge.inject(eng)
        leftovers += bridge.fulfill(eng.poll_results())
        time.sleep(0.002)


def test_forced_query_through_the_bridge_loop_matches_jax(rng):
    x = anti_correlated(rng, 1500, 3, 0, 10000)
    y = anti_correlated(rng, 800, 3, 0, 10000)
    cfg = dict(parallelism=2, dims=3, domain_max=10000.0, buffer_size=512)
    jeng = JaxEngine(JaxConfig(**cfg))
    jstore = jserve.SnapshotStore()
    jeng.attach_snapshots(jstore)
    eng = SkylineEngine(EngineConfig(**cfg, device="cpu"), telemetry=Telemetry())
    store = SnapshotStore()
    eng.attach_snapshots(store)
    for e in (jeng, eng):
        e.process_records(np.arange(1500), x)
        e.process_trigger("0,0")
        e.poll_results()
        e.process_records(np.arange(1500, 2300), y)
    jeng.process_trigger(f"{QueryBridge.PREFIX}1,0")
    (jres,) = jeng.poll_results()
    bridge = QueryBridge()
    srv = SkylineServer(store, bridge=bridge, port=0, telemetry=eng.telemetry)
    stop, leftovers = threading.Event(), []
    loop = threading.Thread(target=_bridge_loop, args=(eng, bridge, stop, leftovers))
    loop.start()
    try:
        code, body, _ = _raw(f"http://127.0.0.1:{srv.port}/query", "POST", timeout=30)
        assert code == 200
        doc = json.loads(body)
        assert doc["query_id"] == jres["query_id"] and doc["skyline_size"] == jres["skyline_size"]
        assert doc["skyline_size"] == skyline_np(np.concatenate([x, y])).shape[0]
        assert store.head_version == jstore.head_version == 2
        assert store.latest().digest == jstore.latest().digest
        assert store.version_lag == 0 and leftovers == []
        code, doc, _ = _get(f"http://127.0.0.1:{srv.port}/skyline?max_version_lag=0")
        assert code == 200 and doc["skyline_size"] == jres["skyline_size"]
    finally:
        stop.set()
        loop.join(timeout=10)
        srv.close()


def test_concurrent_readers_during_active_ingest(rng):
    """32 readers hammer GET /skyline while the engine owner ingests and
    publishes: every read inside its bound, digest-verified (zero torn
    reads), versions monotone per reader; then shedding engages."""
    eng = SkylineEngine(EngineConfig(parallelism=2, dims=2, domain_max=10000.0,
                                     buffer_size=512, device="cpu"))
    store = SnapshotStore()
    body = bs.BodyStore(None).attach(store)
    eng.attach_snapshots(store)
    srv = SkylineServer(store, port=0, bodystore=body)
    windows = [uniform(rng, 400, 2, 0, 10000) for _ in range(30)]
    eng.process_records(np.arange(400), windows[0])
    eng.process_trigger("0,0")
    eng.poll_results()
    stop, ingest_err, errors = threading.Event(), [], []

    def ingest():
        try:
            for qid in range(1, len(windows)):
                if stop.is_set():
                    return
                eng.process_records(np.arange(400 * qid, 400 * (qid + 1)), windows[qid])
                eng.process_trigger(f"{qid},0")
                eng.poll_results()
        except Exception as e:  # pragma: no cover - diagnostic
            ingest_err.append(e)

    url = f"http://127.0.0.1:{srv.port}/skyline?max_age_ms=60000&max_version_lag=100000"

    def reader(idx):
        versions = []
        try:
            for _ in range(4):
                code, doc, _ = _get(url, timeout=30)
                assert code == 200, (idx, code, doc)
                assert not doc["stale"]
                pts = np.asarray(doc["points"], np.float32).reshape(-1, 2)
                assert points_digest(pts) == doc["digest"], f"reader {idx}: torn read"
                versions.append(doc["version"])
            assert versions == sorted(versions), versions
        except Exception as e:
            errors.append(e)

    try:
        it = threading.Thread(target=ingest)
        it.start()
        readers = [threading.Thread(target=reader, args=(i,)) for i in range(32)]
        for t in readers:
            t.start()
        for t in readers:
            t.join(timeout=120)
        stop.set()
        it.join(timeout=120)
        assert not ingest_err and not errors, (ingest_err, errors[:3])
        assert store.head_version > 1
        assert srv.admission.counters.get("reads_served") == 128
        assert body.stats()["torn_reads"] == 0
    finally:
        stop.set()
        srv.close()
    shed = SkylineServer(store, admission=AdmissionController(read_rate=20.0, read_burst=4), port=0)
    try:
        codes, lock = [], threading.Lock()

        def hammer():
            for _ in range(8):
                code, _, _ = _get(f"http://127.0.0.1:{shed.port}/skyline?points=0")
                with lock:
                    codes.append(code)

        hs = [threading.Thread(target=hammer) for _ in range(8)]
        for t in hs:
            t.start()
        for t in hs:
            t.join(timeout=60)
        assert codes.count(429) > 0 and codes.count(200) >= 4
        assert shed.admission.counters.get("reads_shed") == codes.count(429)
    finally:
        shed.close()


def test_sliding_engine_versions_equal_the_jax_engines(monkeypatch, rng):
    _fixed_clocks(monkeypatch)
    x = rng.uniform(0, 1000, size=(900, 2)).astype(np.float32)
    outs = []
    for Engine, Config, mod, extra in ((JaxSlidingEngine, JaxConfig, jserve, {}),
                                       (SlidingEngine, EngineConfig, serve, {"device": "cpu"})):
        eng = Engine(Config(parallelism=2, algo="mr-angle", dims=2, domain_max=1000.0, **extra),
                     window_size=400, slide=200)
        store = mod.SnapshotStore()
        eng.attach_snapshots(store)
        eng.process_records(np.arange(900, dtype=np.int64), x)
        lag = store.version_lag
        snaps = []
        for q in ("0,0", "1,0"):  # the repeat dedupes on (records_in, slides)
            eng.process_trigger(q)
            eng.poll_results()
            snaps.append(store.latest())
        eng.process_records(np.arange(900, 1100, dtype=np.int64), x[:200])
        eng.process_trigger("2,0")
        eng.poll_results()
        snaps.append(store.latest())
        outs.append((lag, store.deduped, [(s.version, s.digest, s.watermark_id, s.meta)
                                         for s in snaps]))
    assert outs[0] == outs[1]
    assert outs[1][0] == 1 and outs[1][1] == 1 and outs[1][2][-1][0] == 2
    snap = outs[1][2][1]
    assert snap[3]["window_filled"] and snap[3]["slides_closed"] >= 2


# -- the import boundary -------------------------------------------------------------------


def test_serving_and_audit_modules_import_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import skyline_tpu_torch.serve, skyline_tpu_torch.audit, "
        "skyline_tpu_torch.audit.__main__, skyline_tpu_torch.metrics.httpstats, "
        "skyline_tpu_torch.resilience, skyline_tpu_torch.resilience.wal, "
        "skyline_tpu_torch.utils.checkpoint, skyline_tpu_torch.serve.bodystore, "
        "skyline_tpu_torch.telemetry.clusterview\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'skyline_tpu' or m.startswith('skyline_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_stats_server_endpoints_match_jax():
    """The stats surface's codes and bodies against the JAX package's, each
    server handed a fresh hub and the same ``/stats`` doc; the clocks,
    traces and the tuner's table (another package's cascade) aside."""
    from skyline_tpu.metrics.httpstats import StatsServer as JaxStatsServer
    from skyline_tpu_torch.metrics.httpstats import StatsServer

    paths = ["/healthz", "/stats", "/", "/ui", "/fleet", "/health", "/cluster", "/ops",
             "/ops?limit=x", "/cluster/overview", "/explain", "/explain?version=x", "/audit",
             "/debug/flight", "/nope"]
    replies = []
    for Server, Tel in ((StatsServer, Telemetry), (JaxStatsServer, JaxTelemetry)):
        srv = Server(lambda: {"records_in": 7, "partitions": {"records_seen": [3, 4]}},
                     port=0, telemetry=Tel())
        try:
            replies.append([_raw(f"http://127.0.0.1:{srv.port}{p}")[:2] for p in paths])
            code, metrics, _ = _raw(f"http://127.0.0.1:{srv.port}/metrics")
            assert code == 200 and b"skyline_records_in 7" in metrics
            for p in ("/profile", "/slo", "/dispatch", "/trace"):
                assert _raw(f"http://127.0.0.1:{srv.port}{p}")[0] == 200
        finally:
            srv.close()
    assert replies[0] == replies[1]
    assert [c for c, _ in replies[0]] == [200] * 8 + [400, 200, 404, 400, 200, 200, 404]

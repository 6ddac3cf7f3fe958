"""The port's body store (``skyline_tpu_torch/serve/bodystore.py``) against
``json.dumps`` and against the JAX package's body store on the same
snapshots: every encoder and wire body byte for byte, the file-backed
and in-memory stores, the seqlock / fence / reclaim discipline (exact
bytes or nothing), and the server's spliced bodies. Tolerance: exact
bytes everywhere.
"""

import json
import socket
import struct
import time
import urllib.request

import numpy as np
import pytest

from skyline_tpu.serve import DeltaRing as JDeltaRing
from skyline_tpu.serve import SkylineServer as JSkylineServer
from skyline_tpu.serve import SnapshotStore as JSnapshotStore
from skyline_tpu.serve import bodystore as jbs
from skyline_tpu_torch.bridge.wire import format_tuple_line
from skyline_tpu_torch.serve import DeltaRing, SkylineServer, SnapshotStore
from skyline_tpu_torch.serve import bodystore as bs
from skyline_tpu_torch.serve.bodystore import (
    FMT_CSV,
    FMT_JSON_NOPOINTS,
    FMT_JSON_NOPOINTS_EXPLAIN,
    FMT_JSON_POINTS,
    FMT_JSON_POINTS_EXPLAIN,
    BodyStore,
    BodyStoreReader,
    csv_body,
    fmt_code,
    json_prefix,
    points_json,
)

FMTS = (FMT_JSON_POINTS, FMT_JSON_NOPOINTS, FMT_JSON_POINTS_EXPLAIN,
        FMT_JSON_NOPOINTS_EXPLAIN, FMT_CSV)


def _pts(rng, k=20, d=4):
    return (rng.uniform(0, 10_000, size=(k, d))).astype(np.float32)


def _json_ref(snap, include_points):
    return json.dumps(snap.to_doc(include_points=include_points))[:-1].encode()


def _csv_ref(snap):
    return "\n".join(
        format_tuple_line(i, row) for i, row in enumerate(snap.points)
    ).encode()


def _raw_get(port, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, resp.read()


SPECIALS = np.array(
    [
        [0.0, -0.0, 1.0, -1.0],
        [np.inf, -np.inf, np.nan, 0.5],
        [1e16, 1e-4, 9.999999e15, 1.0000001e-4],
        [np.float32(1e-45), np.float32(3.4e38), 123456.0, -7.25],
    ],
    dtype=np.float32,
)


# -- encoders --------------------------------------------------------------------


def test_fmt_code_covers_the_read_key_grid_as_jax():
    grid = [("csv", True, False), ("json", True, False), ("json", False, False),
            ("json", True, True), ("json", False, True)]
    assert [fmt_code(*k) for k in grid] == [jbs.fmt_code(*k) for k in grid]
    assert [fmt_code(*k) for k in grid] == [FMT_CSV, FMT_JSON_POINTS,
                                            FMT_JSON_NOPOINTS,
                                            FMT_JSON_POINTS_EXPLAIN,
                                            FMT_JSON_NOPOINTS_EXPLAIN]


@pytest.mark.parametrize("k,d", [(0, 3), (1, 1), (7, 5), (64, 8)])
def test_points_json_matches_json_dumps_and_jax(rng, k, d):
    pts = _pts(rng, k, d)
    assert points_json(pts) == json.dumps(pts.tolist()).encode()
    assert points_json(pts) == jbs.points_json(pts)


def test_points_json_specials_match_json_dumps_and_jax():
    assert points_json(SPECIALS) == json.dumps(SPECIALS.tolist()).encode()
    assert points_json(SPECIALS) == jbs.points_json(SPECIALS)


def test_python_encoders_count_python_rows_and_match_jax(rng):
    """The native encoder is not ported: every body comes from the Python
    encoders, counted ``python_rows``, with the JAX package's bytes in
    both row modes."""
    pts = _pts(rng, 50, 6)
    for mode in (bs.ROWS_JSON, bs.ROWS_CSV):
        assert bs._rows_python(pts, mode) == jbs._rows_python(pts, mode)
    counters = bs._new_counters()
    points_json(pts, counters)
    csv_body(SnapshotStore().publish(pts, now_ms=1.0), counters)
    assert counters["python_rows"] == 2 and counters["native_rows"] == 0


@pytest.mark.parametrize("meta", [{}, {"partial": True, "excluded_chips": [1]}])
def test_wire_bodies_match_direct_serialization_and_jax(rng, meta):
    pts = _pts(rng)
    snap = SnapshotStore().publish(pts, now_ms=1234.5, **meta)
    jsnap = JSnapshotStore().publish(pts, now_ms=1234.5, **meta)
    for inc in (True, False):
        assert json_prefix(snap, inc) == _json_ref(snap, inc)
        assert json_prefix(snap, inc) == jbs.json_prefix(jsnap, inc)
    assert csv_body(snap) == _csv_ref(snap) == jbs.csv_body(jsnap)
    doc = snap.to_doc(include_points=True)
    assert list(doc)[-1] == "points"
    assert {k: v for k, v in doc.items() if k != "points"} == snap.doc_head()


# -- the store: identity grid, writer and reader ---------------------------------


def test_bodystore_identity_grid_matches_jax(rng, tmp_path):
    """format x points x explain x marker meta, writer AND reader mapping,
    every version, against json.dumps and the JAX store's bytes."""
    store, jstore = SnapshotStore(), JSnapshotStore()
    w = BodyStore(str(tmp_path / "bodystore.dat"), keep=2).attach(store)
    jw = jbs.BodyStore(str(tmp_path / "jax.dat"), keep=2).attach(jstore)
    r = BodyStoreReader(str(tmp_path / "bodystore.dat"))
    metas = [{}, {"partial": True}, {"partial": True, "excluded_chips": [0]}]
    try:
        for i in range(6):
            pts = _pts(rng, 10 + i)
            meta = metas[i % len(metas)]
            snap = store.publish(pts, now_ms=1000.0 + i, **meta)
            jstore.publish(pts, now_ms=1000.0 + i, **meta)
            refs = {
                FMT_JSON_POINTS: _json_ref(snap, True),
                FMT_JSON_NOPOINTS: _json_ref(snap, False),
                FMT_JSON_POINTS_EXPLAIN: _json_ref(snap, True),
                FMT_JSON_NOPOINTS_EXPLAIN: _json_ref(snap, False),
                FMT_CSV: _csv_ref(snap),
            }
            for fmt, ref in refs.items():
                assert w.get(snap.version, fmt) == ref
                assert r.get(snap.version, fmt) == ref
                assert jw.get(snap.version, fmt) == ref
        stats, jstats = w.stats(), jw.stats()
        assert stats["publishes"] == 6 and stats["torn_reads"] == 0
        assert r.stats()["hits"] == 30
        for key in ("publishes", "bodies_published", "bytes_published",
                    "ring_wraps", "oversize_skipped"):
            assert stats[key] == jstats[key], key
        # the mapped files hold the same frames (the generation word aside)
        a = (tmp_path / "bodystore.dat").read_bytes()
        b = (tmp_path / "jax.dat").read_bytes()
        gen = slice(bs._H_GENERATION, bs._H_GENERATION + 8)
        assert len(a) == len(b) and a[: gen.start] == b[: gen.start]
        assert a[gen.stop:] == b[gen.stop:]
    finally:
        w.close()
        jw.close()
        r.close()


def test_in_memory_store_needs_no_file(rng):
    store = SnapshotStore()
    w = BodyStore(None).attach(store)
    snap = store.publish(_pts(rng))
    assert w.get(snap.version, FMT_JSON_POINTS) == _json_ref(snap, True)
    assert w.get(snap.version + 1, FMT_JSON_POINTS) is None
    assert w.stats()["misses"] == 1 and w.stats()["python_rows"] == 2
    w.close()


# -- seqlock / fence / reclaim discipline: exact bytes or nothing ----------------


def test_torn_overwrite_is_detected_not_served(rng, tmp_path):
    store = SnapshotStore()
    w = BodyStore(str(tmp_path / "bodystore.dat"), data_bytes=8192, keep=1).attach(store)
    r = BodyStoreReader(str(tmp_path / "bodystore.dat"))
    try:
        refs = {}
        for _ in range(12):
            snap = store.publish(_pts(rng, 30, 4))
            refs[snap.version] = {FMT_JSON_POINTS: _json_ref(snap, True),
                                  FMT_CSV: _csv_ref(snap)}
        assert w.stats()["ring_wraps"] > 0
        served = swept = 0
        for v, per_fmt in refs.items():
            for fmt, ref in per_fmt.items():
                got = r.get(v, fmt)
                if got is None:
                    swept += 1
                else:
                    served += 1
                    assert got == ref
        assert served > 0 and swept > 0
    finally:
        w.close()
        r.close()


def test_seqlock_writer_in_flight_forces_retry_then_miss(rng, tmp_path):
    store = SnapshotStore()
    w = BodyStore(str(tmp_path / "bodystore.dat")).attach(store)
    r = BodyStoreReader(str(tmp_path / "bodystore.dat"))
    try:
        snap = store.publish(_pts(rng))
        eoff = w._slot_off(snap.version, FMT_CSV)
        seq = struct.unpack_from("<Q", w._mm, eoff)[0]
        struct.pack_into("<Q", w._mm, eoff, seq | 1)
        assert r.get(snap.version, FMT_CSV) is None
        assert r.stats()["retries"] > 0
        struct.pack_into("<Q", w._mm, eoff, seq)
        assert r.get(snap.version, FMT_CSV) == _csv_ref(snap)
    finally:
        w.close()
        r.close()


def test_fence_scribble_is_detected(rng, tmp_path):
    store = SnapshotStore()
    w = BodyStore(str(tmp_path / "bodystore.dat")).attach(store)
    r = BodyStoreReader(str(tmp_path / "bodystore.dat"))
    try:
        snap = store.publish(_pts(rng))
        eoff = w._slot_off(snap.version, FMT_CSV)
        _, _, _, ln, frame, fence = bs._ENTRY.unpack_from(w._mm, eoff)
        struct.pack_into("<Q", w._mm, frame, fence + 99)
        assert r.get(snap.version, FMT_CSV) is None
        assert r.stats()["torn_reads"] > 0
        struct.pack_into("<Q", w._mm, frame, fence)
        assert r.get(snap.version, FMT_CSV) == _csv_ref(snap)
    finally:
        w.close()
        r.close()


def test_oversize_body_skips_ring_but_serves_in_process(rng, tmp_path):
    store = SnapshotStore()
    w = BodyStore(str(tmp_path / "bodystore.dat"), data_bytes=512).attach(store)
    r = BodyStoreReader(str(tmp_path / "bodystore.dat"))
    try:
        snap = store.publish(_pts(rng, 64, 8))
        assert w.stats()["oversize_skipped"] > 0
        assert w.get(snap.version, FMT_JSON_POINTS) == _json_ref(snap, True)
        assert r.get(snap.version, FMT_JSON_POINTS) is None
    finally:
        w.close()
        r.close()


def test_reader_remaps_after_writer_recreate(rng, tmp_path):
    path = str(tmp_path / "bodystore.dat")
    store1 = SnapshotStore()
    w1 = BodyStore(path).attach(store1)
    snap1 = store1.publish(_pts(rng))
    r = BodyStoreReader(path)
    try:
        assert r.get(snap1.version, FMT_CSV) == _csv_ref(snap1)
        w1.close()
        store2 = SnapshotStore()
        w2 = BodyStore(path).attach(store2)
        store2.publish(_pts(rng))
        snap2b = store2.publish(_pts(rng))
        try:
            assert r.get(snap2b.version, FMT_CSV) == _csv_ref(snap2b)
            assert r.stats()["remaps"] >= 1
        finally:
            w2.close()
    finally:
        r.close()


def test_jax_reader_maps_the_port_writers_file(rng, tmp_path):
    """The file layout is the reference's: the JAX package's reader serves
    the port writer's frames byte for byte."""
    path = str(tmp_path / "bodystore.dat")
    store = SnapshotStore()
    w = BodyStore(path).attach(store)
    jr = jbs.BodyStoreReader(path)
    try:
        snap = store.publish(_pts(rng), partial=True)
        for fmt in FMTS:
            assert jr.get(snap.version, fmt) == w.get(snap.version, fmt)
    finally:
        w.close()
        jr.close()


# -- serve wiring: HTTP identity, counters, delta and SSE splices ----------------


def test_server_serves_bodystore_bytes_identically_to_jax(rng):
    pts = _pts(rng)
    servers, bodies = [], []
    try:
        for Store, Ring, Server, Body in (
            (SnapshotStore, DeltaRing, SkylineServer, BodyStore),
            (JSnapshotStore, JDeltaRing, JSkylineServer, jbs.BodyStore),
        ):
            store = Store()
            ring = Ring(store, capacity=16)
            body = Body(None).attach(store)
            srv = Server(store, deltas=ring, port=0, read_cache=0, bodystore=body)
            servers.append(srv)
            bodies.append(body)
            store.publish(pts, now_ms=5000.0, partial=True)
        (srv, jsrv), (body, _) = servers, bodies
        snap = srv.store.latest()
        for path, ref in (
            ("/skyline", _json_ref(snap, True)),
            ("/skyline?points=0", _json_ref(snap, False)),
            ("/skyline?explain=1", _json_ref(snap, True)),
            ("/skyline?format=csv", _csv_ref(snap)),
        ):
            status, got = _raw_get(srv.port, path)
            jstatus, jgot = _raw_get(jsrv.port, path)
            assert status == jstatus == 200
            if "csv" in path:
                assert got == ref == jgot
            else:
                cut = b', "age_ms":'
                assert got.split(cut)[0] == ref == jgot.split(cut)[0]
                json.loads(got)
        assert body.stats()["hits"] >= 4
        srv.store.restored = True
        status, got = _raw_get(srv.port, "/skyline")
        assert b'"restored": true' in got and json.loads(got)["restored"]
        status, metrics = _raw_get(srv.port, "/metrics")
        for fam in (b"skyline_serve_bodystore_hits_total",
                    b"skyline_serve_bodystore_torn_reads_total",
                    b"skyline_serve_bodystore_retries_total",
                    b"skyline_serve_read_cache_misses_total"):
            assert fam in metrics
    finally:
        for s in servers:
            s.close()
        for b in bodies:
            b.close()


def test_deltas_response_is_byte_identical_to_json_dumps_and_jax(rng):
    a, b = _pts(rng, 6, 3), _pts(rng, 7, 3)
    servers = []
    try:
        for Store, Ring, Server in ((SnapshotStore, DeltaRing, SkylineServer),
                                    (JSnapshotStore, JDeltaRing, JSkylineServer)):
            store = Store()
            ring = Ring(store, capacity=16)
            servers.append(Server(store, deltas=ring, port=0))
            store.publish(a)
            store.publish(b)
        srv, jsrv = servers
        status, got = _raw_get(srv.port, "/deltas?since=1")
        _, jgot = _raw_get(jsrv.port, "/deltas?since=1")
        assert status == 200
        entered, left, head = srv.deltas.since(1)
        rs = srv.store.read()
        expected = json.dumps({
            "from_version": 1, "to_version": head, "resync": False,
            "count_entered": int(entered.shape[0]),
            "count_left": int(left.shape[0]),
            "entered": entered.tolist(), "left": left.tolist(),
            "staleness_ms": round(rs.staleness_ms, 1),
        }).encode()
        cut = b', "staleness_ms": '
        assert got.split(cut)[0] == expected.split(cut)[0] == jgot.split(cut)[0]
        json.loads(got)
    finally:
        for s in servers:
            s.close()


def test_delta_fragments_memoize_and_match(rng):
    store = SnapshotStore()
    ring = DeltaRing(store, capacity=8)
    store.publish(_pts(rng, 5, 3))
    store.publish(_pts(rng, 6, 3))
    tail = ring.latest()
    assert tail.entered_json() == json.dumps(tail.entered.tolist()).encode()
    assert tail.left_json() == json.dumps(tail.left.tolist()).encode()
    assert tail.entered_json() is tail.entered_json()


def _sse_delta(srv, store, first, second):
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    try:
        store.publish(first, now_ms=1.0)
        sock.sendall(b"GET /subscribe HTTP/1.1\r\nHost: x\r\n\r\n")
        time.sleep(0.3)  # let the subscriber register on the loop
        store.publish(second, now_ms=2.0, partial=True)
        sock.settimeout(10)
        buf = b""
        while b"event: delta" not in buf or not buf.endswith(b"\n\n"):
            chunk = sock.recv(65536)
            assert chunk, f"stream closed early: {buf[-200:]!r}"
            buf = buf + chunk
        frame = buf.split(b"event: delta\n", 1)[1]
        return frame.split(b"data: ", 1)[1].split(b"\n\n", 1)[0]
    finally:
        sock.close()


def test_sse_delta_event_payload_matches_json_dumps_and_jax(rng):
    first, second = _pts(rng, 5, 3), _pts(rng, 6, 3)
    store, jstore = SnapshotStore(), JSnapshotStore()
    ring = DeltaRing(store, capacity=8)
    srv = SkylineServer(store, deltas=ring, port=0)
    jsrv = JSkylineServer(jstore, deltas=JDeltaRing(jstore, capacity=8), port=0)
    try:
        data = _sse_delta(srv, store, first, second)
        tail, snap = ring.latest(), store.latest()
        expected = json.dumps({
            "from_version": tail.from_version, "to_version": tail.to_version,
            "watermark_id": snap.watermark_id,
            "entered": tail.entered.tolist(), "left": tail.left.tolist(),
            "meta": snap.meta,
        }).encode()
        assert data == expected
        assert data == _sse_delta(jsrv, jstore, first, second)
    finally:
        srv.close()
        jsrv.close()


def test_reader_backed_server_serves_the_writers_bytes(rng, tmp_path):
    """A server handed a ``BodyStoreReader`` serves the writer's exact
    bytes for versions its own store also holds."""
    path = str(tmp_path / "bodystore.dat")
    primary_store = SnapshotStore()
    w = BodyStore(path).attach(primary_store)
    psnap = primary_store.publish(_pts(rng, 12, 4), now_ms=123456.0)
    replica_store = SnapshotStore()
    replica_store.restore_state(
        psnap.points, psnap.version, psnap.watermark_id, psnap.timestamp_ms
    )
    reader = BodyStoreReader(path)
    srv = SkylineServer(replica_store, port=0, read_cache=0, role="replica",
                        bodystore=reader)
    try:
        status, got = _raw_get(srv.port, "/skyline?format=csv")
        assert status == 200 and got == _csv_ref(psnap)
        status, got = _raw_get(srv.port, "/skyline")
        assert got.split(b', "age_ms":')[0] == _json_ref(psnap, True)
        assert reader.stats()["hits"] >= 2
    finally:
        srv.close()
        w.close()
        reader.close()

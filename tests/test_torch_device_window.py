"""Device ingest of the port (``skyline_tpu_torch.stream.device_window``, the
torch routing twins, ``PartitionSet(route=...)`` and the engine's
``ingest="device"``) against the JAX package on the CPU, exact bytes
(tolerance 0), on inputs made from a seed with numpy. The JAX side's rank
kernels run in interpret mode (``SKYLINE_PALLAS_INTERPRET=1``), as
``tests/test_device_ingest.py`` runs them; the port's run their plain
versions, as they do on any CPU tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.parallel.partitioners import partition_ids as j_partition_ids
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu.stream import device_window as jdw
from skyline_tpu.stream.batched import PartitionSet as JaxSet
from skyline_tpu.workload.generators import generate
from skyline_tpu_torch.parallel.partitioners import partition_ids
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream import device_window as tdw
from skyline_tpu_torch.stream.batched import PartitionSet

torch.set_num_threads(1)

TAIL = 2048  # sort tail for the function-level tests (>= every B below)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.fixture
def interpret(monkeypatch):
    """The JAX side's rank kernels in interpret mode on the CPU."""
    monkeypatch.setenv("SKYLINE_PALLAS_INTERPRET", "1")


# -- routing ------------------------------------------------------------------


@pytest.mark.parametrize("P", [8, 6])
@pytest.mark.parametrize("kind", ["int", "float", "tiny"])
@pytest.mark.parametrize("algo", ["mr-dim", "mr-grid", "mr-angle"])
@pytest.mark.parametrize("d", [2, 3, 8])
def test_partition_ids_match_jax(rng, d, algo, kind, P):
    """The compiled JAX routing, as device ingest runs it: atan2(0, 0) and
    ``-0.0`` rows included."""
    n = 20000
    if kind == "int":
        x = rng.integers(0, 10001, size=(n, d)).astype(np.float32)
    elif kind == "float":
        x = (rng.random((n, d)) * 10000).astype(np.float32)
    else:
        x = rng.integers(0, 3, size=(n, d)).astype(np.float32)
    x[:50] = 0.0
    x[50:60] = -0.0
    x[60:70, 0] = -0.0
    jit_ids = jax.jit(j_partition_ids, static_argnums=(1, 2, 3))
    want = np.asarray(jit_ids(_j(x), algo, P, 10000.0))
    got = partition_ids(_t(x), algo, P, 10000.0)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        partition_ids(_t(x), "mr-nope", P, 10000.0)


@pytest.mark.parametrize("d", [3, 4, 8, 16])
def test_row_sums_round_like_jnp_sum(rng, d):
    """The sort key: float32 row sums whose rounding depends on the order."""
    x = (rng.random((50000, d)) * 1000 + rng.random((50000, d)) * 1e-3).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(_j(x)))
    assert tdw.row_sums(_t(x)).numpy().tobytes() == want.tobytes()


# -- window functions -----------------------------------------------------------


def _window_inputs(rng, d, P, cap, chunks):
    """Two packages' window buffers after ingesting ``chunks`` (row counts)
    of anti-correlated rows with ties, each chunk padded to its bucket."""
    jwin = jnp.full((cap, d), jnp.inf, jnp.float32)
    jpid = jnp.full((cap,), P, jnp.int32)
    twin = torch.full((cap, d), float("inf"))
    tpid = torch.full((cap,), P, dtype=torch.int32)
    off = 0
    stats = []
    for m in chunks:
        bucket = 1 << max(m - 1, 1).bit_length()
        x = np.full((bucket, d), np.inf, np.float32)
        x[:m] = generate("anti_correlated", rng, m, d, 0, 100)
        ids = np.full((bucket,), -1, np.int32)
        ids[:m] = rng.integers(0, 10**6, m)
        kw = dict(algo="mr-angle", num_partitions=P, domain_max=100.0)
        jwin, jpid, js = jdw.ingest_chunk(jwin, jpid, _j(x), _j(ids), m, off, **kw)
        ts = tdw.ingest_chunk(twin, tpid, _t(x), _t(ids), m, off, **kw)
        stats.append((np.asarray(js), ts.numpy()))
        off += m
    return (jwin, jpid), (twin, tpid), stats, off


@pytest.mark.parametrize("d", [3, 8])
def test_ingest_chunk_matches_jax(rng, d):
    (jwin, jpid), (twin, tpid), stats, _ = _window_inputs(rng, d, 8, 4096, [700, 1024, 300])
    assert twin.numpy().tobytes() == np.asarray(jwin).tobytes()
    assert tpid.numpy().tobytes() == np.asarray(jpid).tobytes()
    for js, ts in stats:
        assert ts.dtype == np.int32 and ts.tobytes() == js.tobytes()


@pytest.mark.parametrize("d", [3, 8])
def test_sort_window_matches_jax(rng, d):
    """Including stale rows past ``nvalid`` from a larger earlier fill of
    the reused buffer."""
    P = 8
    (jwin, jpid), (twin, tpid), _, n = _window_inputs(rng, d, P, 4096, [1024, 1024, 900])
    for nvalid in (n, 1500):
        nb = 1 << (nvalid - 1).bit_length()
        jws, jb = jdw.sort_window(jwin, jpid, nvalid, nb, P, TAIL)
        tws, tb = tdw.sort_window(twin, tpid, nvalid, nb, P, TAIL)
        assert tws.numpy().tobytes() == np.asarray(jws).tobytes()
        assert tb.dtype == torch.int32 and tb.numpy().tobytes() == np.asarray(jb).tobytes()


def _flush_state(rng, d, P=4, cap=2048, n=2000):
    """A sorted window, its bounds and a skyline state (each partition's
    prefix: sum-sorted skyline rows, +inf past the count), as numpy."""
    (jwin, jpid), _, _, n = _window_inputs(rng, d, P, 4096, [1024, n - 1024])
    nb = 1 << (n - 1).bit_length()
    ws, bounds = (np.asarray(a) for a in jdw.sort_window(jwin, jpid, n, nb, P, TAIL))
    sky = np.full((P, cap, d), np.inf, np.float32)
    counts = np.zeros(P, np.int64)
    for p in range(P):
        rows = generate("anti_correlated", rng, 300, d, 0, 100)
        from skyline_tpu.ops.dominance import skyline_np

        s = skyline_np(rows).astype(np.float32)
        s = s[np.argsort(s.sum(axis=1), kind="stable")]
        sky[p, : len(s)] = s
        counts[p] = len(s)
    return ws, bounds, nb, sky, counts


@pytest.mark.parametrize("active_old", [0, 1024])
@pytest.mark.parametrize("d", [3, 8])
def test_rank_window_matches_jax(rng, d, active_old):
    ws, _, nb, sky, counts = _flush_state(rng, d)
    univ = 1 << (nb + 4 * active_old - 1).bit_length()
    jsd, jwr = jdw.rank_window(_j(ws), _j(sky), _j(counts.astype(np.int32)), nb, active_old, univ)
    tsd, twr = tdw.rank_window(_t(ws), _t(sky), _t(counts), nb, active_old, univ)
    assert tsd.numpy().tobytes() == np.asarray(jsd).tobytes()
    assert twr.dtype == torch.int32 and twr.numpy().tobytes() == np.asarray(jwr).tobytes()
    rows = sky[1, :700]
    want = np.asarray(jdw._rank_rows(jsd, _j(rows)))
    assert tdw._rank_rows(tsd, _t(rows)).numpy().tobytes() == want.tobytes()


def _same_round(jout, tout):
    assert tout[0].numpy().tobytes() == np.asarray(jout[0]).tobytes()
    assert np.array_equal(tout[1].numpy(), np.asarray(jout[1]))


@pytest.mark.parametrize("d", [3, 8])
def test_sfs_rounds_at_match_jax(rng, d, interpret):
    """Single-partition and all-partition rounds, value and rank space,
    each slicing its blocks from the sorted window (ragged last blocks
    included)."""
    ws, bounds, nb, sky, counts = _flush_state(rng, d)
    P = sky.shape[0]
    univ = 1 << (nb + P * 1024 - 1).bit_length()
    jsd, jwr = jdw.rank_window(_j(ws), _j(sky), _j(counts.astype(np.int32)), nb, 1024, univ)
    tsd, twr = tdw.rank_window(_t(ws), _t(sky), _t(counts), nb, 1024, univ)
    B, active = 1024, 1024
    jc = counts.astype(np.int32)
    for p in range(P):
        off, width = int(bounds[p]), min(B, int(bounds[p + 1] - bounds[p]))
        want = jdw.sfs_round_at(_j(sky[p]), jc[p], _j(ws), off, width, B=B, active=active)
        got = tdw.sfs_round_at(_t(sky[p]), _t(counts[p]), _t(ws), off, width, B=B, active=active)
        _same_round(want, got)
        want = jdw.sfs_round_at_rank(
            _j(sky[p]), jc[p], _j(ws), jwr, jsd, off, width, B=B, active=active
        )
        got = tdw.sfs_round_at_rank(
            _t(sky[p]), _t(counts[p]), _t(ws), twr, tsd, off, width, B=B, active=active
        )
        _same_round(want, got)
    offs = bounds[:-1] + 512
    widths = np.clip(bounds[1:] - offs, 0, B)
    want = jdw.sfs_round_at_vmapped(
        _j(sky), _j(jc), _j(ws), _j(offs.astype(np.int32)), _j(widths.astype(np.int32)),
        B=B, active=active,
    )
    got = tdw.sfs_round_at_vmapped(
        _t(sky), _t(counts), _t(ws), _t(offs.astype(np.int64)), _t(widths.astype(np.int64)),
        B=B, active=active,
    )
    _same_round(want, got)
    want = jdw.sfs_round_at_rank_vmapped(
        _j(sky), _j(jc), _j(ws), jwr, jsd, _j(offs.astype(np.int32)),
        _j(widths.astype(np.int32)), B=B, active=active,
    )
    got = tdw.sfs_round_at_rank_vmapped(
        _t(sky), _t(counts), _t(ws), twr, tsd, _t(offs.astype(np.int64)),
        _t(widths.astype(np.int64)), B=B, active=active,
    )
    _same_round(want, got)


@pytest.mark.parametrize("d", [3, 8])
def test_sfs_cleanup_rank_matches_jax(rng, d, interpret):
    """Old rows (the prefix) pruned by rows appended after them, in rank
    space over the window-plus-old-prefix universe."""
    ws, bounds, nb, sky, counts = _flush_state(rng, d)
    P = sky.shape[0]
    for p in range(P):  # old rows that the rows appended below dominate
        sky[p, :20] = ws[bounds[p] : bounds[p] + 20] + 1.0
    univ = 1 << (nb + P * 1024 - 1).bit_length()
    jsd, _ = jdw.rank_window(_j(ws), _j(sky), _j(counts.astype(np.int32)), nb, 1024, univ)
    tsd, _ = tdw.rank_window(_t(ws), _t(sky), _t(counts), nb, 1024, univ)
    old = counts.copy()
    # append each partition's first window rows after its old prefix
    for p in range(P):
        rows = ws[bounds[p] : bounds[p] + 200]
        sky[p, old[p] : old[p] + len(rows)] = rows
        counts[p] = old[p] + len(rows)
    want = jdw.sfs_cleanup_rank(
        _j(sky), _j(counts.astype(np.int32)), _j(old.astype(np.int32)), jsd, 1024, 2048
    )
    got = tdw.sfs_cleanup_rank(_t(sky), _t(counts), _t(old), tsd, 1024, 2048)
    _same_round(want, got)
    assert (got[1] < _t(counts)).any()  # something was pruned


# -- the partition set and the engine -----------------------------------------------


def test_partition_set_ingest_bookkeeping_matches_jax(rng):
    """Barrier bookkeeping synced from the device stats, chunk splitting at
    65,536 rows included."""
    P, d = 8, 3
    x = generate("uniform", rng, 70000, d, 0, 10000)
    ids = rng.permutation(70000).astype(np.int64)
    js = JaxSet(P, d, flush_policy="lazy", route=("mr-angle", 10000.0))
    ts = PartitionSet(P, d, flush_policy="lazy", route=("mr-angle", 10000.0), device="cpu")
    assert ts.device_ingest and not PartitionSet(P, d, device="cpu").device_ingest
    for s, lo, hi in ((js, 0, 1000), (ts, 0, 1000), (js, 1000, 70000), (ts, 1000, 70000)):
        s.ingest_chunk(ids[lo:hi], x[lo:hi], now_ms=float(lo))
    assert ts.has_unsynced_ingest and ts.pending_rows_total == 70000
    js.sync_ingest_bookkeeping()
    ts.sync_ingest_bookkeeping()
    assert not ts.has_unsynced_ingest
    assert np.array_equal(ts.max_seen_id, js.max_seen_id)
    assert np.array_equal(ts.records_seen, js.records_seen)
    assert ts.start_time_ms == js.start_time_ms
    js.flush_all()
    ts.flush_all()
    assert ts.pending_rows_total == 0
    assert np.array_equal(ts.sky_counts(), js.sky_counts())
    for p in range(P):
        assert ts.skyline_host(p).tobytes() == js.skyline_host(p).tobytes()
    with pytest.raises(ValueError, match="int32"):
        ts.ingest_chunk(np.array([2**31]), np.zeros((1, d), np.float32), 0.0)


def _drive(engine, windows, chunk=500):
    """Windows back to back through one engine, an immediate trigger after
    each; returns (results, local sizes after each trigger)."""
    out, sizes = [], []
    base = 0
    for i, x in enumerate(windows):
        ids = np.arange(base, base + len(x), dtype=np.int64)
        base += len(x)
        for s in range(0, len(x), chunk):
            engine.process_records(ids[s : s + chunk], x[s : s + chunk])
        engine.process_trigger(f"q{i},0")
        out += engine.poll_results()
        sizes.append(np.asarray(engine.pset.sky_counts()).tolist())
    return out, sizes


def _assert_same(want, got):
    (wr, ws), (gr, gs) = want, got
    assert gs == ws
    assert len(wr) == len(gr)
    for a, b in zip(wr, gr):
        assert b["skyline_size"] == a["skyline_size"]
        assert b["optimality"] == a["optimality"]
        pa = np.asarray(a["skyline_points"], np.float32)
        pb = np.asarray(b["skyline_points"], np.float32)
        assert pb.tobytes() == pa.tobytes()


def _configs(d, algo, **kw):
    common = dict(
        parallelism=4, algo=algo, dims=d, domain_max=10000.0, buffer_size=1024,
        emit_skyline_points=True, flush_policy="lazy", ingest="device", **kw,
    )
    return JaxConfig(**common), EngineConfig(**{**common, "device": "cpu"})


@pytest.mark.parametrize("gate", ["1", "0"])
@pytest.mark.parametrize("algo", ["mr-angle", "mr-dim", "mr-grid"])
@pytest.mark.parametrize("dist", ["uniform", "correlated", "anti_correlated"])
@pytest.mark.parametrize("d", [3, 4, 8])
def test_device_engine_matches_jax(d, dist, algo, gate, interpret, monkeypatch):
    """Two windows through one engine each (the second flush ranks the old
    prefixes into the universe and runs the cleanup): sizes, optimality,
    local sizes and point bytes, rank cascade on and off."""
    monkeypatch.setenv("SKYLINE_RANK_CASCADE", gate)
    assert tdw.rank_flush_enabled() == (gate == "1")
    rng = np.random.default_rng(100 * d + len(dist) + len(algo))
    windows = [generate(dist, rng, 1200, d, 0, 10000) for _ in range(2)]
    jcfg, tcfg = _configs(d, algo)
    _assert_same(_drive(JaxEngine(jcfg), windows), _drive(SkylineEngine(tcfg), windows))


def test_device_engine_skewed_rounds_match_jax(interpret, monkeypatch):
    """4096-row 8-D anti-correlated windows with a small buffer: mr-angle
    routes most rows to few partitions (the sequential rounds, with the
    probe-block escalation), mr-grid spreads them (the batched rounds)."""
    monkeypatch.setenv("SKYLINE_RANK_CASCADE", "1")
    rng = np.random.default_rng(5)
    windows = [generate("anti_correlated", rng, 4096, 8, 0, 10000) for _ in range(2)]
    for algo in ("mr-angle", "mr-grid"):
        jcfg, tcfg = _configs(8, algo, initial_capacity=2048)
        _assert_same(
            _drive(JaxEngine(jcfg), windows, chunk=4096),
            _drive(SkylineEngine(tcfg), windows, chunk=4096),
        )


def test_device_engine_barrier_path_matches_jax():
    """A trigger whose barrier is not met waits; device ingest syncs its
    bookkeeping when later data arrives and answers per partition."""
    rng = np.random.default_rng(9)
    x = generate("anti_correlated", rng, 3000, 4, 0, 10000)
    ids = np.arange(3000, dtype=np.int64)
    jcfg, tcfg = _configs(4, "mr-dim")
    results = []
    for eng in (JaxEngine(jcfg), SkylineEngine(tcfg)):
        eng.process_records(ids[:1000], x[:1000])
        eng.process_trigger("late,2500")
        assert eng.poll_results() == []
        eng.process_records(ids[1000:], x[1000:])
        results.append((eng.poll_results(), []))
    _assert_same(*results)
    assert results[1][0][0]["skyline_size"] > 0


def test_load_state_drops_the_device_window(rng):
    ts = PartitionSet(4, 3, flush_policy="lazy", route=("mr-dim", 100.0), device="cpu")
    x = generate("uniform", rng, 500, 3, 0, 100)
    ts.ingest_chunk(np.arange(500), x, 0.0)
    ts.load_state(np.zeros((4, 16, 3), np.float32), np.zeros(4, np.int64))
    assert ts.pending_rows_total == 0 and not ts.has_unsynced_ingest
    ts.flush_all()
    assert ts.sky_counts().tolist() == [0, 0, 0, 0]

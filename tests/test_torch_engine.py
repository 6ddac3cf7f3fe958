"""The whole slice against the JAX engine: the same stream through
``skyline_tpu.stream.SkylineEngine`` (host ingest, lazy flush) and
``skyline_tpu_torch.stream.SkylineEngine`` on the CPU must give the same
skyline size, optimality and point bytes, window after window (the second
window runs the old-vs-new cleanup). Plus state carried across packages."""

import numpy as np
import pytest
import torch

from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu.stream.batched import PartitionSet as JaxSet
from skyline_tpu.workload.generators import generate
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream.batched import PartitionSet

torch.set_num_threads(1)


def _drive(engine, windows, chunk=2500):
    """Windows back to back through one engine, an immediate trigger after
    each; returns the results in order."""
    out = []
    base = 0
    for i, x in enumerate(windows):
        ids = np.arange(base, base + len(x), dtype=np.int64)
        base += len(x)
        for s in range(0, len(x), chunk):
            engine.process_records(ids[s : s + chunk], x[s : s + chunk])
        engine.process_trigger(f"q{i},0")
        out += engine.poll_results()
    return out


def _assert_same_results(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert b["skyline_size"] == a["skyline_size"]
        assert b["optimality"] == a["optimality"]
        assert b["query_id"] == a["query_id"] and b["record_count"] == a["record_count"]
        pa = np.asarray(a["skyline_points"], np.float32)
        pb = np.asarray(b["skyline_points"], np.float32)
        assert pb.tobytes() == pa.tobytes()


def _configs(d, algo, **kw):
    common = dict(
        parallelism=4, algo=algo, dims=d, domain_max=10000.0, buffer_size=1024,
        emit_skyline_points=True, flush_policy="lazy", ingest="host", **kw,
    )
    return JaxConfig(**common), EngineConfig(**{**common, "device": "cpu"})


@pytest.mark.parametrize("algo", ["mr-angle", "mr-dim"])
@pytest.mark.parametrize("dist", ["uniform", "correlated", "anti_correlated"])
@pytest.mark.parametrize("d", [3, 4, 8])
def test_engine_matches_jax(d, dist, algo):
    rng = np.random.default_rng(100 * d + len(dist))
    windows = [generate(dist, rng, 4000, d, 0, 10000) for _ in range(2)]
    jcfg, tcfg = _configs(d, algo)
    _assert_same_results(_drive(JaxEngine(jcfg), windows), _drive(SkylineEngine(tcfg), windows))


def test_engine_matches_jax_large_window():
    """20k-row 8-D anti-correlated windows with a pre-sized buffer: the
    probe-block escalation and the batched rounds both run."""
    rng = np.random.default_rng(5)
    windows = [generate("anti_correlated", rng, 20000, 8, 0, 10000) for _ in range(2)]
    jcfg, tcfg = _configs(8, "mr-grid", initial_capacity=4096)
    _assert_same_results(
        _drive(JaxEngine(jcfg), windows, chunk=8192),
        _drive(SkylineEngine(tcfg), windows, chunk=8192),
    )


def test_engine_barrier_path_matches_jax():
    """A trigger whose barrier is not met waits for data, answers through
    the per-partition snapshots and the host-side union merge."""
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
        results.append(eng.poll_results())
    _assert_same_results(*results)
    assert results[1][0]["skyline_size"] > 0


def _jax_flushed(rng, P, d, n):
    js = JaxSet(P, d, buffer_size=1024, flush_policy="lazy")
    x = generate("anti_correlated", rng, n, d, 0, 10000)
    pids = rng.integers(0, P, n)
    for p in range(P):
        if (pids == p).any():
            js.add_batch(p, np.ascontiguousarray(x[pids == p]), n, 0.0)
    js.flush_all()
    return js, x, pids


def test_load_state_round_trip_from_jax():
    """A flushed JAX PartitionSet's skylines load into the port; both then
    take the same rows, flush (the port runs its cleanup) and merge to the
    same bytes."""
    P, d = 8, 4
    rng = np.random.default_rng(21)
    js, _, _ = _jax_flushed(rng, P, d, 6000)
    sky, counts = np.asarray(js.sky), js.sky_counts()
    ts = PartitionSet(P, d, buffer_size=1024, flush_policy="lazy", device="cpu")
    ts.load_state(sky, counts, max_seen_id=js.max_seen_id, records_seen=js.records_seen)
    tsky, tcounts = ts.state_numpy()
    assert np.array_equal(tcounts, counts)
    for p in range(P):
        assert tsky[p, : counts[p]].tobytes() == sky[p, : counts[p]].tobytes()
        assert np.isinf(tsky[p, counts[p] :]).all()
    assert np.array_equal(ts.max_seen_id, js.max_seen_id)

    more = generate("anti_correlated", rng, 3000, d, 0, 10000)
    pids = rng.integers(0, P, 3000)
    for s in (js, ts):
        for p in range(P):
            if (pids == p).any():
                s.add_batch(p, np.ascontiguousarray(more[pids == p]), 9000, 1.0)
        s.flush_all()
    jc, jsurv, jg, jpts = js.global_merge_stats(emit_points=True)
    tc, tsurv, tg, tpts = ts.global_merge_stats(emit_points=True)
    assert np.array_equal(np.asarray(tc), jc) and np.array_equal(np.asarray(tsurv), jsurv)
    assert tg == jg and tpts.tobytes() == np.asarray(jpts).tobytes()
    for p in range(P):
        assert ts.skyline_host(p).tobytes() == js.skyline_host(p).tobytes()


def test_load_state_rejects_mismatched_state():
    ts = PartitionSet(4, 3, device="cpu")
    with pytest.raises(ValueError):
        ts.load_state(np.zeros((4, 16, 5), np.float32), np.zeros(4))
    with pytest.raises(ValueError):
        ts.load_state(np.zeros((4, 16, 3), np.float32), np.full(4, 17))


def test_partition_set_snapshot_matches_jax():
    P, d = 8, 3
    rng = np.random.default_rng(4)
    js, x, pids = _jax_flushed(rng, P, d, 5000)
    ts = PartitionSet(P, d, buffer_size=1024, flush_policy="lazy", device="cpu")
    for p in range(P):
        if (pids == p).any():
            ts.add_batch(p, np.ascontiguousarray(x[pids == p]), 5000, 0.0)
    for p in range(P):
        assert ts.snapshot(p).tobytes() == js.snapshot(p).tobytes()
    assert np.array_equal(ts.sky_counts(), js.sky_counts())

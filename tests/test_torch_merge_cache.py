"""The epoch-keyed global-merge cache and the overlapped query sync against
the JAX package, exact bytes on the CPU: ``global_merge_delta_device``, the
exact hit (no merge function runs), delta merges and their counters, the
cutoff knob, random flush and query interleavings under all three flush
policies with the cache on and off, ``load_state`` dropping the cache, and
the engine with the query overlap on and off — consecutive triggers, a
flush between launch and harvest, interleaved windows and repeated
triggers. The ``cuda``-marked twins skip without a card."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.ops import dispatch as jdispatch
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu.stream import window as jwin
from skyline_tpu.stream.batched import PartitionSet as JaxSet
from skyline_tpu.workload.generators import anti_correlated, correlated, generate, uniform
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream import batched as tbatched
from skyline_tpu_torch.stream import window as twin
from skyline_tpu_torch.stream.batched import PartitionSet
from skyline_tpu_torch.ops import cascade
from skyline_tpu_torch.utils import knobs

from test_torch_merge_tree import assert_same_counters, assert_same_merge, merge_of

torch.set_num_threads(1)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _twins(P, d, **kw):
    return JaxSet(P, d, **kw), PartitionSet(P, d, device="cpu", **kw)


def _feed(sets, rng, x, P, max_id=0, parts=None):
    """Route ``x`` at random over ``parts`` (default all) of ``P`` partitions
    into every set, then flush each."""
    parts = np.arange(P) if parts is None else np.asarray(parts)
    pids = parts[rng.integers(0, len(parts), x.shape[0])]
    for s in sets:
        for p in parts:
            rows = np.ascontiguousarray(x[pids == p])
            if rows.shape[0]:
                s.add_batch(int(p), rows, max_id, 0.0)
        s.flush_all()


# -- the delta function ---------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 3, 8])
def test_global_merge_delta_matches_jax(rng, d):
    """Dirty skylines and cached clean segments (whose slices run into the
    next partitions' survivors) against the JAX function."""
    P, cap = 5, 2048
    counts = np.array([300, 0, 1000, 40, 700])
    sky = np.full((P, cap, d), np.inf, np.float32)
    for p in range(P):
        sky[p, : counts[p]] = rng.integers(0, 50, size=(counts[p], d))
    surv = np.array([120, 0, 500, 40, 10])
    g = int(surv.sum())
    gpts = np.full((2 * twin._next_pow2(g), d), np.inf, np.float32)
    gpts[:g] = rng.integers(0, 50, size=(g, d))
    bounds = np.concatenate(([0], np.cumsum(surv))).astype(np.int32)
    dirty = (True, False, False, True, False)
    seg = np.where(dirty, 0, surv)
    clean_active = twin._active_bucket(int(seg.max()))
    active = twin._active_bucket(int(counts[list(dirty)].max()))
    union_cap = twin._active_bucket(int(seg.sum() + counts[list(dirty)].sum()))
    ju, jk, js = jwin.global_merge_delta_device(
        jnp.asarray(sky), jnp.asarray(counts.astype(np.int32)), jnp.asarray(gpts),
        jnp.asarray(bounds), active, clean_active, union_cap, dirty,
    )
    tu, tk, ts = twin.global_merge_delta_device(
        torch.from_numpy(sky), torch.from_numpy(counts), torch.from_numpy(gpts),
        bounds.astype(np.int64), active, clean_active, union_cap, dirty,
    )
    assert tu.numpy().tobytes() == np.asarray(ju).tobytes()
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="cannot hold"):
        twin.global_merge_delta_device(
            torch.from_numpy(sky), torch.from_numpy(counts), torch.from_numpy(gpts[:g]),
            bounds, active, clean_active, union_cap, dirty,
        )


# -- PartitionSet ---------------------------------------------------------------------


def _watch_merges(monkeypatch):
    """Count calls of every merge function ``PartitionSet`` launches."""
    calls = []
    for name in ("global_merge_stats_device", "global_merge_delta_device",
                 "tree_pair_merge", "extract_sky_leaf", "extract_cached_leaf",
                 "partition_summaries_device"):
        real = getattr(tbatched, name)

        def counted(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(tbatched, name, counted)
    return calls


@pytest.mark.parametrize("d", [2, 4])
def test_repeated_trigger_is_pure_cache_hit(rng, monkeypatch, d):
    """A repeated trigger with no flush in between runs no merge function,
    and its answers are copies the caller may write into."""
    js, ts = _twins(4, d, buffer_size=256)
    _feed([js, ts], rng, uniform(rng, 2000, d, 0, 10000).astype(np.float32), 4)
    first = merge_of(ts)
    assert_same_merge(merge_of(js), first)
    calls = _watch_merges(monkeypatch)
    second = merge_of(ts)
    merge_of(js)
    assert calls == []
    assert ts.merge_cache_hits == 1 and ts.merge_cache_misses == 1
    assert_same_merge(first, second)
    second[3][:] = -1.0
    second[0][:] = -1
    assert_same_merge(first, merge_of(ts))
    merge_of(js)
    assert_same_counters(js, ts)


def test_flush_invalidates_and_delta_merges(rng, monkeypatch):
    """Dirtying one partition of eight takes the delta path (1/8 <= the
    cutoff) and equals the cache-off full merge and the JAX package."""
    P = 8
    x = anti_correlated(rng, 4000, 4, 0, 10000).astype(np.float32)
    js, ts = _twins(P, 4, buffer_size=512)
    ref = PartitionSet(P, 4, buffer_size=512, device="cpu")
    _feed([js, ts, ref], np.random.default_rng(0), x, P)
    merge_of(js), merge_of(ts)
    top = uniform(rng, 64, 4, 0, 10000).astype(np.float32)
    for s in (js, ts, ref):
        s.add_batch(0, top, 1, 0.0)
        s.flush_all()
    got = merge_of(ts)
    assert_same_merge(merge_of(js), got)
    assert ts.merge_delta_merges == 1 and ts.last_dirty_fraction == 1 / P
    assert ts.merge_delta_rows > 0
    assert_same_counters(js, ts)
    monkeypatch.setenv("SKYLINE_MERGE_CACHE", "0")
    assert_same_merge(merge_of(ref), got)


def test_delta_cutoff_zero_disables_delta_path(rng, monkeypatch):
    monkeypatch.setenv("SKYLINE_DELTA_CUTOFF", "0")
    js, ts = _twins(4, 3, buffer_size=256)
    _feed([js, ts], rng, uniform(rng, 1000, 3, 0, 10000).astype(np.float32), 4)
    merge_of(js), merge_of(ts)
    extra = uniform(rng, 16, 3, 0, 10000).astype(np.float32)
    for s in (js, ts):
        s.add_batch(0, extra, 1, 0.0)
        s.flush_all()
    assert_same_merge(merge_of(js), merge_of(ts))
    assert ts.merge_delta_merges == 0 and ts.merge_cache_misses == 2
    assert_same_merge(merge_of(js), merge_of(ts))
    assert ts.merge_cache_hits == 1
    assert_same_counters(js, ts)


GENS = {"uniform": uniform, "correlated": correlated, "anti_correlated": anti_correlated}


POLICIES = ("incremental", "lazy", "overlap")


@pytest.mark.parametrize("gen", list(GENS))
@pytest.mark.parametrize("d", [2, 4, 8])
def test_random_interleaving_matches_jax(monkeypatch, gen, d):
    """Random flush and query interleavings: every answer of the cached port
    set equals the JAX package's (cache on too) and a cache-off port twin's,
    and the two packages' counters agree at the end. Dirty subsets, repeated
    triggers and flushes with nothing pending. The flush policy runs a Latin
    square over (d, generator): each policy meets each d and each
    generator once."""
    policy = POLICIES[([2, 4, 8].index(d) + list(GENS).index(gen)) % 3]
    P = 4
    g = GENS[gen]
    rng = np.random.default_rng(d * 101 + len(gen))
    kw = dict(buffer_size=256, flush_policy=policy, overlap_rows=300)
    js, ts = _twins(P, d, **kw)
    plain = PartitionSet(P, d, device="cpu", **kw)

    def trigger_all():
        monkeypatch.setenv("SKYLINE_MERGE_CACHE", "1")
        want, got = merge_of(js), merge_of(ts)
        monkeypatch.setenv("SKYLINE_MERGE_CACHE", "0")
        assert_same_merge(want, got, "(jax vs port)")
        assert_same_merge(merge_of(plain), got, "(cache off vs on)")

    sets = (js, ts, plain)
    _feed(sets, rng, g(rng, 800, d, 0, 10000).astype(np.float32), P)
    for step in range(6):
        op = rng.integers(0, 3)
        if step == 0 or op == 0:
            parts = rng.choice(P, size=int(rng.integers(1, P + 1)), replace=False)
            for p in parts:
                rows = g(rng, int(rng.integers(1, 300)), d, 0, 10000).astype(np.float32)
                for s in sets:
                    s.add_batch(int(p), rows.copy(), step, 0.0)
                    s.maybe_flush()
            for s in sets:
                s.flush_all()
        elif op == 2:
            for s in sets:
                s.flush_all()
        trigger_all()
    assert_same_counters(js, ts)
    assert ts.merge_cache_hits > 0


def test_equivalence_with_staging_disabled(rng, monkeypatch):
    monkeypatch.setenv("SKYLINE_STAGE_DEPTH", "0")
    P, d = 4, 4
    x = anti_correlated(rng, 3000, d, 0, 10000).astype(np.float32)
    js, ts = _twins(P, d, buffer_size=256)
    plain = PartitionSet(P, d, buffer_size=256, device="cpu")
    _feed([js, ts, plain], np.random.default_rng(3), x, P)
    a, a2, want = merge_of(ts), merge_of(ts), merge_of(js)
    monkeypatch.setenv("SKYLINE_MERGE_CACHE", "0")
    b = merge_of(plain)
    assert a[3].tobytes() == b[3].tobytes() == a2[3].tobytes() == want[3].tobytes()
    assert ts.merge_cache_hits == 1


def test_load_state_drops_cache(rng):
    """Loading state advances every epoch and drops the cache: a stale cached
    global would bring back the old state."""
    ps = PartitionSet(2, 3, buffer_size=128, device="cpu")
    _feed([ps], rng, uniform(rng, 500, 3, 0, 10000).astype(np.float32), 2)
    old = merge_of(ps)
    epoch = ps.epoch.copy()
    sky, counts = ps.state_numpy()
    sky[:, :, 0] += 20000  # another world with the same counts
    ps.load_state(sky, counts)
    assert (ps.epoch == epoch + 1).all() and ps._gm_cache is None
    after = merge_of(ps)
    assert ps.merge_cache_hits == 0 and ps.merge_cache_misses == 2
    assert after[2] == old[2] and after[3].tobytes() != old[3].tobytes()
    fresh = PartitionSet(2, 3, buffer_size=128, device="cpu")
    fresh.load_state(sky, counts)
    assert_same_merge(merge_of(fresh), after)


@pytest.mark.parametrize("d", [3, 8])
def test_flush_between_launch_and_harvest(rng, d):
    """The overlap's aliasing case: a merge launched over one live
    partition (a one-leaf tree root) and a cached global, then a lazy flush
    appends into the state in place, then the harvest. The answer, the
    cache's +inf padding past g and the next (delta) merge equal the JAX
    package's, which has immutable arrays."""
    P = 4
    # room for the append, so it writes into the very buffer the leaf reads
    js, ts = _twins(P, d, flush_policy="lazy", initial_capacity=4096)
    x = anti_correlated(rng, 600, d, 0, 10000).astype(np.float32)
    y = anti_correlated(rng, 600, d, 0, 10000).astype(np.float32)
    for s in (js, ts):
        s.add_batch(1, x, 600, 0.0)
        s.flush_all()
    handles = [s.global_merge_launch(emit_points=True) for s in (js, ts)]
    for s in (js, ts):
        s.add_batch(1, y, 1200, 0.0)
        s.add_batch(2, y[:50], 1200, 0.0)
        s.flush_all()
    want, got = (s.global_merge_harvest(h) for s, h in zip((js, ts), handles))
    assert_same_merge(want, got, "(harvest after a flush)")
    g = got[2]
    assert torch.isinf(ts._gm_cache["pts_dev"][g:]).all()
    assert_same_merge(merge_of(js), merge_of(ts), "(delta after the harvest)")
    assert ts.merge_delta_merges == 1
    assert_same_counters(js, ts)


# -- the engine -----------------------------------------------------------------------


def _configs(d, policy, ingest="host", **kw):
    common = dict(
        parallelism=2, algo="mr-angle", dims=d, domain_max=10000.0, buffer_size=256,
        emit_skyline_points=True, flush_policy=policy, ingest=ingest,
    )
    common.update(kw)
    return JaxConfig(**common), EngineConfig(**{**common, "device": "cpu"})


def _same_results(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        for k in ("query_id", "record_count", "skyline_size", "optimality"):
            assert b[k] == a[k], k
        pa = np.asarray(a["skyline_points"], np.float32)
        pb = np.asarray(b["skyline_points"], np.float32)
        assert pb.tobytes() == pa.tobytes()


def _interleaved(eng, rng_seed, d, P):
    """Windows, repeated triggers and chunks routed to a subset of
    partitions (rows picked by the routing itself), with ingest landing
    while a merge is in flight; the last two windows' triggers take delta
    merges. Returns (results, overlapped triggers)."""
    from skyline_tpu_torch.parallel.partitioners import partition_ids_np

    def lower_half(x):
        return np.ascontiguousarray(x[partition_ids_np(x, "mr-angle", P, 10000.0) < P // 2])

    rng = np.random.default_rng(rng_seed)
    out, nid, overlapped = [], 0, 0
    for rnd in range(4):
        x = generate("anti_correlated", rng, 1500, d, 0, 10000)
        if rnd >= 2:
            x = lower_half(x)
        ids = np.arange(nid, nid + len(x))
        nid += len(x)
        eng.process_records(ids, x, now_ms=float(rnd))
        eng.process_trigger(f"q{rnd},0", now_ms=rnd + 0.5)
        overlapped += eng._inflight_merge is not None
        eng.process_trigger(f"r{rnd},0", now_ms=rnd + 0.6)
        y = generate("anti_correlated", rng, 400, d, 0, 10000)
        if rnd >= 1:
            y = lower_half(y)
        ids = np.arange(nid, nid + len(y))
        nid += len(y)
        eng.process_records(ids, y, now_ms=rnd + 0.7)
        out += eng.poll_results()
    return out, overlapped


@pytest.mark.parametrize("overlap", ["1", "0"])
@pytest.mark.parametrize("policy", ["incremental", "lazy", "overlap"])
@pytest.mark.parametrize("d", [2, 3])
def test_engine_interleaved_matches_jax(monkeypatch, d, policy, overlap):
    """The engine with the query overlap on and off against the JAX engine
    (same knob): every answer and every plane counter."""
    monkeypatch.setenv("SKYLINE_QUERY_OVERLAP", overlap)
    jcfg, tcfg = _configs(d, policy, overlap_rows=700)
    je, te = JaxEngine(jcfg), SkylineEngine(tcfg)
    want, _ = _interleaved(je, 11, d, 4)
    got, overlapped = _interleaved(te, 11, d, 4)
    _same_results(want, got)
    assert len(got) == 8
    assert overlapped == (4 if overlap == "1" else 0)
    assert_same_counters(je.pset, te.pset)
    assert te.pset.merge_cache_hits >= 4 and te.pset.merge_delta_merges >= 1


def test_overlap_on_matches_overlap_off(monkeypatch):
    runs = {}
    for overlap in ("1", "0"):
        monkeypatch.setenv("SKYLINE_QUERY_OVERLAP", overlap)
        runs[overlap] = _interleaved(SkylineEngine(_configs(4, "incremental")[1]), 3, 4, 4)[0]
    _same_results(runs["0"], runs["1"])


def test_overlap_consecutive_triggers(monkeypatch):
    """A second trigger harvests the first's merge before launching its own:
    results in trigger order, one each; the repeat is an exact hit."""
    monkeypatch.setenv("SKYLINE_QUERY_OVERLAP", "1")
    rng = np.random.default_rng(5)
    eng = SkylineEngine(_configs(3, "incremental")[1])
    x = rng.random((3000, 3)).astype(np.float32)
    eng.process_records(np.arange(3000), x, now_ms=0.0)
    eng.process_trigger("qa,0", now_ms=1.0)
    assert eng._inflight_merge is not None
    eng.process_trigger("qb,0", now_ms=2.0)
    res = eng.poll_results()
    assert [r["query_id"] for r in res] == ["qa", "qb"]
    assert res[0]["skyline_size"] == res[1]["skyline_size"]
    assert eng.pset.merge_cache_hits == 1 and eng._inflight_merge is None
    assert eng.last_merge_ms is not None


def test_overlap_harvested_at_ingest(monkeypatch):
    """On the CPU a launched merge is ready at once, so the next ingest
    harvests it without a poll."""
    monkeypatch.setenv("SKYLINE_QUERY_OVERLAP", "1")
    eng = SkylineEngine(_configs(3, "lazy")[1])
    x = np.random.default_rng(6).random((2000, 3)).astype(np.float32)
    eng.process_records(np.arange(1000), x[:1000])
    eng.process_trigger("q,0")
    assert eng._inflight_merge is not None and eng._results == []
    eng.process_records(np.arange(1000, 2000), x[1000:])
    assert eng._inflight_merge is None and len(eng._results) == 1


# -- knobs ------------------------------------------------------------------------------


KNOBS = {
    "SKYLINE_MERGE_CACHE": ("merge_cache_enabled", "merge_cache_enabled"),
    "SKYLINE_DELTA_CUTOFF": ("delta_dirty_cutoff", "delta_dirty_cutoff"),
    "SKYLINE_MERGE_TREE": ("merge_tree_enabled", "merge_tree_enabled"),
    "SKYLINE_MERGE_PRUNE": ("merge_prune_enabled", "merge_prune_enabled"),
    "SKYLINE_QUERY_OVERLAP": ("query_overlap_enabled", "query_overlap_enabled"),
}


@pytest.mark.parametrize("raw", [None, "", "0", "1", "off", "0.5", "x"])
@pytest.mark.parametrize("env", list(KNOBS))
def test_plane_knobs_match_jax(monkeypatch, env, raw):
    """Each plane knob reads as the reference's does, unset, set and
    unparsable (both warn once per name and fall back to the default)."""
    if raw is None:
        monkeypatch.delenv(env, raising=False)
    else:
        monkeypatch.setenv(env, raw)
    port_fn, ref_fn = KNOBS[env]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert getattr(knobs, port_fn)() == getattr(jdispatch, ref_fn)()


def test_plane_rules():
    assert not cascade.delta_applies(0.0) and cascade.delta_applies(0.75)
    assert not cascade.delta_applies(0.76)
    assert not cascade.merge_tree_on(False, 2) and cascade.merge_tree_on(False, 3)
    assert [cascade.merge_path(t, dl) for t in (True, False) for dl in (True, False)] == [
        "tree_delta", "tree", "delta", "flat"]


# -- on the card -------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3, 8])
def test_interleaved_engine_on_card_matches_cpu(cuda_card, d):
    want, _ = _interleaved(SkylineEngine(_configs(d, "incremental")[1]), 11, d, 4)
    cfg = _configs(d, "incremental")[1]
    cfg.device = "cuda"
    eng = SkylineEngine(cfg)
    got, _ = _interleaved(eng, 11, d, 4)
    _same_results(want, got)

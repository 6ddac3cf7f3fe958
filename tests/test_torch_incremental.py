"""The incremental and overlap flush policies, and d <= 2, against the JAX
package, exact bytes on the CPU: the merge step (``merge_step_active``, its
plain core and its K2 core against ``_merge_step_pallas_core`` in interpret
mode), the engine under every policy (sizes, optimality, record counts and
point bytes, window after window), the barrier path, state carried across
packages, the host syncs the flushes make, and the knobs. The ``cuda``-marked
legs (merge-step kernel core against plain, the engine on the card against
the CPU) skip without a card."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.ops import dispatch as jdispatch
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu.stream import window as jwin
from skyline_tpu.stream.batched import PartitionSet as JaxSet
from skyline_tpu.workload.generators import generate
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream import window as twin
from skyline_tpu_torch.stream.batched import PartitionSet
from skyline_tpu_torch.utils import knobs

torch.set_num_threads(1)

DISTS = ["uniform", "correlated", "anti_correlated"]
ALGOS = ["mr-angle", "mr-dim", "mr-grid"]


@pytest.fixture
def interpret(monkeypatch):
    """The JAX side's Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setenv("SKYLINE_PALLAS_INTERPRET", "1")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# -- the merge step -------------------------------------------------------------


def _state(rng, P, cap, d, counts, domain=40):
    """(P, cap, d) +inf-padded skylines with ``counts`` rows each, in the
    arrival order of their survivors (what the merge step stores)."""
    from skyline_tpu_torch.ops.dominance import skyline_mask

    sky = np.full((P, cap, d), np.inf, np.float32)
    for p in range(P):
        rows = np.zeros((0, d), np.float32)
        while rows.shape[0] < counts[p]:
            x = rng.integers(0, domain, size=(4 * counts[p] + 8, d)).astype(np.float32)
            x[:, 0] = domain - x[:, 1:].sum(1) / max(d - 1, 1) + rng.integers(0, 3, x.shape[0])
            rows = x[skyline_mask(torch.from_numpy(x)).numpy()]
        sky[p, : counts[p]] = rows[: counts[p]]
    return sky


def _batch(rng, P, B, d, widths, domain=40):
    batch = np.full((P, B, d), np.inf, np.float32)
    for p in range(P):
        batch[p, : widths[p]] = rng.integers(0, domain, size=(widths[p], d))
    return batch, np.arange(B)[None, :] < widths[:, None]


def _merge_inputs(rng, d, grow):
    """A merge round of 4 partitions: a ragged sky prefix and ragged batch
    widths; ``grow`` makes counts + widths outgrow the 1024-row capacity."""
    P, cap, B = 4, 1024, 1024
    counts = np.array([0, 37, 300, 511]) if not grow else np.array([5, 600, 900, 1000])
    widths = np.array([1024, 0, 77, 640 if grow else 400])
    sky = _state(rng, P, cap, d, counts)
    batch, bvalid = _batch(rng, P, B, d, widths)
    valid = np.arange(cap)[None, :] < counts[:, None]
    active = min(cap, twin._active_bucket(max(int(counts.max()), 1)))
    out_active = twin._next_pow2(int((counts + widths).max()))
    return sky, valid, batch, bvalid, active, out_active


@pytest.mark.parametrize("grow", [False, True])
@pytest.mark.parametrize("d", [3, 8])
def test_merge_step_active_matches_jax(rng, d, grow):
    sky, valid, batch, bvalid, active, out_active = _merge_inputs(rng, d, grow)
    assert (out_active > sky.shape[1]) == grow
    jv, jval, jc, jres = jwin.merge_step_active(
        jnp.asarray(sky), jnp.asarray(valid), jnp.asarray(batch), jnp.asarray(bvalid),
        active, out_active,
    )
    tv, tval, tc, tres = twin.merge_step_active(
        torch.from_numpy(sky), torch.from_numpy(valid), torch.from_numpy(batch),
        torch.from_numpy(bvalid), active, out_active,
    )
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
    assert np.array_equal(tval.numpy(), np.asarray(jval))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tres.numpy(), np.asarray(jres))
    assert tv.shape[1] == max(sky.shape[1], out_active)


@pytest.mark.parametrize("grow", [False, True])
def test_merge_step_kernel_core_matches_pallas(rng, grow, interpret):
    """The K2 core (CPU wrappers) against ``_merge_step_pallas_core`` in
    interpret mode, vmapped over partitions, at tile-multiple sizes."""
    d = 3
    sky, valid, batch, bvalid, active, out_active = _merge_inputs(rng, d, grow)
    core = jax.jit(
        jax.vmap(jwin._merge_step_pallas_core, in_axes=(0, 0, 0, 0, None)),
        static_argnums=(4,),
    )
    jv, jval, jc, _ = core(
        jnp.asarray(sky[:, :active]), jnp.asarray(valid[:, :active]), jnp.asarray(batch),
        jnp.asarray(bvalid), out_active,
    )
    tv, tval, tc, _ = twin._merge_step_kernel_core(
        torch.from_numpy(sky[:, :active]), torch.from_numpy(valid[:, :active]),
        torch.from_numpy(batch), torch.from_numpy(bvalid), out_active,
    )
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
    assert np.array_equal(tval.numpy(), np.asarray(jval))
    assert np.array_equal(tc.numpy(), np.asarray(jc))


def test_merge_step_cores_agree_on_special_values(rng):
    """The plain core and the K2 core on ±0.0, ±inf, NaN and duplicate
    rows, batches in arrival order (not sum-sorted); the sky and its
    validity are active-prefix slices of wider buffers, as
    ``merge_step_active`` passes them."""
    P, S, B, d = 3, 300, 257, 4
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, 2.0], np.float32)
    sky = torch.from_numpy(special[rng.integers(0, 7, size=(P, 2 * S, d))])[:, :S]
    batch = special[rng.integers(0, 7, size=(P, B, d))]
    batch[:, 100:150] = batch[:, :50]
    sv = torch.from_numpy(rng.random((P, 2 * S)) < 0.8)[:, :S]
    bv = torch.from_numpy(rng.random((P, B)) < 0.8)
    assert not sky.is_contiguous() and not sv.is_contiguous()
    a = twin._merge_step_core(sky, sv, torch.from_numpy(batch), bv, 1024)
    b = twin._merge_step_kernel_core(sky, sv, torch.from_numpy(batch), bv, 1024)
    assert a[0].numpy().tobytes() == b[0].numpy().tobytes()
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_mixed_precision_matches_jax(rng, monkeypatch):
    """``mp=True`` and ``SKYLINE_MIXED_PRECISION=1`` run the bf16 passes
    and give the JAX package's results: the merge step's bytes, counts and
    certified drops, and a set's flushed state and cascade counters."""
    sky, valid, batch, bvalid, active, out_active = _merge_inputs(rng, 3, False)
    jout = jwin.merge_step_active(
        *(jnp.asarray(a) for a in (sky, valid, batch, bvalid)), active, out_active, mp=True
    )
    tout = twin.merge_step_active(
        *(torch.from_numpy(a) for a in (sky, valid, batch, bvalid)), active, out_active,
        mp=True,
    )
    assert tout[0].numpy().tobytes() == np.asarray(jout[0]).tobytes()
    for t, j in zip(tout[1:], jout[1:]):
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert int(tout[3].sum()) > 0  # the pre-drop certified some rows
    monkeypatch.setenv("SKYLINE_MIXED_PRECISION", "1")
    assert knobs.mixed_precision_enabled("cpu")
    x = generate("anti_correlated", rng, 3000, 3, 0, 10000)
    states = []
    for ps in (PartitionSet(2, 3, buffer_size=256, device="cpu"), JaxSet(2, 3, buffer_size=256)):
        for s in range(0, 3000, 500):
            ps.add_batch(s // 500 % 2, x[s : s + 500], s + 499, 0.0)
            ps.flush_all()
        counts = np.asarray(ps.sky_counts())
        states.append((counts.tolist(), [np.asarray(ps.sky[p, : counts[p]]).tobytes()
                                         for p in range(2)], ps.flush_cascade_stats()))
    assert states[0] == states[1]
    assert states[0][2]["bf16_resolved"] > 0 and states[0][2]["mixed_precision"]


@pytest.mark.parametrize("raw", [None, "", "0", "1", "3", "-2", "two"])
def test_stage_depth_knob_matches_jax(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("SKYLINE_STAGE_DEPTH", raising=False)
    else:
        monkeypatch.setenv("SKYLINE_STAGE_DEPTH", raw)
    with pytest.warns(UserWarning) if raw == "two" else contextlib.nullcontext():
        got = knobs.flush_stage_depth()
    assert got == jdispatch.flush_stage_depth()


# -- the engine -----------------------------------------------------------------


def _drive(engine, windows, chunk=500):
    """Windows back to back through one engine, an immediate trigger after
    each: (results, local sizes after each trigger)."""
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
    assert len(wr) == len(gr) == len(ws)
    assert gs == ws
    for a, b in zip(wr, gr):
        assert b["skyline_size"] == a["skyline_size"]
        assert b["optimality"] == a["optimality"]
        assert b["query_id"] == a["query_id"] and b["record_count"] == a["record_count"]
        pa = np.asarray(a["skyline_points"], np.float32)
        pb = np.asarray(b["skyline_points"], np.float32)
        assert pb.tobytes() == pa.tobytes()


def _configs(d, algo, policy, ingest="host", **kw):
    common = dict(
        parallelism=4, algo=algo, dims=d, domain_max=10000.0, buffer_size=256,
        emit_skyline_points=True, flush_policy=policy, ingest=ingest,
    )
    common.update(kw)
    return JaxConfig(**common), EngineConfig(**{**common, "device": "cpu"})


def _same_engines(jcfg, tcfg, windows, chunk=500):
    want = _drive(JaxEngine(jcfg), windows, chunk)
    got = _drive(SkylineEngine(tcfg), windows, chunk)
    _assert_same(want, got)
    return got


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_incremental_engine_matches_jax(d, dist):
    """The default policy, two windows through one engine: several
    automatic merge rounds per window (buffer 256), then the query flush
    and the flat merge; each generator with a different routing."""
    algo = ALGOS[(d + DISTS.index(dist)) % 3]
    rng = np.random.default_rng(100 * d + len(dist))
    windows = [generate(dist, rng, 1200, d, 0, 10000) for _ in range(2)]
    _same_engines(*_configs(d, algo, "incremental"), windows)


def test_incremental_engine_growth_matches_jax():
    """8-D anti-correlated windows that grow the capacity more than once
    (the count sync on growth), with rows carrying ``-0.0`` coordinates."""
    rng = np.random.default_rng(3)
    windows = [generate("anti_correlated", rng, 2000, 8, 0, 10000) for _ in range(2)]
    windows[0][:40] = -0.0
    windows[1][:20, 3] = -0.0
    _same_engines(*_configs(8, "mr-grid", "incremental", parallelism=2), windows, chunk=1000)


@pytest.mark.parametrize("d", [2, 8])
def test_overlap_host_ingest_matches_jax(d):
    """Host ingest: an automatic flush every 600 rows, each after the first
    running the old-vs-new cleanup (or the sweep at d = 2)."""
    rng = np.random.default_rng(40 + d)
    windows = [generate("anti_correlated", rng, 1200, d, 0, 10000) for _ in range(2)]
    _same_engines(*_configs(d, "mr-angle", "overlap", overlap_rows=400), windows)


@pytest.mark.parametrize("gate", ["1", "0"])
@pytest.mark.parametrize("d", [2, 4])
def test_overlap_device_ingest_matches_jax(d, gate, interpret, monkeypatch):
    """Device ingest, rank cascade on and off: the sync-free automatic
    flushes (tighten=False) every 500 rows, their cleanups against the
    pre-flush device counts, then the query flush."""
    monkeypatch.setenv("SKYLINE_RANK_CASCADE", gate)
    rng = np.random.default_rng(50 + d)
    windows = [generate("anti_correlated", rng, 1500, d, 0, 10000) for _ in range(2)]
    _same_engines(
        *_configs(d, "mr-dim", "overlap", ingest="device", overlap_rows=500), windows
    )


@pytest.mark.parametrize("ingest", ["host", "device"])
def test_lazy_engine_at_d2_matches_jax(ingest):
    """The lazy policy at the reference's default dimension: every flush
    is the sweep, from host pending rows or from the device window."""
    rng = np.random.default_rng(12)
    windows = [generate("anti_correlated", rng, 2500, 2, 0, 10000) for _ in range(2)]
    windows[1][:30] = -0.0
    _same_engines(*_configs(2, "mr-angle", "lazy", ingest=ingest), windows)


@pytest.mark.parametrize("d", [2, 4])
def test_incremental_barrier_path_matches_jax(d):
    """A trigger whose barrier is not met waits; later data answers it per
    partition (each snapshot flushes), then the host-side union merge."""
    rng = np.random.default_rng(9)
    x = generate("anti_correlated", rng, 3000, d, 0, 10000)
    ids = np.arange(3000, dtype=np.int64)
    jcfg, tcfg = _configs(d, "mr-dim", "incremental")
    results = []
    for eng in (JaxEngine(jcfg), SkylineEngine(tcfg)):
        eng.process_records(ids[:1000], x[:1000])
        eng.process_trigger("late,2500")
        assert eng.poll_results() == []
        for s in range(1000, 3000, 400):
            eng.process_records(ids[s : s + 400], x[s : s + 400])
        results.append((eng.poll_results(), [np.asarray(eng.pset.sky_counts()).tolist()]))
    _assert_same(*results)
    assert results[1][0][0]["skyline_size"] > 0


def test_engine_defaults_are_the_reference_defaults():
    t, j = EngineConfig(device="cpu"), JaxConfig()
    for field in ("dims", "flush_policy", "overlap_rows", "parallelism", "algo",
                  "domain_max", "buffer_size", "ingest"):
        assert getattr(t, field) == getattr(j, field), field
    assert (t.dims, t.flush_policy, t.overlap_rows) == (2, "incremental", 262144)
    eng = SkylineEngine(EngineConfig(device="cpu"))
    assert eng.pset.flush_policy == "incremental" and not eng.pset.device_ingest
    # the global-merge plane's knobs under an empty environment
    plane = ("SKYLINE_MERGE_CACHE", "SKYLINE_DELTA_CUTOFF", "SKYLINE_MERGE_TREE",
             "SKYLINE_MERGE_PRUNE", "SKYLINE_QUERY_OVERLAP")
    with pytest.MonkeyPatch.context() as mp:
        for name in plane:
            mp.delenv(name, raising=False)
        for fn in ("merge_cache_enabled", "delta_dirty_cutoff", "merge_tree_enabled",
                   "merge_prune_enabled", "query_overlap_enabled"):
            assert getattr(knobs, fn)() == getattr(jdispatch, fn)(), fn
        assert (knobs.merge_cache_enabled(), knobs.delta_dirty_cutoff(),
                knobs.merge_tree_enabled(), knobs.merge_prune_enabled(),
                knobs.query_overlap_enabled()) == (True, 0.75, True, True, True)


# -- state across packages --------------------------------------------------------


def test_overlap_device_cleanup_after_tightened_bounds():
    """A sync-free overlap flush of the device window whose rounds tighten
    the count bounds under growth pressure: the cleanup's old prefix comes
    from the loose pre-flush bound, which the JAX package then slices past
    its final bucket and fails on mismatched shapes (2048 against 1024
    rows here; recorded in ROADMAP.md queue 3). The port clamps the old
    prefix to the final bucket — the old rows all lie in it — and answers
    each window as the numpy oracle does."""
    from skyline_tpu_torch.ops.dominance import skyline_np

    rng = np.random.default_rng(53)
    windows = [generate("anti_correlated", rng, 4096, 3, 0, 10000) for _ in range(2)]
    jcfg, tcfg = _configs(3, "mr-angle", "overlap", ingest="device", buffer_size=512,
                          overlap_rows=1024)
    with pytest.raises(TypeError, match="incompatible shapes"):
        _drive(JaxEngine(jcfg), windows, 1024)
    results, _ = _drive(SkylineEngine(tcfg), windows, 1024)
    for i, r in enumerate(results):
        want = skyline_np(np.concatenate(windows[: i + 1]))
        got = np.asarray(r["skyline_points"], np.float64)
        assert r["skyline_size"] == want.shape[0]
        assert np.array_equal(got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])])


@pytest.mark.parametrize("d", [2, 4])
def test_load_state_round_trip_from_incremental_jax(d):
    """A JAX set flushed under the incremental policy loads into the port;
    both then take the same rows, flush and merge to the same bytes."""
    P = 8
    rng = np.random.default_rng(31 + d)
    js = JaxSet(P, d, buffer_size=512, flush_policy="incremental")
    ts = PartitionSet(P, d, buffer_size=512, flush_policy="incremental", device="cpu")

    def feed(sets, n, max_id):
        x = generate("anti_correlated", rng, n, d, 0, 10000)
        pids = rng.integers(0, P, n)
        for s in sets:
            for p in range(P):
                if (pids == p).any():
                    s.add_batch(p, np.ascontiguousarray(x[pids == p]), max_id, 0.0)
                    s.maybe_flush()

    feed([js], 5000, 5000)
    js.flush_all()
    sky, counts = np.asarray(js.sky), js.sky_counts()
    ts.load_state(sky, counts, max_seen_id=js.max_seen_id, records_seen=js.records_seen)
    tsky, tcounts = ts.state_numpy()
    assert np.array_equal(tcounts, counts)
    for p in range(P):
        assert tsky[p, : counts[p]].tobytes() == sky[p, : counts[p]].tobytes()
    feed([js, ts], 3000, 8000)
    for s in (js, ts):
        s.flush_all()
    jc, jsurv, jg, jpts = js.global_merge_stats(emit_points=True)
    tc, tsurv, tg, tpts = ts.global_merge_stats(emit_points=True)
    assert np.array_equal(np.asarray(tc), jc) and np.array_equal(np.asarray(tsurv), jsurv)
    assert tg == jg and tpts.tobytes() == np.asarray(jpts).tobytes()
    for p in range(P):
        assert ts.skyline_host(p).tobytes() == js.skyline_host(p).tobytes()


# -- host syncs ---------------------------------------------------------------------


def _count_syncs(monkeypatch, pset):
    calls = []
    real = pset._host

    def counting(t):
        calls.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(pset, "_host", counting)
    return calls


def test_incremental_rounds_sync_only_on_growth(rng, monkeypatch):
    """Three merge rounds into a pre-sized set read no count; the round
    whose upper bounds outgrow the capacity reads the counts once, after
    which the exact counts leave room."""
    P, d = 4, 3
    ps = PartitionSet(P, d, buffer_size=1024, initial_capacity=4096, device="cpu")
    for p in range(P):
        ps.add_batch(p, generate("anti_correlated", rng, 3 * 1024, d, 0, 10000), 1, 0.0)
    calls = _count_syncs(monkeypatch, ps)
    ps.flush_all()
    assert calls == [] and ps._cap == 4096
    ps.add_batch(0, generate("uniform", rng, 3 * 1024, d, 0, 10000), 2, 0.0)
    ps.flush_all()
    assert calls == [(P,)] and ps._cap == 4096


@pytest.mark.parametrize("gate", ["1", "0"])
def test_overlap_device_flush_reads_only_the_bounds(rng, monkeypatch, gate, interpret):
    """An overlap auto-flush on non-empty state reads the segment bounds and
    nothing else (no count, no had-old check); a query-time flush reads the
    exact counts."""
    monkeypatch.setenv("SKYLINE_RANK_CASCADE", gate)
    P, d = 4, 3
    ps = PartitionSet(
        P, d, flush_policy="overlap", route=("mr-grid", 10000.0), overlap_rows=3000,
        initial_capacity=16384, device="cpu",
    )
    ps.ingest_chunk(np.arange(3000), generate("anti_correlated", rng, 3000, d, 0, 10000), 0.0)
    calls = _count_syncs(monkeypatch, ps)
    assert ps.maybe_flush()
    assert calls == [(P + 1,)]
    ps.ingest_chunk(np.arange(3000), generate("anti_correlated", rng, 3000, d, 0, 10000), 0.0)
    assert ps.maybe_flush()
    assert calls == [(P + 1,)] * 2
    ps.ingest_chunk(np.arange(100), generate("anti_correlated", rng, 100, d, 0, 10000), 0.0)
    assert not ps.maybe_flush()
    ps.flush_all()
    assert (P,) in calls[2:]


# -- on the card ---------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("grow", [False, True])
def test_merge_step_kernel_core_on_card(rng, cuda_card, grow):
    for d in (3, 8):
        sky, valid, batch, bvalid, active, out_active = _merge_inputs(rng, d, grow)
        args = [torch.from_numpy(a).to(cuda_card) for a in (sky, valid, batch, bvalid)]
        args = [args[0][:, :active], args[1][:, :active], args[2], args[3]]
        a = twin._merge_step_kernel_core(*args, out_active)
        b = twin._merge_step_core(*args, out_active)
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["incremental", "overlap"])
@pytest.mark.parametrize("d", [2, 4])
def test_engine_on_card_matches_cpu(cuda_card, policy, d):
    rng = np.random.default_rng(d)
    windows = [generate("anti_correlated", rng, 4000, d, 0, 10000) for _ in range(2)]
    common = dict(dims=d, buffer_size=256, emit_skyline_points=True, flush_policy=policy,
                  overlap_rows=1500, domain_max=10000.0)
    want = _drive(SkylineEngine(EngineConfig(**common, device="cpu")), windows)
    got = _drive(SkylineEngine(EngineConfig(**common, device="cuda")), windows)
    _assert_same(want, got)

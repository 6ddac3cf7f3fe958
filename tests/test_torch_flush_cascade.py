"""The flush dominance cascade — the quantized-grid prefilter
(``SKYLINE_FLUSH_PREFILTER``) and the mixed-precision passes
(``SKYLINE_MIXED_PRECISION``) — against the JAX package on the CPU, the
port's counterpart of ``tests/test_flush_cascade.py``: with the cascade on
in both packages, every flush policy and ingest, d in {4, 8} and the three
workload shapes give the same per-partition skylines (row order included),
the same global merge and the same ``flush_cascade_stats()``; the cascade on
gives the bytes of the cascade off; and the edge cases (an all-dropped
batch, NaN and +inf rows, bf16-ambiguous ties, ``load_state`` dropping the
grid). Every comparison is exact. The ``cuda``-marked test holds a set on a
card, under the card's defaults, to the CPU set with the cascade forced on."""

import numpy as np
import pytest
import torch

from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu.stream.batched import PartitionSet as JaxSet
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream.batched import PartitionSet

from conftest import gen_points as _gen
from test_torch_incremental import _assert_same, _drive

torch.set_num_threads(1)

P = 3


@pytest.fixture(autouse=True)
def reference_rounds(monkeypatch):
    """The JAX lazy flush may take its host cascade (``ops/sorted_sfs.py``)
    on the CPU, which has no bf16 pre-drop; pin its SFS rounds, the path
    the port runs, so the certified-drop counts compare (answer bytes are
    the same on every path). The merge cache off, as the reference's
    cascade tests run."""
    monkeypatch.setenv("SKYLINE_SORTED_SFS", "off")
    monkeypatch.setenv("SKYLINE_DEVICE_CASCADE", "off")
    monkeypatch.setenv("SKYLINE_MERGE_CACHE", "0")


def _cascade_env(monkeypatch, on: bool):
    v = "1" if on else "0"
    monkeypatch.setenv("SKYLINE_FLUSH_PREFILTER", v)
    monkeypatch.setenv("SKYLINE_MIXED_PRECISION", v)


def _sets(policy, d, ingest="host", **kw):
    route = ("mr-angle", 1.0) if ingest == "device" else None
    kw = dict(flush_policy=policy, route=route, **kw)
    return JaxSet(P, d, **kw), PartitionSet(P, d, device="cpu", **kw)


def _run_rounds(pset, x, rounds=2, ingest="host", seed=3):
    """Feed ``x`` in ``rounds`` chunks with a flush after each — the first
    flush's tail queues the grid summary the second's prefilter reads.
    Host ingest routes at random (one seed for every set), device ingest
    by the set's own routing."""
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, P, x.shape[0])
    step = -(-x.shape[0] // rounds)
    for lo in range(0, x.shape[0], step):
        hi = min(lo + step, x.shape[0])
        if ingest == "device":
            pset.ingest_chunk(np.arange(lo, hi), x[lo:hi], 0.0)
        else:
            for p in range(P):
                rows = np.ascontiguousarray(x[lo:hi][pids[lo:hi] == p])
                if rows.shape[0]:
                    pset.add_batch(p, rows, x.shape[0], 0.0)
        pset.flush_all()


def _state(pset):
    """Per-partition skylines (order included) and the global merge."""
    snaps = [np.asarray(pset.snapshot(p)) for p in range(P)]
    counts, surv, g, pts = pset.global_merge_stats(emit_points=True)
    return snaps, (np.asarray(counts).tolist(), np.asarray(surv).tolist(), int(g),
                   np.asarray(pts))


def _assert_identical(a, b, ctx=""):
    (sa, ga), (sb, gb) = a, b
    for p, (ra, rb) in enumerate(zip(sa, sb)):
        assert ra.shape == rb.shape and ra.tobytes() == rb.tobytes(), (
            f"partition {p} skyline diverges {ctx}"
        )
    assert ga[:3] == gb[:3], f"merge stats diverge {ctx}"
    assert ga[3].tobytes() == gb[3].tobytes(), f"points diverge {ctx}"


def _both(monkeypatch, policy, d, x, ingest="host", rounds=2, **kw):
    """The cascade on: (JAX state, port state, JAX stats, port stats)."""
    _cascade_env(monkeypatch, True)
    js, ts = _sets(policy, d, ingest, **kw)
    for s in (js, ts):
        _run_rounds(s, x, rounds, ingest)
    return _state(js), _state(ts), js.flush_cascade_stats(), ts.flush_cascade_stats()


CASES = [("incremental", "host"), ("lazy", "host"), ("lazy", "device"),
         ("overlap", "host"), ("overlap", "device")]


@pytest.mark.parametrize("kind", ["uniform", "correlated", "anti"])
@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("policy,ingest", CASES)
def test_cascade_matches_jax(monkeypatch, kind, d, policy, ingest):
    """The cascade on in both packages: same states, same counters; and the
    port with the cascade off gives the same bytes."""
    x = _gen(np.random.default_rng(29), 900, d, kind)
    jstate, tstate, jstats, tstats = _both(monkeypatch, policy, d, x, ingest)
    ctx = f"(kind={kind} d={d} policy={policy} ingest={ingest})"
    _assert_identical(jstate, tstate, ctx)
    assert tstats == jstats, ctx
    assert tstats["prefilter_enabled"] and tstats["mixed_precision"]
    # host rows pass the prefilter; the device window does not
    assert (tstats["prefilter_seen"] > 0) == (ingest == "host")
    _cascade_env(monkeypatch, False)
    off = PartitionSet(P, d, device="cpu", flush_policy=policy,
                       route=("mr-angle", 1.0) if ingest == "device" else None)
    _run_rounds(off, x, ingest=ingest)
    _assert_identical(_state(off), tstate, f"on vs off {ctx}")
    stats = off.flush_cascade_stats()
    assert stats["prefilter_dropped"] == 0 and stats["bf16_resolved"] == 0


def test_cascade_is_live(monkeypatch):
    """Both stages act, not vacuously pass: a later flush of uniform rows
    drops a share at the grid and certifies rows at the bf16 pre-drop."""
    x = _gen(np.random.default_rng(5), 4000, 4, "uniform")
    jstate, tstate, jstats, tstats = _both(monkeypatch, "incremental", 4, x,
                                           buffer_size=256)
    _assert_identical(jstate, tstate)
    assert tstats == jstats
    assert tstats["prefilter_dropped"] > 0 and tstats["bf16_resolved"] > 0
    assert tstats["prefilter_drop_fraction"] == pytest.approx(
        tstats["prefilter_dropped"] / tstats["prefilter_seen"]
    )


@pytest.mark.parametrize("d", [3, 4, 8])
def test_grid_drop_is_the_reference_test(d):
    """``grid_drop`` (per-dimension masks of representatives) against the
    reference's formulation (``skyline_tpu/stream/batched.py``
    ``_prefilter_rows``: every row's code against every representative's):
    the same drops on random ladders and codes, a dimension whose ladder
    failed the host check, NaN, +-inf and -0.0 rows, rows on the ladder's
    own values, and fewer than 64 representatives."""
    from skyline_tpu_torch.stream.batched import grid_drop

    rng = np.random.default_rng(d)
    for R in (64, 5):
        lo = rng.uniform(-5, 5, d).astype(np.float32)
        step = rng.uniform(0.01, 1, d).astype(np.float32)
        bounds = (lo + np.arange(33, dtype=np.float32)[:, None] * step).astype(np.float32)
        ux = rng.integers(0, 34, size=(R, d)).astype(np.int32)
        ux[: R // 2] = rng.integers(0, 6, size=(R // 2, d))
        ux[:, d - 1][rng.random(R) < 0.2] = 33
        y = rng.uniform(-6, 40, size=(3000, d)).astype(np.float32)
        y[::7] = bounds[rng.integers(0, 33, size=(429, d)), np.arange(d)]
        y[::11, 0] = np.nan
        y[::13, d - 1] = np.inf
        y[::17, 1] = -np.inf
        y[::19, 0] = -0.0
        for bad in (False, True):
            u = ux.copy()
            if bad:  # the host check disabled dimension 1
                u[:, 1] = 33
            vy = (bounds[None, :, :] <= y[:, None, :]).sum(axis=1, dtype=np.int32) - 1
            want = np.any(np.all(u[None, :, :] < vy[:, None, :], axis=2), axis=1)
            got = grid_drop(bounds, u, y)
            assert np.array_equal(got, want)
            assert want.any() == (not bad)  # a disabled dimension certifies nothing


def _two_flushes(sets, first, second, p=0):
    for s in sets:
        s.add_batch(p, first, first.shape[0], 0.0)
        s.flush_all()
        s.add_batch(p, second, first.shape[0] + second.shape[0], 0.0)
        s.flush_all()


@pytest.mark.parametrize("policy", ["incremental", "lazy"])
def test_all_dropped_batch(monkeypatch, policy):
    """A whole batch certified at the grid: the flush has nothing left for
    that partition, and the state is the cascade-off state."""
    rng = np.random.default_rng(11)
    strong = (rng.random((64, 4)) * 0.01).astype(np.float32)
    weak = (0.5 + rng.random((300, 4)) * 0.5).astype(np.float32)
    _cascade_env(monkeypatch, True)
    js, ts = _sets(policy, 4)
    _two_flushes((js, ts), strong, weak)
    on = _state(ts)
    _assert_identical(_state(js), on, "(all-dropped batch)")
    assert ts.flush_cascade_stats() == js.flush_cascade_stats()
    assert ts.flush_cascade_stats()["prefilter_dropped"] == 300
    _cascade_env(monkeypatch, False)
    off = PartitionSet(P, 4, device="cpu", flush_policy=policy)
    _two_flushes((off,), strong, weak)
    _assert_identical(_state(off), on, "(all-dropped batch, on vs off)")


def test_nan_inf_rows(monkeypatch):
    """NaN rows are never prefiltered (code -1) nor certified; +inf rows may
    be dropped. Equal to JAX and to the cascade off; all 40 NaN rows
    survive."""
    rng = np.random.default_rng(13)
    base = rng.random((400, 4)).astype(np.float32)
    odd = rng.random((200, 4)).astype(np.float32)
    odd[:40, 1] = np.nan
    odd[40:80, 2] = np.inf
    _cascade_env(monkeypatch, True)
    js, ts = _sets("incremental", 4)
    _two_flushes((js, ts), base, odd)
    on = _state(ts)
    _assert_identical(_state(js), on, "(NaN/inf rows)")
    assert ts.flush_cascade_stats() == js.flush_cascade_stats()
    assert np.isnan(on[0][0]).any(axis=1).sum() == 40
    _cascade_env(monkeypatch, False)
    off = PartitionSet(P, 4, device="cpu")
    _two_flushes((off,), base, odd)
    _assert_identical(_state(off), on, "(NaN/inf rows, on vs off)")


@pytest.mark.parametrize("policy", ["incremental", "lazy"])
def test_bf16_ambiguous_ties(monkeypatch, policy):
    """Exact duplicates of skyline rows and rows one f32 ulp worse sit
    inside the bf16 margin: they go to the exact passes (duplicates never
    dominate each other). Equal to JAX and to the cascade off."""
    rng = np.random.default_rng(17)
    base = rng.random((300, 4)).astype(np.float32)
    near = np.concatenate([
        base[:50], np.nextafter(base[50:100], np.float32(2.0), dtype=np.float32)
    ])
    _cascade_env(monkeypatch, True)
    js, ts = _sets(policy, 4)
    _two_flushes((js, ts), base, near)
    on = _state(ts)
    _assert_identical(_state(js), on, "(bf16-ambiguous ties)")
    assert ts.flush_cascade_stats() == js.flush_cascade_stats()
    _cascade_env(monkeypatch, False)
    off = PartitionSet(P, 4, device="cpu", flush_policy=policy)
    _two_flushes((off,), base, near)
    _assert_identical(_state(off), on, "(bf16-ambiguous ties, on vs off)")


def test_load_state_drops_the_grid(monkeypatch):
    """``load_state`` replaces the world: the grid summary of the old
    skylines must go, or its cells would certify drops against rows that no
    longer exist. The next flush then answers as a fresh set loaded with the
    same state, and as the JAX set restored to it (``restore_all``)."""
    _cascade_env(monkeypatch, True)
    rng = np.random.default_rng(41)
    ps = PartitionSet(P, 4, device="cpu")
    _run_rounds(ps, (rng.random((1500, 4)) * 0.1).astype(np.float32))
    assert ps._grid is not None
    sky, counts = ps.state_numpy()
    sky[:, :, 0] += np.float32(5.0)  # a weaker world: the old grid would drop rows
    ps.load_state(sky, counts)
    assert ps._grid is None and ps._grid_host is None and ps._grid_epoch is None
    dropped = ps.prefilter_dropped
    fresh = PartitionSet(P, 4, device="cpu")
    fresh.load_state(sky, counts)
    js = JaxSet(P, 4)
    js.restore_all([sky[p, : counts[p]] for p in range(P)],
                   [np.zeros((0, 4), np.float32)] * P)
    rows = (0.2 + rng.random((500, 4)) * 0.5).astype(np.float32)
    for s in (ps, fresh, js):
        s.add_batch(1, rows, 2000, 0.0)
        s.flush_all()
    assert ps.prefilter_dropped == dropped  # no grid yet: nothing dropped
    _assert_identical(_state(fresh), _state(ps), "(after load_state)")
    _assert_identical(_state(js), _state(ps), "(after load_state, vs restore_all)")


@pytest.mark.parametrize("policy", ["incremental", "lazy", "overlap"])
def test_engine_cascade_matches_jax(monkeypatch, policy):
    """The engine under the cascade: every result (sizes, optimality,
    point bytes) equal to the JAX engine's, window after window."""
    _cascade_env(monkeypatch, True)
    rng = np.random.default_rng(19)
    windows = [_gen(rng, 1500, 4, "uniform") for _ in range(2)]
    common = dict(parallelism=2, dims=4, domain_max=1.0, buffer_size=256,
                  emit_skyline_points=True, flush_policy=policy, overlap_rows=600,
                  ingest="host")
    want = _drive(JaxEngine(JaxConfig(**common)), windows)
    eng = SkylineEngine(EngineConfig(**common, device="cpu"))
    _assert_same(want, _drive(eng, windows))
    assert eng.pset.flush_cascade_stats()["bf16_resolved"] > 0


# -- on the card ------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["incremental", "lazy"])
def test_card_defaults_match_cpu_cascade(monkeypatch, policy):
    """A set on the card under its defaults (mp on, prefilter on) against the
    CPU set with ``SKYLINE_MIXED_PRECISION=1``: state bytes and counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    x = _gen(np.random.default_rng(7), 3000, 8, "anti")
    monkeypatch.delenv("SKYLINE_MIXED_PRECISION", raising=False)
    monkeypatch.delenv("SKYLINE_FLUSH_PREFILTER", raising=False)
    card = PartitionSet(P, 8, device="cuda", flush_policy=policy)
    _run_rounds(card, x, rounds=3)
    got, gstats = _state(card), card.flush_cascade_stats()
    monkeypatch.setenv("SKYLINE_MIXED_PRECISION", "1")
    cpu = PartitionSet(P, 8, device="cpu", flush_policy=policy)
    _run_rounds(cpu, x, rounds=3)
    _assert_identical(_state(cpu), got)
    assert cpu.flush_cascade_stats() == gstats

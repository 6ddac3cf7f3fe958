"""The engine's observability plane against the JAX package's, on the CPU:
``SkylineEngine.stats()`` — with a ``Telemetry`` hub and without — equals
the JAX engine's with the timing fields excluded (``untimed``), for every
flush policy, d in {2, 4, 8} and the three workload shapes, and for device
ingest; the hub's counters, histogram counts and span names equal the
reference's; a hub changes no result byte; the grid prefilter answers the
reference's two cases as the JAX engine does; ``event_ms`` feeds the
freshness lineage; the tracer's phases are the reference's; and the
sliding engine records into the real hub what the reference's records.

Comparisons are exact. The lazy flush's race and the mask race choose by
measured walls, so the grids pin the SFS rounds on both sides
(``SKYLINE_SORTED_SFS=off``, ``SKYLINE_DEVICE_CASCADE=off``); the race test
compares only its first two flushes, whose paths are fixed (each candidate
explores once, in order)."""

import numpy as np
import pytest
import torch

from skyline_tpu.ops import cascade as jax_cascade
from skyline_tpu.ops import dispatch as jax_dispatch
from skyline_tpu.metrics.tracing import Tracer as JaxTracer
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu.stream.sliding_engine import SlidingEngine as JaxSlidingEngine
from skyline_tpu.telemetry import Telemetry as JaxTelemetry
from skyline_tpu.telemetry import spans as jax_spans
from skyline_tpu_torch.metrics.tracing import Tracer
from skyline_tpu_torch.ops import cascade, dispatch
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream.sliding_engine import SlidingEngine
from skyline_tpu_torch.telemetry import Telemetry, spans

from conftest import gen_points

torch.set_num_threads(1)

# every key of stats() and the plans that holds a wall time, a wall-clock
# stamp or a per-process identity: keys ending in _ms or _s, and these
TIMING_KEYS = frozenset({
    "processing_ms", "wall_ms", "ema_ms", "first_call_ms", "last_ms",
    "phase_total_ms", "attributed_share", "t_ms", "trace_id",
    # the freshness lineage's lag histograms
    "stages",
})


def untimed(doc):
    """``doc`` (a ``stats()`` dict, a plan, a result) without its timing
    fields, the kernel profile's rows (sorted by wall) in signature order."""
    if isinstance(doc, dict):
        out = {
            k: untimed(v) for k, v in doc.items()
            if k not in TIMING_KEYS and not k.endswith(("_ms", "_s"))
        }
        if isinstance(out.get("kernels"), list):
            out["kernels"] = sorted(
                out["kernels"],
                key=lambda r: (r["variant"], r["d"], r["n_bucket"], r["backend"], r["mp"]),
            )
        return out
    if isinstance(doc, list):
        return [untimed(v) for v in doc]
    return doc


@pytest.fixture(autouse=True)
def process_state(monkeypatch):
    """Process-global state of both packages: the mask dispatch's profiler
    (the newest engine's), the cascade table's pins and overrides (the
    tuner's) and the trace-id sequence."""
    for mod_dispatch, mod_cascade, mod_spans in (
        (dispatch, cascade, spans), (jax_dispatch, jax_cascade, jax_spans)
    ):
        monkeypatch.setattr(mod_dispatch, "_MASK_PROFILER", None)
        monkeypatch.setattr(mod_spans, "_mint_seq", 0)
        mod_cascade.clear_pins()
        for name in list(mod_cascade.overrides_doc()):
            mod_cascade.clear_override(name)
    yield
    for mod_cascade in (cascade, jax_cascade):
        mod_cascade.clear_pins()
        for name in list(mod_cascade.overrides_doc()):
            mod_cascade.clear_override(name)


@pytest.fixture
def rounds_only(monkeypatch):
    """The lazy flush pinned to the SFS rounds on both sides."""
    monkeypatch.setenv("SKYLINE_SORTED_SFS", "off")
    monkeypatch.setenv("SKYLINE_DEVICE_CASCADE", "off")


def _engines(hub: bool, **kw):
    """A port engine on the CPU and a JAX engine of one configuration, each
    with its package's hub when ``hub``."""
    jax_eng = JaxEngine(JaxConfig(**kw), telemetry=JaxTelemetry() if hub else None)
    eng = SkylineEngine(EngineConfig(**kw, device="cpu"),
                        telemetry=Telemetry() if hub else None)
    return eng, jax_eng


def _drive(engines, windows, chunk=700, event_ms=None):
    """Each window in chunks through every engine, a trigger after each;
    returns each engine's results."""
    results = [[] for _ in engines]
    base = 0
    for w, x in enumerate(windows):
        ids = np.arange(base, base + x.shape[0], dtype=np.int64)
        base += x.shape[0]
        for s in range(0, x.shape[0], chunk):
            for eng in engines:
                eng.process_records(ids[s : s + chunk], x[s : s + chunk], event_ms=event_ms)
        for eng, out in zip(engines, results):
            eng.process_trigger(f"q{w},0")
            out += eng.poll_results()
    return results


def _windows(kind: str, d: int, n: int = 1500, count: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed + d)
    return [gen_points(rng, n, d, kind) * 1000.0 for _ in range(count)]


def _assert_same_plane(eng, jax_eng):
    assert untimed(eng.stats(include_skyline_counts=True)) == untimed(
        jax_eng.stats(include_skyline_counts=True))
    tel, jtel = eng.telemetry, jax_eng.telemetry
    if tel is None:
        return
    assert tel.counters.snapshot() == jtel.counters.snapshot()
    assert {k: v["count"] for k, v in tel.latency_snapshot().items()} == {
        k: v["count"] for k, v in jtel.latency_snapshot().items()}
    assert [(s["name"], s["tid"], sorted(s.get("args", {}))) for s in tel.spans.snapshot()] \
        == [(s["name"], s["tid"], sorted(s.get("args", {}))) for s in jtel.spans.snapshot()]
    assert untimed(tel.explain.snapshot()) == untimed(jtel.explain.snapshot())
    assert untimed(tel.flight.snapshot()) == untimed(jtel.flight.snapshot())


@pytest.mark.parametrize("kind", ["uniform", "correlated", "anti"])
@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("policy", ["incremental", "lazy", "overlap"])
def test_stats_match_reference(policy, d, kind, rounds_only):
    """Host ingest, two windows of 1,500 rows in 700-row chunks: the
    results, ``stats()`` (with and without a hub), the hub's counters,
    histogram counts, spans, plans and flight notes equal the JAX
    engine's; the hub changes no result byte."""
    kw = dict(parallelism=2, dims=d, buffer_size=512, overlap_rows=1000, ingest="host",
              flush_policy=policy, emit_skyline_points=True)
    windows = _windows(kind, d)
    runs = {}
    for hub in (False, True):
        eng, jax_eng = _engines(hub, **kw)
        got, want = _drive([eng, jax_eng], windows)
        assert untimed(got) == untimed(want)
        _assert_same_plane(eng, jax_eng)
        runs[hub] = got
    assert untimed(runs[True]) == untimed(runs[False])
    assert all("trace_id" in r for r in runs[True])


@pytest.mark.parametrize("policy,d", [("lazy", 4), ("lazy", 8), ("overlap", 4), ("lazy", 2)])
def test_device_ingest_stats_match_reference(policy, d, rounds_only):
    kw = dict(parallelism=2, dims=d, buffer_size=512, overlap_rows=1000, ingest="device",
              flush_policy=policy, emit_skyline_points=True)
    eng, jax_eng = _engines(True, **kw)
    got, want = _drive([eng, jax_eng], _windows("anti", d, seed=7))
    assert untimed(got) == untimed(want)
    _assert_same_plane(eng, jax_eng)


def test_lazy_race_first_flushes_match_reference():
    """Under ``auto`` each candidate explores once, in order (the host
    sorted cascade, then the rounds): the first two flushes' paths, the
    ``flush.sorted_sfs`` counter and the plane match."""
    kw = dict(parallelism=2, dims=4, buffer_size=512, ingest="host", flush_policy="lazy")
    eng, jax_eng = _engines(True, **kw)
    _drive([eng, jax_eng], _windows("anti", 4, seed=3))
    assert eng.telemetry.counters.get("flush.sorted_sfs") == 1
    _assert_same_plane(eng, jax_eng)


def test_planes_off_match_reference(monkeypatch, rounds_only):
    """Every plane's knob off: ``stats()`` loses the same blocks."""
    for name in ("SKYLINE_FRESHNESS", "SKYLINE_KERNEL_PROFILE", "SKYLINE_EXPLAIN",
                 "SKYLINE_AUDIT", "SKYLINE_WORKLOAD", "SKYLINE_TUNER"):
        monkeypatch.setenv(name, "0")
    kw = dict(parallelism=2, dims=4, buffer_size=512, flush_policy="lazy", ingest="host")
    eng, jax_eng = _engines(True, **kw)
    _drive([eng, jax_eng], _windows("uniform", 4))
    st = eng.stats()
    for block in ("explain", "audit", "freshness", "workload", "kernel_profile"):
        assert block not in st
    assert eng.tuner is None and eng.profiler is None
    _assert_same_plane(eng, jax_eng)


def test_audit_block_without_a_store(rounds_only):
    """With a hub and ``SKYLINE_AUDIT`` on, the audit counters register at
    0 and ``stats()["audit"]`` is the hub's verdict document: no check
    runs before a snapshot store exists, in either package."""
    eng, jax_eng = _engines(True, dims=3, flush_policy="lazy", ingest="host")
    _drive([eng, jax_eng], _windows("anti", 3))
    audit = eng.stats()["audit"]
    assert audit == jax_eng.stats()["audit"] == eng.telemetry.audit.doc()
    assert audit["checks_total"] == 0 and audit["ok"] is True
    assert eng.telemetry.counters.get("audit.checks") == 0


def test_event_ms_feeds_freshness(rounds_only):
    """``event_ms`` as a scalar and as a (min, max) pair: the lineage's
    batch count and the ingest histogram match the reference's; the
    published watermark stays unset without a snapshot store."""
    eng, jax_eng = _engines(True, dims=3, flush_policy="incremental", buffer_size=512)
    x = _windows("uniform", 3)[0]
    for i, ev in enumerate((1000.0, (900.0, 1100.0), None)):
        ids = np.arange(i * 500, (i + 1) * 500, dtype=np.int64)
        for e in (eng, jax_eng):
            e.process_records(ids, x[i * 500 : (i + 1) * 500], event_ms=ev)
    for e in (eng, jax_eng):
        e.process_trigger("q,0")
        e.poll_results()
    got, want = eng.stats()["freshness"], jax_eng.stats()["freshness"]
    assert got["batches"] == want["batches"] == 3
    assert got["published_wm_ms"] is want["published_wm_ms"] is None
    assert {s: v["count"] for s, v in got["stages"].items()} == {
        s: v["count"] for s, v in want["stages"].items()}
    assert eng.telemetry.histogram("ingest_batch_ms").count == 3


def test_tracer_phases_match_reference(rounds_only):
    """The port's phases are the reference's, with the same counts, for
    host and device ingest (the engine's and the set's phases)."""
    for ingest, policy in (("host", "incremental"), ("host", "lazy"), ("device", "lazy")):
        kw = dict(parallelism=2, dims=4, buffer_size=512, flush_policy=policy, ingest=ingest)
        tr, jtr = Tracer(sync_device=False), JaxTracer(sync_device=False)
        eng = SkylineEngine(EngineConfig(**kw, device="cpu"), tracer=tr)
        jax_eng = JaxEngine(JaxConfig(**kw), tracer=jtr)
        _drive([eng, jax_eng], _windows("anti", 4, seed=11))
        got = {k: v["count"] for k, v in tr.report().items()}
        want = {k: v["count"] for k, v in jtr.report().items()}
        assert got == want, (ingest, policy)
        assert got.get("flush/merge_kernel", 0) > 0
        prof = eng.stats()["kernel_profile"]
        assert prof["phase_total_ms"] == round(tr.report()["flush/merge_kernel"]["total_ms"], 3)


def test_engine_profiler_is_the_mask_dispatch_profiler(rounds_only):
    """The newest engine's profiler is the mask dispatch's, as in the
    reference; with the kernel profile off it is not registered."""
    eng = SkylineEngine(EngineConfig(dims=4, device="cpu"))
    assert dispatch._mask_profiler() is eng.profiler
    tel = Telemetry()
    eng2 = SkylineEngine(EngineConfig(dims=4, device="cpu"), telemetry=tel)
    assert eng2.profiler is tel.profiler is dispatch._mask_profiler()


# -- the grid prefilter -----------------------------------------------------------


def _feed(engines, x, start_id=0, chunk=500):
    for s in range(0, x.shape[0], chunk):
        ids = np.arange(start_id + s, start_id + min(s + chunk, x.shape[0]), dtype=np.int64)
        for e in engines:
            e.process_records(ids, x[s : s + chunk])


def test_grid_prefilter_exact_and_barrier_safe_like_reference(rng, rounds_only):
    """The reference's case (``tests/test_engine.py``): a barrier inside a
    normal tail clears only through the dropped rows' ids; the answer,
    ``prefiltered``, every partition's ``max_seen_id`` and ``stats()``
    equal the JAX engine's, and the answer equals the unfiltered one."""
    x = rng.uniform(0, 1000, size=(4000, 3)).astype(np.float32)
    normal = rng.uniform(0, 1000, size=(200, 3)).astype(np.float32)
    doomed = rng.uniform(600, 1000, size=(100, 3)).astype(np.float32)
    kw = dict(parallelism=2, algo="mr-grid", dims=3, buffer_size=256,
              grid_prefilter=True, emit_skyline_points=True)
    for hub in (False, True):
        eng, jax_eng = _engines(hub, **kw)
        both = (eng, jax_eng)
        _feed(both, x)
        for e in both:
            e.process_trigger("1,4150")
            assert e.poll_results() == []
        _feed(both, normal, start_id=4000)
        before = eng.prefiltered
        _feed(both, doomed, start_id=4200)
        (got,), (want,) = eng.poll_results(), jax_eng.poll_results()
        assert untimed(got) == untimed(want) and got["query_id"] == "1"
        assert eng.prefiltered == jax_eng.prefiltered and eng.prefiltered - before == 100
        assert [p.max_seen_id for p in eng.partitions] == [
            p.max_seen_id for p in jax_eng.partitions]
        assert eng.partitions[7 % eng.config.num_partitions].max_seen_id == 4299
        _assert_same_plane(eng, jax_eng)
    base = SkylineEngine(EngineConfig(**{**kw, "grid_prefilter": False}, device="cpu"))
    _feed([base], np.concatenate([x, normal, doomed]))
    base.process_trigger("0,0")
    (full,) = base.poll_results()
    assert full["skyline_size"] == got["skyline_size"]


def test_grid_prefilter_waits_for_witness_like_reference(rounds_only):
    kw = dict(parallelism=1, algo="mr-grid", dims=2, domain_max=1000.0, buffer_size=64,
              grid_prefilter=True)
    eng, jax_eng = _engines(True, **kw)
    high = np.array([[800.0, 600.0], [600.0, 800.0]], dtype=np.float32)
    for e in (eng, jax_eng):
        e.process_records(np.arange(2, dtype=np.int64), high)
        assert e.prefiltered == 0
        e.process_trigger("0,0")
    (got,), (want,) = eng.poll_results(), jax_eng.poll_results()
    assert got["skyline_size"] == want["skyline_size"] == 2
    _assert_same_plane(eng, jax_eng)


def test_grid_prefilter_ingest_resolution():
    """``ingest="device"`` with the prefilter raises the reference's
    error; ``"auto"`` ingests on the host."""
    with pytest.raises(ValueError, match="without grid_prefilter"):
        SkylineEngine(EngineConfig(flush_policy="lazy", ingest="device", grid_prefilter=True,
                                   device="cpu"))
    eng = SkylineEngine(EngineConfig(flush_policy="lazy", grid_prefilter=True, device="cpu"))
    assert not eng.pset.device_ingest


# -- the sliding engine with the real hub -------------------------------------------


def test_sliding_engine_records_like_reference():
    """``SlidingEngine`` with the real ``Telemetry``: the results (trace ids
    and timings aside), the histogram counts, the span names, tids and args
    keys, and the trace ids' joins equal the reference engine's with its
    hub."""
    kw = dict(parallelism=2, dims=3, buffer_size=256)
    tel, jtel = Telemetry(), JaxTelemetry()
    eng = SlidingEngine(EngineConfig(**kw, device="cpu"), window_size=600, slide=200,
                        emit_per_slide=True, telemetry=tel)
    jax_eng = JaxSlidingEngine(JaxConfig(**kw), window_size=600, slide=200,
                               emit_per_slide=True, telemetry=jtel)
    x = gen_points(np.random.default_rng(4), 1700, 3, "anti") * 1000.0
    results = [[], []]
    for s in range(0, 1700, 300):
        ids = np.arange(s, min(s + 300, 1700), dtype=np.int64)
        for e, out in zip((eng, jax_eng), results):
            e.process_records(ids, x[s : s + 300])
            if s == 900:
                e.process_trigger("mid,0")
            out += e.poll_results()
    assert untimed(results[0]) == untimed(results[1]) and len(results[0]) >= 8
    # per-slide emissions carry no trace id; triggered answers do
    assert [("trace_id" in r) for r in results[0]] == [("trace_id" in r) for r in results[1]]
    assert any("trace_id" in r for r in results[0])
    assert tel.counters.snapshot() == jtel.counters.snapshot()
    assert {k: v["count"] for k, v in tel.latency_snapshot().items()} == {
        k: v["count"] for k, v in jtel.latency_snapshot().items()}

    def shape(hub):
        ids = {}
        return [(s["name"], s["tid"], sorted(s.get("args", {})),
                 ids.setdefault(s.get("trace_id"), len(ids)))
                for s in hub.spans.snapshot()]

    assert shape(tel) == shape(jtel)


def test_profile_cost_keys_like_reference(monkeypatch, rounds_only):
    """``SKYLINE_PROFILE_COST``: the merge step's first dispatch of each
    signature carries a ``cost`` with the reference's keys (the port
    reckons them from shapes, the reference asks XLA), and only then."""
    kw = dict(parallelism=2, dims=4, buffer_size=512, flush_policy="incremental")
    for on in ("0", "1"):
        monkeypatch.setenv("SKYLINE_PROFILE_COST", on)
        eng, jax_eng = _engines(False, **kw)
        _drive([eng, jax_eng], _windows("anti", 4, count=1))
        rows = [r for r in eng.stats()["kernel_profile"]["kernels"]
                if r["variant"] == "merge_step"]
        jrows = [r for r in jax_eng.stats()["kernel_profile"]["kernels"]
                 if r["variant"] == "merge_step"]
        assert rows and len(rows) == len(jrows)
        assert [sorted(r.get("cost", {})) for r in rows] == [
            sorted(r.get("cost", {})) for r in jrows]
        if on == "1":
            for r in rows:
                assert r["cost"]["flops"] > 0 and r["cost"]["bytes_accessed"] > 0
        else:
            assert all("cost" not in r for r in rows)

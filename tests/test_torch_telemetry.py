"""The port's telemetry primitives against the JAX package's, on the CPU:
each pair is fed the same observations (made from a seed with numpy) and
must give the same output, exactly unless a test says otherwise —
``Histogram`` snapshots, quantiles and buckets, ``SpanRecorder`` rings and
their Chrome export (timestamps aside), ``prometheus.render`` byte for
byte, ``Counters``, ``FlightRecorder``, the SLO burn, the freshness lineage
and the workload characterizer (regime, drift, quantile sketches); the
kernel profiler's spans and cost thunk; the kernel build cache's counters;
and the import boundary of ``skyline_tpu_torch.telemetry``."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from skyline_tpu.metrics.collector import Counters as JaxCounters
from skyline_tpu.telemetry import Telemetry as JaxTelemetry
from skyline_tpu.telemetry import freshness as jax_freshness
from skyline_tpu.telemetry import histogram as jax_histogram
from skyline_tpu.telemetry import profiler as jax_profiler
from skyline_tpu.telemetry import prometheus as jax_prometheus
from skyline_tpu.telemetry import slo as jax_slo
from skyline_tpu.telemetry import spans as jax_spans
from skyline_tpu.telemetry import workload as jax_workload
from skyline_tpu_torch.metrics.collector import Counters
from skyline_tpu_torch.telemetry import Telemetry
from skyline_tpu_torch.telemetry import freshness, histogram, profiler, prometheus, slo
from skyline_tpu_torch.telemetry import spans, workload
from skyline_tpu_torch.utils import compile_cache

from conftest import gen_points

torch.set_num_threads(1)


def _without(doc, keys=("t_ms",)):
    """``doc`` without the wall-clock stamps in ``keys``, at any depth."""
    if isinstance(doc, dict):
        return {k: _without(v, keys) for k, v in doc.items() if k not in keys}
    if isinstance(doc, list):
        return [_without(v, keys) for v in doc]
    return doc


# -- histograms ---------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 37, 1024, 5000])
@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_matches_reference(n, seed):
    """Snapshots, quantiles and cumulative buckets, in the exact-sample
    regime (n <= 1024) and past it (bucket interpolation)."""
    v = np.random.default_rng(seed).lognormal(1.0, 2.0, n)
    a, b = histogram.Histogram("h"), jax_histogram.Histogram("h")
    for x in v:
        a.observe(float(x))
        b.observe(float(x))
    assert a.snapshot() == b.snapshot()
    assert a.bucket_counts() == b.bucket_counts()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert a.quantile(q) == b.quantile(q)
    assert a.percentiles(50, 99.9) == b.percentiles(50, 99.9)
    assert histogram.DEFAULT_EDGES == jax_histogram.DEFAULT_EDGES


def test_histogram_edges_labels_and_errors():
    a = histogram.Histogram("h", edges=(1.0, 2.0, 4.0), sample_cap=2, labels=(("k", "v"),))
    b = jax_histogram.Histogram("h", edges=(1.0, 2.0, 4.0), sample_cap=2, labels=(("k", "v"),))
    for x in (0.5, 1.5, 3.0, 9.0, 2.0):
        a.observe(x)
        b.observe(x)
    assert a.snapshot() == b.snapshot() and a.labels == b.labels
    assert a.bucket_counts() == b.bucket_counts()
    assert histogram.Histogram("e").snapshot() == {"count": 0}
    with pytest.raises(ValueError):
        histogram.Histogram("bad", edges=(2.0, 1.0))
    with pytest.raises(ValueError):
        a.quantile(1.5)


# -- spans -----------------------------------------------------------------------


def _fill_spans(rec, n: int, seed: int):
    rng = np.random.default_rng(seed)
    starts = np.cumsum(rng.integers(1, 10_000, n))
    for i in range(n):
        args = {"rows": int(i)} if i % 3 else None
        rec.record(f"s{i % 5}", int(starts[i]), int(starts[i] + rng.integers(0, 5000)),
                   trace_id=f"t{i % 4}" if i % 2 else None, tid=int(i % 3), args=args)


@pytest.mark.parametrize("cap,n", [(16, 10), (16, 40), (1, 3)])
def test_span_ring_matches_reference(cap, n):
    a, b = spans.SpanRecorder(cap), jax_spans.SpanRecorder(cap)
    _fill_spans(a, n, cap + n)
    _fill_spans(b, n, cap + n)
    assert a.snapshot() == b.snapshot()
    assert (a.recorded, a.dropped, len(a)) == (b.recorded, b.dropped, len(b))
    assert a.dropped == max(0, n - cap)
    ca, cb = a.to_chrome(), b.to_chrome()
    # the exported timestamps are relative to each recorder's creation
    strip = ("ts", "anchor_epoch_ms")
    assert _without(ca, strip) == _without(cb, strip)
    assert ca["otherData"]["partial"] == (n > cap)


def test_span_context_and_write_chrome(tmp_path):
    rec = spans.SpanRecorder(8)
    with rec.span("x", trace_id="t", tid=1, rows=3):
        pass
    (s,) = rec.snapshot()
    assert (s["name"], s["trace_id"], s["tid"], s["args"]) == ("x", "t", 1, {"rows": 3})
    assert rec.write_chrome(str(tmp_path / "t.json")) == 1
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"][0]["name"] == "x"


def test_trace_ids_are_unique():
    ids = {spans.mint_trace_id() for _ in range(1000)}
    assert len(ids) == 1000


# -- prometheus, counters --------------------------------------------------------


def _render(mod, hist_mod, seed: int):
    rng = np.random.default_rng(seed)
    hists = []
    for name, labels in (("query_latency_ms", None), ("freshness_lag_ms", (("stage", "a"),)),
                         ("freshness_lag_ms", (("stage", "b"),))):
        h = hist_mod.Histogram(name, labels=labels)
        for x in rng.lognormal(0.0, 1.5, 300):
            h.observe(float(x))
        hists.append(h)
    counters = {"merge.cache_hit": 3, "flush.prefilter_dropped": 0, "x-y": 2.5}
    gauges = mod.flatten_gauges({"serve": {"reads": 3, "on": True, "name": "x"},
                                 "9lag": 1.5e20, "inf": float("inf")})
    labeled = {"chip_rows": [((("chip", "0"),), 5), ((("chip", '1"\n'),), 7)]}
    return mod.render(counters=counters, gauges=gauges, histograms=hists,
                      labeled_counters=labeled, labeled_gauges=labeled)


@pytest.mark.parametrize("seed", [0, 1])
def test_prometheus_render_byte_for_byte(seed):
    got = _render(prometheus, histogram, seed)
    assert got == _render(jax_prometheus, jax_histogram, seed)
    assert prometheus.CONTENT_TYPE == jax_prometheus.CONTENT_TYPE
    assert prometheus.render() == jax_prometheus.render() == "\n"


def test_counters_match_reference():
    a, b = Counters(), JaxCounters()
    rng = np.random.default_rng(3)
    for name, n in zip(rng.integers(0, 5, 200), rng.integers(0, 4, 200)):
        a.inc(f"c{name}", int(n))
        b.inc(f"c{name}", int(n))
    assert a.snapshot() == b.snapshot()
    assert a.get("c1") == b.get("c1") and a.get("none") == 0


def test_hub_prometheus_matches_reference():
    """The same recordings into both hubs render the same exposition (the
    build-cache counters set alike: the JAX hub counts XLA's cache)."""
    hubs = Telemetry(span_capacity=4), JaxTelemetry(span_capacity=4)
    for tel in hubs:
        for i in range(6):
            tel.inc("queries.answered")
            tel.histogram("query_latency_ms").observe(1.5 * i)
            tel.histogram("freshness_lag_ms", labels=(("stage", "flush"),)).observe(i)
            tel.spans.record("ingest", i, i + 1)
    cc = {"compile_cache.hits": 0, "compile_cache.misses": 0}
    got, want = (t.render_prometheus(gauges={"g": 1.0}, extra_counters=cc) for t in hubs)
    assert got == want
    assert "skyline_telemetry_spans_dropped_total 2" in got
    assert hubs[0].latency_snapshot() == hubs[1].latency_snapshot()
    for slot in ("fleet", "health", "cluster", "opslog", "clusterview", "workload", "tuner"):
        assert getattr(hubs[0], slot) is None
    assert hubs[0].replication == []


def test_compile_cache_counters_in_exposition(monkeypatch):
    """A cached source counts a hit, an nvcc run a miss; both read 0 until
    a build runs, as they do on the CPU."""
    monkeypatch.setattr(compile_cache, "_counts", {"hits": 0, "misses": 0})
    tel = Telemetry()
    assert "skyline_compile_cache_misses_total 0" in tel.render_prometheus()
    compile_cache.note_build(True)
    compile_cache.note_build(False)
    compile_cache.note_build(True)
    assert compile_cache.compile_cache_stats() == {"hits": 2, "misses": 1}
    text = tel.render_prometheus()
    assert "skyline_compile_cache_hits_total 2" in text
    assert "skyline_compile_cache_misses_total 1" in text


# -- the flight recorder, the kernel profiler's spans and cost ------------------


def _notes(rec):
    rec.note("flush.dispatch", policy="lazy", rows=10, sequential=False)
    rec.set_trace("t-1")
    rec.note("merge.cache_hit", key=b"\x00\x01\xff")
    rec.note("merge.launch", path="tree", dirty_fraction=0.25, obj=(1, 2), none=None)
    rec.note("merge.launch", trace_id="own")
    rec.set_trace(None)
    for i in range(5):
        rec.note("flush.prefilter", seen=i, dropped=0)


@pytest.mark.parametrize("cap", [3, 64])
def test_flight_recorder_matches_reference(cap, capsys):
    a, b = profiler.FlightRecorder(cap), jax_profiler.FlightRecorder(cap)
    _notes(a)
    _notes(b)
    assert _without(a.snapshot()) == _without(b.snapshot())
    assert _without(a.doc()) == _without(b.doc())
    assert a.doc()["partial"] == (cap < 9) and len(a) == min(cap, 9)
    a.dump("why")
    dumped = capsys.readouterr().err
    assert dumped.startswith("skyline-flight-recorder: ")
    assert json.loads(dumped.split(": ", 1)[1])["reason"] == "why"


def test_profiler_spans_and_cost_match_reference():
    """``record`` with a span ring lands ``kernel/<variant>`` spans on tid 2
    with the reference's args; a cost thunk runs once per signature."""
    a_spans, b_spans = spans.SpanRecorder(64), jax_spans.SpanRecorder(64)
    a = profiler.KernelProfiler(spans=a_spans, backend="cpu")
    b = jax_profiler.KernelProfiler(spans=b_spans, backend="cpu")
    calls = []

    def thunk():
        calls.append(1)
        return {"flops": 12.0, "bytes accessed": 34, "other": "x"}

    for prof in (a, b):
        for n, mp in ((1000, False), (1000, False), (5000, True)):
            with prof.record("merge_step", 4, n, mp=mp, cost_thunk=thunk):
                pass
    assert len(calls) == 4  # once per signature, both profilers

    def strip(ring):
        return [(s["name"], s["tid"], s["args"]) for s in ring.snapshot()]

    assert strip(a_spans) == strip(b_spans)
    assert strip(a_spans)[0] == ("kernel/merge_step", 2, {"d": 4, "n_bucket": 1024, "mp": False})
    rows_a = sorted(a.doc()["kernels"], key=lambda r: r["n_bucket"])
    rows_b = sorted(b.doc()["kernels"], key=lambda r: r["n_bucket"])
    timing = ("wall_ms", "ema_ms", "first_call_ms")
    assert _without(rows_a, timing) == _without(rows_b, timing)
    assert rows_a[0]["cost"] == {"flops": 12.0, "bytes_accessed": 34.0}


@pytest.mark.parametrize("cost", [
    {"flops": 1, "bytes_accessed": 2.5},
    [{"flops": 3.0}],
    [],
    "nonsense",
    {"flops": "x"},
    RuntimeError("no cost"),
])
def test_try_cost_matches_reference(cost):
    def thunk():
        if isinstance(cost, Exception):
            raise cost
        return cost

    got = profiler.KernelProfiler._try_cost(thunk)
    assert got == jax_profiler.KernelProfiler._try_cost(thunk)


# -- the SLO engine, freshness, the workload characterizer -----------------------


def _slo_feed(tel, rng_seed: int, t: float):
    rng = np.random.default_rng(rng_seed)
    for x in rng.lognormal(3.0, 1.0, 200):
        tel.histogram("serve_read_ms").observe(float(x))
        tel.histogram("freshness_lag_ms", labels=(("stage", "read"),)).observe(float(x) * 80)
    tel.inc("queries.answered", int(rng.integers(5, 50)))
    tel.inc("degraded_answers", int(rng.integers(0, 3)))
    tel.inc("audit.checks", 10)
    tel.inc("audit.divergence", int(rng.integers(0, 2)))
    tel.inc("supervisor.restarts", int(rng.integers(0, 3)))


def test_slo_burn_matches_reference(monkeypatch):
    monkeypatch.setenv("SKYLINE_SLO_FAST_WINDOW_S", "30")
    monkeypatch.setenv("SKYLINE_SLO_READ_P99_MS", "40")
    clock = [1000.0]
    hubs = Telemetry(), JaxTelemetry()
    engines = slo.SloEngine(hubs[0], clock=lambda: clock[0]), jax_slo.SloEngine(
        hubs[1], clock=lambda: clock[0])
    docs = []
    for step in range(6):
        clock[0] += 20.0
        for tel in hubs:
            _slo_feed(tel, step, clock[0])
        docs.append(tuple(e.evaluate() for e in engines))
    for got, want in docs:
        assert got == want
    assert any(not got["ok"] for got, _ in docs) or all(got["ok"] for got, _ in docs)


def test_freshness_matches_reference():
    rng = np.random.default_rng(5)
    ev = np.cumsum(rng.uniform(1, 50, 40))
    a, b = freshness.FreshnessTracker(), jax_freshness.FreshnessTracker()
    hubs = Telemetry(), JaxTelemetry()
    ha, hb = freshness.FreshnessTracker(hubs[0]), jax_freshness.FreshnessTracker(hubs[1])
    for tr in (a, b, ha, hb):
        now = 10_000.0
        for i in range(0, 40, 4):
            tr.on_ingest(ev[i], ev[i + 3], now_ms=now)
            now += 7.0
            if i % 8 == 0:
                tr.on_flush(now_ms=now)
                tr.on_merge(now_ms=now + 1)
                tr.on_publish(now_ms=now + 2)
                tr.on_read(3.5)
        tr.restore(5.0)
    assert a.stats() == b.stats() == ha.stats() == hb.stats()
    assert a.published_wm == b.published_wm
    assert hubs[0].latency_snapshot() == hubs[1].latency_snapshot()


def _workload_stream(rng, d: int):
    """Batches whose regime flips: uniform, then anti-correlated, then
    correlated, then shifted uniform."""
    out = []
    for kind in ("uniform", "anti", "correlated"):
        for _ in range(3):
            out.append(gen_points(rng, 700, d, kind) * 1000.0)
    for _ in range(3):
        out.append(gen_points(rng, 900, d, "uniform") * 300.0 + 600.0)
    return out


@pytest.mark.parametrize("d", [2, 4, 8])
def test_workload_matches_reference(d):
    batches = _workload_stream(np.random.default_rng(d), d)
    kw = dict(epoch_rows=512, sample_cap=512, ring=5)
    counters = Counters(), JaxCounters()
    flights = profiler.FlightRecorder(64), jax_profiler.FlightRecorder(64)
    a = workload.WorkloadCharacterizer(d, counters=counters[0], flight=flights[0], **kw)
    b = jax_workload.WorkloadCharacterizer(d, counters=counters[1], flight=flights[1], **kw)
    kinds = set()
    for i, x in enumerate(batches):
        for w in (a, b):
            w.observe(x)
            if i % 2:
                w.note_query(17 + i, 700 * (i + 1))
        assert a.regime() == b.regime()
        kinds.add(a.regime()["kind"])
    assert a.stats() == b.stats()
    assert counters[0].snapshot() == counters[1].snapshot()
    assert _without(flights[0].snapshot()) == _without(flights[1].snapshot())
    st = a.stats()
    assert st["epochs_closed"] >= 4 and st["drift_total"] >= 1
    assert len(kinds - {"unknown"}) >= 2


def test_workload_knobs_match_reference(monkeypatch):
    monkeypatch.setenv("SKYLINE_WORKLOAD_EPOCH_ROWS", "300")
    monkeypatch.setenv("SKYLINE_WORKLOAD_SAMPLE_CAP", "100")
    monkeypatch.setenv("SKYLINE_WORKLOAD_DRIFT_THRESHOLD", "0.05")
    a, b = workload.WorkloadCharacterizer(3), jax_workload.WorkloadCharacterizer(3)
    assert (a.epoch_rows, a.sample_cap, a.drift_threshold) == (300, 100, 0.05)
    rng = np.random.default_rng(9)
    for _ in range(8):
        x = gen_points(rng, 450, 3, "anti")
        a.observe(x)
        b.observe(x)
    assert a.stats() == b.stats()


# -- the import boundary ---------------------------------------------------------


def test_telemetry_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import skyline_tpu_torch, skyline_tpu_torch.telemetry\n"
        "import skyline_tpu_torch.telemetry.tuner, skyline_tpu_torch.explain\n"
        "import skyline_tpu_torch.stream.engine\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'skyline_tpu' or m.startswith('skyline_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

"""``SlidingEngine`` and the query watchdog of both engine modes, against
the JAX package on the CPU, exact bytes.

Every test of ``tests/test_sliding_engine.py`` but the meshed one and the
worker's is repeated here against the port, each result compared with the
JAX engine's on the same seeded stream (sizes, optimality, fill flag,
slides closed, ``partial`` and the ``skyline_points`` bytes; the timing
fields are not compared) and with the numpy oracle. Every branch of the
slide step: the sweep (d <= 2), the scan, and K3 over every partition
(its plain version on the CPU) against the reference's ``use_pallas``
step in interpret mode; the K3 gate against the reference's on an
accelerator; the ``tracer``, ``telemetry`` and ``attach_snapshots`` hooks
with recording fakes; ``SkylineEngine.check_timeouts`` under every flush
policy and with a merge in flight. The ``cuda``-marked leg skips without a
card."""

import subprocess
import sys
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from skyline_tpu.ops import skyline_np
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu.stream.sliding_engine import SlidingEngine as JaxSliding
from skyline_tpu.workload.generators import generate
from skyline_tpu_torch.ops import dominance_kernels as dk
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream.sliding_engine import SlidingEngine

from conftest import assert_same_set

torch.set_num_threads(1)

# the fields that must agree; the timing fields and trace ids are not
# compared (their clocks differ)
FIELDS = ("query_id", "record_count", "skyline_size", "optimality", "window_size",
          "slide", "slides_closed", "window_filled", "partial", "missing_partitions")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _cfgs(**kw):
    common = dict(domain_max=1000.0, emit_skyline_points=True)
    common.update(kw)
    return JaxConfig(**common), EngineConfig(**{**common, "device": "cpu"})


def _pair(window, slide, **kw):
    """(JAX engine, port engine) over the same configuration."""
    eng_kw = {k: kw.pop(k) for k in ("emit_per_slide",) if k in kw}
    jcfg, tcfg = _cfgs(**kw)
    return (JaxSliding(jcfg, window_size=window, slide=slide, **eng_kw),
            SlidingEngine(tcfg, window_size=window, slide=slide, **eng_kw))


def _window_oracle(x, consumed, window, slide):
    """Rows covered by the engine's window after ``consumed`` tuples."""
    closed = (consumed // slide) * slide
    return x[max(0, closed - window) : consumed]


def _drive(eng, x, chunk=700, start_id=0, now_ms=None):
    ids = np.arange(start_id, start_id + x.shape[0], dtype=np.int64)
    for i in range(0, x.shape[0], chunk):
        eng.process_records(ids[i : i + chunk], x[i : i + chunk], now_ms=now_ms)


def _assert_same(want, got):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        for f in FIELDS:
            assert b.get(f) == a.get(f), f
        if "skyline_points" in a:
            pa = np.asarray(a["skyline_points"], np.float32)
            pb = np.asarray(b["skyline_points"], np.float32)
            assert pb.tobytes() == pa.tobytes()


def _both(engines, fn):
    """Run ``fn(engine)`` on the JAX and the port engine; assert the polled
    results agree; return the port's."""
    out = []
    for eng in engines:
        fn(eng)
        out.append(eng.poll_results())
    _assert_same(*out)
    return out[1]


def test_rejects_misaligned_slide():
    with pytest.raises(ValueError):
        SlidingEngine(EngineConfig(device="cpu"), window_size=100, slide=33)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlidingEngine(EngineConfig(), window_size=100, slide=50)


# -- the reference's sliding-engine tests, against the JAX engine ---------------


@pytest.mark.parametrize("algo", ["mr-dim", "mr-angle"])
def test_trigger_matches_jax_and_oracle(rng, algo):
    window, slide = 2000, 500
    x = rng.uniform(0, 1000, size=(5300, 3)).astype(np.float32)
    engines = _pair(window, slide, parallelism=2, algo=algo, dims=3)

    def run(eng):
        _drive(eng, x)
        eng.process_trigger("0,0")

    (r,) = _both(engines, run)
    oracle = skyline_np(_window_oracle(x, 5300, window, slide))
    assert r["skyline_size"] == oracle.shape[0]
    assert_same_set(np.asarray(r["skyline_points"]), oracle)
    assert r["window_filled"] is True and r["slides_closed"] == 10


def test_mid_slide_and_warmup_match_jax(rng):
    window, slide = 1000, 250
    x = rng.uniform(0, 1000, size=(1600, 2)).astype(np.float32)
    engines = _pair(window, slide, parallelism=2, algo="mr-grid", dims=2)
    (r,) = _both(engines, lambda e: (_drive(e, x[:100]), e.process_trigger("0,0")))
    assert_same_set(np.asarray(r["skyline_points"]), skyline_np(x[:100]))
    assert r["window_filled"] is False
    (r2,) = _both(engines, lambda e: (_drive(e, x[100:], start_id=100),
                                      e.process_trigger("1,0")))
    assert_same_set(np.asarray(r2["skyline_points"]),
                    skyline_np(_window_oracle(x, 1600, window, slide)))


@pytest.mark.parametrize("d,algo,P", [(2, "mr-dim", 1), (8, "mr-angle", 2)])
def test_per_slide_emission_matches_jax(rng, d, algo, P):
    x = generate("anti_correlated", rng, 900, d, 0, 1000)
    engines = _pair(400, 200, parallelism=P, algo=algo, dims=d, emit_per_slide=True)
    results = _both(engines, lambda e: _drive(e, x, chunk=300))
    assert len(results) == 4
    for i, r in enumerate(results):
        assert r["query_id"] == f"slide-{i}"
        assert r["record_count"] == min(900, 300 * (-(-(i + 1) * 200 // 300)))
        oracle = skyline_np(_window_oracle(x, (i + 1) * 200, 400, 200))
        assert r["skyline_size"] == oracle.shape[0], i


def test_barrier_defers_matches_jax(rng):
    x = rng.uniform(0, 1000, size=(600, 2)).astype(np.float32)
    engines = _pair(400, 200, parallelism=1, algo="mr-dim", dims=2)
    assert _both(engines, lambda e: (_drive(e, x[:300]), e.process_trigger("0,500"))) == []
    assert [e.inflight_queries for e in engines] == [1, 1]
    (r,) = _both(engines, lambda e: _drive(e, x[300:], start_id=300))
    assert r["query_id"] == "0"
    assert [e.inflight_queries for e in engines] == [0, 0]


@pytest.mark.parametrize("when", ["first", "later"])
def test_growth_on_skew_matches_jax(rng, when):
    """mr-dim routes by dim0: clustered rows land on one partition and
    overflow the balanced ring capacity — in the first slide, or after
    balanced slides filled the ring (closed buckets keep their rows)."""
    skew = np.column_stack([rng.uniform(0, 40, 4000), rng.uniform(0, 1000, 4000)])
    flat = rng.uniform(0, 1000, size=(4000, 2))
    x = (skew if when == "first" else np.concatenate([flat[:3000], skew[:1000]]))
    x = np.asarray(x, np.float32)
    x3 = np.column_stack([x, rng.uniform(0, 1000, x.shape[0])]).astype(np.float32)
    for data, d in ((x, 2), (x3, 3)):
        engines = _pair(2000, 1000, parallelism=4, algo="mr-dim", dims=d)
        caps = [engines[1]._cap]

        def run(eng, data=data):
            for i in range(0, 4000, 500):
                eng.process_records(np.arange(i, i + 500, dtype=np.int64), data[i : i + 500])
                if eng is engines[1]:
                    caps.append(eng._cap)
                eng.process_trigger(f"{i},0")

        results = _both(engines, run)
        assert caps[-1] > caps[0] and engines[1]._cap == 1024
        assert_same_set(np.asarray(results[-1]["skyline_points"]),
                        skyline_np(_window_oracle(data, 4000, 2000, 1000)))


def test_timing_invariant_with_midcall_close_matches_jax(rng):
    """One process_records call closes two slides and then answers a
    deferred query; under injected constant clocks the close's wall must
    reach the answer (total >= local)."""
    x = rng.uniform(0, 1000, size=(5000, 6)).astype(np.float32)
    ids = np.arange(x.shape[0], dtype=np.int64)
    engines = _pair(4000, 2000, parallelism=2, algo="mr-grid", dims=6,
                    emit_skyline_points=False)

    def first(eng):
        eng.process_records(ids[:1500], x[:1500], now_ms=1000.0)
        eng.process_trigger("0,4000", now_ms=1500.0)

    assert _both(engines, first) == []
    (r,) = _both(engines, lambda e: e.process_records(ids[1500:], x[1500:], now_ms=2000.0))
    assert r["local_processing_time_ms"] >= 0
    assert r["total_processing_time_ms"] >= r["local_processing_time_ms"]
    assert r["total_processing_time_ms"] >= r["global_processing_time_ms"]
    assert r["ingestion_time_ms"] >= 0
    assert engines[1].processing_ns > 0


# -- the slide step's branches ----------------------------------------------------


@pytest.mark.parametrize("d,algo,branch", [(1, "mr-dim", "sweep"), (2, "mr-angle", "sweep"),
                                           (3, "mr-grid", "scan"), (8, "mr-angle", "scan")])
def test_branch_matches_jax(d, algo, branch):
    """Triggers mid-slide and at slide ends, ring wrapping, -0.0 rows and
    duplicates; the port's ``stats()`` names the branch it took."""
    rng = np.random.default_rng(30 + d)
    x = generate("anti_correlated", rng, 1500, d, 0, 1000)
    x[100:130] = x[99]
    x[700:720, 0] = -0.0
    engines = _pair(600, 150, parallelism=2, algo=algo, dims=d)

    def run(eng):
        for i in range(0, 1500, 175):
            eng.process_records(np.arange(i, i + 175, dtype=np.int64)[: len(x[i : i + 175])],
                                x[i : i + 175])
            eng.process_trigger(f"{i},0")

    _both(engines, run)
    assert engines[1].stats()["mask_kernel"] == branch


@pytest.fixture
def interpret(monkeypatch):
    """The JAX side's Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setenv("SKYLINE_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("d", [3, 8])
def test_k3_branch_matches_pallas_step(d, interpret):
    """The port's K3 branch (its plain version on the CPU: one masked pass
    over every partition) against the reference's ``use_pallas`` step, as
    ``tests/test_sliding_engine.py`` forces it; the ring grows mid-stream."""
    rng = np.random.default_rng(60 + d)
    x = generate("anti_correlated", rng, 1200, d, 0, 1000)
    x[300:340] = 0.0
    x[340:350] = -0.0
    engines = _pair(400, 100, parallelism=2, algo="mr-angle", dims=d)
    engines[0]._use_pallas = True
    engines[1]._use_k3 = True

    def run(eng):
        for i in range(0, 1200, 175):
            eng.process_records(np.arange(i, min(i + 175, 1200), dtype=np.int64),
                                x[i : i + 175])
            eng.process_trigger(f"{i},0")

    _both(engines, run)
    assert engines[1].stats()["mask_kernel"] == "k3"


@pytest.mark.parametrize("window,slide,P", [(4096, 1024, 4), (2048, 256, 4), (8192, 1024, 4),
                                            (8192, 2048, 1), (1000, 10, 1)])
def test_k3_gate_is_the_reference_gate(monkeypatch, window, slide, P):
    """The gate reads ``k * cap >= 8192`` on a card as the reference reads
    it on an accelerator, at construction and after growth (which flips
    it at 8192 / 1024)."""
    import skyline_tpu.ops.dispatch as jdispatch

    monkeypatch.setattr(jdispatch, "on_tpu", lambda: True)
    jeng, teng = _pair(window, slide, parallelism=P, dims=3)

    def gate_on_card():  # the gate only: no tensor is made on the card
        teng.device = torch.device("cuda")
        try:
            return teng._k3_gate()
        finally:
            teng.device = torch.device("cpu")

    assert teng._cap == jeng._cap
    assert gate_on_card() == jeng._use_pallas
    new = 4 * teng._cap
    jeng._grow(new)
    teng._grow(new)
    assert teng._cap == jeng._cap == new
    assert gate_on_card() == jeng._use_pallas
    assert not teng._k3_gate() and not teng._use_k3  # never on the CPU


# -- the watchdog, hooks and stats --------------------------------------------------


def test_sliding_timeout_answers_partial_like_jax(rng):
    """A deferred barrier that times out answers over what exists, marked
    ``partial``; its barrier entries are withdrawn."""
    x = rng.uniform(0, 1000, size=(700, 3)).astype(np.float32)
    engines = _pair(400, 200, parallelism=2, algo="mr-dim", dims=3, query_timeout_ms=50.0)

    def run(eng):
        _drive(eng, x[:500], now_ms=1000.0)
        eng.process_trigger("late,5000", now_ms=1000.0)
        assert eng.check_timeouts(now_ms=1040.0) == 0
        assert eng.inflight_queries == 1
        assert eng.check_timeouts(now_ms=1100.0) == 1
        assert eng.inflight_queries == 0
        _drive(eng, x[500:], start_id=5000, now_ms=1200.0)  # would clear it

    (r,) = _both(engines, run)
    assert r["partial"] is True and "missing_partitions" not in r
    assert_same_set(np.asarray(r["skyline_points"]), skyline_np(_window_oracle(x, 500, 400, 200)))
    off = _pair(400, 200, dims=3)[1]
    off.process_trigger("late,5000")
    assert off.check_timeouts(now_ms=1e15) == 0  # 0 = wait forever


class _Telemetry:
    """Records what an engine asks of its telemetry hub, times aside."""

    def __init__(self):
        self.calls = []
        self.spans = self
        self._ids = 0

    def mint_trace_id(self):
        self._ids += 1
        self.calls.append(("mint", self._ids))
        return f"trace-{self._ids}"

    def histogram(self, name):
        calls = self.calls

        class _H:
            def observe(self, value):
                calls.append(("observe", name, isinstance(value, (int, float))))

        return _H()

    def record(self, name, t0, t1, trace_id=None, tid=None, args=None):
        assert t1 >= t0
        self.calls.append(("span", name, trace_id, tid, args))


class _Snapshots:
    def __init__(self):
        self.calls = []

    def note_ingest(self, max_id):
        self.calls.append(("note_ingest", max_id))

    def publish(self, points, **meta):
        self.calls.append(("publish", np.asarray(points, np.float32).tobytes(), meta))


class _Tracer:
    def __init__(self):
        self.calls = []

    @contextmanager
    def phase(self, name):
        self.calls.append(name)
        yield


def test_hooks_call_what_the_reference_calls(rng):
    """One recording fake each for ``tracer``, ``telemetry`` and the
    snapshot store: both engines make the same calls, in the same order,
    with the same arguments."""
    x = rng.uniform(0, 1000, size=(1300, 3)).astype(np.float32)
    jcfg, tcfg = _cfgs(parallelism=2, algo="mr-angle", dims=3, query_timeout_ms=10.0)
    fakes = []
    for cls, cfg in ((JaxSliding, jcfg), (SlidingEngine, tcfg)):
        tel, snaps, tr = _Telemetry(), _Snapshots(), _Tracer()
        eng = cls(cfg, window_size=600, slide=200, emit_per_slide=True, tracer=tr, telemetry=tel)
        eng.attach_snapshots(snaps)
        _drive(eng, x[:450], chunk=150, now_ms=0.0)
        eng.process_trigger("a,0", now_ms=0.0)
        eng.process_trigger("b,10000", now_ms=0.0)  # deferred, then times out
        eng.check_timeouts(now_ms=100.0)
        _drive(eng, x[450:], chunk=150, start_id=450, now_ms=0.0)
        eng.process_trigger("c,0", now_ms=0.0)
        fakes.append((tel.calls, snaps.calls, tr.calls, eng.poll_results()))
    (jt, js, jr, jres), (tt, ts, tr_, tres) = fakes
    assert tt == jt
    assert ts == js
    assert tr_ == jr
    _assert_same(jres, tres)
    assert [r.get("trace_id") for r in tres] == [r.get("trace_id") for r in jres]
    assert {"route", "slide/step", "query/snapshot_transfer"} <= set(tr_)


def test_stats_match_jax(rng):
    x = rng.uniform(0, 1000, size=(900, 3)).astype(np.float32)
    engines = _pair(400, 200, parallelism=2, algo="mr-dim", dims=3)
    for eng in engines:
        _drive(eng, x)
        eng.process_trigger("q,5000")
    js, ts = (e.stats(include_skyline_counts=True) for e in engines)
    assert list(ts) == list(js)
    for key in js:
        if key not in ("processing_ms", "mask_kernel"):
            assert ts[key] == js[key], key
    assert (js["mask_kernel"], ts["mask_kernel"], ts["meshed"]) == ("scan", "scan", False)


# -- SkylineEngine.check_timeouts -----------------------------------------------------


def _engines(policy, ingest):
    jcfg, tcfg = _cfgs(parallelism=2, algo="mr-dim", dims=3, buffer_size=256,
                       flush_policy=policy, ingest=ingest, query_timeout_ms=100.0)
    return JaxEngine(jcfg), SkylineEngine(tcfg)


@pytest.mark.parametrize("policy,ingest", [("incremental", "host"), ("lazy", "host"),
                                           ("lazy", "device"), ("overlap", "host")])
def test_engine_timeout_with_partitions_missing_matches_jax(rng, policy, ingest):
    """Partition 0 alone reaches the barrier; the watchdog finalizes the
    query with ``"partial": true`` and the other partitions missing (the
    reported partition's points, sizes and optimality equal the JAX
    engine's), and later data does not answer it again."""
    x = rng.uniform(0, 1000, size=(1000, 3)).astype(np.float32)
    low = np.column_stack([rng.uniform(0, 200, 300), rng.uniform(0, 1000, (300, 2))])
    low = low.astype(np.float32)

    def run(eng):
        eng.process_records(np.arange(1000, dtype=np.int64), x, now_ms=0.0)
        eng.process_records(np.arange(1000, 1300, dtype=np.int64), low, now_ms=0.0)
        eng.process_trigger("late,1100", now_ms=1000.0)
        assert eng.check_timeouts(now_ms=1050.0) == 0
        assert eng.inflight_queries == 1
        assert eng.check_timeouts(now_ms=1101.0) == 1
        assert eng.inflight_queries == 0
        eng.process_records(np.arange(2000, 2300, dtype=np.int64), x[:300], now_ms=2000.0)
        eng.process_trigger("full,0", now_ms=3000.0)

    partial, full = _both(_engines(policy, ingest), run)
    assert (partial["query_id"], partial["partial"]) == ("late", True)
    assert partial["missing_partitions"] == [1, 2, 3] and partial["skyline_size"] > 0
    assert full["query_id"] == "full" and "partial" not in full


def test_engine_timeout_harvests_a_merge_in_flight(rng, monkeypatch):
    """Under the query overlap a trigger's merge is in flight; the
    watchdog lands it as a full answer instead of finalizing it twice."""
    monkeypatch.setenv("SKYLINE_QUERY_OVERLAP", "1")
    x = rng.uniform(0, 1000, size=(1200, 3)).astype(np.float32)
    engines = _engines("lazy", "host")

    def run(eng):
        eng.process_records(np.arange(1200, dtype=np.int64), x, now_ms=0.0)
        eng.process_trigger("q,0", now_ms=0.0)
        assert eng._inflight_merge is not None and eng.inflight_queries == 1
        assert eng.check_timeouts(now_ms=1e9) == 0
        assert eng._inflight_merge is None and eng.inflight_queries == 0

    (r,) = _both(engines, run)
    assert "partial" not in r and r["query_id"] == "q"


def test_engine_timeout_defaults_like_jax():
    assert EngineConfig(device="cpu").query_timeout_ms == JaxConfig().query_timeout_ms == 0.0
    eng = SkylineEngine(EngineConfig(device="cpu", dims=3))
    eng.process_records(np.arange(10, dtype=np.int64), np.ones((10, 3), np.float32))
    eng.process_trigger("q,100")
    assert eng.inflight_queries == 1
    assert eng.check_timeouts(now_ms=1e15) == 0  # 0 = wait forever


# -- the import boundary and the card -----------------------------------------------


@pytest.mark.parametrize("module", ["skyline_tpu_torch.stream.sliding_engine",
                                    "skyline_tpu_torch.stream.sliding",
                                    "skyline_tpu_torch.metrics.tracing"])
def test_module_imports_no_jax(module):
    code = (
        f"import sys; import {module}; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'skyline_tpu' or m.startswith('skyline_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.cuda
def test_engine_on_card_takes_k3_and_matches_cpu(cuda_card):
    """On a card a flat window of 8,192 rows or more runs the K3 branch:
    two launches a slide (bucket and window passes), answers equal to the
    CPU's scan."""
    rng = np.random.default_rng(8)
    x = generate("anti_correlated", rng, 12288, 8, 0, 1000)
    out = []
    for dev in ("cuda", "cpu"):
        cfg = EngineConfig(parallelism=1, algo="mr-angle", dims=8, domain_max=1000.0,
                           emit_skyline_points=True, device=dev)
        eng = SlidingEngine(cfg, window_size=8192, slide=2048)
        before = dk.LAUNCHES["skyline_mask_kernel"]
        for i in range(0, 12288, 2048):
            eng.process_records(np.arange(i, i + 2048, dtype=np.int64), x[i : i + 2048])
            eng.process_trigger(f"{i},0")
        launched = dk.LAUNCHES["skyline_mask_kernel"] - before
        out.append(eng.poll_results())
        if dev == "cuda":
            assert eng.stats()["mask_kernel"] == "k3" and launched == 2 * 6
    _assert_same(*out)

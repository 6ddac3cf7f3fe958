"""The dispatch tuner against the JAX package's, on the CPU: both
``DispatchTuner``s, each over its package's cascade table, are handed the
same evidence — profiler EMAs (injected through ``restore_state``), workload
regimes, flight-ring dirty fractions and SLO verdicts — and a fixed clock;
every scenario's decisions (wall stamps aside), pins, overrides,
``state_doc``, ``doc``, ``explain_block``, counters and ``dispatch_doc``
must be equal. Then both engines with a hub on one stream, the tuner's
cadence at 0 s: the same cutoff moves, state and plans' tuner blocks.
Exact comparisons."""

import json

import numpy as np
import pytest
import torch

from skyline_tpu.ops import cascade as jax_cascade
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu.telemetry import Telemetry as JaxTelemetry
from skyline_tpu.telemetry import profiler as jax_profiler
from skyline_tpu.telemetry import tuner as jax_tuner
from skyline_tpu_torch.ops import cascade
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.telemetry import Telemetry
from skyline_tpu_torch.telemetry import profiler, tuner

from test_torch_observability import process_state, rounds_only, untimed  # noqa: F401

torch.set_num_threads(1)

SIDES = (
    ("port", cascade, profiler, tuner),
    ("jax", jax_cascade, jax_profiler, jax_tuner),
)


class _Slo:
    def __init__(self):
        self.ok = True

    def evaluate(self):
        return {"ok": self.ok}


class _Hub:
    """The hub surface the tuner reads: counters, the flight ring, the SLO
    verdict."""

    def __init__(self, prof_mod):
        self.counters = {}
        self.flight = prof_mod.FlightRecorder(128)
        self.slo = _Slo()
        self.tuner = None

    def inc(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n


class _Workload:
    def __init__(self, kind="uniform", epoch=1):
        self.kind, self.epoch = kind, epoch

    def regime(self):
        return {"kind": self.kind, "epoch": self.epoch}


def _prof(prof_mod, emas):
    p = prof_mod.KernelProfiler(backend="cpu")
    p.restore_state({"version": 1, "entries": [
        {"variant": v, "d": d, "n_bucket": nb, "backend": "cpu", "mp": False, "calls": 3,
         "wall_ms": e * 3, "ema_ms": e, "first_call_ms": e, "last_ms": e}
        for (v, d, nb), e in emas.items()
    ]})
    return p


MASK_EMAS = {("mask_scan", 4, 512): 1.0, ("sorted_sfs_mask", 4, 512): 5.0}
TWO_SIGS = {**MASK_EMAS, ("mask_scan", 8, 1024): 1.0, ("sorted_sfs_mask", 8, 1024): 5.0}
FLUSH_EMAS = {("flush_sfs_vmapped", 4, 2048): 3.0, ("flush_sorted_sfs", 4, 2048): 2.0,
              ("flush_sfs_sequential", 8, 4096): 9.0, ("flush_device_cascade", 8, 4096): 4.0}


def _snapshot(cas, t, hub):
    """Everything a scenario leaves behind, wall stamps aside."""
    return untimed({
        "doc": t.doc(), "state": t.state_doc(), "explain": t.explain_block(),
        "pins": cas.pins_doc(), "overrides": cas.overrides_doc(),
        "cutoff": cas.delta_cutoff(), "counters": hub.counters,
        "flight": hub.flight.snapshot(),
        "stats": (t.epochs, t.moves, t.reverts, t.switches),
    })


def _scenario_pins(cas, t, hub, wl, prof, clock):
    t.maybe_tune(now=10.0)
    t.maybe_tune(now=11.0)  # inside the cadence: no epoch
    t.maybe_tune(now=20.0)  # a stable winner: no second move


def _scenario_passive(cas, t, hub, wl, prof, clock):
    wl.epoch = 0
    t.maybe_tune(now=100.0)


def _scenario_cutoff(cas, t, hub, wl, prof, clock):
    for f in (0.4, 0.4, 0.3, 0.5, 0.4, 0.2, 0.4, 0.45, 0.0, 1.0):
        hub.flight.note("merge.launch", path="flat", dirty_fraction=f)
    t.maybe_tune(now=10.0)
    t.maybe_tune(now=20.0)
    t.maybe_tune(now=30.0)


def _scenario_hysteresis(cas, t, hub, wl, prof, clock):
    t.maybe_tune(now=10.0)
    wl.kind = "anti_correlated"
    t.maybe_tune(now=20.0)
    t.maybe_tune(now=30.0)
    wl.kind = "uniform"
    t.maybe_tune(now=40.0)
    t.maybe_tune(now=50.0)


def _scenario_revert(cas, t, hub, wl, prof, clock):
    for _ in range(10):
        hub.flight.note("merge.launch", path="flat", dirty_fraction=0.4)
    t.maybe_tune(now=10.0)
    hub.slo.ok = False
    t.maybe_tune(now=20.0)
    t.maybe_tune(now=30.0)


def _scenario_round_trip(cas, t, hub, wl, prof, clock):
    for _ in range(10):
        hub.flight.note("merge.launch", path="flat", dirty_fraction=0.4)
    t.maybe_tune(now=10.0)
    doc = json.loads(json.dumps(t.state_doc()))
    cas.clear_pins()
    cas.clear_override("SKYLINE_DELTA_CUTOFF")
    assert t.restore(doc) == len(doc["pins"])
    assert t.restore({"version": 99}) == 0 and t.restore("nonsense") == 0


SCENARIOS = {
    "pins": (_scenario_pins, MASK_EMAS, {}),
    "bounded": (_scenario_pins, TWO_SIGS, {"SKYLINE_TUNER_MAX_MOVES": "1"}),
    "single_candidate": (_scenario_pins, {("mask_scan", 4, 512): 1.0}, {}),
    "passive": (_scenario_passive, MASK_EMAS, {}),
    "cutoff": (_scenario_cutoff, {}, {}),
    "cutoff_env_pinned": (_scenario_cutoff, {}, {"SKYLINE_DELTA_CUTOFF": "0.9"}),
    "hysteresis": (_scenario_hysteresis, TWO_SIGS, {"SKYLINE_TUNER_HYSTERESIS": "2"}),
    "switch_explores": (_scenario_hysteresis, MASK_EMAS, {"SKYLINE_TUNER_HYSTERESIS": "1"}),
    "no_drift_explore": (_scenario_hysteresis, MASK_EMAS,
                         {"SKYLINE_TUNER_HYSTERESIS": "1",
                          "SKYLINE_TUNER_EXPLORE_ON_DRIFT": "0"}),
    "slo_revert": (_scenario_revert, MASK_EMAS, {}),
    "round_trip": (_scenario_round_trip, MASK_EMAS, {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("with_flush", [False, True])
def test_tuner_decisions_match_reference(name, with_flush, monkeypatch):
    run, emas, env = SCENARIOS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = {}
    for side, cas, prof_mod, tun_mod in SIDES:
        hub, wl = _Hub(prof_mod), _Workload()
        prof = _prof(prof_mod, emas)
        flush = _prof(prof_mod, FLUSH_EMAS) if with_flush else None
        clock = [0.0]
        t = tun_mod.DispatchTuner(telemetry=hub, workload=wl, profiler=prof,
                                  flush_profiler=(lambda f=flush: f), clock=lambda: clock[0])
        hub.tuner = t
        run(cas, t, hub, wl, prof, clock)
        snap = _snapshot(cas, t, hub)
        snap["emas"] = sorted((r["variant"], r["d"], r["n_bucket"], r["ema_ms"])
                              for p in (prof, flush) if p is not None
                              for r in p.doc()["kernels"])
        snap["dispatch"] = untimed(tun_mod.dispatch_doc(hub))["tuner"]
        out[side] = snap
        cas.clear_pins()
        for o in list(cas.overrides_doc()):
            cas.clear_override(o)
    assert out["port"] == out["jax"]
    # the flush profiler's signatures give every active scenario a pin
    idle = ("passive",) if with_flush else ("passive", "single_candidate", "cutoff_env_pinned")
    assert (out["port"]["stats"][1] > 0) == (name not in idle)


def test_dispatch_doc_matches_reference():
    """The table half of ``GET /dispatch`` is the cascade table's own
    document (held against the reference's by ``test_torch_cascade_table``);
    without a tuner both report it off."""
    assert tuner.dispatch_doc(None)["tuner"] == jax_tuner.dispatch_doc(None)["tuner"] == {
        "enabled": False}
    assert tuner.dispatch_doc(None)["table"] == cascade.table_doc()
    assert tuner.STAGE_VARIANTS == jax_tuner.STAGE_VARIANTS


def test_engine_tuner_matches_reference(monkeypatch, rounds_only):
    """Both engines with a hub, the cadence at 0 s and 256-row workload
    epochs: triggers after chunks routed to one partition (mr-dim) give
    dirty fractions of 1/8, the tuner steps the delta cutoff toward them
    and the plans carry its block — the same in both packages."""
    monkeypatch.setenv("SKYLINE_TUNER_EPOCH_S", "0")
    monkeypatch.setenv("SKYLINE_WORKLOAD_EPOCH_ROWS", "256")
    kw = dict(parallelism=4, dims=4, domain_max=1000.0, algo="mr-dim", flush_policy="lazy",
              ingest="host")
    tels = Telemetry(), JaxTelemetry()
    engines = (SkylineEngine(EngineConfig(**kw, device="cpu"), telemetry=tels[0]),
               JaxEngine(JaxConfig(**kw), telemetry=tels[1]))
    rng = np.random.default_rng(2)
    x = rng.uniform(1, 999, size=(2000, 4)).astype(np.float32)
    base = 0
    for q in range(14):
        rows = x if q == 0 else rng.uniform(1, 999, size=(96, 4)).astype(np.float32)
        if q:
            rows[:, 0] = rng.uniform(1, 90, size=96)
        ids = np.arange(base, base + rows.shape[0])
        base += rows.shape[0]
        results = []
        for e in engines:
            e.process_records(ids, rows)
            e.process_trigger(f"q{q},0")
            results.append(e.poll_results())
        assert untimed(results[0]) == untimed(results[1])
    got, want = (untimed(e.tuner.state_doc()) for e in engines)
    assert got == want
    assert got["stats"]["moves"] >= 1 and got["overrides"]
    assert untimed(engines[0].tuner.doc()) == untimed(engines[1].tuner.doc())
    assert untimed(tels[0].explain.snapshot()) == untimed(tels[1].explain.snapshot())
    assert tels[0].explain.latest()["tuner"]["moves"] == got["stats"]["moves"]
    assert tels[0].counters.snapshot() == tels[1].counters.snapshot()

"""The sharded engine's fleet plane and chip knobs on the CPU against the JAX
package's, and the kernels' one-device check.

- ``FleetStats``: the same ``doc()``, labeled series and Prometheus
  ``skyline_chip_*{chip=...}`` / ``skyline_fleet_*`` lines as the JAX
  class on the same call sequences; the imbalance flight entry fires once
  per excursion.
- A sharded engine with a hub: the hub's ``fleet`` and ``health`` slots
  and ``fleet_doc`` equal the JAX engine's (timings aside);
  ``SKYLINE_FLEET=0`` leaves the slot empty.
- The chip-plane knob readers (``chip_barrier_policy``,
  ``chip_merge_deadline_ms``, ``failover_lock_ms``,
  ``chip_failover_enabled``, ``fleet_enabled``) read every value as the
  reference's do.
- ``ops/dominance_kernels.py``: ``_launch`` and ``_predrop_call`` raise
  ``ValueError`` naming the entry point when operands lie on different
  devices (meta tensors stand in for a second card here).

Tolerance: exact; wall-clock fields excluded.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from skyline_tpu.distributed import ShardedEngine as JaxShardedEngine
from skyline_tpu.ops import dispatch as jdispatch
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.telemetry import Telemetry as JaxTelemetry
from skyline_tpu.telemetry import fleet_doc as jax_fleet_doc
from skyline_tpu.telemetry.fleet import FleetStats as JaxFleetStats
from skyline_tpu.telemetry.profiler import FlightRecorder as JaxFlight
from skyline_tpu_torch.distributed import ShardedEngine
from skyline_tpu_torch.ops import dominance_kernels as dk
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.telemetry import FleetStats, Telemetry, fleet_doc
from skyline_tpu_torch.telemetry.profiler import FlightRecorder
from skyline_tpu_torch.utils import knobs

from conftest import gen_points
from test_torch_observability import process_state, untimed  # noqa: F401


def _calls(f) -> list:
    """One call sequence: skewed ingest, flushes, two merges with pruned
    and surviving chips, then a rebalance below the threshold and a new
    excursion."""
    f.note_ingest(0, 900)
    f.note_ingest(1, 50)
    f.note_ingest(2, 30)
    f.note_flush(0, 900, 3.5)
    f.note_flush(2, 30, 0.25)
    f.note_level1(0, 40, 1.5)
    f.note_level1(2, 7, 0.5)
    f.note_level2(0, False, 0)
    f.note_level2(1, True, 0)
    f.note_level2(2, False, 64)
    docs = [f.note_merge_done()]
    f.note_ingest(1, 850)
    f.note_ingest(2, 880)
    docs.append(f.note_merge_done())
    f.note_ingest(3, 9000)
    docs.append(f.note_merge_done())
    docs.append(f.note_merge_done())
    return docs


@pytest.mark.parametrize("ring,threshold", [(None, None), (2, 1.5)])
def test_fleet_stats_match_jax(ring, threshold):
    fl, jfl = FlightRecorder(64), JaxFlight(64)
    f = FleetStats(4, flight=fl, imbalance_threshold=threshold, ring=ring)
    jf = JaxFleetStats(4, flight=jfl, imbalance_threshold=threshold, ring=ring)
    assert _calls(f) == _calls(jf)
    assert f.doc() == jf.doc()
    assert f.labeled_series() == jf.labeled_series()
    assert untimed(fl.snapshot()) == untimed(jfl.snapshot())
    fired = [e for e in fl.snapshot() if e["kind"] == "fleet.imbalance"]
    assert len(fired) == f.imbalance_events == 2  # one per excursion
    tel, jtel = Telemetry(), JaxTelemetry()
    tel.fleet, jtel.fleet = f, jf

    def chip_lines(text):
        return [ln for ln in text.splitlines() if "_chip_" in ln or "_fleet_" in ln]

    lines = chip_lines(tel.render_prometheus())
    assert lines and lines == chip_lines(jtel.render_prometheus())
    assert 'skyline_chip_interconnect_rows_total{chip="2"} 64' in lines


def test_fleet_knobs_set_the_plane(monkeypatch):
    monkeypatch.setenv("SKYLINE_FLEET_RING", "1")
    monkeypatch.setenv("SKYLINE_FLEET_IMBALANCE_THRESHOLD", "1.25")
    f, jf = FleetStats(2), JaxFleetStats(2)
    assert f.imbalance_threshold == jf.imbalance_threshold == 1.25
    assert f._skew_ring.maxlen == jf._skew_ring.maxlen == 2


def _run(engine, x):
    ids = np.arange(x.shape[0], dtype=np.int64)
    for lo in range(0, x.shape[0], 128):
        engine.process_records(ids[lo : lo + 128], x[lo : lo + 128])
    engine.process_trigger("0,0")
    return engine.poll_results()


def test_fleet_doc_matches_jax():
    """The hub's slots and the ``/fleet`` join of a sharded engine (the
    HTTP replies are held in ``tests/test_torch_serve.py``)."""
    kw = dict(parallelism=2, dims=3, buffer_size=64, domain_max=1.0, emit_skyline_points=True)
    x = gen_points(np.random.default_rng(0), 500, 3, "anti")
    eng = ShardedEngine(EngineConfig(**kw, device="cpu"), chips=4, telemetry=Telemetry())
    jeng = JaxShardedEngine(JaxConfig(**kw), chips=4, telemetry=JaxTelemetry())
    assert untimed(_run(eng, x)) == untimed(_run(jeng, x))
    tel, jtel = eng.telemetry, jeng.telemetry
    assert isinstance(tel.fleet, FleetStats) and tel.health is eng.health
    doc = untimed(fleet_doc(tel, eng.stats()))
    assert doc["enabled"] is True and doc["chips"] == 4 and doc["last_query"]["chips"]
    assert doc["per_chip"][0]["ingest_rows"] > 0
    assert doc == untimed(jax_fleet_doc(jtel, jeng.stats()))


def test_fleet_off_and_flat_engine(monkeypatch):
    monkeypatch.setenv("SKYLINE_FLEET", "0")
    eng = ShardedEngine(EngineConfig(parallelism=2, dims=2, device="cpu"), chips=2,
                        telemetry=Telemetry())
    assert eng.telemetry.fleet is None and eng.telemetry.health is eng.health
    assert "fleet" not in eng.stats()["sharded"]
    flat = SkylineEngine(EngineConfig(parallelism=2, dims=2, device="cpu"), telemetry=Telemetry())
    doc = fleet_doc(flat.telemetry, flat.stats())
    assert doc["enabled"] is False and doc["health"] is None


# -- the chip-plane knob readers ---------------------------------------------------------------


READERS = {
    "SKYLINE_CHIP_BARRIER": ("chip_barrier_policy", ["merge", "checkpoint", "off", "MERGE"]),
    "SKYLINE_CHIP_MERGE_DEADLINE_MS": ("chip_merge_deadline_ms", ["0", "250", "-5", "1.5"]),
    "SKYLINE_CHIP_FAILOVER_LOCK_MS": ("failover_lock_ms", ["100", "-1", "0"]),
    "SKYLINE_CHIP_FAILOVER": ("chip_failover_enabled", ["0", "1", "off"]),
    "SKYLINE_FLEET": ("fleet_enabled", ["0", "yes"]),
}


@pytest.mark.parametrize("raw_kind", ["unset", "blank", "values", "junk"])
@pytest.mark.parametrize("env", list(READERS))
def test_chip_knob_readers_match_jax(monkeypatch, env, raw_kind):
    name, values = READERS[env]
    raws = {"unset": [None], "blank": [""], "values": values, "junk": ["x"]}[raw_kind]
    for raw in raws:
        if raw is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, raw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert getattr(knobs, name)() == getattr(jdispatch, name)(), (env, raw)


# -- every kernel launch on one device ---------------------------------------------------------


def test_launch_entries_check_one_device():
    """The compare and pre-drop entries take raw pointers, so an operand
    on another device must raise before any launch, naming the entry."""
    cpu = torch.zeros((1, 3, 8))
    meta = torch.zeros((1, 3, 8), device="meta")
    ok = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match=r"dominated_by_rect: operands on different devices"):
        dk._launch("dominated_by_rect", cpu, ok, meta)
    with pytest.raises(ValueError, match=r"dominated_by_any.*victims on meta"):
        dk._launch("dominated_by_any", cpu, ok, meta)
    y3 = torch.zeros((1, 8, 3))
    with pytest.raises(ValueError, match=r"strictly_dominated_bf16_kernel: operands"):
        dk._predrop_call(y3, None, y3.to("meta"), ok, fused=False)
    with pytest.raises(ValueError, match=r"mp_predrop_kernel: operands.*scratch0 on meta"):
        dk._predrop_call(y3, ok, y3, ok, fused=True,
                         scratch=[torch.zeros(1, device="meta"), torch.zeros(1), torch.zeros(1)])

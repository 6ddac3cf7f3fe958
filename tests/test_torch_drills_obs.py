"""The observability drill (``skyline_tpu_torch/deploy/drills/obs.py``) on
the CPU, held against the JAX package, and the SSE catch-up twin.

``python -m skyline_tpu_torch.deploy.drills obs --device cpu
--outcomes-only`` must exit 0 with every leg. The legs that publish or count
then run in process through the JAX package's objects on the same streams
and knob settings, and the port's evidence must equal the JAX drill's: the
worker leg's answer, merge-cache and audit counts; the prune, flush-cascade,
sorted-SFS and device-cascade digests and counters (the JAX witness is the
reference's trace count under ``jax.jit``; the port's, the same mask as the
quadratic referee); the tuner's counts and per-trigger digests; the
replica's CSV bytes, SSE event and tenant sheds; the body store's CSV bytes.

``test_sse_since_catchup_and_overflow_resync_match_jax`` is the twin of the
reference's ``tests/test_replica.py`` SSE test, held against the JAX
server: ``/subscribe?since=V`` inside the ring replays the net catch-up (the
same bytes), a ``since`` behind the ring opens with a resync, and a 1-deep
queue whose consumer cannot keep up gets a resync instead of losing
deltas. The event loop is held by an event, not a sleep, while the
publishes land.

Tolerance: exact (digests of bytes, event payload bytes, counters).
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from skyline_tpu_torch.deploy.drills import obs

REPO = Path(__file__).resolve().parents[1]


def jax_cascade_witness() -> dict:
    import jax
    import jax.numpy as jnp

    from skyline_tpu.ops.device_cascade import cascade_trace_count, device_cascade_mask
    from skyline_tpu.ops.dominance import skyline_mask
    from skyline_tpu.workload.generators import anti_correlated

    x = jnp.asarray(anti_correlated(np.random.default_rng(29), 1117, 5, 0, 10000))
    before = cascade_trace_count()
    got = np.asarray(jax.jit(device_cascade_mask)(x))
    assert cascade_trace_count() > before
    assert np.array_equal(got, np.asarray(skyline_mask(x)))
    return {"survivors": int(got.sum()), "launches": {}}


def jax_ns() -> SimpleNamespace:
    from skyline_tpu.bridge import MemoryBus, SkylineWorker
    from skyline_tpu.bridge.wire import format_trigger, format_tuple_line
    from skyline_tpu.ops import cascade
    from skyline_tpu.resilience.wal import WalWriter
    from skyline_tpu.serve import ServeConfig, SkylineServer, SnapshotStore, delta_wal_record
    from skyline_tpu.serve.bodystore import BodyStore
    from skyline_tpu.serve.replica import SkylineReplica
    from skyline_tpu.stream import EngineConfig, SkylineEngine
    from skyline_tpu.stream.batched import PartitionSet
    from skyline_tpu.telemetry import Telemetry
    from skyline_tpu.telemetry.clusterview import ClusterView
    from skyline_tpu.telemetry.opslog import OpsLog
    from skyline_tpu.telemetry.sentinel import DEFAULT_RULES
    from skyline_tpu.utils.config import parse_job_args
    from skyline_tpu.workload.generators import anti_correlated, uniform

    return SimpleNamespace(
        device="cpu", parse_job_args=parse_job_args, MemoryBus=MemoryBus,
        SkylineWorker=SkylineWorker, format_trigger=format_trigger,
        format_tuple_line=format_tuple_line, anti_correlated=anti_correlated, uniform=uniform,
        PartitionSet=PartitionSet, Telemetry=Telemetry, EngineConfig=EngineConfig,
        SkylineEngine=SkylineEngine, cascade=cascade, WalWriter=WalWriter,
        SkylineServer=SkylineServer, SnapshotStore=SnapshotStore, ServeConfig=ServeConfig,
        delta_wal_record=delta_wal_record, SkylineReplica=SkylineReplica, BodyStore=BodyStore,
        ClusterView=ClusterView, OpsLog=OpsLog, DEFAULT_RULES=DEFAULT_RULES,
        cascade_witness=jax_cascade_witness, launches=dict)


@pytest.fixture(scope="module")
def port_evidence():
    r = subprocess.run([sys.executable, "-m", "skyline_tpu_torch.deploy.drills", "obs",
                        "--device", "cpu", "--outcomes-only"], cwd=REPO, env=dict(os.environ),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    for line in ("[obs-smoke] PASS", "prune digest ok", "flush cascade digest ok",
                 "sorted-SFS digest ok", "device cascade ok", "tuner digest ok",
                 "replica surface ok", "ops plane ok", "bodystore ok", "sentinel ok",
                 "static-analysis gate ok", "[obs-smoke] ALL PASS"):
        assert line in r.stdout, line
    ev = json.loads(r.stdout.strip().splitlines()[-1])
    assert ev["ok"] is True and ev["launches"] == {}
    return ev["drills"]["obs"]


@pytest.fixture
def jax_state():
    from skyline_tpu.ops import cascade, dispatch

    cascade.clear_pins()
    for k in list(cascade.overrides_doc()):
        cascade.clear_override(k)
    dispatch._MASK_PROFILER = None
    yield
    cascade.clear_pins()
    for k in list(cascade.overrides_doc()):
        cascade.clear_override(k)


# the keys not compared: the latency SLOs' breaches (wall-clock readings;
# the JAX worker's first queries compile), the port's flush-path
# counts and the port's kernel launches (none on the CPU), the JSON wire
# shapes (a per-publish stamp precedes their volatile tail) and the trace
# file's span count
PORT_ONLY = {"slo_breaches", "flush_paths", "launches", "/skyline", "/skyline?points=0",
             "/skyline?explain=1", "trace_out_events", "replica_hits"}


def shared(doc):
    if isinstance(doc, dict):
        return {k: shared(v) for k, v in doc.items() if k not in PORT_ONLY}
    return doc


@pytest.mark.parametrize("leg", ["worker", "prune", "flush_cascade", "sorted_sfs",
                                 "device_cascade", "tuner", "replica", "bodystore"])
def test_obs_leg_matches_jax(port_evidence, jax_state, leg):
    ref = dict(obs.LEGS)[leg](jax_ns(), bounds=False)
    assert shared(port_evidence[leg]) == shared(ref)


def test_obs_drill_outcomes(port_evidence):
    ev = port_evidence
    assert ev["flush_cascade"]["prefilter_dropped"] > 0
    assert ev["sorted_sfs"]["sorted_flushes"] >= 1
    assert ev["device_cascade"]["cascade_flushes"] >= 1
    assert ev["device_cascade"]["flush_paths"] == {"device_cascade": 1}
    assert ev["sentinel"] == {"steady": 0, "drifted": 1}
    assert ev["lint"]["analysis"]["exit"] == 0 and ev["lint"]["check_doc"]["exit"] == 0
    assert ev["worker"]["profile"]["backends"] == ["cpu"]
    assert ev["replica"]["sse_event"] == "delta" and ev["replica"]["tenant_shed"] >= 1


# -- the SSE catch-up and resync twin ------------------------------------------


def _sse_connect(port, query=""):
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall(f"GET /subscribe{query} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    f = s.makefile("rb")
    assert b"200" in f.readline()
    while f.readline() not in (b"\r\n", b"\n", b""):
        pass
    return s, f


def _sse_read_event(f):
    """The next (event, raw data bytes), keepalives skipped."""
    kind = data = None
    while True:
        line = f.readline()
        assert line, "the stream closed"
        line = line.strip()
        if line.startswith(b":"):
            continue
        if line.startswith(b"event:"):
            kind = line.split(b":", 1)[1].strip().decode()
        elif line.startswith(b"data:"):
            data = line.split(b":", 1)[1].strip()
        elif not line and kind is not None:
            return kind, data


def _wait_for_subscribers(srv, n=1):
    deadline = time.monotonic() + 10
    while len(srv._sse_queues) < n:
        assert time.monotonic() < deadline, "the SSE subscriber never registered"
        time.sleep(0.005)


def _sse_scenario(SnapshotStore, DeltaRing, SkylineServer) -> dict:
    rng = np.random.default_rng(41)
    out = {}
    # catch-up inside the ring: one net delta from V to the head
    store = SnapshotStore()
    ring = DeltaRing(store, capacity=16)
    srv = SkylineServer(store, deltas=ring, port=0)
    try:
        for v in range(5):
            store.publish(rng.random((8, 3)).astype(np.float32), now_ms=1000.0 + v)
        s, f = _sse_connect(srv.port, "?since=2")
        out["catchup"] = _sse_read_event(f)
        _wait_for_subscribers(srv)
        store.publish(rng.random((8, 3)).astype(np.float32), now_ms=2000.0)
        out["pushed"] = _sse_read_event(f)
        s.close()
    finally:
        srv.close()
    # behind the ring, then a consumer that cannot keep up
    store = SnapshotStore()
    ring = DeltaRing(store, capacity=2)
    srv = SkylineServer(store, deltas=ring, port=0)
    try:
        for v in range(5):
            store.publish(rng.random((8, 3)).astype(np.float32), now_ms=3000.0 + v)
        s, f = _sse_connect(srv.port, "?since=1")
        out["behind"] = _sse_read_event(f)
        _wait_for_subscribers(srv)
        # hold the event loop until all six publishes have handed it their
        # fanout: the 1-deep queue overflows before the consumer can drain
        gate = threading.Event()
        srv._loop.call_soon_threadsafe(gate.wait, 30.0)
        for v in range(6):
            store.publish(rng.random((8, 3)).astype(np.float32), now_ms=4000.0 + v)
        gate.set()
        out["overflow"] = _sse_read_event(f)
        s.close()
    finally:
        srv.close()
    return out


def test_sse_since_catchup_and_overflow_resync_match_jax(monkeypatch):
    from skyline_tpu.serve import DeltaRing as JRing
    from skyline_tpu.serve import SkylineServer as JServer
    from skyline_tpu.serve import SnapshotStore as JStore
    from skyline_tpu_torch.serve import DeltaRing, SkylineServer, SnapshotStore

    monkeypatch.setenv("SKYLINE_SERVE_SSE_QUEUE", "1")
    got = _sse_scenario(SnapshotStore, DeltaRing, SkylineServer)
    ref = _sse_scenario(JStore, JRing, JServer)
    assert got == ref
    kind, data = got["catchup"]
    doc = json.loads(data)
    assert kind == "delta" and doc["from_version"] == 2 and doc["to_version"] == 5
    assert doc["entered"]
    kind, data = got["pushed"]
    assert kind == "delta" and json.loads(data)["to_version"] == 6
    kind, data = got["behind"]
    assert kind == "resync" and json.loads(data)["head_version"] == 5
    kind, data = got["overflow"]
    assert kind == "resync" and json.loads(data)["head_version"] == 11

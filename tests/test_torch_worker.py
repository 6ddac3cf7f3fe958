"""The port's worker (``skyline_tpu_torch/bridge/worker.py``) and job
config (``utils/config.py``) on the CPU against the JAX package's.

- ``parse_job_args`` over every shared flag, every environment default and
  the validation errors; ``JobConfig``'s defaults against the knob
  registry; the port's own ``--device`` and the placements that raise.
- ``SkylineWorker(device="cpu")`` against the JAX worker over
  ``MemoryBus``es fed the same lines, the event clock pinned in both
  (the worker stamps each batch with ``time.time()``): the output-topic
  lines with the timing fields (``*_ms``, ``trace_id``) aside and the WAL
  records and segment bytes, for the lazy, overlap and incremental
  policies at d in {2, 3, 8}; the drain bound, malformed drops, a trigger
  before its data, an oversized arrays batch, ``--serve`` with ``/stats``
  answering, and the sliding branch.
- The CLIs: each entry point exists, ``--device cuda`` without a card
  raises, and no new module imports ``jax`` or ``skyline_tpu`` (a fresh
  interpreter).

Tolerance: exact lines, records and bytes.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time as _time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import skyline_tpu.bridge.worker as jworker
import skyline_tpu_torch.bridge.worker as tworker
from skyline_tpu.bridge import MemoryBus as JBus
from skyline_tpu.resilience import ResilienceConfig as JRes
from skyline_tpu.stream.engine import EngineConfig as JConfig
from skyline_tpu.utils import config as jconfig
from skyline_tpu_torch.bridge import MemoryBus
from skyline_tpu_torch.resilience import ResilienceConfig
from skyline_tpu_torch.stream.engine import EngineConfig
from skyline_tpu_torch.utils import config as tconfig
from skyline_tpu_torch.utils.knobs import KNOBS
from skyline_tpu_torch.workload.generators import anti_correlated, uniform

REPO = Path(__file__).resolve().parents[1]


class PinnedClock:
    """The ``time`` module a worker module sees, with ``time()`` a fixed
    sequence (the batches' event stamps) and every other clock real."""

    def __init__(self, start=1.7e9, step=0.001):
        self.t, self.step = start, step

    def time(self):
        self.t += self.step
        return self.t

    def __getattr__(self, name):
        return getattr(_time, name)


@pytest.fixture
def pinned(monkeypatch):
    """Pin both worker modules' event clocks."""
    monkeypatch.setattr(jworker, "time", PinnedClock())
    monkeypatch.setattr(tworker, "time", PinnedClock())


def lines_of(rows, start=0):
    return [f"{start + i}," + ",".join(str(int(v)) for v in r) for i, r in enumerate(rows)]


def untimed(line: str) -> dict:
    return {k: v for k, v in json.loads(line).items()
            if not k.endswith("_ms") and k != "trace_id"}


def make(kind, bus, cfg_kw, **kw):
    """A worker of package ``kind`` ("jax" or "port") over ``bus``."""
    if kind == "jax":
        return jworker.SkylineWorker(bus, JConfig(**cfg_kw), **kw)
    return tworker.SkylineWorker(bus, EngineConfig(**cfg_kw, device="cpu"), **kw)


def drive(kind, lines, cfg_kw, chunk=500, trigger="q1,0", trigger_first=False,
          res_dir=None, **kw):
    """Feed ``lines`` over a fresh bus, one trigger, step to the answer.
    Returns (output lines, worker) — the worker closed."""
    bus = JBus() if kind == "jax" else MemoryBus()
    res = None
    if res_dir is not None:
        res = (JRes if kind == "jax" else ResilienceConfig)(
            checkpoint_dir=str(res_dir), checkpoint_interval_s=0.0)
    w = make(kind, bus, cfg_kw, resilience=res, **kw)
    out = bus.consumer("output-skyline")
    try:
        if trigger_first:
            bus.produce("queries", trigger)
            w.step(max_records=chunk)
            bus.produce_many("input-tuples", lines)
        else:
            bus.produce_many("input-tuples", lines)
            while w.step(max_records=chunk):
                pass
            bus.produce("queries", trigger)
        got = []
        for _ in range(20):
            w.step(max_records=chunk)
            got += out.poll()
            if got and not bus.size("input-tuples") > w._data_pos:
                break
        return got, w
    finally:
        w.close()


def both(lines, cfg_kw, tmp_path=None, **kw):
    a, wa = drive("port", lines, cfg_kw, res_dir=tmp_path and tmp_path / "port", **kw)
    b, wb = drive("jax", lines, cfg_kw, res_dir=tmp_path and tmp_path / "jax", **kw)
    return (a, wa), (b, wb)


# -- the job config ----------------------------------------------------------------


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out.pop("device", None)
    return out


ENV_VALUES = {
    "SKYLINE_PARALLELISM": "3", "SKYLINE_ALGO": "mr-grid", "SKYLINE_INPUT_TOPIC": "i2",
    "SKYLINE_QUERY_TOPIC": "q2", "SKYLINE_OUTPUT_TOPIC": "o2", "SKYLINE_DOMAIN": "55.5",
    "SKYLINE_DIMS": "5", "SKYLINE_BOOTSTRAP": "h:1", "SKYLINE_BUFFER_SIZE": "77",
    "SKYLINE_EMIT_SKYLINE_POINTS": "yes", "SKYLINE_QUERY_TIMEOUT_MS": "12.5",
    "SKYLINE_GRID_PREFILTER": "1", "SKYLINE_INITIAL_CAPACITY": "64",
    "SKYLINE_FLUSH_POLICY": "lazy", "SKYLINE_OVERLAP_ROWS": "99", "SKYLINE_INGEST": "host",
    "SKYLINE_STATS_PORT": "9", "SKYLINE_MAX_DRAIN_POLLS": "4", "SKYLINE_SERVE": "0",
    "SKYLINE_SERVE_READ_RATE": "2.5", "SKYLINE_SERVE_READ_BURST": "3",
    "SKYLINE_SERVE_MAX_QUERIES": "4", "SKYLINE_SERVE_QUERY_QUEUE": "5",
    "SKYLINE_SERVE_QUERY_DEADLINE_MS": "6.5", "SKYLINE_SERVE_DELTA_RING": "7",
    "SKYLINE_SERVE_HISTORY": "8", "SKYLINE_SERVE_READ_CACHE": "0",
    "SKYLINE_SERVE_TENANT_RATE": "1.5", "SKYLINE_SERVE_TENANT_BURST": "2",
    "SKYLINE_TRACE_OUT": "t.json", "SKYLINE_TRACE_RING": "10",
    "SKYLINE_JAX_PROFILE_DIR": "prof", "SKYLINE_CHECKPOINT_DIR": "ck",
    "SKYLINE_CHECKPOINT_INTERVAL_S": "2.5", "SKYLINE_CHECKPOINT_RETAIN": "2",
    "SKYLINE_WAL_FSYNC": "always", "SKYLINE_WAL_SEGMENT_BYTES": "8192",
}


def test_parse_job_args_defaults_match_jax_and_the_registry():
    port, ref = tconfig.parse_job_args([]), jconfig.parse_job_args([])
    assert _fields(port) == _fields(ref) == _fields(tconfig.JobConfig())
    assert port.device == "cuda"
    registry = {k.name: k.default for k in KNOBS}
    flags = {f.name for f in dataclasses.fields(tconfig.JobConfig)} - {"device"}
    env_of = {"window_size": "SKYLINE_WINDOW", "serve_port": "SKYLINE_SERVE"}
    for name in flags:
        knob = env_of.get(name, "SKYLINE_" + name.upper())
        assert registry[knob] == getattr(tconfig.JobConfig(), name), knob


@pytest.mark.parametrize("name", sorted(ENV_VALUES))
def test_parse_job_args_environment_defaults_match_jax(monkeypatch, name):
    monkeypatch.setenv(name, ENV_VALUES[name])
    port, ref = tconfig.parse_job_args([]), jconfig.parse_job_args([])
    assert _fields(port) == _fields(ref) != _fields(tconfig.JobConfig())


FLAG_SETS = [
    ["--parallelism", "2", "--algo", "mr-dim", "--dims", "8", "--domain", "10000",
     "--buffer-size", "8192", "--flush-policy", "lazy", "--emit-skyline-points"],
    ["--window", "1024", "--slide", "256", "--emit-per-slide", "--stats-port", "5"],
    ["--serve", "0", "--serve-read-rate", "3", "--serve-tenant-burst", "9",
     "--checkpoint-dir", "x", "--wal-fsync", "off", "--wal-segment-bytes", "5000",
     "--checkpoint-interval-s", "0", "--checkpoint-retain", "1", "--trace-out", "t",
     "--trace-ring", "7", "--jax-profile-dir", "p", "--max-drain-polls", "2"],
    ["--mesh-chips", "2", "--cluster-hosts", "2", "--replicas", "0", "--grid-prefilter",
     "--query-timeout-ms", "5", "--initial-capacity", "128", "--overlap-rows", "64",
     "--ingest", "device", "--bootstrap", "b:2", "--input-topic", "a", "--query-topic", "b",
     "--output-topic", "c"],
]


@pytest.mark.parametrize("argv", FLAG_SETS)
def test_parse_job_args_flags_match_jax(argv):
    port = tconfig.parse_job_args(argv + ["--device", "cpu"])
    assert _fields(port) == _fields(jconfig.parse_job_args(argv))
    assert port.device == "cpu"
    if port.checkpoint_dir:
        assert dataclasses.asdict(port.resilience_config()) == dataclasses.asdict(
            jconfig.parse_job_args(argv).resilience_config())
    if port.serve_port >= 0:
        assert vars(port.serve_config()) == vars(jconfig.parse_job_args(argv).serve_config())


BAD = [
    dict(parallelism=0), dict(algo="nope"), dict(dims=0), dict(domain=0.0),
    dict(buffer_size=0), dict(query_timeout_ms=-1.0), dict(initial_capacity=-1),
    dict(flush_policy="eager"), dict(overlap_rows=0), dict(ingest="gpu"), dict(mesh=-1),
    dict(mesh_chips=-1), dict(mesh=2, mesh_chips=2), dict(cluster_hosts=-1),
    dict(cluster_hosts=2, mesh=2), dict(max_drain_polls=0), dict(serve_port=-2),
    dict(serve_read_rate=-1.0), dict(serve_read_burst=0), dict(serve_max_queries=0),
    dict(serve_query_queue=-1), dict(serve_query_deadline_ms=0.0), dict(serve_delta_ring=0),
    dict(trace_ring=0), dict(serve_tenant_rate=-1.0), dict(serve_tenant_burst=0),
    dict(replicas=-1), dict(replicas=1), dict(replicas=1, checkpoint_dir="d"),
    dict(replica_of="w", replicas=1, checkpoint_dir="d", serve_port=0),
    dict(mesh=3), dict(mesh_chips=3), dict(cluster_hosts=3),
    dict(cluster_hosts=2, mesh_chips=3), dict(window_size=8), dict(window_size=10, slide=4),
    dict(window_size=8, slide=4, mesh_chips=2), dict(window_size=8, slide=4, cluster_hosts=2),
    dict(window_size=8, slide=4, flush_policy="lazy"), dict(checkpoint_interval_s=-1.0),
    dict(checkpoint_retain=0), dict(wal_fsync="sometimes"), dict(wal_segment_bytes=100),
    dict(window_size=8, slide=4, checkpoint_dir="d"),
]


@pytest.mark.parametrize("kw", BAD, ids=lambda kw: ",".join(kw))
def test_validation_errors_match_jax(kw):
    with pytest.raises(ValueError) as port:
        tconfig.JobConfig(**kw)
    with pytest.raises(ValueError) as ref:
        jconfig.JobConfig(**kw)
    assert str(port.value) == str(ref.value)


def test_port_config_device_and_unported_placements():
    with pytest.raises(ValueError, match="device"):
        tconfig.JobConfig(device="tpu")
    with pytest.raises(SystemExit):
        tconfig.parse_job_args(["--device", "tpu"])
    cfg = tconfig.parse_job_args(["--device", "cpu", "--dims", "3"])
    assert cfg.engine_config() == EngineConfig(dims=3, device="cpu")
    mesh = tconfig.parse_job_args(["--mesh", "2", "--device", "cpu"]).build_mesh()
    assert (mesh.axis_names, mesh.grid, mesh.device_type) == (("part",), (2,), "cpu")
    ref = jconfig.parse_job_args(["--mesh", "2"]).build_mesh()
    assert ref.axis_names == mesh.axis_names and ref.devices.shape == mesh.devices.shape
    if not __import__("torch").cuda.is_available():
        # the job refuses a mesh of more cards than it sees, as the reference
        with pytest.raises(RuntimeError, match="--mesh 2 requested"):
            tconfig.parse_job_args(["--mesh", "2"]).build_mesh()
    cl = tconfig.parse_job_args(["--cluster-hosts", "2", "--mesh-chips", "2"])
    ref = jconfig.parse_job_args(["--cluster-hosts", "2", "--mesh-chips", "2"])
    assert (cl.cluster_hosts, cl.mesh_chips) == (ref.cluster_hosts, ref.mesh_chips) == (2, 2)
    assert tconfig.parse_job_args(["--mesh-chips", "2"]).mesh_chips == 2
    assert tconfig.parse_job_args([]).build_mesh() is None


# -- the worker against the JAX worker ------------------------------------------


GRID = [(pol, d) for pol in ("lazy", "overlap", "incremental") for d in (2, 3, 8)]


@pytest.mark.parametrize("policy,d", GRID)
def test_worker_output_and_wal_match_jax(pinned, tmp_path, policy, d):
    rows = anti_correlated(np.random.default_rng(d), 1200, d, 0, 10000)
    cfg = dict(parallelism=2, dims=d, domain_max=10000.0, buffer_size=128,
               flush_policy=policy, overlap_rows=300, emit_skyline_points=True)
    (a, wa), (b, wb) = both(lines_of(rows), cfg, tmp_path=tmp_path)
    assert len(a) == len(b) == 1
    assert [untimed(x) for x in a] == [untimed(x) for x in b]
    assert wa.engine.records_in == wb.engine.records_in == 1200
    from skyline_tpu.resilience.wal import list_segments as jsegs
    from skyline_tpu.resilience.wal import read_records as jread
    from skyline_tpu_torch.resilience.wal import list_segments, read_records

    recs, torn = read_records(str(tmp_path / "port" / "wal"))
    jrecs, jtorn = jread(str(tmp_path / "jax" / "wal"))
    assert recs == jrecs and torn == jtorn == 0
    assert [r["type"] for r in recs].count("batch") == -(-1200 // 500)
    segs = [Path(p).read_bytes() for _, p in list_segments(str(tmp_path / "port" / "wal"))]
    assert segs == [Path(p).read_bytes() for _, p in jsegs(str(tmp_path / "jax" / "wal"))]


@pytest.mark.parametrize("chips,policy,d", [(2, "incremental", 3), (4, "lazy", 8)])
def test_sharded_worker_output_and_journals_match_jax(pinned, tmp_path, chips, policy, d):
    """``mesh_chips``: the sharded engine behind the worker. The output
    lines, every main-WAL record and segment byte, and every chip-journal
    record and segment byte equal the JAX sharded worker's; the answer is
    the flat worker's."""
    from skyline_tpu.resilience.chip_wal import read_chip_records as jchips
    from skyline_tpu.resilience.wal import list_segments as jsegs
    from skyline_tpu.resilience.wal import read_records as jread
    from skyline_tpu_torch.resilience.chip_wal import read_chip_records, verify_chip_barriers
    from skyline_tpu_torch.resilience.wal import list_segments, read_records

    rows = anti_correlated(np.random.default_rng(d), 1200, d, 0, 10000)
    cfg = dict(parallelism=2, dims=d, domain_max=10000.0, buffer_size=128,
               flush_policy=policy, emit_skyline_points=True)
    (a, wa), (b, wb) = both(lines_of(rows), cfg, tmp_path=tmp_path, mesh_chips=chips)
    assert type(wa.engine).__name__ == "ShardedEngine" and wa.engine.mesh_chips == chips
    assert len(a) == len(b) == 1
    assert [untimed(x) for x in a] == [untimed(x) for x in b]
    flat, _ = drive("port", lines_of(rows), cfg)
    assert [untimed(x) for x in a] == [untimed(x) for x in flat]
    port_wal, jax_wal = tmp_path / "port" / "wal", tmp_path / "jax" / "wal"
    assert read_records(str(port_wal)) == jread(str(jax_wal))
    chips_port = read_chip_records(str(port_wal), chips)
    assert chips_port == jchips(str(jax_wal), chips)
    assert all(any(r["type"] == "chip-barrier" for r in recs) for recs in chips_port)
    assert verify_chip_barriers(str(port_wal))["agree"]
    for c in [None, *range(chips)]:
        sub = "" if c is None else f"chip-{c:02d}"
        segs = [Path(p).read_bytes() for _, p in list_segments(str(port_wal / sub))]
        assert segs == [Path(p).read_bytes() for _, p in jsegs(str(jax_wal / sub))], sub


def test_malformed_lines_drop_like_jax(pinned):
    lines = lines_of(uniform(np.random.default_rng(1), 300, 3, 0, 100))
    lines[5:5] = ["garbage", "1,2", "7,nan,1,2", "8,1,2,3,4", ""]
    cfg = dict(parallelism=2, dims=3, domain_max=100.0, emit_skyline_points=True)
    (a, wa), (b, wb) = both(lines, cfg)
    assert [untimed(x) for x in a] == [untimed(x) for x in b]
    assert wa.engine.dropped == wb.engine.dropped == 4
    assert wa.engine.records_in == wb.engine.records_in == 300


def test_trigger_before_data_matches_jax(pinned):
    """A trigger visible before its data: the id barrier defers it until
    the rows past it arrive, in both packages alike."""
    lines = lines_of(uniform(np.random.default_rng(2), 400, 2, 0, 1000))
    cfg = dict(parallelism=2, dims=2, domain_max=1000.0, emit_skyline_points=True)
    (a, _), (b, _) = both(lines, cfg, trigger="q9,350", trigger_first=True)
    assert len(a) == 1 and [untimed(x) for x in a] == [untimed(x) for x in b]
    assert json.loads(a[0])["record_count"] == 350


class _EndlessLines:
    """A data consumer that always has one more line (a producer that
    never stops)."""

    def __init__(self):
        self.i = 0

    def poll(self, max_records):
        i, self.i = self.i, self.i + 1
        return [f"{i},{float(i % 7)},{float(7 - i % 7)}"]


def test_drain_bound_applies_the_trigger_like_jax(pinned, capsys):
    outs = {}
    for kind, bus in (("port", MemoryBus()), ("jax", JBus())):
        endless = _EndlessLines()
        orig = bus.consumer
        bus.consumer = lambda topic, from_beginning=True, o=orig, e=endless: (
            e if topic == "input-tuples" else o(topic, from_beginning))
        w = make(kind, bus, dict(parallelism=1, algo="mr-dim", dims=2, domain_max=1e9,
                                 emit_skyline_points=True), max_drain_polls=3)
        bus.produce("queries", "9,0")
        w.step()
        outs[kind] = (bus.consumer("output-skyline").poll(), w.engine.records_in)
        w.close()
        err = capsys.readouterr().err
        assert "drain bound hit after 4 polls" in err and "--max-drain-polls" in err
    assert outs["port"][1] == outs["jax"][1] == 4
    assert [untimed(x) for x in outs["port"][0]] == [untimed(x) for x in outs["jax"][0]]


def _arrays_bus(base, ids, values):
    """``base`` whose data consumer serves one oversized arrays batch."""
    served = []

    class Arrays:
        def poll(self, max_records=65536):
            return []

        def poll_arrays(self, dims):
            if served:
                return np.empty(0, np.int64), np.empty((0, dims), np.float32), 0
            served.append(1)
            return ids, values, 3

    bus = base()
    orig = bus.consumer
    bus.consumer = lambda topic, from_beginning=True: (
        Arrays() if topic == "input-tuples" else orig(topic, from_beginning))
    return bus


def test_oversized_arrays_batch_chunks_like_jax(pinned):
    rng = np.random.default_rng(4)
    ids = np.arange(1000, dtype=np.int64)
    values = rng.integers(0, 100, (1000, 2)).astype(np.float32)
    seen = {}
    for kind, base in (("port", MemoryBus), ("jax", JBus)):
        bus = _arrays_bus(base, ids, values)
        w = make(kind, bus, dict(parallelism=2, algo="mr-dim", dims=2, domain_max=100.0,
                                 emit_skyline_points=True))
        sizes = []
        orig = w.engine.process_records
        w.engine.process_records = lambda i, v, now_ms=None, event_ms=None, o=orig: (
            sizes.append(i.shape[0]), o(i, v, now_ms=now_ms, event_ms=event_ms))[1]
        got = [w.step(max_records=256)]
        while got[-1]:
            got.append(w.step(max_records=256))
        bus.produce("queries", "q,0")
        w.step(max_records=256)
        seen[kind] = (sizes, got, w._arrays_plane, w.engine.dropped,
                      [untimed(x) for x in bus.consumer("output-skyline").poll()])
        w.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [256, 256, 256, 232] and seen["port"][2] is True


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, json.loads(r.read())


def test_serve_and_stats_answer(pinned, tmp_path):
    rows = anti_correlated(np.random.default_rng(5), 600, 3, 0, 10000)
    bus = MemoryBus()
    w = make("port", bus, dict(parallelism=2, dims=3, domain_max=10000.0,
                               emit_skyline_points=True),
             serve_port=0, stats_port=0,
             resilience=ResilienceConfig(checkpoint_dir=str(tmp_path)))
    try:
        bus.produce_many("input-tuples", lines_of(rows))
        while w.step(max_records=200):
            pass
        bus.produce("queries", "q,0")
        w.step()
        (line,) = bus.consumer("output-skyline").poll()
        status, snap = _get(w.serve_server.port, "/skyline")
        assert status == 200 and snap["skyline_size"] == json.loads(line)["skyline_size"]
        assert sorted(map(tuple, snap["points"])) == sorted(
            map(tuple, json.loads(line)["skyline_points"]))
        status, stats = _get(w.stats_server.port, "/stats")
        assert status == 200 and stats["records_in"] == 600
        assert stats["results_emitted"] == 1
        assert {"worker/poll", "worker/ingest", "worker/query"} <= set(stats["phase_breakdown_ms"])
        assert stats["resilience"]["wal"]["appends"] > 0
        assert stats["resilience"]["ops"] is not None and w.telemetry.opslog is not None
    finally:
        w.close()


@pytest.mark.parametrize("d,window,slide", [(2, 512, 128), (4, 1024, 256)])
def test_sliding_branch_matches_jax(pinned, d, window, slide):
    rows = anti_correlated(np.random.default_rng(d), 1500, d, 0, 10000)
    cfg = dict(parallelism=2, dims=d, domain_max=10000.0, emit_skyline_points=True)
    kw = dict(window_size=window, slide=slide, emit_per_slide=True)
    (a, wa), (b, _) = both(lines_of(rows), cfg, **kw)
    assert type(wa.engine).__name__ == "SlidingEngine"
    assert len(a) == len(b) > 5
    assert [untimed(x) for x in a] == [untimed(x) for x in b]


def test_worker_raises_on_unported_placements_and_missing_card(tmp_path):
    """The device mesh, the sharded and cluster engines and the read
    replicas are ported: the worker builds them, and rejects what the
    reference's worker rejects."""
    from skyline_tpu_torch.parallel import make_mesh

    bus = MemoryBus()
    cfg = EngineConfig(device="cpu")
    w = tworker.SkylineWorker(bus, cfg, mesh=make_mesh(2, device="cpu"))
    assert type(w.engine).__name__ == "SkylineEngine" and w.engine.stats()["meshed"]
    w.close()
    w = tworker.SkylineWorker(bus, cfg, mesh_chips=2)
    assert type(w.engine).__name__ == "ShardedEngine"
    w.close()
    w = tworker.SkylineWorker(bus, EngineConfig(parallelism=4, device="cpu"), cluster_hosts=2,
                              mesh_chips=2)
    ref = jworker.SkylineWorker(JBus(), JConfig(parallelism=4), cluster_hosts=2, mesh_chips=2)
    assert type(w.engine).__name__ == type(ref.engine).__name__ == "ClusterEngine"
    assert w.engine.pset._member_chips == ref.engine.pset._member_chips == [2, 2]
    w.close()
    ref.close()
    for kw in (dict(mesh_chips=2, window_size=64, slide=32), dict(mesh_chips=2, mesh=object()),
               dict(cluster_hosts=2, window_size=64, slide=32),
               dict(cluster_hosts=2, mesh=object()), dict(replicas=1),
               dict(replicas=1, serve_port=0)):
        with pytest.raises(ValueError) as port:
            tworker.SkylineWorker(bus, cfg, **kw)
        with pytest.raises(ValueError) as ref:
            jworker.SkylineWorker(JBus(), JConfig(), **kw)
        assert str(port.value) == str(ref.value)
    w = tworker.SkylineWorker(bus, cfg, serve_port=0, replicas=1,
                              resilience=ResilienceConfig(checkpoint_dir=str(tmp_path)))
    try:
        (rep,) = w.replicas
        assert rep.replica_id == "replica-0" and rep.wal_dir == str(tmp_path / "wal")
    finally:
        w.close()
    assert rep._thread is None or not rep._thread.is_alive()
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tworker.main(["--device", "cuda"])
    # --replica-of runs the standalone replica (main), never a worker; its
    # CLI is held against the JAX package's in tests/test_torch_replica.py
    with pytest.raises(ValueError, match="standalone read replica"):
        tworker.build_worker(tconfig.parse_job_args(["--device", "cpu", "--replica-of", "x"]))


# -- the CLIs and the import boundary -------------------------------------------

CLIS = [
    "skyline_tpu_torch.bridge.worker", "skyline_tpu_torch.workload.producer",
    "skyline_tpu_torch.workload.trigger", "skyline_tpu_torch.metrics.collector",
    "skyline_tpu_torch.bridge.kafkalite.broker", "skyline_tpu_torch.resilience.supervisor",
    "skyline_tpu_torch.opslog",
]

NEW_MODULES = CLIS + [
    "skyline_tpu_torch.native", "skyline_tpu_torch.bridge.memory",
    "skyline_tpu_torch.bridge.kafka", "skyline_tpu_torch.bridge.kafkalite.client",
    "skyline_tpu_torch.bridge.kafkalite.protocol", "skyline_tpu_torch.bridge.wire",
    "skyline_tpu_torch.resilience.wal", "skyline_tpu_torch.resilience.checkpoints",
    "skyline_tpu_torch.resilience.chip_wal", "skyline_tpu_torch.telemetry.opslog",
    "skyline_tpu_torch.utils.config", "skyline_tpu_torch.workload.generators",
    "skyline_tpu_torch.serve.bodystore",
]


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'skyline_tpu' or m.startswith('skyline_tpu.'))\n"
        "print(len(bad), bad[:5])\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []"


@pytest.mark.parametrize("module", CLIS)
def test_cli_entry_points_exist(module, monkeypatch, capsys):
    import runpy

    monkeypatch.setattr(sys, "argv", [module, "--help"])
    with pytest.raises(SystemExit) as ex:
        runpy.run_module(module, run_name="__main__", alter_sys=False)
    assert ex.value.code == 0
    assert "usage" in capsys.readouterr().out.lower()

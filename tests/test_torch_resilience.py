"""The port's crash safety (``skyline_tpu_torch/resilience``) on the CPU
against the JAX package's.

- The WAL: segment files and ``read_records`` byte-equal to the JAX
  package's ``WalWriter`` for the same records, each package reading the
  other's log; a torn tail, a CRC mismatch, rotation with barrier
  truncation, a bad fsync policy; ``batch_digest`` on the polled host
  arrays only; ``segment_first_record`` and the tailer.
- The ``CheckpointManager``: fallback over torn and corrupt files, the
  crash before ``os.replace``, ``retain``; restoring onto the engine's
  device.
- The ``Supervisor``: the backoff schedule (the JAX package's for the same
  seed) and the budget; the subprocess CLI.
- The chaos grid of ``tests/test_resilience.py`` on the port's worker: the
  recovered answer equals its own uninterrupted run and the JAX worker's
  answer; the digest-mismatch refusal; SIGTERM → checkpoint → a boot that
  replays nothing; the serve plane and the event watermark restored from
  the WAL.

Tolerance: exact records, bytes and answers.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from skyline_tpu.bridge import MemoryBus as JBus
from skyline_tpu.bridge import SkylineWorker as JWorker
from skyline_tpu.resilience import wal as jwal
from skyline_tpu.resilience.supervisor import Supervisor as JSupervisor
from skyline_tpu.stream.engine import EngineConfig as JConfig
from skyline_tpu_torch.bridge import MemoryBus, SkylineWorker
from skyline_tpu_torch.bridge.wire import format_trigger, format_tuple_line
from skyline_tpu_torch.resilience import WAL_SUBDIR, ResilienceConfig
from skyline_tpu_torch.resilience.checkpoints import CheckpointManager
from skyline_tpu_torch.resilience.faults import (
    FaultPlan,
    InjectedCrash,
    active_plan,
    clear,
    install_plan,
)
from skyline_tpu_torch.resilience.supervisor import (
    RestartBudgetExceeded,
    Supervisor,
    WorkerCrashed,
)
from skyline_tpu_torch.resilience.wal import (
    WalReplayError,
    WalTailer,
    WalWriter,
    batch_digest,
    list_segments,
    read_records,
    segment_first_record,
)
from skyline_tpu_torch.stream.engine import EngineConfig
from skyline_tpu_torch.telemetry import Telemetry
from skyline_tpu_torch.workload.generators import anti_correlated, correlated, uniform

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    clear()
    yield
    clear()


RECORDS = [
    {"type": "start", "data_off": 0, "query_off": 0},
    {"type": "batch", "lo": 0, "hi": 64, "digest": "aa"},
    {"type": "commit", "data_off": 64, "query_off": 1},
    {"type": "delta", "from": 0, "to": 1, "d": 2, "entered": "AAAA", "left": "",
     "wm": 63, "ewm": 1.5, "meta": {}},
    {"type": "commit", "data_off": 128, "query_off": 1, "note": "é ünïcode"},
]


def _segments(d):
    return [Path(p).read_bytes() for _, p in list_segments(d)]


def _write_both(tmp_path, records, **kw):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    wa, wb = WalWriter(a, **kw), jwal.WalWriter(b, **kw)
    for r in records:
        if r.get("type") == "ckpt":
            wa.barrier(r)
            wb.barrier(r)
        else:
            wa.append(r)
            wb.append(r)
    wa.close()
    wb.close()
    return a, b, wa, wb


def test_wal_segments_and_records_byte_equal_to_jax(tmp_path):
    a, b, _, _ = _write_both(tmp_path, RECORDS, fsync="off")
    assert _segments(a) == _segments(b)
    assert read_records(a) == jwal.read_records(a) == (RECORDS, 0)
    assert read_records(b) == jwal.read_records(b)
    assert segment_first_record(list_segments(a)[0][1]) == RECORDS[0]


def test_wal_rotation_and_barrier_truncation_match_jax(tmp_path):
    recs = [{"type": "commit", "data_off": i, "query_off": 0} for i in range(20)]
    recs += [{"type": "ckpt", "data_off": 20, "query_off": 0},
             {"type": "commit", "data_off": 21, "query_off": 0}]
    a, b, wa, wb = _write_both(tmp_path, recs, segment_bytes=64, fsync="off")
    assert wa.segments_created > 1 and wa.segments_truncated > 0
    assert wa.stats() == wb.stats()
    assert [n for n in sorted(os.listdir(a))] == [n for n in sorted(os.listdir(b))]
    assert _segments(a) == _segments(b)
    got, torn = read_records(a)
    assert [r["type"] for r in got] == ["ckpt", "commit"] and torn == 0


@pytest.mark.parametrize("damage", ["torn", "crc"])
def test_wal_torn_tail_and_crc_mismatch_read_like_jax(tmp_path, damage):
    a, b, _, _ = _write_both(tmp_path, RECORDS, fsync="off")
    for d in (a, b):
        _, path = list_segments(d)[-1]
        data = bytearray(Path(path).read_bytes())
        if damage == "torn":
            data = data[:-5]
        else:
            data[-3] ^= 0xFF
        Path(path).write_bytes(bytes(data))
    got = read_records(a)
    assert got == jwal.read_records(b)
    assert got[0] == RECORDS[:-1] and got[1] == 1


def test_wal_rejects_bad_fsync_policy_like_jax(tmp_path):
    with pytest.raises(ValueError) as port:
        WalWriter(str(tmp_path / "a"), fsync="sometimes")
    with pytest.raises(ValueError) as ref:
        jwal.WalWriter(str(tmp_path / "b"), fsync="sometimes")
    assert str(port.value) == str(ref.value)


def test_batch_digest_hashes_the_polled_host_arrays_only(rng):
    import torch

    ids = np.arange(7, dtype=np.int64)
    vals = rng.random((7, 3)).astype(np.float32)
    assert batch_digest(ids, vals) == jwal.batch_digest(ids, vals)
    assert batch_digest(ids, vals) != batch_digest(ids[::-1].copy(), vals)
    with pytest.raises(TypeError, match="host arrays"):
        batch_digest(torch.from_numpy(ids), torch.from_numpy(vals))
    with pytest.raises(TypeError, match="int64 ids and float32"):
        batch_digest(ids, vals.astype(np.float64))


def test_tailer_follows_like_jax(tmp_path):
    d = str(tmp_path / "wal")
    w = WalWriter(d, segment_bytes=200, fsync="off")
    t, jt = WalTailer(d, "port"), jwal.WalTailer(d, "jax")
    for r in RECORDS:
        w.append(r)
    assert t.poll() == jt.poll() == RECORDS
    w.append({"type": "commit", "data_off": 1})
    assert t.poll() == jt.poll() == [{"type": "commit", "data_off": 1}]
    assert t.stats() == jt.stats()
    t.close()
    jt.close()
    w.close()


# -- checkpoints -------------------------------------------------------------------


def _feed(bus, rows, start_id=0):
    bus.produce_many("input-tuples",
                     [format_tuple_line(start_id + i, row) for i, row in enumerate(rows)])


def _cfg(d=2, buffer_size=128):
    return dict(parallelism=2, dims=d, domain_max=10000.0, buffer_size=buffer_size,
                emit_skyline_points=True)


def _worker(bus, tmp_path, d=2, interval=0.0, serve=False, telem=None, jax=False):
    if jax:
        from skyline_tpu.resilience import ResilienceConfig as JRes

        res = JRes(checkpoint_dir=str(tmp_path), checkpoint_interval_s=interval)
        return JWorker(bus, JConfig(**_cfg(d)), resilience=res, telemetry=telem,
                       serve_port=0 if serve else None)
    res = ResilienceConfig(checkpoint_dir=str(tmp_path), checkpoint_interval_s=interval)
    return SkylineWorker(bus, EngineConfig(**_cfg(d), device="cpu"), resilience=res,
                         telemetry=telem, serve_port=0 if serve else None)


def test_checkpoint_fallback_on_torn_and_corrupt_files(rng, tmp_path):
    bus = MemoryBus()
    _feed(bus, uniform(rng, 200, 2, 0, 10000))
    w = _worker(bus, tmp_path)
    while w.step(max_records=64):
        pass
    p1 = w.checkpoint_now()
    _feed(bus, uniform(rng, 100, 2, 0, 10000), start_id=200)
    while w.step(max_records=64):
        pass
    p2 = w.checkpoint_now()
    p3 = w.checkpoint_now()
    w.close()
    with open(p3, "r+b") as f:  # torn
        f.truncate(os.path.getsize(p3) // 2)
    with np.load(p2, allow_pickle=False) as z:  # valid zip, rewritten content
        arrays = {k: z[k].copy() for k in z.files}
    key = max((k for k in arrays if k != "__meta__" and arrays[k].size),
              key=lambda k: arrays[k].nbytes)
    arrays[key] = arrays[key] + 1.0
    with open(p2, "wb") as f:
        np.savez_compressed(f, **arrays)
    telem = Telemetry()
    mgr = CheckpointManager(str(tmp_path), telemetry=telem)
    engine, meta, path = mgr.restore_latest(telemetry=telem, device="cpu")
    assert path == p1 and engine.records_in == 200 and meta["extra"]["data_off"] == 200
    assert engine.config.device == "cpu" and mgr.fallbacks == 2
    counts = telem.counters.snapshot()
    assert counts["checkpoint.fallbacks"] == 2 and counts["checkpoint.restored"] == 1


def test_checkpoint_restore_raises_without_a_card_or_on_placements(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mgr.restore_latest()
    # the sharded and cluster engines and a device mesh restore (nothing to
    # restore here); a CPU mesh stands for the device
    from skyline_tpu_torch.parallel import make_mesh

    assert mgr.restore_latest(mesh_chips=2, device="cpu") is None
    assert mgr.restore_latest(cluster_hosts=2, device="cpu") is None
    assert mgr.restore_latest(mesh=make_mesh(2, device="cpu")) is None


def test_crash_before_replace_and_retain(rng, tmp_path):
    bus = MemoryBus()
    _feed(bus, uniform(rng, 150, 2, 0, 10000))
    w = _worker(bus, tmp_path)
    while w.step(max_records=64):
        pass
    p1 = w.checkpoint_now()
    install_plan(FaultPlan.parse("crash@checkpoint.pre_replace:1"))
    with pytest.raises(InjectedCrash):
        w.checkpoint_now()
    clear()
    mgr = CheckpointManager(str(tmp_path))
    assert [p for _, p in mgr.list()] == [p1]
    assert mgr.restore_latest(device="cpu")[2] == p1
    paths = [w.checkpoint_now() for _ in range(5)]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".npz.tmp")]
    assert w._ckpt_mgr.retain == 3
    assert [p for _, p in w._ckpt_mgr.list()] == paths[-3:]
    w.close()


# -- the supervisor ----------------------------------------------------------------


def test_supervisor_backoff_and_budget_match_jax():
    sleeps, jsleeps = [], []

    from skyline_tpu.resilience.faults import InjectedCrash as JInjectedCrash

    def always_crashes(attempt):
        raise InjectedCrash(f"boom {attempt}")

    def jax_always_crashes(attempt):
        raise JInjectedCrash(f"boom {attempt}")

    telem = Telemetry()
    kw = dict(max_restarts=4, backoff_base_s=0.5, backoff_cap_s=3.0, jitter_frac=0.1, seed=3)
    sup = Supervisor(always_crashes, telemetry=telem, sleep=sleeps.append, **kw)
    jsup = JSupervisor(jax_always_crashes, sleep=jsleeps.append, **kw)
    with pytest.raises(RestartBudgetExceeded):
        sup.run()
    with pytest.raises(Exception, match="budget"):
        jsup.run()
    assert sleeps == jsleeps and len(sleeps) == 4 and sup.restarts == 5
    for i, lo in enumerate((0.5, 1.0, 2.0, 3.0)):
        assert lo <= sleeps[i] <= lo * 1.1 + 1e-9
    assert sup.stats() == jsup.stats()
    assert "skyline_resilience_restarts_total 5" in telem.render_prometheus()


def test_supervisor_recovers_and_lets_operator_intent_through():
    state = {"n": 0}

    def flaky(attempt):
        state["n"] += 1
        if state["n"] < 3:
            raise RuntimeError("transient")
        return "done"

    sup = Supervisor(flaky, max_restarts=5, backoff_base_s=0.0, backoff_cap_s=0.0,
                     sleep=lambda s: None)
    assert sup.run() == "done" and sup.restarts == 2

    def interrupted(attempt):
        raise KeyboardInterrupt()

    sup = Supervisor(interrupted, max_restarts=5, sleep=lambda s: None)
    with pytest.raises(KeyboardInterrupt):
        sup.run()
    assert sup.restarts == 0
    assert WorkerCrashed(3).returncode == 3


def test_supervisor_cli_gives_up_on_a_crashing_worker(tmp_path):
    """The subprocess supervisor restarts a worker that exits non-zero (a
    ``--device cuda`` request on a machine without a card, or a bad flag)
    and gives up with exit code 1 once its budget is spent."""
    env = {k: v for k, v in os.environ.items() if k != "SKYLINE_FAULT_PLAN"}
    worker_args = ["--dims", "0", "--device", "cpu"]  # invalid: the job refuses
    out = subprocess.run(
        [sys.executable, "-m", "skyline_tpu_torch.resilience.supervisor",
         "--max-restarts", "1", "--backoff-s", "0", "--", *worker_args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 1, out.stderr[-2000:]
    assert "giving up" in out.stderr and "restart 1/1" in out.stderr


# -- the chaos property: supervised == uninterrupted == the JAX worker ------------


def _drive_to_result(worker, bus, out, shared, chunk):
    idle = 0
    while True:
        if worker.step(max_records=chunk):
            idle = 0
            continue
        if not shared["trigger_sent"]:
            bus.produce("queries", format_trigger(0, 0))
            shared["trigger_sent"] = True
            continue
        shared["lines"].extend(out.poll())
        if shared["lines"]:
            return json.loads(shared["lines"][-1])
        idle += 1
        assert idle < 500, "worker went idle without producing a result"


def _run_stream(tmp_path, rows, d, plan_spec, interval, chunk=64, jax=False):
    bus = JBus() if jax else MemoryBus()
    _feed(bus, rows)
    out = bus.consumer("output-skyline", from_beginning=True)
    telem = None if jax else Telemetry()
    shared = {"trigger_sent": False, "lines": []}
    holder = {}
    if plan_spec:
        install_plan(FaultPlan.parse(plan_spec))

    def incarnation(attempt):
        w = _worker(bus, tmp_path, d=d, interval=interval, telem=telem, jax=jax)
        holder["w"] = w
        return _drive_to_result(w, bus, out, shared, chunk)

    sup = Supervisor(incarnation, max_restarts=8, backoff_base_s=0.0,
                     backoff_cap_s=0.0, telemetry=telem, sleep=lambda s: None)
    try:
        doc = sup.run()
    finally:
        clear()
        if holder.get("w") is not None:
            holder["w"].close()
    return doc, holder["w"], sup, telem


CHAOS_GRID = [
    ("crash@kafka.poll:5", uniform, 2, 0.0),
    ("crash@flush.pre_merge:2", correlated, 4, 0.0),
    ("crash@wal.pre_fsync:3", anti_correlated, 8, 0.0),
    ("crash@checkpoint.pre_replace:2,crash@kafka.poll:9", uniform, 4, 1e-6),
]


@pytest.mark.parametrize("plan,gen,d,interval", CHAOS_GRID)
def test_chaos_equals_uninterrupted_and_the_jax_worker(rng, tmp_path, plan, gen, d, interval):
    n = 400
    rows = gen(rng, n, d, 0, 10000)
    base, _, base_sup, _ = _run_stream(tmp_path / "base", rows, d, None, 0.0)
    ref, _, _, _ = _run_stream(tmp_path / "jax", rows, d, None, 0.0, jax=True)
    doc, w, sup, telem = _run_stream(tmp_path / "chaos", rows, d, plan, interval)
    assert base_sup.restarts == 0 and sup.restarts >= 1 and active_plan() is None
    assert w.engine.records_in == n
    for other in (base, ref):
        assert doc["skyline_size"] == other["skyline_size"]
        assert np.asarray(doc["skyline_points"], np.float32).tobytes() == np.asarray(
            other["skyline_points"], np.float32).tobytes()
    counts = telem.counters.snapshot()
    assert counts["resilience.restarts"] == sup.restarts
    if interval:
        assert counts.get("checkpoint.restored", 0) >= 1
    else:
        assert counts.get("wal.replayed", 0) >= 1
    assert w._recovered is not None and w._recovered["wal_records"] > 0


def test_replay_refuses_rewritten_history(rng, tmp_path):
    bus = MemoryBus()
    rows = uniform(rng, 128, 2, 0, 10000)
    _feed(bus, rows)
    telem = Telemetry()
    w = _worker(bus, tmp_path)
    while w.step(max_records=64):
        pass
    w._wal.flush(force=True)
    bus._topics["input-tuples"][5] = format_tuple_line(5, rows[6])
    with pytest.raises(WalReplayError, match="digest"):
        _worker(bus, tmp_path, telem=telem)
    assert telem.counters.snapshot()["wal.digest_mismatch"] == 1
    w.close()


def test_sigterm_checkpoints_and_next_boot_replays_nothing(rng, tmp_path):
    bus = MemoryBus()
    _feed(bus, uniform(rng, 300, 2, 0, 10000))
    telem = Telemetry()
    w = _worker(bus, tmp_path, telem=telem)
    while w.step(max_records=64):
        pass
    assert w._dirty
    w._signal_handler(signal.SIGTERM, None)
    w.run_forever(idle_sleep_s=0.0)
    assert w._closed and telem.counters.snapshot().get("checkpoint.saved", 0) == 1
    recs, torn = read_records(os.path.join(str(tmp_path), WAL_SUBDIR))
    assert torn == 0 and recs[-1]["type"] == "ckpt" and recs[-1]["data_off"] == 300
    w2 = _worker(bus, tmp_path)
    assert w2.engine.records_in == 300 and w2._data_pos == 300
    assert w2._recovered["replayed_batches"] == 0
    assert w2.stats()["resilience"]["recovered"]["checkpoint"] is not None
    w2.close()


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, (json.loads(body) if body else {})


def test_serve_plane_and_watermark_restored_from_wal(rng, tmp_path):
    bus = MemoryBus()
    _feed(bus, anti_correlated(rng, 400, 2, 0, 10000))
    w1 = _worker(bus, tmp_path, serve=True)
    bus.produce("queries", format_trigger(0, 0))
    while w1.step(max_records=128):
        pass
    head1 = w1._snap_store.latest()
    assert head1 is not None and head1.points.shape[0] > 0
    w1.checkpoint_now()
    _feed(bus, anti_correlated(rng, 100, 2, 0, 10000), start_id=400)
    bus.produce("queries", format_trigger(1, 0))
    while w1.step(max_records=128):
        pass
    head2 = w1._snap_store.latest()
    assert head2.version > head1.version and head2.event_wm_ms is not None
    w1._wal.flush(force=True)
    w1.close()

    w2 = _worker(bus, tmp_path, serve=True)
    store = w2._snap_store
    assert store.restored and store.latest().version == head2.version
    assert store.latest().watermark_id == head2.watermark_id
    assert store.latest().event_wm_ms == head2.event_wm_ms
    assert store.latest().points.tobytes() == head2.points.tobytes()
    entered, left, to_version = w2._serve_ring.since(head1.version)
    assert to_version == head2.version
    pts = head1.points
    if left.size:
        pts = pts[~np.isin([r.tobytes() for r in pts], [r.tobytes() for r in left])]
    if entered.size:
        pts = np.concatenate([pts, entered]) if pts.size else entered
    assert sorted(map(bytes, pts)) == sorted(map(bytes, head2.points))
    status, doc = _get(f"http://127.0.0.1:{w2.serve_server.port}/skyline?points=1")
    assert status == 200 and doc["restored"] is True
    _feed(bus, anti_correlated(rng, 50, 2, 0, 10000), start_id=500)
    bus.produce("queries", format_trigger(2, 0))
    while w2.step(max_records=128):
        pass
    assert not store.restored and store.latest().event_wm_ms >= head2.event_wm_ms
    status, doc = _get(f"http://127.0.0.1:{w2.serve_server.port}/skyline")
    assert status == 200 and "restored" not in doc
    w2.close()


def test_port_replays_a_wal_the_jax_worker_wrote(rng, tmp_path):
    """The logs are one format: a WAL the JAX worker left behind (no
    checkpoint) replays into the port's worker, digest-verified."""
    rows = uniform(rng, 256, 2, 0, 10000)
    jbus = JBus()
    _feed(jbus, rows)
    jw = _worker(jbus, tmp_path, jax=True)
    while jw.step(max_records=64):
        pass
    jw._wal.flush(force=True)
    jw.close()
    bus = MemoryBus()
    _feed(bus, rows)
    w = _worker(bus, tmp_path)
    assert w.engine.records_in == 256 and w._recovered["replayed_batches"] == 4
    w.close()


def test_dispatch_state_rides_the_checkpoint(rng, tmp_path):
    """The profiler EMAs, the flush chooser's profiler and the tuner's
    pins go into the checkpoint's extra meta (the same keys as the JAX
    worker's) and come back into the restarted worker's live planes."""
    rows = anti_correlated(rng, 600, 4, 0, 10000)
    docs = {}
    for jax in (False, True):
        bus = JBus() if jax else MemoryBus()
        _feed(bus, rows)
        w = _worker(bus, tmp_path / ("jax" if jax else "port"), d=4, jax=jax)
        while w.step(max_records=128):
            pass
        bus.produce("queries", format_trigger(0, 0))
        w.step()
        docs[jax] = w._dispatch_state()
        w.checkpoint_now()
        w.close()
    assert sorted(docs[False]) == sorted(docs[True])
    assert docs[False]["profiler"]
    bus = MemoryBus()
    _feed(bus, rows)
    w2 = _worker(bus, tmp_path / "port", d=4)
    assert w2.engine.records_in == 600 and w2._recovered["replayed_batches"] == 0
    assert w2._dispatch_state()["profiler"] == docs[False]["profiler"]
    assert w2._dispatch_state()["tuner"] == docs[False]["tuner"]
    w2.close()

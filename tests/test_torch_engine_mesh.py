"""The port's engines over a device mesh (``SkylineEngine(mesh=)``,
``PartitionSet(mesh=)``, ``SlidingEngine(mesh=)``, the worker's ``--mesh``
and the checkpoint across topologies) against the JAX package's on the CPU.

JAX's meshes span the eight virtual CPU devices of ``conftest.py``; the
port's put every place on the CPU. Each engine pair is fed the same seeded
rows: the answer rows and their order, their digest, the per-partition
survivors and ``stats()`` (timing fields aside) with a telemetry hub's
counters, spans, EXPLAIN plans and flight notes are compared exactly, as is
the flat port engine's answer. The lazy flush pins the SFS rounds on both
sides where a flat engine joins (a meshed set never races)."""

import json

import numpy as np
import pytest
import torch

from skyline_tpu.bridge import MemoryBus as JBus
from skyline_tpu.parallel import make_mesh as jax_make_mesh
from skyline_tpu.stream.batched import PartitionSet as JaxPartitionSet
from skyline_tpu.stream.sliding_engine import SlidingEngine as JaxSliding
from skyline_tpu.utils import checkpoint as jax_ckpt
from skyline_tpu.utils import config as jconfig
from skyline_tpu_torch.bridge import MemoryBus
from skyline_tpu_torch.bridge import worker as tworker
from skyline_tpu_torch.parallel import make_mesh
from skyline_tpu_torch.stream.batched import PartitionSet
from skyline_tpu_torch.stream.sliding_engine import SlidingEngine
from skyline_tpu_torch.telemetry import Telemetry
from skyline_tpu_torch.utils import checkpoint as ckpt
from skyline_tpu_torch.utils import config as tconfig

from conftest import merge_state, points_digest_of
from test_torch_mesh import mesh_rows
from test_torch_observability import (  # noqa: F401  (process_state: autouse)
    JaxConfig,
    JaxEngine,
    JaxTelemetry,
    EngineConfig,
    SkylineEngine,
    _assert_same_plane,
    process_state,
    untimed,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def rounds_only(monkeypatch):
    monkeypatch.setenv("SKYLINE_SORTED_SFS", "off")
    monkeypatch.setenv("SKYLINE_DEVICE_CASCADE", "off")


def _engines(n, hub=True, mesh_axis="p", **kw):
    """(port engine, JAX engine), each over an n-place mesh of its package."""
    from jax.sharding import Mesh as JaxMesh
    import jax

    jmesh = JaxMesh(np.asarray(jax.devices()[:n]), (mesh_axis,))
    jeng = JaxEngine(JaxConfig(**kw), mesh=jmesh, telemetry=JaxTelemetry() if hub else None)
    eng = SkylineEngine(EngineConfig(**kw, device="cpu"),
                        mesh=make_mesh(n, axis=mesh_axis, device="cpu"),
                        telemetry=Telemetry() if hub else None)
    return eng, jeng


def _drive(engines, windows, chunk=500, base=0, qid="q"):
    """Each window in chunks through every engine, a trigger after each;
    returns each engine's results."""
    out = [[] for _ in engines]
    for w, x in enumerate(windows):
        ids = np.arange(base, base + x.shape[0], dtype=np.int64)
        base += x.shape[0]
        for s in range(0, x.shape[0], chunk):
            for eng in engines:
                eng.process_records(ids[s : s + chunk], x[s : s + chunk], now_ms=1.0)
        for eng, o in zip(engines, out):
            eng.process_trigger(f"{qid}{w},0", now_ms=2.0)
            o += eng.poll_results()
    return out


def _assert_answers(got, want):
    """Results equal field for field (timing aside), their points byte for
    byte (a NaN coordinate equals itself only by its bytes)."""
    def fields(rs):
        return untimed([{k: v for k, v in r.items() if k != "skyline_points"} for r in rs])

    assert fields(got) == fields(want)
    for a, b in zip(got, want):
        pa = np.asarray(a["skyline_points"], np.float32)
        pb = np.asarray(b["skyline_points"], np.float32)
        assert pa.tobytes() == pb.tobytes()
        assert points_digest_of(pa) == points_digest_of(pb)


GRID = [(d, n, policy, algo)
        for d in (3, 8) for n in (2, 4)
        for policy in ("incremental", "lazy", "overlap")
        for algo in (("mr-angle", "mr-grid", "mr-dim") if d == 3 else ("mr-angle",))]


@pytest.mark.parametrize("d,n,policy,algo", GRID)
def test_meshed_engine_matches_jax(d, n, policy, algo):
    """Two windows (800 rows at d = 3, 400 at d = 8), P = 8: answers,
    digests, survivors per partition, ``stats()`` and the hub's planes equal
    the JAX meshed engine's, and the answers equal the flat port engine's."""
    kw = dict(parallelism=4, algo=algo, dims=d, domain_max=1000.0, buffer_size=256,
              overlap_rows=600, flush_policy=policy, emit_skyline_points=True)
    windows = [mesh_rows("anti", d, 800 if d == 3 else 400, seed=s + d) for s in range(2)]
    eng, jeng = _engines(n, **kw)
    flat = SkylineEngine(EngineConfig(**kw, device="cpu"))
    got, want, plain = _drive([eng, jeng, flat], windows, chunk=300)
    _assert_answers(got, want)
    assert [r["skyline_points"] for r in got] == [r["skyline_points"] for r in plain]
    _assert_same_plane(eng, jeng)
    st = eng.stats()
    assert st["meshed"] is True and st["merge_cache"]["hits"] == 0
    assert eng.telemetry.explain.snapshot()[-1]["merge"]["path"] == "host"


@pytest.mark.parametrize("kind", ["inf", "nan", "signed_zero", "mixed", "duplicates",
                                  "inf_ties"])
@pytest.mark.parametrize("policy", ["incremental", "lazy", "overlap"])
def test_meshed_engine_awkward_rows_match_jax(kind, policy):
    """The value hazards at d = 3, P = 8 over four places: the same answer
    bytes, survivors and ``stats()`` as the JAX meshed engine."""
    kw = dict(parallelism=4, algo="mr-grid", dims=3, domain_max=1.0, buffer_size=128,
              overlap_rows=400, flush_policy=policy, emit_skyline_points=True)
    eng, jeng = _engines(4, hub=False, **kw)
    got, want = _drive([eng, jeng], [mesh_rows(kind, 3, 800, seed=1)], chunk=200)
    _assert_answers(got, want)
    assert untimed(eng.stats(include_skyline_counts=True)) == untimed(
        jeng.stats(include_skyline_counts=True))


def test_meshed_set_gates_and_state_match_jax():
    """``PartitionSet(mesh=)`` at d = 2 (no sweep under a mesh), lazy and
    incremental: the state's bytes, the merge (flat: no cache, no tree),
    its profiler variants and the refusals equal the reference's."""
    from skyline_tpu.ops import cascade as jax_cascade
    from skyline_tpu_torch.ops import cascade

    rng = np.random.default_rng(4)
    for policy in ("lazy", "incremental"):
        sets = (PartitionSet(8, 2, 64, flush_policy=policy, mesh=make_mesh(4, device="cpu")),
                JaxPartitionSet(8, 2, 64, flush_policy=policy, mesh=jax_make_mesh(4)))
        x = mesh_rows("anti", 2, 900, seed=2)
        pids = rng.integers(0, 8, x.shape[0])
        for s in sets:
            for p in range(8):
                s.add_batch(p, np.ascontiguousarray(x[pids == p]), max_id=900, now_ms=0.0)
            s.flush_all()
        a, b = merge_state(sets[0]), merge_state(sets[1])
        assert all(np.asarray(u).tobytes() == np.asarray(v).tobytes() for u, v in zip(a, b))
        assert [sets[0].skyline_host(p).tobytes() for p in range(8)] == [
            sets[1].skyline_host(p).tobytes() for p in range(8)]
        assert sets[0].merge_tree_merges == sets[1].merge_tree_merges == 0
        assert sets[0].merge_cache_hits == sets[1].merge_cache_hits == 0
    assert not cascade.applies("flush_prefilter", d=3, meshed=True)
    assert not jax_cascade.applies("flush_prefilter", d=3, meshed=True)
    with pytest.raises(ValueError, match="single-device"):
        PartitionSet(8, 3, flush_policy="lazy", route=("mr-angle", 1.0),
                     mesh=make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="divisible"):
        PartitionSet(6, 3, mesh=make_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="divisible"):
        SkylineEngine(EngineConfig(parallelism=3, dims=2, device="cpu"),
                      mesh=make_mesh(8, device="cpu"))
    with pytest.raises(ValueError, match="single-device"):
        SkylineEngine(EngineConfig(dims=3, flush_policy="lazy", ingest="device", device="cpu"),
                      mesh=make_mesh(2, device="cpu"))


def test_meshed_lazy_sequential_queries_and_growth_match_jax():
    """Two queries under the meshed lazy policy (the second runs the meshed
    cleanup over a non-empty state), then a growth of the sharded buffers
    past 1,024 rows: the answers equal the reference's."""
    kw = dict(parallelism=4, algo="mr-dim", dims=3, domain_max=2000.0,
              flush_policy="lazy", emit_skyline_points=True)
    eng, jeng = _engines(4, hub=False, **kw)
    rng = np.random.default_rng(9)
    windows = [np.abs(1500 - rng.uniform(0, 1000, (3000, 3))).astype(np.float32)
               for _ in range(2)]
    got, want = _drive([eng, jeng], windows, chunk=1000)
    _assert_answers(got, want)
    assert eng.pset._cap == jeng.pset._cap > 1024


def test_checkpoint_across_topologies_matches_jax(tmp_path):
    """A meshed engine saved on four places, restored flat, saved again and
    restored on two places: every step's next answer equals the JAX
    package's over the same moves, and the uninterrupted engine's."""
    kw = dict(parallelism=4, algo="mr-angle", dims=3, domain_max=1000.0, buffer_size=128,
              flush_policy="lazy", emit_skyline_points=True)
    x = mesh_rows("anti", 3, 3000, seed=8)
    eng, jeng = _engines(4, hub=False, **kw)
    whole = SkylineEngine(EngineConfig(**kw, device="cpu"))
    _drive([eng, jeng, whole], [x[:1000]], qid="a")
    ckpt.save_engine(eng, str(tmp_path / "m4.npz"))
    jax_ckpt.save_engine(jeng, str(tmp_path / "j4.npz"))
    flat = ckpt.load_engine(str(tmp_path / "m4.npz"), device="cpu")
    jflat = jax_ckpt.load_engine(str(tmp_path / "j4.npz"))
    assert flat.mesh is None and jflat.mesh is None
    got = _drive([flat, jflat, whole], [x[1000:2000]], base=1000, qid="b")
    _assert_answers(got[0], got[1])
    assert got[0][0]["skyline_points"] == got[2][0]["skyline_points"]
    ckpt.save_engine(flat, str(tmp_path / "f.npz"))
    jax_ckpt.save_engine(jflat, str(tmp_path / "jf.npz"))
    m2 = ckpt.load_engine(str(tmp_path / "f.npz"), mesh=make_mesh(2, device="cpu"))
    jm2 = jax_ckpt.load_engine(str(tmp_path / "jf.npz"), mesh=jax_make_mesh(2))
    assert m2.stats()["meshed"] and jm2.stats()["meshed"]
    got = _drive([m2, jm2, whole], [x[2000:]], base=2000, qid="c")
    _assert_answers(got[0], got[1])
    assert got[0][0]["skyline_points"] == got[2][0]["skyline_points"]


def _unmerged_spans(mesh, n, axis):
    """``device_spans`` as if every place sat on a device of its own."""
    from skyline_tpu_torch.parallel.mesh import split_rows

    return list(zip(split_rows(mesh, n, axis), mesh.axis_places(axis)))


@pytest.mark.parametrize("per_place", [False, True])
@pytest.mark.parametrize("policy", ["incremental", "lazy", "overlap"])
def test_meshed_steps_per_device_run(monkeypatch, policy, per_place):
    """Places on one device step as one batched call over every partition;
    places on devices of their own (forced here by ``device_spans`` without
    the merge) keep their slices of the state between steps (``Placed``),
    each stepped on its own. Both equal the JAX meshed engine's answers and
    ``stats()``, with one core call a meshed step, or one a place."""
    from skyline_tpu_torch.parallel import mesh as mesh_mod
    from skyline_tpu_torch.stream import window

    calls = {"core": 0, "steps": 0}
    for name in ("merge_step_active", "sfs_round", "sfs_cleanup"):
        real = getattr(window, name)

        def counted(*a, _real=real, **kw):
            calls["core"] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(window, name, counted)
    real_per_place = window._per_place

    def per_place(*a):
        run = real_per_place(*a)

        def step(*ins):
            calls["steps"] += 1
            return run(*ins)

        return step

    monkeypatch.setattr(window, "_per_place", per_place)
    real_split = mesh_mod.Placed.split.__func__

    def split(cls, *a):
        calls["splits"] += 1
        return real_split(cls, *a)

    calls["splits"] = 0
    monkeypatch.setattr(mesh_mod.Placed, "split", classmethod(split))
    for name in ("meshed_merge_step", "meshed_sfs_round", "meshed_sfs_cleanup"):
        getattr(window, name).cache_clear()
    if per_place:
        monkeypatch.setattr(mesh_mod, "device_spans", _unmerged_spans)
    kw = dict(parallelism=8, algo="mr-angle", dims=3, domain_max=1000.0, buffer_size=32,
              overlap_rows=600, flush_policy=policy, emit_skyline_points=True)
    eng, jeng = _engines(4, hub=False, **kw)
    windows = [mesh_rows("anti", 3, 900, seed=s + 40) for s in range(2)]
    got, want = _drive([eng, jeng], windows, chunk=300)
    for name in ("meshed_merge_step", "meshed_sfs_round", "meshed_sfs_cleanup"):
        getattr(window, name).cache_clear()
    _assert_answers(got, want)
    assert untimed(eng.stats()) == untimed(jeng.stats())
    assert calls["steps"] > 0
    assert calls["core"] == calls["steps"] * (4 if per_place else 1)
    # the slices stay where they are between steps: a split only after a
    # read of the whole state (a trigger's host path)
    assert calls["splits"] <= calls["steps"]
    if per_place and policy == "incremental":
        assert calls["splits"] < calls["steps"]


def test_meshed_engine_custom_axis_name():
    """A mesh whose first axis is not named "p" works end to end (ingest
    and the sharded merge)."""
    kw = dict(parallelism=4, algo="mr-grid", dims=2, domain_max=100.0, buffer_size=64,
              emit_skyline_points=True)
    eng, jeng = _engines(4, hub=False, mesh_axis="workers", **kw)
    got, want = _drive([eng, jeng], [mesh_rows("uniform", 2, 1500, seed=3) / 10.0])
    _assert_answers(got, want)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("n", [2, 4])
def test_meshed_sliding_engine_matches_jax(n, d):
    """Window 1,200, slide 400, a result at every slide and a trigger at
    the end: the meshed sliding engine equals the JAX meshed one and the
    flat port engine (sizes, flags and point bytes)."""
    kw = dict(parallelism=4, algo="mr-angle", dims=d, domain_max=1000.0,
              emit_skyline_points=True)
    x = mesh_rows("anti", d, 3000, seed=d)
    engines = (
        SlidingEngine(EngineConfig(**kw, device="cpu"), window_size=1200, slide=400,
                      mesh=make_mesh(n, device="cpu"), emit_per_slide=True),
        JaxSliding(JaxConfig(**kw), window_size=1200, slide=400, mesh=jax_make_mesh(n),
                   emit_per_slide=True),
        SlidingEngine(EngineConfig(**kw, device="cpu"), window_size=1200, slide=400,
                      emit_per_slide=True),
    )
    out = _drive(engines, [x], chunk=700)
    assert len(out[0]) == len(out[1]) == len(out[2]) > 6
    for a, b, c in zip(*out):
        assert untimed(a) == untimed(b)
        assert a["skyline_points"] == c["skyline_points"]
    assert untimed(engines[0].stats()) == untimed(engines[1].stats())
    assert engines[0].stats()["meshed"] and not engines[2].stats()["meshed"]
    with pytest.raises(ValueError, match="divisible"):
        SlidingEngine(EngineConfig(parallelism=3, dims=2, device="cpu"), window_size=100,
                      slide=50, mesh=make_mesh(4, device="cpu"))


@pytest.mark.parametrize("n", [2, 4])
def test_meshed_sliding_engine_per_place_copies(monkeypatch, n):
    """The sliding engine with every place on a device of its own (forced as
    above): each place keeps its slice of the rings and slides it; the
    answers and ``stats()`` equal the JAX meshed engine's."""
    from skyline_tpu_torch.parallel import mesh as mesh_mod
    from skyline_tpu_torch.parallel.mesh import Placed

    monkeypatch.setattr(mesh_mod, "device_spans", _unmerged_spans)
    kw = dict(parallelism=4, algo="mr-angle", dims=4, domain_max=1000.0,
              emit_skyline_points=True)
    x = mesh_rows("anti", 4, 2400, seed=n + 7)
    engines = (
        SlidingEngine(EngineConfig(**kw, device="cpu"), window_size=1200, slide=400,
                      mesh=make_mesh(n, device="cpu"), emit_per_slide=True),
        JaxSliding(JaxConfig(**kw), window_size=1200, slide=400, mesh=jax_make_mesh(n),
                   emit_per_slide=True),
    )
    assert isinstance(engines[0]._rings, Placed) and len(engines[0]._rings.parts) == n
    out = _drive(engines, [x], chunk=700)
    assert len(out[0]) == len(out[1]) > 4
    for a, b in zip(*out):
        assert untimed(a) == untimed(b)
    assert untimed(engines[0].stats()) == untimed(engines[1].stats())


def test_worker_mesh_matches_jax(monkeypatch):
    """``--mesh 2 --device cpu`` through ``build_worker`` over a
    ``MemoryBus`` against the JAX worker built with ``cfg.build_mesh()``:
    the same output lines, the event clock pinned in both."""
    import skyline_tpu.bridge.worker as jworker
    from test_torch_worker import PinnedClock, lines_of

    monkeypatch.setattr(jworker, "time", PinnedClock())
    monkeypatch.setattr(tworker, "time", PinnedClock())
    rows = (mesh_rows("anti", 3, 1200, seed=6)).astype(np.int64)
    argv = ["--mesh", "2", "--dims", "3", "--domain", "1000", "--parallelism", "4",
            "--emit-skyline-points", "--flush-policy", "lazy"]
    outs = []
    for kind in ("port", "jax"):
        if kind == "port":
            cfg = tconfig.parse_job_args(argv + ["--device", "cpu"])
            bus = MemoryBus()
            w = tworker.build_worker(cfg, bus=bus)
        else:
            cfg = jconfig.parse_job_args(argv)
            bus = JBus()
            w = jworker.SkylineWorker(bus, cfg.engine_config(), mesh=cfg.build_mesh())
        assert w.engine.stats()["meshed"]
        out = bus.consumer("output-skyline")
        bus.produce_many("input-tuples", lines_of(rows))
        while w.step(max_records=400):
            pass
        bus.produce("queries", "q1,0")
        got = []
        for _ in range(20):
            w.step(max_records=400)
            got += out.poll()
            if got:
                break
        w.close()
        outs.append([{k: v for k, v in json.loads(line).items()
                      if not k.endswith("_ms") and k != "trace_id"} for line in got])
    assert outs[0] == outs[1] and len(outs[0]) == 1

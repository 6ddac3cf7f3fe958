"""The port's host-side planes and the flat global merge against the JAX
package: bucket arithmetic, routing, generators, wire formats, the device
merge function; plus the package's import and device rules."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.bridge import wire as jwire
from skyline_tpu.parallel.partitioners import partition_ids_np as j_route
from skyline_tpu.stream import engine as jengine
from skyline_tpu.stream import window as jwin
from skyline_tpu.utils.buckets import next_pow2 as j_next_pow2
from skyline_tpu.workload import generators as jgen
from skyline_tpu_torch.bridge import wire as twire
from skyline_tpu_torch.ops.dispatch import skyline_keep_np
from skyline_tpu_torch.parallel.partitioners import partition_ids_np as t_route
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream import engine as tengine
from skyline_tpu_torch.stream import window as twin
from skyline_tpu_torch.stream.batched import PartitionSet
from skyline_tpu_torch.utils.buckets import next_pow2 as t_next_pow2
from skyline_tpu_torch.utils.devices import resolve_device
from skyline_tpu_torch.workload import generators as tgen

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def test_bucket_arithmetic_matches_jax():
    ns = list(range(0, 70000, 37)) + [2**k + o for k in range(10, 22) for o in (-1, 0, 1)]
    for n in ns:
        assert twin._active_bucket(n) == jwin._active_bucket(n), n
        assert twin._next_pow2(n) == jwin._next_pow2(n), n
        assert t_next_pow2(n, 256) == j_next_pow2(n, 256)
    assert twin._ladder_min() == jwin._ladder_min()
    assert twin.DEFAULT_BUFFER_SIZE == jwin.DEFAULT_BUFFER_SIZE
    assert twin._MIN_CAP == jwin._MIN_CAP


@pytest.mark.parametrize("algo", ["mr-dim", "mr-grid", "mr-angle"])
@pytest.mark.parametrize("d", [1, 2, 3, 8])
def test_routing_matches_jax(rng, algo, d):
    x = rng.integers(0, 10001, size=(5000, d)).astype(np.float32)
    x[:50] = 0.0  # atan2(0, 0) rows
    assert np.array_equal(t_route(x, algo, 8, 10000.0), j_route(x, algo, 8, 10000.0))
    with pytest.raises(ValueError):
        t_route(x, "mr-nope", 8, 10000.0)


@pytest.mark.parametrize("dist", ["uniform", "correlated", "anti_correlated"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_generators_match_jax(dist, d):
    a = jgen.generate(dist, np.random.default_rng(3), 2000, d, 0, 10000)
    b = tgen.generate(dist, np.random.default_rng(3), 2000, d, 0, 10000)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_wire_matches_jax():
    for payload in ("q1,500", "q2", "q3,abc", " q4 , 7 "):
        assert twire.parse_trigger(payload) == jwire.parse_trigger(payload)
    assert twire.format_trigger("q", 9) == jwire.format_trigger("q", 9)
    assert twire.RESULT_FIELDS == jwire.RESULT_FIELDS
    res = {
        "skyline_points": [[1.0, 2.0]], "query_id": "q", "record_count": 5,
        "skyline_size": 1, "optimality": 0.123456, "ingestion_time_ms": 1,
        "local_processing_time_ms": 2, "global_processing_time_ms": 3,
        "total_processing_time_ms": 4, "query_latency_ms": 5,
    }
    assert twire.format_result(res) == jwire.format_result(res)
    assert json.loads(twire.format_result(res))["optimality"] == 0.1235


def test_engine_helpers_match_jax():
    for payload in ("q,12", "q", "q,-3", "q,x"):
        assert tengine.echo_record_count(payload) == jengine.echo_record_count(payload)
    args = ([3, 0, 5], [6, 0, 10], 8)
    assert tengine.optimality_mean(*args) == jengine.optimality_mean(*args)


@pytest.mark.parametrize("d", [3, 8])
def test_global_merge_device_matches_jax(rng, d):
    """The flat merge over one stacked state: union, survivor mask, packed
    stats and compacted points."""
    P, cap = 8, 2048
    sky = np.full((P, cap, d), np.inf, np.float32)
    counts = rng.integers(0, 300, P)
    counts[2] = 0
    for p in range(P):
        sky[p, : counts[p]] = rng.integers(0, 50, size=(counts[p], d))
    active = twin._active_bucket(int(counts.max()))
    union_cap = twin._active_bucket(int(counts.sum()))
    ju, jk, js = jwin.global_merge_stats_device(
        jnp.asarray(sky), jnp.asarray(counts, jnp.int32), active, union_cap
    )
    tu, tk, ts = twin.global_merge_stats_device(
        torch.from_numpy(sky), torch.from_numpy(counts), active, union_cap
    )
    assert tu.numpy().tobytes() == np.asarray(ju).tobytes()
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    g = int(ts[-1])
    out_cap = twin._next_pow2(g)
    jp = jwin.global_points_device(ju, jk, out_cap)
    tp = twin.global_points_device(tu, tk, out_cap)
    assert tp.numpy().tobytes() == np.asarray(jp).tobytes()


def test_skyline_keep_np_matches_jax(rng):
    from skyline_tpu.ops.dispatch import skyline_keep_np as j_keep

    x = rng.integers(0, 20, size=(1500, 4)).astype(np.float32)
    assert np.array_equal(skyline_keep_np(x, "cpu"), j_keep(x))
    assert skyline_keep_np(np.zeros((0, 4), np.float32), "cpu").shape == (0,)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, skyline_tpu_torch, skyline_tpu_torch.stream.engine, "
        "skyline_tpu_torch.ops.dominance_kernels, skyline_tpu_torch.workload.generators, "
        "skyline_tpu_torch.bridge.wire, skyline_tpu_torch.stream.device_window, "
        "skyline_tpu_torch.utils.knobs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'skyline_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_import_nothing_of_the_reference():
    for path in (ROOT / "skyline_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "from skyline_tpu." not in text and "import skyline_tpu." not in text, path
        assert "import jax" not in text and "from jax" not in text, path


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineConfig(dims=4)
    cfg = EngineConfig(dims=4, device="cpu")
    cfg.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        SkylineEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        PartitionSet(8, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_unported_paths_refuse():
    """The refusals the reference also makes: device ingest under the
    incremental policy (``tests/test_device_ingest.py``), an unknown ingest
    mode or flush policy. Every policy and d <= 2 now construct."""
    with pytest.raises(ValueError):
        SkylineEngine(
            EngineConfig(dims=4, flush_policy="incremental", ingest="device", device="cpu")
        )
    with pytest.raises(ValueError):
        PartitionSet(8, 4, flush_policy="incremental", route=("mr-dim", 100.0), device="cpu")
    with pytest.raises(ValueError):
        SkylineEngine(EngineConfig(dims=4, ingest="bogus", device="cpu"))
    with pytest.raises(ValueError):
        PartitionSet(8, 4, flush_policy="eager", device="cpu")
    for policy in ("incremental", "lazy", "overlap"):
        for d in (1, 2, 4):
            assert PartitionSet(8, d, flush_policy=policy, device="cpu").dims == d
    eng = SkylineEngine(EngineConfig(dims=4, ingest="auto", device="cpu"))
    assert eng.pset.device.type == "cpu"


@pytest.mark.parametrize("ingest", ["auto", "host", "device"])
def test_ingest_resolution(ingest, monkeypatch):
    """"auto" is device ingest on a card and host ingest on the CPU, for
    the lazy and overlap policies; the incremental policy (the default)
    always ingests on the host, as in the reference."""
    for policy in ("lazy", "overlap"):
        eng = SkylineEngine(
            EngineConfig(dims=4, ingest=ingest, flush_policy=policy, device="cpu")
        )
        assert eng.pset.device_ingest == (ingest == "device")
    # on a card (the device check is all "auto" reads), "auto" is device
    monkeypatch.setattr(tengine, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(tengine, "PartitionSet", lambda *a, **kw: kw)
    for policy in ("lazy", "overlap"):
        eng = SkylineEngine(
            EngineConfig(dims=4, ingest=ingest, flush_policy=policy, device="cpu")
        )
        assert (eng.pset["route"] is not None) == (ingest != "host")
    if ingest != "device":
        eng = SkylineEngine(EngineConfig(dims=4, ingest=ingest, device="cpu"))
        assert eng.pset["route"] is None

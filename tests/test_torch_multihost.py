"""The port's multi-host two-phase (``skyline_tpu_torch/parallel/
multihost.py``) against the JAX package's on the CPU.

In one process: the 2x4, 4x2 and 1x8 ``(host, chip)`` meshes (JAX on the
eight virtual CPU devices of ``conftest.py``, the port with every place on
the CPU), ``host_keep``, ``global_keep`` and ``overflowed`` bit for bit,
exact and with an overflowing ``host_cap`` (1,024 rows a host of 4,096:
the same superset), on ordinary rows and on the value hazards; the mesh
constructor's shapes and errors. Across processes: two ``gloo`` ranks on the
CPU, one host each, whose joined masks equal JAX's 2x4 result."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from skyline_tpu.parallel.multihost import build_hierarchical_two_phase as jax_hier
from skyline_tpu.parallel.multihost import make_host_chip_mesh as jax_host_mesh
from skyline_tpu.parallel.multihost import shard_rows_2d as jax_shard_2d
from skyline_tpu_torch.ops.dominance import skyline_mask
from skyline_tpu_torch.parallel.multihost import (
    CHIP_AXIS,
    HOST_AXIS,
    build_hierarchical_two_phase,
    init_multihost,
    make_host_chip_mesh,
    shard_rows_2d,
)

from test_torch_mesh import mesh_rows

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _jax_run(shape, x, valid, host_cap=None):
    mesh = jax_host_mesh(*shape)
    step = jax_hier(mesh, rows_per_shard=x.shape[0] // 8, host_cap=host_cap,
                    local_block=x.shape[0] // 8, cross_block=128)
    hk, gk, ov = step(*jax_shard_2d(mesh, x, valid))
    return np.asarray(hk), np.asarray(gk), int(ov)


def _port_run(shape, x, valid, host_cap=None):
    mesh = make_host_chip_mesh(*shape, places=8, device="cpu")
    step = build_hierarchical_two_phase(mesh, rows_per_shard=x.shape[0] // 8,
                                        host_cap=host_cap, local_block=64, cross_block=128)
    hk, gk, ov = step(x, valid)
    return hk.numpy(), gk.numpy(), int(ov)


def _overflow_rows(n=8192, d=8, seed=0):
    """The reference test's anti-correlated rows: most survive locally, so
    a 1,024-row host buffer overflows."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 100, size=(n, 1)).astype(np.float32)
    x = np.concatenate([base, 100.0 - base + rng.normal(0, 0.01, size=(n, 1))], axis=1)
    return np.concatenate([x, rng.uniform(0, 100, size=(n, d - 2))], axis=1).astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform", "anti", "inf", "nan", "signed_zero", "mixed",
                                  "duplicates", "inf_ties"])
@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8)])
def test_hierarchical_matches_jax(shape, kind):
    """512 rows of d = 4, a tenth invalid: the three outputs equal the
    reference's bit for bit, and the global mask is the exact one."""
    x = mesh_rows(kind, 4, 512, seed=11)
    valid = np.random.default_rng(7).random(512) < 0.9
    want = _jax_run(shape, x, valid)
    got = _port_run(shape, x, valid)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[2] == want[2] == 0
    assert np.array_equal(got[1], skyline_mask(torch.from_numpy(x), torch.from_numpy(valid)).numpy())


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_overflowing_host_cap_matches_jax(shape):
    """8,192 rows, ``host_cap`` 1,024 against 4,096 (2x4) or 2,048 (4x2)
    rows a host: the same overflow count, the same host masks and the same
    superset of the exact skyline as the reference."""
    x = _overflow_rows()
    valid = np.ones(x.shape[0], dtype=bool)
    exact = _port_run(shape, x, valid)
    assert exact[2] == 0
    want = _jax_run(shape, x, valid, host_cap=1024)
    got = _port_run(shape, x, valid, host_cap=1024)
    assert got[2] == want[2] > 0
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert np.all(got[1][exact[1]]) and got[1].sum() > exact[1].sum()


def test_mesh_shapes_and_errors_match_jax():
    mesh = make_host_chip_mesh(2, 4, places=8, device="cpu")
    ref = jax_host_mesh(2, 4)
    assert mesh.axis_names == ref.axis_names == (HOST_AXIS, CHIP_AXIS)
    assert mesh.devices.shape == ref.devices.shape == (2, 4)
    assert make_host_chip_mesh(2, places=8, device="cpu").grid == (2, 4)
    assert make_host_chip_mesh(places=8, device="cpu").grid == (1, 8)
    for args, kw in (((3,), {}), ((2, 8), {})):
        with pytest.raises(ValueError) as port:
            make_host_chip_mesh(*args, places=8, device="cpu", **kw)
        with pytest.raises(ValueError) as jax_err:
            jax_host_mesh(*args, **kw)
        assert str(port.value) == str(jax_err.value)
    for cap in (100, 1500):
        with pytest.raises(ValueError) as port:
            build_hierarchical_two_phase(mesh, rows_per_shard=64, host_cap=cap)
        with pytest.raises(ValueError) as jax_err:
            jax_hier(ref, rows_per_shard=64, host_cap=cap)
        assert str(port.value) == str(jax_err.value)
    # host_cap == rows_per_host need not be a multiple of 1,024
    build_hierarchical_two_phase(mesh, rows_per_shard=100, host_cap=400)
    xs, vs = shard_rows_2d(mesh, mesh_rows("uniform", 3, 64), np.ones(64, bool))
    assert [t.shape[0] for t in xs] == [8] * 8 and len(vs) == 8


def test_init_multihost_without_a_group_is_a_noop(monkeypatch):
    for name in ("SKYLINE_COORDINATOR", "SKYLINE_NUM_PROCESSES", "SKYLINE_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    init_multihost(device="cpu")
    monkeypatch.setenv("SKYLINE_NUM_PROCESSES", "1")
    init_multihost(device="cpu")
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("SKYLINE_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        init_multihost(device="cpu")


_RANK = """
import sys
import numpy as np
import torch
from skyline_tpu_torch.parallel.multihost import (
    build_hierarchical_two_phase, init_multihost, make_host_chip_mesh)

torch.set_num_threads(1)
rank, out = int(sys.argv[1]), sys.argv[2]
init_multihost(device="cpu")  # SKYLINE_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID
mesh = make_host_chip_mesh(chips_per_host=4, device="cpu")
assert mesh.grid == (2, 4) and mesh.process_index == rank
data = np.load(sys.argv[3])
res = {}
for tag, cap in (("exact", None), ("capped", 1024)):
    x = data["x_" + tag]
    step = build_hierarchical_two_phase(mesh, rows_per_shard=x.shape[0] // 8,
                                        host_cap=cap, local_block=64, cross_block=128)
    hk, gk, ov = step(x, np.ones(x.shape[0], dtype=bool))
    res["hk_" + tag], res["gk_" + tag], res["ov_" + tag] = hk.numpy(), gk.numpy(), int(ov)
np.savez(out, **res)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_jax(tmp_path):
    """Two processes, one host of four CPU chips each, the host stage over
    ``torch.distributed`` (gloo): each rank's rows of ``host_keep`` and
    ``global_keep``, joined in rank order, and the summed overflow equal
    JAX's 2x4 result, exact and with an overflowing ``host_cap``."""
    x_exact = mesh_rows("mixed", 4, 512, seed=5)
    x_capped = _overflow_rows(seed=3)
    np.savez(tmp_path / "in.npz", x_exact=x_exact, x_capped=x_capped)
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), SKYLINE_COORDINATOR=f"127.0.0.1:{port}",
                   SKYLINE_NUM_PROCESSES="2", SKYLINE_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(rank), str(tmp_path / f"r{rank}.npz"),
             str(tmp_path / "in.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    ranks = [np.load(tmp_path / f"r{r}.npz") for r in range(2)]
    for tag, x, cap in (("exact", x_exact, None), ("capped", x_capped, 1024)):
        want = _jax_run((2, 4), x, np.ones(x.shape[0], dtype=bool), host_cap=cap)
        assert np.array_equal(np.concatenate([r["hk_" + tag] for r in ranks]), want[0])
        assert np.array_equal(np.concatenate([r["gk_" + tag] for r in ranks]), want[1])
        assert [int(r["ov_" + tag]) for r in ranks] == [want[2]] * 2
    assert want[2] > 0

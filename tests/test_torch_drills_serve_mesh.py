"""The serve and mesh drills (``skyline_tpu_torch/deploy/drills``) on the
CPU, held against the JAX package.

Each drill runs as a user runs it, ``python -m
skyline_tpu_torch.deploy.drills <name> --device cpu --outcomes-only`` (every
outcome the reference script asserts; its wall-clock bounds are the card
run's), and must exit 0 with its PASS line. The same drill steps then run in
process through the JAX package's objects (``run(ns)`` is written against a
namespace of the package under test) over the same streams, and the port's
evidence — published digests, sizes, versions, the chip-prune counter, the
explain attribution, the per-chip ingest — must equal the JAX drill's.

Tolerance: exact (digests of the published bytes, integer counters).
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from skyline_tpu_torch.deploy.drills import mesh, serve

REPO = Path(__file__).resolve().parents[1]


def run_drill(name: str, timeout: int = 300) -> dict:
    """The CLI on the CPU: exit 0, its PASS line, its evidence line."""
    r = subprocess.run([sys.executable, "-m", "skyline_tpu_torch.deploy.drills", name,
                        "--device", "cpu", "--outcomes-only"], cwd=REPO,
                       env=dict(os.environ), capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert f"[{name}-smoke] PASS" in r.stdout
    ev = json.loads(r.stdout.strip().splitlines()[-1])
    assert ev["ok"] is True and ev["device"] == "cpu" and ev["bounds"] is False
    assert ev["launches"] == {}  # the CPU runs the plain versions
    return ev["drills"][name]


def jax_job_ns() -> SimpleNamespace:
    from skyline_tpu.bridge import MemoryBus, SkylineWorker
    from skyline_tpu.bridge.wire import format_trigger, format_tuple_line
    from skyline_tpu.ops import skyline_np
    from skyline_tpu.serve.snapshot import points_digest
    from skyline_tpu.utils.config import parse_job_args
    from skyline_tpu.workload.generators import anti_correlated

    return SimpleNamespace(
        parse_job_args=parse_job_args, MemoryBus=MemoryBus, SkylineWorker=SkylineWorker,
        format_trigger=format_trigger, format_tuple_line=format_tuple_line,
        skyline_np=skyline_np, points_digest=points_digest, anti_correlated=anti_correlated)


def test_serve_drill_matches_jax(capsys):
    port = run_drill("serve")
    ref = serve.run(jax_job_ns(), bounds=False)
    assert "[serve-smoke] PASS" in capsys.readouterr().out
    assert port == ref
    assert port["v1"]["version"] == 1 and port["forced"]["head_version"] == 2
    assert port["forced"]["size"] > port["v1"]["size"] > 0


def test_mesh_drill_matches_jax(capsys):
    import jax

    if jax.device_count() < 4:
        pytest.skip("the JAX mesh drill needs 4 devices")
    port = run_drill("mesh")
    ref = mesh.run(jax_job_ns(), bounds=False)
    assert "[mesh-smoke] PASS" in capsys.readouterr().out
    assert port == ref
    assert port["chips_pruned"] >= 1 and port["digest"] == port["flat_digest"]
    assert port["explain_path"] == "sharded_tree"


def test_mesh_drill_counts_negative_zeros():
    import numpy as np

    assert mesh.negative_zeros(np.array([[0.0, -0.0], [1.0, -0.0]])) == 2
    assert mesh.negative_zeros(np.zeros((3, 2))) == 0

"""Whole runs on the CPU at a small size, the look for a card skipped: a
sound run comes out correct, and each fault planted in the timed path
underneath comes out not correct."""

import json
import time

import numpy as np
import pytest

from skybench import harness
from skybench.tests.test_skybench_discovery import copy_benchmark
from skyline_tpu_torch.distributed import sharded
from skyline_tpu_torch.stream import SkylineEngine

TINY = {"window_rows": 5000, "chunk_rows": 1024, "pool_windows": 1, "check_windows": 1}
# cells that wait under PERF.md's open questions: their configuration files
# stay, and these tests run them from a copy whose BENCHMARK.json has them
WAITING = {
    "anti3d_mrangle.bulk": ("anti3d_mrangle", 1),
    "indep8d_mrdim_x4.bulk": ("indep8d_mrdim_x4", 4),
}
SHARDED = "indep8d_mrdim_x4.bulk"
CELLS = harness.cell_names() + list(WAITING)


@pytest.fixture(scope="module")
def waiting_root(tmp_path_factory):
    root = copy_benchmark(tmp_path_factory.mktemp("waiting"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell, (config, chips) in WAITING.items():
        bench["configs"].append({"name": config, "source": "test",
                                 "file": f"skybench/configs/{config}.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": cell, "config": config, "traffic": "bulk",
                                   "chips": chips, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(cell, root, seed=2**31 + 3):
    return harness.run_cell(cell, seed, 0.01, False, t_start=time.perf_counter(), device="cpu",
                            root=root, overrides=TINY, log=lambda *_: None)


def root_of(cell, request):
    return request.getfixturevalue("waiting_root") if cell in WAITING else harness.ROOT


def state_unchanged(mp):
    """Ingest returns with the engine's state as it was."""
    mp.setattr(SkylineEngine, "process_records", lambda self, ids, values, *a, **k: None)


def half_batch(mp):
    """Each chunk's second half left out."""
    orig = SkylineEngine.process_records

    def half(self, ids, values, *a, **k):
        h = values.shape[0] // 2
        return orig(self, ids[:h], values[:h], *a, **k)

    mp.setattr(SkylineEngine, "process_records", half)


def answer_altered(mp):
    """One coordinate of one point changed where the answer is emitted."""
    orig = SkylineEngine._emit_result

    def altered(self, q, *, points=None, **k):
        if points is not None and len(points):
            points = np.array(points, dtype=np.float32)
            points[0, 0] += 1.0
        return orig(self, q, points=points, **k)

    mp.setattr(SkylineEngine, "_emit_result", altered)


def exchange_left_out(mp):
    """The cross-chip tournament's pairs take nothing from their second
    chip: each pair's result is the first chip's rows alone."""
    import torch

    orig = sharded.tree_pair_merge

    def first_only(av, ap, ac, bv, bp, bc, out_cap):
        return orig(av, ap, ac, bv, bp, torch.zeros_like(bc), out_cap)

    mp.setattr(sharded, "tree_pair_merge", first_only)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, answer_altered, exchange_left_out)}


def applies(cell, fault):
    """A cell on one chip has no exchange between chips to leave out."""
    return fault != "exchange_left_out" or cell == SHARDED


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, request):
    out = run(cell, root_of(cell, request))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize(
    "cell,fault", [(c, f) for c in CELLS for f in FAULTS if applies(c, f)]
)
def test_fault_is_caught(cell, fault, monkeypatch, request):
    FAULTS[fault](monkeypatch)
    out = run(cell, root_of(cell, request))
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0

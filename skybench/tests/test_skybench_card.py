"""The benchmark's command on a card: each cell's short run prints one
result line, correct, with its device and its checks."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from skybench import harness

REPO = Path(__file__).resolve().parent.parent.parent


@pytest.mark.cuda
@pytest.mark.parametrize("cell", harness.cell_names())
def test_cell_runs_on_the_card(cell, card):
    import torch

    chips = harness.load_cell(cell).chips
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} asks for {chips} cards")
    p = subprocess.run(
        [sys.executable, "-m", "skybench.run", "--workload", cell, "--seed", "4000000017",
         "--seconds", "2", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == chips
    assert list(out)[-1] == "checks"

"""The control, the plain reference in bfloat16 in the program's place,
fails the comparison on every cell's data and traffic at a size a test run
holds; on the card it runs at the cells' own sizes through
``python3 -m skybench.readings``."""

import pytest

from skybench import harness, readings

SMALL = {"window_rows": 12000, "chunk_rows": 4096}


@pytest.mark.parametrize("cell", harness.cell_names())
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 4_000_000_001])
def test_control_fails(cell, seed):
    got = readings.control_readings(cell, seed, "cpu", SMALL)
    assert got["wrong_rows"] > 0
    assert got["answers"] >= 1

"""The work count against hand-counted windows."""

import numpy as np
import pytest
import torch

from skybench import reference, work


def counted(x):
    x = np.asarray(x, dtype=np.float32)
    sky = x[reference.skyline_mask(torch.from_numpy(x)).numpy()]
    return work.window_work(x.shape[0], x.shape[1], sky)


def test_copies_and_one_dominated_row():
    # skyline [1,2], [2,1], [1,2]; [3,3] dominated (1 pair). Sums all 3:
    # each [1,2] sees 3 rows of sum <= 3 less its 2 equal rows (1 each),
    # [2,1] sees 3 less itself (2): 1 + 1 + 1 + 2 = 5
    w = counted([[1, 2], [2, 1], [3, 3], [1, 2]])
    assert w["pairs"] == 5
    assert w["bytes"] == (4 + 3) * 2 * 4


def test_one_row():
    w = counted([[0, 0, 0]])
    assert w["pairs"] == 0 and w["bytes"] == 2 * 3 * 4
    assert w["bound_by"] == "bytes"
    assert w["floor_s"] == pytest.approx(24 / work.HBM_BYTES_S)


def test_chain_of_equal_sums_and_a_dominator():
    # [1,1] (sum 2) dominates [1,2] and [2,1]; the skyline [0,3], [3,0],
    # [1,1]: [1,1] sees itself only (0), [0,3] and [3,0] see all 3 less
    # themselves (2 each); 2 dominated rows: 2 + 0 + 2 + 2 = 6
    w = counted([[0, 3], [1, 2], [2, 1], [3, 0], [1, 1]])
    assert w["pairs"] == 6


def test_operations_bound_a_large_skyline():
    x = np.stack([np.arange(4000), 3999 - np.arange(4000)], 1)
    w = counted(x)
    assert w["pairs"] == 4000 * 3999
    assert w["bound_by"] == "operations"
    assert w["floor_s"] == pytest.approx(4000 * 3999 * 2 / work.FP32_FLOPS)

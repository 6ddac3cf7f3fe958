"""The plain reference against brute force: small windows full of
duplicates, equal sums and ties, cut into blocks smaller than the window."""

import numpy as np
import pytest
import torch

from skybench import check, data, reference


def brute(x: np.ndarray) -> np.ndarray:
    le = (x[None, :, :] <= x[:, None, :]).all(-1)
    lt = (x[None, :, :] < x[:, None, :]).any(-1)
    return ~(le & lt).any(1)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("dims", [2, 3, 8])
@pytest.mark.parametrize("block", [3, 16, 4096])
def test_mask_matches_brute_force(seed, dims, block):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, size=(300, dims)).astype(np.float32)
    x[50:60] = x[0]  # copies of one row
    got = reference.skyline_mask(torch.from_numpy(x), block=block).numpy()
    np.testing.assert_array_equal(got, brute(x))


def test_equal_sums_and_copies():
    x = np.array(
        [[1, 2], [2, 1], [1, 2], [3, 0], [0, 3], [2, 2], [1, 1], [1, 1]], dtype=np.float32
    )
    got = reference.skyline_mask(torch.from_numpy(x), block=2).numpy()
    # [1, 1] twice dominates [1, 2], [2, 1] and [2, 2]; equal sums 3 of
    # [3, 0] and [0, 3] stay, as do both copies of [1, 1]
    np.testing.assert_array_equal(got, [False, False, False, True, True, False, True, True])


@pytest.mark.parametrize("dist,dims", [("uniform", 8), ("anti_correlated", 3)])
def test_prefixes_match_brute_force(dist, dims):
    (w,) = data.window_pool(2**33 + 7, {"distribution": dist, "low": 0, "high": 50}, dims, 1, 1100)
    prefixes = [1, 2, 5, 9]
    got = reference.prefix_skylines(w, 128, prefixes, "cpu")
    for k in prefixes:
        x = w[: k * 128]
        assert check.wrong_rows(got[k], x[brute(x)]) == 0


def test_control_precision_changes_answers():
    (w,) = data.window_pool(11, {"distribution": "uniform", "low": 0, "high": 10000}, 8, 1, 6000)
    want = reference.prefix_skylines(w, 1000, [6], "cpu")[6]
    got = reference.prefix_skylines(w, 1000, [6], "cpu", compare_dtype=torch.bfloat16)[6]
    assert check.wrong_rows(got, want) > 0


def test_wrong_rows_counts_the_multiset_difference():
    a = np.array([[1, 2], [1, 2], [0, 5]], dtype=np.float32)
    assert check.wrong_rows(a, a[[2, 1, 0]]) == 0
    assert check.wrong_rows(a, a[:2]) == 1
    assert check.wrong_rows(a, a[[0, 2]]) == 1
    assert check.wrong_rows(a, np.array([[1, 2], [0, 6]], dtype=np.float32)) == 3
    assert check.wrong_rows(np.array([[-0.0, 1]], np.float32), np.array([[0.0, 1]], np.float32)) == 0


def test_pool_is_the_seeds():
    spec = {"distribution": "anti_correlated", "low": 0, "high": 10000}
    a = data.window_pool(2**31 + 99, spec, 3, 2, 5000)
    b = data.window_pool(2**31 + 99, spec, 3, 2, 5000)
    c = data.window_pool(2**31 + 100, spec, 3, 2, 5000)
    assert data.pool_digest(a) == data.pool_digest(b) != data.pool_digest(c)
    assert not np.array_equal(a[0], a[1])
    assert data.negative_zeros(a) == 0
    # the 3-D band: sums at most 16,500 (truncation and the clamp to the
    # domain only lower them), every value an integer in the domain
    assert a[0].sum(1).max() <= 16500
    assert a[0].min() >= 0 and a[0].max() <= 10000 and (a[0] == a[0].round()).all()
    assert data.negative_zeros([np.array([[-0.0, 0.0, 1.0]], np.float32)]) == 1

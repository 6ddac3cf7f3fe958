"""The port's host sorted-order SFS cascade (``ops/sorted_sfs.py``) against
the JAX package's, on the CPU: masks byte for byte over uniform, correlated
and anti-correlated rows at d in {3, 4, 8} (duplicates, invalid rows, small
scan blocks that take the chunked buffer pass), the reference's
adversarial cases, ``sorted_sfs_keep``'s union semantics, and the mask
dispatch with the host cascade forced against the JAX dispatch. Every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.ops import dispatch as jdispatch
from skyline_tpu.ops import sorted_sfs as jsorted
from skyline_tpu_torch.ops import dispatch as tdispatch
from skyline_tpu_torch.ops import sorted_sfs as tsorted
from skyline_tpu_torch.ops.dominance import skyline_mask

from conftest import gen_points
from test_torch_device_cascade import ADVERSARIAL

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _floating_knobs(monkeypatch):
    for k in ("SKYLINE_SORTED_SFS", "SKYLINE_DEVICE_CASCADE", "SKYLINE_SORTED_SFS_BLOCK"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("block", [None, "64"])
@pytest.mark.parametrize("kind", ["uniform", "correlated", "anti"])
@pytest.mark.parametrize("d", [3, 4, 8])
def test_mask_matches_jax(monkeypatch, rng, kind, d, block):
    """``block=64``: blocks double from 64 to the cap, and a 3,000-row
    window sends the buffer pass through several 1024-row chunks."""
    if block:
        monkeypatch.setenv("SKYLINE_SORTED_SFS_BLOCK", block)
    x = gen_points(rng, 3000 if block else 600, d, kind)
    x = np.concatenate([x, x[:41]])
    got = tsorted.sorted_skyline_mask_np(x)
    assert np.array_equal(got, jsorted.sorted_skyline_mask_np(x)), (kind, d)
    assert np.array_equal(got, skyline_mask(torch.from_numpy(x)).numpy())


def test_mask_matches_jax_with_valid(rng):
    x = gen_points(rng, 500, 5, "anti")
    valid = rng.random(500) < 0.6
    got = tsorted.sorted_skyline_mask_np(x, valid)
    assert np.array_equal(got, jsorted.sorted_skyline_mask_np(x, valid))
    assert not got[~valid].any()
    assert not tsorted.sorted_skyline_mask_np(x, np.zeros(500, bool)).any()


ADV = dict(ADVERSARIAL, **{
    "signed-zero-2d": np.array([[-0.0, 0.0], [0.0, -0.0], [0.0, 0.0], [1.0, 1.0]],
                               np.float32),
    "one-tuple": np.repeat(np.array([[2, 3, 4]], np.float32), 9, axis=0),
})


@pytest.mark.parametrize("case", sorted(ADV))
def test_mask_adversarial(case):
    x = ADV[case]
    got = tsorted.sorted_skyline_mask_np(x)
    want = jsorted.sorted_skyline_mask_np(x)
    assert np.array_equal(got, want), case
    assert x[got].tobytes() == x[want].tobytes(), case


@pytest.mark.parametrize("d", [3, 6])
def test_keep_union_semantics(rng, d):
    old = gen_points(rng, 300, d, "anti")
    old = old[skyline_mask(torch.from_numpy(old)).numpy()]
    rows = gen_points(rng, 400, d, "uniform")
    keep = tsorted.sorted_sfs_keep(rows, old)
    assert np.array_equal(keep, jsorted.sorted_sfs_keep(rows, old))
    assert np.array_equal(tsorted.sorted_sfs_keep(rows), jsorted.sorted_sfs_keep(rows))
    assert np.array_equal(tsorted.sorted_sfs_keep(rows, old[:0]), jsorted.sorted_sfs_keep(rows))


def test_keep_duplicate_of_old_survives():
    old = np.array([[1, 1, 1]], np.float32)
    rows = np.array([[1, 1, 1], [2, 2, 2], [0, 5, 5]], np.float32)
    keep = tsorted.sorted_sfs_keep(rows, old)
    assert keep.tolist() == [True, False, True]
    assert np.array_equal(keep, jsorted.sorted_sfs_keep(rows, old))


@pytest.mark.parametrize("sorted_mode,dc", [("on", "auto"), ("auto", "off"), ("off", "off"),
                                            ("auto", "auto"), ("off", "on")])
def test_dispatch_rows_match_jax(monkeypatch, rng, sorted_mode, dc):
    """``skyline_mask_auto`` on a CPU tensor, each row forced and raced,
    against the JAX dispatch; three calls so the race explores."""
    monkeypatch.setenv("SKYLINE_SORTED_SFS", sorted_mode)
    monkeypatch.setenv("SKYLINE_DEVICE_CASCADE", dc)
    for n in (300, 301, 302):
        x = gen_points(rng, n, 5, "anti")
        valid = rng.random(n) < 0.9
        want = np.asarray(jdispatch.skyline_mask_auto(jnp.asarray(x), jnp.asarray(valid)))
        got = tdispatch.skyline_mask_auto(torch.from_numpy(x), torch.from_numpy(valid))
        assert np.array_equal(got.numpy(), want)
        keep = tdispatch.skyline_keep_np(x, "cpu")
        assert np.array_equal(keep, jdispatch.skyline_keep_np(x))
        assert tdispatch.skyline_of_np(x, 5, "cpu").tobytes() == jdispatch.skyline_of_np(
            x, 5).tobytes()

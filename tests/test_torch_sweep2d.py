"""The port's d <= 2 sort-and-sweep (``skyline_tpu_torch/ops/sweep2d.py``)
against the JAX package's, exact bytes: signed zeros, NaN and infinities,
ties in x and in y, empty partitions, d = 1; the survivor-mask dispatch
at d <= 2; and the sweep on the card (skipped without one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.ops import sweep2d as jsw
from skyline_tpu.ops.dispatch import skyline_mask_auto as j_mask_auto
from skyline_tpu_torch.ops import sweep2d as tsw
from skyline_tpu_torch.ops.dispatch import skyline_mask_auto

torch.set_num_threads(1)

_SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, 2.0], np.float32)


def _points(rng, n, d, kind):
    """(n, d) float32 rows of one of several shapes."""
    if kind == "ties":  # a tiny integer domain: ties in x, in y, and whole rows
        return rng.integers(0, 4, size=(n, d)).astype(np.float32)
    if kind == "special":  # ±0.0, ±inf and NaN mixed with small integers
        return _SPECIAL[rng.integers(0, len(_SPECIAL), size=(n, d))]
    if kind == "signed_zero":
        x = rng.integers(0, 3, size=(n, d)).astype(np.float32)
        zeros = x == 0
        x[zeros & (rng.random((n, d)) < 0.5)] = -0.0
        return x
    return rng.random((n, d)).astype(np.float32)


KINDS = ["uniform", "ties", "special", "signed_zero"]


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("n", [1, 7, 600])
def test_skyline_mask_sweep_matches_jax(rng, d, n, kind):
    x = _points(rng, n, d, kind)
    valid = rng.random(n) < 0.85
    want = _np(jsw.skyline_mask_sweep(jnp.asarray(x), jnp.asarray(valid)))
    got = tsw.skyline_mask_sweep(torch.from_numpy(x), torch.from_numpy(valid))
    assert np.array_equal(got.numpy(), want)
    want_all = _np(jsw.skyline_mask_sweep(jnp.asarray(x)))
    assert np.array_equal(tsw.skyline_mask_sweep(torch.from_numpy(x)).numpy(), want_all)


def test_sweep_rejects_more_than_two_dims():
    with pytest.raises(ValueError):
        tsw.skyline_mask_sweep(torch.zeros((4, 3)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [1, 2])
def test_mask_dispatch_takes_the_sweep_at_low_d(rng, d, kind):
    """``skyline_mask_auto`` sends d <= 2 through the sweep on every device,
    as the reference does before its backend check."""
    x = _points(rng, 900, d, kind)
    valid = rng.random(900) < 0.9
    want = _np(j_mask_auto(jnp.asarray(x), jnp.asarray(valid)))
    got = skyline_mask_auto(torch.from_numpy(x), torch.from_numpy(valid))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 5, 1000])
def test_segmented_cummin_matches_jax(rng, n):
    y = _points(rng, n, 1, "special")[:, 0]
    seg = rng.random(n) < 0.2
    seg[0] = True
    want = _np(jax.jit(jsw._segmented_cummin)(jnp.asarray(y), jnp.asarray(seg)))
    got = tsw._segmented_cummin(torch.from_numpy(y), torch.from_numpy(seg)).numpy()
    # equal as numbers (NaN where NaN); the sign of a zero may differ, and
    # only comparisons read these minima
    assert np.array_equal(got, want, equal_nan=True)


def _partitioned_inputs(rng, n, P, kind, empty=()):
    x = _points(rng, n, 2, kind)
    pids = rng.integers(0, P, n).astype(np.int32)
    for p in empty:
        pids[pids == p] = (p + 1) % P
    valid = rng.random(n) < 0.9
    return x, pids, valid


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [8, 1024, 3000])
def test_partitioned_sweep2_matches_jax(rng, n, kind):
    """Core and scatter: sorted rows (own bits), partition ids, mask, ranks
    and counts, then the packed (P, cap, 2) state — with empty partitions."""
    P = 8
    x, pids, valid = _partitioned_inputs(rng, n, P, kind, empty=(2, 5))
    j = jsw.partitioned_sweep2_core(jnp.asarray(x), jnp.asarray(pids), jnp.asarray(valid), P)
    t = tsw.partitioned_sweep2_core(
        torch.from_numpy(x), torch.from_numpy(pids), torch.from_numpy(valid), P
    )
    rows, p, keep, rank, counts = (a.numpy() for a in t)
    jrows, jp, jkeep, jrank, jcounts = (_np(a) for a in j)
    assert rows.tobytes() == jrows.tobytes()
    assert np.array_equal(p, jp) and np.array_equal(keep, jkeep)
    assert np.array_equal(rank[keep], jrank[jkeep])
    assert np.array_equal(counts, jcounts) and counts[2] == 0 and counts[5] == 0
    for cap in (int(max(counts.max(), 1)), 1024):
        jsky, jc = jsw.scatter_sweep2(*j, P, cap)
        tsky, tc = tsw.scatter_sweep2(*t, P, cap)
        assert tsky.numpy().tobytes() == _np(jsky).tobytes()
        assert np.array_equal(tc.numpy(), _np(jc))
        jsky, jc = jsw.partitioned_sweep2(
            jnp.asarray(x), jnp.asarray(pids), jnp.asarray(valid), P, cap
        )
        tsky, tc = tsw.partitioned_sweep2(
            torch.from_numpy(x), torch.from_numpy(pids), torch.from_numpy(valid), P, cap
        )
        assert tsky.numpy().tobytes() == _np(jsky).tobytes()


def test_scatter_drops_survivors_past_cap(rng):
    """A cap below a partition's survivor count drops the overflow and clips
    the counts, as the reference's scatter does."""
    P = 4
    x = np.stack([np.arange(64), 63 - np.arange(64)], 1).astype(np.float32)
    pids = (np.arange(64) % P).astype(np.int32)
    valid = np.ones(64, bool)
    args = [jnp.asarray(x), jnp.asarray(pids), jnp.asarray(valid)]
    jsky, jc = jsw.partitioned_sweep2(*args, P, 8)
    tsky, tc = tsw.partitioned_sweep2(*(torch.from_numpy(a) for a in (x, pids, valid)), P, 8)
    assert tsky.numpy().tobytes() == _np(jsky).tobytes()
    assert tc.tolist() == _np(jc).tolist() == [8] * P


def test_sweep_of_one_partition_equals_plain_mask(rng):
    """The partitioned sweep with one partition keeps exactly the plain
    dominance predicate's survivors."""
    from skyline_tpu_torch.ops.dominance import skyline_mask

    x = _points(rng, 2000, 2, "ties")
    valid = rng.random(2000) < 0.9
    t = [torch.from_numpy(a) for a in (x, np.zeros(2000, np.int32), valid)]
    rows, _, keep, _, counts = tsw.partitioned_sweep2_core(*t, 1)
    want = skyline_mask(t[0], t[2])
    assert int(counts[0]) == int(want.sum())
    got = rows[keep].numpy()
    ref = x[want.numpy()]
    assert np.array_equal(got[np.lexsort(got.T)], ref[np.lexsort(ref.T)])


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sweep_on_card_matches_cpu(rng, cuda_card):
    """The sweep's torch ops on the card give the CPU's bytes."""
    P = 8
    for kind in KINDS:
        x, pids, valid = _partitioned_inputs(rng, 70000, P, kind, empty=(3,))
        cpu = tsw.partitioned_sweep2(
            *(torch.from_numpy(a) for a in (x, pids, valid)), P, 70000
        )
        card = tsw.partitioned_sweep2(
            *(torch.from_numpy(a).cuda() for a in (x, pids, valid)), P, 70000
        )
        assert card[0].cpu().numpy().tobytes() == cpu[0].numpy().tobytes()
        assert torch.equal(card[1].cpu(), cpu[1])
        m = tsw.skyline_mask_sweep(torch.from_numpy(x), torch.from_numpy(valid))
        mc = tsw.skyline_mask_sweep(torch.from_numpy(x).cuda(), torch.from_numpy(valid).cuda())
        assert torch.equal(mc.cpu(), m)

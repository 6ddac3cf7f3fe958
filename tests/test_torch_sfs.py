"""SFS append rounds and the cleanup (``skyline_tpu_torch.ops.sfs``) against
``skyline_tpu.ops.sfs`` on the same numpy state: sky buffer bytes and counts
must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.ops import sfs as jsfs
from skyline_tpu.ops.dominance import skyline_np
from skyline_tpu_torch.ops import sfs as tsfs

torch.set_num_threads(1)


def _sorted_block(rng, B, w, d):
    """A (B, d) block whose first ``w`` rows are sum-sorted integer rows
    (ties included), the rest +inf padding."""
    rows = rng.integers(0, 30, size=(w, d)).astype(np.float32)
    rows = rows[np.argsort(rows.sum(axis=1), kind="stable")]
    block = np.full((B, d), np.inf, np.float32)
    block[:w] = rows
    return block, np.arange(B) < w


def _state(rng, P, cap, d):
    """Stacked skylines with +inf past each count (the storage invariant)."""
    sky = np.full((P, cap, d), np.inf, np.float32)
    counts = np.zeros(P, np.int64)
    for p in range(P):
        pts = skyline_np(rng.integers(0, 40, size=(rng.integers(0, 60), d)))
        pts = pts[np.argsort(pts.sum(axis=1), kind="stable")].astype(np.float32)
        sky[p, : len(pts)] = pts
        counts[p] = len(pts)
    return sky, counts


@pytest.mark.parametrize("d", [3, 4, 8])
def test_sfs_round_matches_jax(rng, d):
    P, cap, B = 4, 512, 128
    sky, counts = _state(rng, P, cap, d)
    blocks, bvalids = zip(*[_sorted_block(rng, B, int(w), d) for w in (128, 70, 0, 5)])
    blocks, bvalids = np.stack(blocks), np.stack(bvalids)
    active = 256
    jsky, jc, jres = jsfs.sfs_round(
        jnp.asarray(sky), jnp.asarray(counts, jnp.int32), jnp.asarray(blocks),
        jnp.asarray(bvalids), active,
    )
    tsky, tc, tres = tsfs.sfs_round(
        torch.from_numpy(sky.copy()), torch.from_numpy(counts), torch.from_numpy(blocks),
        torch.from_numpy(bvalids), active,
    )
    assert tsky.numpy().tobytes() == np.asarray(jsky).tobytes()
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tres.numpy(), np.asarray(jres))


@pytest.mark.parametrize("d", [3, 8])
@pytest.mark.parametrize("w", [0, 1, 200, 256])
def test_sfs_round_single_matches_jax(rng, d, w):
    cap, B = 1024, 256
    sky, counts = _state(rng, 1, cap, d)
    block, bvalid = _sorted_block(rng, B, w, d)
    jsky, jc, _ = jsfs.sfs_round_single(
        jnp.asarray(sky[0]), jnp.asarray(counts[0], jnp.int32), jnp.asarray(block),
        jnp.asarray(bvalid), 512,
    )
    t_in = torch.from_numpy(sky[0].copy())
    tsky, tc, _ = tsfs.sfs_round_single(
        t_in, torch.tensor(counts[0]), torch.from_numpy(block), torch.from_numpy(bvalid), 512
    )
    assert tsky.numpy().tobytes() == np.asarray(jsky).tobytes()
    assert int(tc) == int(jc)
    # the round appends in place: the passed buffer is the result
    assert tsky.data_ptr() == t_in.data_ptr()


def test_repeated_rounds_match_jax(rng):
    """Several rounds in a row over one sorted window (the flush loop)."""
    d, P, cap, B = 4, 2, 2048, 128
    rows = [rng.integers(0, 50, size=(500, d)).astype(np.float32) for _ in range(P)]
    rows = [r[np.argsort(r.sum(axis=1), kind="stable")] for r in rows]
    jsky = jnp.full((P, cap, d), jnp.inf, jnp.float32)
    jc = jnp.zeros(P, jnp.int32)
    tsky = torch.full((P, cap, d), float("inf"))
    tc = torch.zeros(P, dtype=torch.int64)
    for rnd in range(4):
        blk = np.full((P, B, d), np.inf, np.float32)
        bv = np.zeros((P, B), bool)
        for p in range(P):
            part = rows[p][rnd * B : (rnd + 1) * B]
            blk[p, : len(part)] = part
            bv[p, : len(part)] = True
        jsky, jc, _ = jsfs.sfs_round(jsky, jc, jnp.asarray(blk), jnp.asarray(bv), 1024)
        tsky, tc, _ = tsfs.sfs_round(tsky, tc, torch.from_numpy(blk), torch.from_numpy(bv), 1024)
        assert tsky.numpy().tobytes() == np.asarray(jsky).tobytes()
        assert np.array_equal(tc.numpy(), np.asarray(jc))
    for p in range(P):
        n = int(tc[p])
        got = tsky[p, :n].numpy().astype(np.float64)
        want = skyline_np(rows[p])
        assert got.shape == want.shape


@pytest.mark.parametrize("d", [3, 8])
def test_sfs_cleanup_matches_jax(rng, d):
    """Old prefix, then newly appended rows that dominate some old ones."""
    P, cap = 3, 512
    sky = np.full((P, cap, d), np.inf, np.float32)
    old = np.zeros(P, np.int64)
    new = np.zeros(P, np.int64)
    for p in range(P):
        a = skyline_np(rng.integers(5, 40, size=(80, d))).astype(np.float32)
        b = skyline_np(rng.integers(0, 40, size=(80, d))).astype(np.float32)
        sky[p, : len(a)] = a
        sky[p, len(a) : len(a) + len(b)] = b
        old[p], new[p] = len(a), len(a) + len(b)
    old_active, active = 256, 512
    jsky, jc = jsfs.sfs_cleanup(
        jnp.asarray(sky), jnp.asarray(new, jnp.int32), jnp.asarray(old, jnp.int32),
        old_active, active,
    )
    tsky, tc = tsfs.sfs_cleanup(
        torch.from_numpy(sky), torch.from_numpy(new), torch.from_numpy(old), old_active, active
    )
    assert tsky.numpy().tobytes() == np.asarray(jsky).tobytes()
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert (tc.numpy() < new).any()  # some old rows were pruned
    for p in range(P):
        v, c = tsfs.sfs_cleanup_core(
            torch.from_numpy(sky[p]), torch.tensor(new[p]), torch.tensor(old[p]),
            old_active, active,
        )
        assert v.numpy().tobytes() == tsky[p].numpy().tobytes() and int(c) == int(tc[p])

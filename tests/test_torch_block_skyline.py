"""The port's chunked scan (``skyline_mask_scan``, the dispatch's CPU
fallback), ``skyline_large`` and the mesh's blocked mask and cross prune
(``skyline_mask_blocked``, ``dominated_by_blocked``) against the JAX
package's, on the CPU: masks byte for byte with and without the bf16
prefix pre-pass and over several chunk widths, ``skyline_large``'s rows
and their order over windows that take several SFS rounds (the lag-2 count
reads) and the dense path below its threshold, the blocked mask against the
reference's dense mask at every block (and its blocked mask where that is
one block), the cross prune's verdict on every valid victim. Every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.ops import block_skyline as jblock
from skyline_tpu_torch.ops import block_skyline as tblock
from skyline_tpu_torch.ops.dominance import skyline_mask

from conftest import gen_points
from test_torch_device_cascade import ADVERSARIAL

torch.set_num_threads(1)


@pytest.mark.parametrize("mp", [False, True])
@pytest.mark.parametrize("chunk", [0, 256])
@pytest.mark.parametrize("kind", ["uniform", "correlated", "anti"])
@pytest.mark.parametrize("d", [3, 4, 8])
def test_scan_matches_jax(rng, kind, d, chunk, mp):
    n = 1100
    x = gen_points(rng, n, d, kind)
    x[rng.integers(0, n, 50)] = x[rng.integers(0, n, 50)]
    valid = rng.random(n) < 0.9
    want = np.asarray(jblock.skyline_mask_scan(jnp.asarray(x), jnp.asarray(valid),
                                               chunk=chunk, mp=mp))
    got = tblock.skyline_mask_scan(torch.from_numpy(x), torch.from_numpy(valid),
                                   chunk=chunk, mp=mp).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", sorted(c for c in ADVERSARIAL if ADVERSARIAL[c].shape[0]))
def test_scan_adversarial(case):
    x = ADVERSARIAL[case]
    want = np.asarray(jblock.skyline_mask_scan(jnp.asarray(x)))
    got = tblock.skyline_mask_scan(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, skyline_mask(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("mp", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "anti"])
@pytest.mark.parametrize("d", [3, 8])
def test_large_matches_jax(rng, kind, d, mp):
    """Blocks of 512 over 6,000 rows: twelve rounds, ten of them bounded by
    the lag-2 count read; the rows and their order equal the JAX op's."""
    x = gen_points(rng, 6000, d, kind)
    x = np.concatenate([x, x[:300]])
    want = jblock.skyline_large(x, block=512, dense_threshold=256, mp=mp)
    got = tblock.skyline_large(x, block=512, dense_threshold=256, mp=mp, device="cpu")
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


def test_large_dense_and_edge_cases(rng):
    x = gen_points(rng, 700, 4, "anti")
    got = tblock.skyline_large(x, device="cpu")  # below the dense threshold
    want = jblock.skyline_large(x)
    assert got.tobytes() == want.tobytes()
    empty = np.zeros((0, 4), np.float32)
    assert tblock.skyline_large(empty, device="cpu").shape == (0, 4)
    dup = np.repeat(np.array([[1, 2, 3]], np.float32), 900, axis=0)
    got = tblock.skyline_large(dup, block=128, dense_threshold=64, device="cpu")
    assert got.tobytes() == jblock.skyline_large(dup, block=128, dense_threshold=64).tobytes()


def test_large_default_block_on_cpu(rng):
    """The CPU's default block (8,192) over 20,000 rows: three rounds."""
    x = gen_points(rng, 20000, 5, "anti")
    got = tblock.skyline_large(x, device="cpu")
    assert got.tobytes() == jblock.skyline_large(x).tobytes()


BLOCKED_KINDS = ["uniform", "anti", "inf", "nan", "signed_zero", "mixed", "duplicates",
                 "inf_ties", "round_ties"]


@pytest.mark.parametrize("block", [16, 64, 1024])
@pytest.mark.parametrize("kind", BLOCKED_KINDS)
def test_blocked_mask_matches_jax(kind, block):
    """600 rows of d = 3, a tenth invalid: the port's blocked mask is the
    reference's dense ``skyline_mask`` whatever the block, and its blocked
    mask where that is one block (the reference's multi-block mask misses
    equal-sum dominators: ``tests/test_torch_mesh.py``)."""
    from skyline_tpu.ops.dominance import skyline_mask as jax_mask
    from test_torch_mesh import mesh_rows

    x = mesh_rows(kind, 3, 600, seed=block)
    valid = np.random.default_rng(block).random(600) < 0.9
    got = tblock.skyline_mask_blocked(torch.from_numpy(x), torch.from_numpy(valid),
                                      block=block).numpy()
    assert np.array_equal(got, np.asarray(jax_mask(jnp.asarray(x), jnp.asarray(valid))))
    if block >= 600:
        want = jblock.skyline_mask_blocked(jnp.asarray(x), jnp.asarray(valid), block=block)
        assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("mp", [False, True])
@pytest.mark.parametrize("block", [32, 256, 8192])
@pytest.mark.parametrize("kind", ["uniform", "anti", "inf", "nan", "mixed", "inf_ties"])
def test_dominated_by_blocked_matches_jax(kind, block, mp):
    """Victims against a dominator set with validity, chunked at ``block``
    with the sum-bound skip and the bf16 prefix pass: the verdicts equal
    the reference's on every victim without ``y_valid`` and on every valid
    victim with it."""
    from test_torch_mesh import mesh_rows

    x = mesh_rows(kind, 4, 700, seed=2)
    y = mesh_rows(kind, 4, 300, seed=3)
    rng = np.random.default_rng(block)
    xv, yv = rng.random(700) < 0.8, rng.random(300) < 0.7
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for y_valid in (None, yv):
        want = np.asarray(jblock.dominated_by_blocked(
            jnp.asarray(y), jnp.asarray(x), x_valid=jnp.asarray(xv), block=block,
            y_valid=None if y_valid is None else jnp.asarray(y_valid), mp=mp))
        got = tblock.dominated_by_blocked(
            ty, tx, x_valid=torch.from_numpy(xv), block=block,
            y_valid=None if y_valid is None else torch.from_numpy(y_valid), mp=mp).numpy()
        keep = np.ones(300, bool) if y_valid is None else y_valid
        assert np.array_equal(got[keep], want[keep])
    assert tblock.dominated_by_blocked(ty[:0], tx).shape == (0,)
    assert not tblock.dominated_by_blocked(ty, tx[:0]).any()

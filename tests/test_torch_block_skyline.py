"""The port's chunked scan (``skyline_mask_scan``, the dispatch's CPU
fallback) and ``skyline_large`` against the JAX package's, on the CPU:
masks byte for byte with and without the bf16 prefix pre-pass and over
several chunk widths, and ``skyline_large``'s rows and their order over
windows that take several SFS rounds (the lag-2 count reads) and the dense
path below its threshold. Every comparison is exact."""

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

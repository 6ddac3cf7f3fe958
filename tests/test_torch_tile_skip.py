"""The value kernel's skip rule (``tile_skip_plain``), its build key, and
K1–K3 on inputs aimed at the rule.

``tile_skip_plain`` mirrors the summaries and the skip test of
``csrc/dominance.cu``: a (victim block, dominator tile) pair it skips may
hold no pair that the plain predicate says dominates. The adversarial
inputs also go through the K1–K3 wrappers on the CPU (their plain
versions) against the JAX package's Pallas kernels in interpret mode, and,
on a card, through the CUDA kernel against the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from skyline_tpu.ops.pallas_dominance import (
    dominated_by_any_pallas,
    dominated_by_pallas,
    skyline_mask_pallas,
)
from skyline_tpu_torch.ops import dominance_kernels as dk
from skyline_tpu_torch.ops.dominance import dominance_mask

torch.set_num_threads(1)

TILES = dict(row_tile=256, col_tile=512, interpret=True)
# coordinates that stress the rule: signed zeros, infinities, NaN, ties
POOL = np.array([-np.inf, -1.0, -0.0, 0.0, 1.0, 2.0, np.inf, np.nan], np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_sound(x3, v2, y3, tile, block):
    """No skipped (block, tile) pair holds a dominating pair."""
    skip = dk.tile_skip_plain(x3, v2, y3, tile, block)
    P, _, nx = x3.shape
    ny = y3.shape[2]
    assert skip.shape == (P, -(-ny // block), -(-nx // tile))
    for p in range(P):
        dom = dominance_mask(x3[p].T, y3[p].T) & v2[p][:, None]
        for b, t in skip[p].nonzero().tolist():
            pairs = dom[t * tile : (t + 1) * tile, b * block : (b + 1) * block]
            assert not bool(pairs.any()), f"skipped block {b} x tile {t} holds a domination"
    return skip


@st.composite
def _sets(draw):
    d = draw(st.sampled_from([1, 3, 8]))
    P = draw(st.integers(1, 2))
    nx = draw(st.integers(0, 40))
    ny = draw(st.integers(0, 40))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    # a few distinct rows repeated: duplicates and equal sums
    rows = POOL[rng.integers(0, len(POOL), size=(6, d))]
    x = rows[rng.integers(0, 6, size=(P, nx))]
    y = rows[rng.integers(0, 6, size=(P, ny))]
    # and some free draws from the pool
    x[rng.random((P, nx)) < 0.3] = POOL[rng.integers(0, len(POOL), size=d)]
    valid = rng.random((P, nx)) < 0.8
    tile = draw(st.sampled_from([1, 2, 3, 8]))
    block = draw(st.sampled_from([1, 2, 5, 8]))
    return x, valid, y, tile, block


@settings(max_examples=150, deadline=None)
@given(_sets())
def test_skipped_pairs_never_dominate(case):
    x, valid, y, tile, block = case
    _assert_sound(
        _t(x.transpose(0, 2, 1)), _t(valid), _t(y.transpose(0, 2, 1)), tile, block
    )


@pytest.mark.parametrize("d", [1, 3, 8])
def test_duplicates_are_skipped_whole(rng, d):
    """Copies of one row, +0.0 and -0.0 mixed: every pair is skipped (box
    rule), though every sum is equal."""
    n = 1000
    x = np.zeros((n, d), np.float32)
    x[rng.random((n, d)) < 0.1] = -0.0
    xt = _t(x.T)[None]
    skip = _assert_sound(xt, torch.ones(1, n, dtype=torch.bool), xt, dk.TILE_ROWS,
                         dk.BLOCK_VICTIMS)
    assert bool(skip.all())


def _plane(rng, n, d):
    head = rng.integers(0, 100, size=(2 * n, d - 1))
    rows = np.unique(np.column_stack([head, (d - 1) * 100 - head.sum(1)]), axis=0)
    return rows[rng.permutation(len(rows))[:n]].astype(np.float32)


@pytest.mark.parametrize("d", [3, 8])
def test_plane_is_never_skipped(rng, d):
    """Distinct rows of one exact sum: no skip may apply."""
    x = _plane(rng, 1500, d)
    xt = _t(x.T)[None]
    skip = dk.tile_skip_plain(xt, torch.ones(1, 1500, dtype=torch.bool), xt, dk.TILE_ROWS,
                              dk.BLOCK_VICTIMS)
    assert not bool(skip.any())


def test_empty_tiles_and_blocks_are_skipped(rng):
    """Invalid dominators and NaN victims take part in no domination."""
    x = rng.integers(0, 3, size=(1, 3, 20)).astype(np.float32)
    y = rng.integers(0, 3, size=(1, 3, 12)).astype(np.float32)
    v = np.ones((1, 20), bool)
    v[0, :8] = False  # tile 0 (rows 0..7) holds no valid row
    x[0, 1, 8:16] = np.nan  # tile 1: every row has a NaN coordinate
    y[0, 2, 4:8] = np.nan  # block 1 (victims 4..7): all NaN rows
    skip = _assert_sound(_t(x), _t(v), _t(y), 8, 4)
    assert bool(skip[0, :, 0].all()) and bool(skip[0, :, 1].all())
    assert bool(skip[0, 1, :].all())


def test_build_key_covers_local_headers(tmp_path, monkeypatch):
    src, hdr = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text('#include <cuda_runtime.h>\n#include "k.cuh"\nint a;\n')
    hdr.write_text("int b;\n")
    monkeypatch.setitem(dk.SOURCES, "probe", (src, "f", "g"))
    first = dk._library_path("probe")
    assert dk._local_includes(src) == [src.resolve(), hdr.resolve()]
    hdr.write_text("int c;\n")
    assert dk._library_path("probe") != first


# -- adversarial inputs through K1–K3 ------------------------------------------


def _adversarial(rng, d, nx, ny):
    """(name, dominators (nx, d), validity, victims (ny, d))."""
    y = rng.integers(0, 4, size=(ny, d)).astype(np.float32)
    out = []
    x = y[rng.integers(0, ny, size=nx)]
    lower = y[ny // 2].copy()
    lower[d // 2] -= 1.0
    x[rng.integers(0, nx)] = lower
    out.append(("copies_plus_one_lower", x, np.ones(nx, bool), y))
    signed = np.array([0.0, -0.0, 1.0], np.float32)
    out.append(("signed_zeros", signed[rng.integers(0, 3, size=(nx, d))], np.ones(nx, bool),
                signed[rng.integers(0, 3, size=(ny, d))]))
    x = rng.integers(0, 4, size=(nx, d)).astype(np.float32)
    x[:256] = np.nan
    out.append(("nan_tile", x, np.ones(nx, bool), y))
    yb = y.copy()
    yb[::5] = np.inf
    yb[1::7, d - 1] = np.nan
    x = rng.integers(0, 4, size=(nx, d)).astype(np.float32)
    v = rng.random(nx) < 0.8
    x[~v] = np.inf
    out.append(("nan_inf_victims", x, v, yb))
    x = rng.integers(2, 6, size=(nx, d)).astype(np.float32)
    x[250:262] = 1.0
    x[300, :] = 1.0
    x[300, 0] = 0.0
    yb = y.copy()
    yb[250:262] = 1.0
    out.append(("equal_rows_across_tile_border", x, np.ones(nx, bool), yb))
    return out


def _pad(a, n):
    return np.concatenate([a, np.full((n - len(a), a.shape[1]), np.inf, np.float32)])


CASE_NAMES = [
    "copies_plus_one_lower", "signed_zeros", "nan_tile", "nan_inf_victims",
    "equal_rows_across_tile_border",
]


@pytest.mark.parametrize("case", CASE_NAMES)
@pytest.mark.parametrize("d", [3, 8])
def test_adversarial_cases_match_pallas(case, d):
    rng = np.random.default_rng(5)
    nx, ny = 600, 530
    _, x, v, y = next(c for c in _adversarial(rng, d, nx, ny) if c[0] == case)
    # the Pallas kernels take tile multiples: +inf padding, never valid
    xp, vp, yp = _pad(x, 768), np.pad(v, (0, 768 - nx)), _pad(y, 1024)
    want = np.asarray(dominated_by_pallas(jnp.asarray(xp.T), jnp.asarray(vp),
                                          jnp.asarray(yp.T), **TILES))[:ny]
    assert np.array_equal(dk.dominated_by_rect(_t(x.T), _t(v), _t(y.T)).numpy(), want)
    u = np.concatenate([x, y])
    uv = np.concatenate([v, np.ones(len(y), bool)])
    up, uvp = _pad(u, 1536), np.pad(uv, (0, 1536 - len(u)))
    want = np.asarray(dominated_by_any_pallas(jnp.asarray(up.T), jnp.asarray(uvp),
                                              **TILES))[: len(u)]
    assert np.array_equal(dk.dominated_by_any(_t(u.T), _t(uv)).numpy(), want)
    want = np.asarray(skyline_mask_pallas(jnp.asarray(u), jnp.asarray(uv), **TILES))
    assert np.array_equal(dk.skyline_mask_kernel(_t(u), _t(uv)).numpy(), want)
    _assert_sound(_t(x.T)[None], _t(v)[None], _t(y.T)[None], dk.TILE_ROWS, dk.BLOCK_VICTIMS)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 8, 16])
def test_adversarial_cases_on_card(cuda_card, d):
    rng = np.random.default_rng(9)
    for name, x, v, y in _adversarial(rng, d, 1283, 1799):
        xt, vt, yt = (_t(a).to(cuda_card) for a in (x.T, v, y.T))
        assert torch.equal(dk.dominated_by_rect(xt, vt, yt),
                           dk.dominated_by_rect_plain(xt, vt, yt)), name
        u = torch.cat([xt, yt], dim=1).contiguous()
        uv = torch.cat([vt, torch.ones(yt.shape[1], dtype=torch.bool, device=cuda_card)])
        assert torch.equal(dk.dominated_by_any(u, uv), dk.dominated_by_any_plain(u, uv)), name
        ut = u.T.contiguous()
        assert torch.equal(dk.skyline_mask_kernel(ut, uv), dk.skyline_mask_plain(ut, uv)), name

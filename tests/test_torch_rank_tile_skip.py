"""The rank kernel's skip rule (``rank_tile_skip_plain``) and K5–K7 on
inputs aimed at it.

``rank_tile_skip_plain`` mirrors the summaries and the skip test of
``csrc/dominance_rank.cu``: a (victim block, dominator tile) pair it skips
may hold no pair that the plain rank predicate (all ranks <= and a strictly
smaller sum row) says dominates. Three deliberately unsound variants of the
rule must fail that check. The adversarial inputs also go through the K5–K7
wrappers on the CPU (their plain versions) against the JAX package's rank
Pallas kernels in interpret mode, and, on a card, through the CUDA kernel
against the plain version. Exact equality throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from skyline_tpu.ops.pallas_dominance import (
    dominated_by_any_rank_pallas,
    dominated_by_rank_pallas,
    skyline_mask_rank_pallas,
)
from skyline_tpu_torch.ops import dominance_kernels as dk
from skyline_tpu_torch.ops.dominance import rank_dominance_mask

torch.set_num_threads(1)

TILES = dict(row_tile=256, col_tile=512, interpret=True)
I32_MAX, I32_MIN = np.iinfo(np.int32).max, np.iinfo(np.int32).min


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _honest(r):
    """(n, d) ranks -> (d+1, n) int32 with their sum as the last row."""
    return np.ascontiguousarray(np.column_stack([r, r.sum(1)]).T.astype(np.int32))


def _violations(skip, x3, v2, y3, tile, block):
    """Skipped (block, tile) pairs of ``skip`` that hold a dominating pair."""
    bad = 0
    for p in range(x3.shape[0]):
        dom = rank_dominance_mask(x3[p].T, y3[p].T) & v2[p][:, None]
        for b, t in skip[p].nonzero().tolist():
            bad += bool(dom[t * tile : (t + 1) * tile, b * block : (b + 1) * block].any())
    return bad


def _rule(x3, v2, y3, tile, block, mutation=None):
    """The skip rule from its summaries, exact or with one deliberately
    unsound change."""
    lo = dk._per_group(torch.where(v2[:, None], x3, I32_MAX), tile, I32_MAX, torch.amin)
    hi = dk._per_group(y3, block, I32_MIN, torch.amax)
    lo4, hi4 = lo[:, :, None, :], hi[:, :, :, None]
    sums = lo4[:, -1] >= hi4[:, -1]
    if mutation == "sum_vs_block_min":  # (iii) the block's least sum
        bmin = dk._per_group(y3[:, -1], block, I32_MAX, torch.amin)
        sums = lo[:, -1][:, None, :] >= bmin[:, :, None]
    ranks = (lo4[:, :-1] > hi4[:, :-1]).any(dim=1)
    if mutation == "ge_in_one_dim":  # (i) equality still lets a row dominate
        ranks = (lo4[:, :-1] >= hi4[:, :-1]).any(dim=1)
    skip = sums | ranks
    if mutation == "value_rule_c":  # (ii) the value kernel's rule (c)
        skip = skip | (lo4[:, :-1] >= hi4[:, :-1]).all(dim=1)
    return skip


def _rank_case(rng, d, P, nx, ny):
    """(P, d+1, nx) dominators, (P, nx) validity, (P, d+1, ny) victims:
    a few rank rows repeated (duplicates, equal sums), ranks lifted so sums
    sit near 2^24 or 2^25 (they differ by 1 where float32 ties them), sum
    rows that are not the sum of their ranks, invalid dominators, and
    invalid tail victims with one large rank in every row."""
    base = int(rng.choice([0, 2**24 // d, 2**25 // d]))
    pool = rng.integers(0, 4, size=(6, d)) + base

    def draw(n):
        r = pool[rng.integers(0, 6, size=(P, n))]
        free = rng.random((P, n)) < 0.3
        r[free] = rng.integers(0, 4, size=(int(free.sum()), d)) + base
        s = r.sum(-1) + np.where(rng.random((P, n)) < 0.3, rng.integers(-1, 2, (P, n)), 0)
        return np.concatenate([r, s[..., None]], -1).transpose(0, 2, 1).astype(np.int32)

    x, y = draw(nx), draw(ny)
    tail = int(rng.integers(0, 4)) if ny else 0
    if tail:
        y[:, :, ny - tail :] = (base + 4) * (d + 1)
    return _t(x), _t(rng.random((P, nx)) < 0.8), _t(y)


@st.composite
def _sets(draw):
    d = draw(st.sampled_from([1, 3, 8]))
    P = draw(st.integers(1, 2))
    nx, ny = draw(st.integers(0, 40)), draw(st.integers(0, 40))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    tile = draw(st.sampled_from([1, 2, 3, 8]))
    block = draw(st.sampled_from([1, 2, 5, 8]))
    return (*_rank_case(rng, d, P, nx, ny), tile, block)


@settings(max_examples=150, deadline=None)
@given(_sets())
def test_skipped_pairs_never_dominate(case):
    x3, v2, y3, tile, block = case
    skip = dk.rank_tile_skip_plain(x3, v2, y3, tile, block)
    assert skip.shape == (x3.shape[0], -(-y3.shape[2] // block), -(-x3.shape[2] // tile))
    assert torch.equal(skip, _rule(x3, v2, y3, tile, block))
    assert _violations(skip, x3, v2, y3, tile, block) == 0


# the smallest input each unsound variant gets wrong: (x rows, y rows, tile,
# block), each row d ranks and then its sum row
BROKEN_BY = {
    "ge_in_one_dim": ([[0, 1, 1]], [[0, 2, 2]], 1, 1),
    "value_rule_c": ([[1, 1, 1]], [[1, 1, 2]], 1, 1),
    "sum_vs_block_min": ([[2, 3, 5]], [[0, 1, 1], [3, 4, 7]], 1, 2),
}


@pytest.mark.parametrize("mutation", sorted(BROKEN_BY))
def test_unsound_variants_fail_the_check(mutation):
    xs, ys, tile, block = BROKEN_BY[mutation]
    x3 = _t(np.array(xs, np.int32).T[None])
    y3 = _t(np.array(ys, np.int32).T[None])
    v2 = torch.ones(1, x3.shape[2], dtype=torch.bool)
    exact = dk.rank_tile_skip_plain(x3, v2, y3, tile, block)
    assert _violations(exact, x3, v2, y3, tile, block) == 0
    assert _violations(_rule(x3, v2, y3, tile, block, mutation), x3, v2, y3, tile, block) > 0
    # and the generator of the property test finds it too
    rng = np.random.default_rng(1)
    for _ in range(400):
        d, P = int(rng.choice([1, 3, 8])), int(rng.integers(1, 3))
        x3, v2, y3 = _rank_case(rng, d, P, int(rng.integers(0, 41)), int(rng.integers(0, 41)))
        tile, block = int(rng.choice([1, 2, 3, 8])), int(rng.choice([1, 2, 5, 8]))
        if _violations(_rule(x3, v2, y3, tile, block, mutation), x3, v2, y3, tile, block):
            return
    pytest.fail(f"no generated case catches the unsound variant {mutation}")


@pytest.mark.parametrize("d", [1, 3, 8])
def test_duplicate_zero_rows_are_skipped_whole(d):
    """The north-star union's zero vectors: equal ranks and equal sums, so
    rule (a) skips every pair."""
    rt = _t(np.zeros((1, d + 1, 1000), np.int32))
    ok = torch.ones(1, 1000, dtype=torch.bool)
    assert bool(dk.rank_tile_skip_plain(rt, ok, rt, dk.TILE_ROWS, dk.BLOCK_VICTIMS).all())


def test_invalid_tiles_are_skipped_and_tail_victims_are_not():
    d = 3
    x = np.zeros((1, d + 1, 16), np.int32)
    v = np.ones((1, 16), bool)
    v[0, :8] = False  # tile 0 holds no valid row
    y = np.ones((1, d + 1, 8), np.int32)
    y[0, d] = d
    y[0, :, 4:] = 100 * (d + 1)  # block 1: invalid tail victims
    skip = dk.rank_tile_skip_plain(_t(x), _t(v), _t(y), 8, 4)
    assert bool(skip[0, :, 0].all()) and not bool(skip[0, :, 1].any())
    assert _violations(skip, _t(x), _t(v), _t(y), 8, 4) == 0


# -- adversarial inputs through K5–K7 ------------------------------------------


def _adversarial(rng, d, nx, ny):
    """(name, dominators (d+1, nx) int32, validity (nx,), victims (d+1, ny))."""
    out = []
    y = rng.integers(0, 4, size=(ny, d))
    # exact copies of the victims, and one row lower in a single dimension
    x = y[rng.integers(0, ny, size=nx)]
    lower = y[ny // 2].copy()
    lower[d // 2] -= 1
    x[rng.integers(0, nx)] = lower
    out.append(("copies_plus_one_lower", _honest(x), np.ones(nx, bool), _honest(y)))
    # equal rank sums straddling a tile border, one dominator beyond it
    x = rng.integers(2, 6, size=(nx, d))
    x[250:262] = 1
    x[300] = 1
    x[300, 0] = 0
    yb = y.copy()
    yb[250:262] = 1
    out.append(("equal_sums_across_tile_border", _honest(x), np.ones(nx, bool), _honest(yb)))
    # sums that differ by 1 where float32 ties them
    for name, total in (("sums_near_2p24", 2**24), ("sums_near_2p25", 2**25)):
        base = total // d
        out.append((name, _honest(x + base), np.ones(nx, bool), _honest(yb + base)))
    # equal ranks, sum rows one apart: the lower sum row dominates
    xr, yr = _honest(y[rng.integers(0, ny, size=nx)]), _honest(y)
    xr[d, ::3] -= 1
    out.append(("sum_rows_not_their_sums", xr, np.ones(nx, bool), yr))
    # invalid dominators with finite ranks, and invalid tail victims at the
    # round's rank U * (d + 1) in every row
    x = rng.integers(0, 4, size=(nx, d))
    valid = rng.random(nx) < 0.8
    yr = _honest(y)
    yr[:, ny - 37 :] = (nx + ny) * (d + 1)
    out.append(("invalid_tail_victims", _honest(x), valid, yr))
    return out


CASE_NAMES = [
    "copies_plus_one_lower", "equal_sums_across_tile_border", "sums_near_2p24",
    "sums_near_2p25", "sum_rows_not_their_sums", "invalid_tail_victims",
]


def _pad(a, n):
    """Columns of zeros up to ``n`` (rows the Pallas kernels need; invalid
    as dominators, their answers cut off as victims)."""
    return np.pad(a, ((0, 0), (0, n - a.shape[1])))


@pytest.mark.parametrize("case", CASE_NAMES)
@pytest.mark.parametrize("d", [3, 8])
def test_adversarial_cases_match_pallas(case, d):
    rng = np.random.default_rng(5)
    nx, ny = 600, 530
    _, x, v, y = next(c for c in _adversarial(rng, d, nx, ny) if c[0] == case)
    want = np.asarray(dominated_by_rank_pallas(
        jnp.asarray(_pad(x, 768)), jnp.asarray(np.pad(v, (0, 168))),
        jnp.asarray(_pad(y, 1024)), **TILES))[:ny]
    got = dk.dominated_by_rank_rect(_t(x), _t(v), _t(y)).numpy()
    assert np.array_equal(got, want)
    u = np.concatenate([x, y], axis=1)
    uv = np.concatenate([v, np.ones(ny, bool)])
    want = np.asarray(dominated_by_any_rank_pallas(
        jnp.asarray(_pad(u, 1536)), jnp.asarray(np.pad(uv, (0, 1536 - nx - ny))),
        **TILES))[: nx + ny]
    assert np.array_equal(dk.dominated_by_any_rank(_t(u), _t(uv)).numpy(), want)
    # K7 takes values: the rank rows read as coordinates
    pts = np.ascontiguousarray(u[:d].T.astype(np.float32))
    want = np.asarray(skyline_mask_rank_pallas(jnp.asarray(pts), jnp.asarray(uv), **TILES))
    assert np.array_equal(dk.skyline_mask_rank_kernel(_t(pts), _t(uv)).numpy(), want)
    x3, v2, y3 = _t(x)[None], _t(v)[None], _t(y)[None]
    skip = dk.rank_tile_skip_plain(x3, v2, y3, dk.TILE_ROWS, dk.BLOCK_VICTIMS)
    assert _violations(skip, x3, v2, y3, dk.TILE_ROWS, dk.BLOCK_VICTIMS) == 0


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 8, 16])
def test_adversarial_cases_on_card(cuda_card, d):
    rng = np.random.default_rng(9)
    draws = [_adversarial(rng, d, 1283, 1799) for _ in range(3)]
    for c, name in enumerate(CASE_NAMES):
        xs, vs, ys = ([_t(dr[c][i]).to(cuda_card) for dr in draws] for i in (1, 2, 3))
        for x3, v2, y3 in ((xs[0], vs[0], ys[0]), (torch.stack(xs), torch.stack(vs),
                                                   torch.stack(ys))):
            assert torch.equal(dk.dominated_by_rank_rect(x3, v2, y3),
                               dk.dominated_by_rank_rect_plain(x3, v2, y3)), name
            u = torch.cat([x3, y3], dim=-1).contiguous()
            uv = torch.cat([v2, torch.ones_like(y3[..., 0, :], dtype=torch.bool)], dim=-1)
            assert torch.equal(dk.dominated_by_any_rank(u, uv),
                               dk.dominated_by_any_rank_plain(u, uv)), name
        pts = torch.cat([xs[0], ys[0]], dim=1)[:d].T.float().contiguous()
        uv = torch.cat([vs[0], torch.ones(ys[0].shape[1], dtype=torch.bool, device=cuda_card)])
        assert torch.equal(dk.skyline_mask_rank_kernel(pts, uv),
                           dk.skyline_mask_rank_plain(pts, uv)), name

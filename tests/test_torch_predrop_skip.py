"""The pre-drop kernel's skip rule (``predrop_skip_plain``) and the flush's
fused pre-drop (``mp_predrop_plain``, the plain version of
``mp_predrop_kernel``) on the CPU.

``predrop_skip_plain`` mirrors the summaries and the skip test of
``csrc/dominance.cu`` step 8: a (victim block, dominator tile) pair it skips
may hold no pair that ``strictly_dominated_bf16`` certifies. An unsound
variant of the rule must fail the same check. The fused plain version must
equal the JAX package's flush pre-drop (``skyline_tpu/ops/sfs.py``'s mp
branch, ``stream/window.py`` ``_mp_predrop``) byte for byte. Exact
comparisons, no tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from skyline_tpu.ops.dominance import strictly_dominated_bf16 as j_predrop
from skyline_tpu.stream import window as jwin
from skyline_tpu_torch.ops import dominance_kernels as dk
from skyline_tpu_torch.ops import sfs as tsfs
from skyline_tpu_torch.ops.dominance import bf16_round, strictly_dominated_bf16
from test_torch_mp import TINY_SUB, adversarial_pairs, predrop_cases

torch.set_num_threads(1)

F32 = np.float32
# coordinates that stress the rule: signed zeros, infinities, NaN, values
# one bf16 ulp and one margin apart, the 1e-30 term, subnormals, and large
# values whose rounded sums overflow to +inf while their pairs certify
POOL = np.array([-np.inf, -2.0, -0.0, 0.0, 1e-30, 3e-30, TINY_SUB, 1.0, 1.0078125,
                 1.03125, 2.0, 5e37, 1.3e38, 3.3e38, np.inf, np.nan], F32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _certified(y, x, xv):
    """(L, B) bool per partition stacked: dominator i certifies victim j
    under ``strictly_dominated_bf16`` (one dominator at a time)."""
    P, L = x.shape[:2]
    out = torch.zeros((P, L, y.shape[1]), dtype=torch.bool)
    for p in range(P):
        for i in range(L):
            out[p, i] = strictly_dominated_bf16(y[p], x[p, i : i + 1], xv[p, i : i + 1])
    return out


def _unsound_pairs(skip, cert, yv, tile, block):
    """(p, b, t) of the skipped pairs that hold a certified pair of a valid
    victim."""
    bad = []
    for p, b, t in skip.nonzero().tolist():
        pairs = cert[p, t * tile : (t + 1) * tile, b * block : (b + 1) * block]
        if yv is not None:
            pairs = pairs & yv[p, b * block : (b + 1) * block][None, :]
        if bool(pairs.any()):
            bad.append((p, b, t))
    return bad


@st.composite
def _sets(draw):
    d = draw(st.sampled_from([1, 3, 8]))
    P = draw(st.integers(1, 2))
    nx = draw(st.integers(0, 24))
    ny = draw(st.integers(0, 24))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    # a few distinct rows repeated (half of them one value in every
    # dimension), rows a margin above them, free draws
    rows = POOL[rng.integers(0, len(POOL), size=(6, d))]
    const = rng.random(6) < 0.5
    rows[const] = POOL[rng.integers(0, len(POOL), size=int(const.sum()))][:, None]
    x = rows[rng.integers(0, 6, size=(P, nx))]
    y = rows[rng.integers(0, 6, size=(P, ny))]
    with np.errstate(over="ignore"):
        y[rng.random((P, ny)) < 0.3] *= F32(1.0625)
    x[rng.random((P, nx)) < 0.3] = POOL[rng.integers(0, len(POOL), size=d)]
    xv = rng.random((P, nx)) < 0.8
    yv = (rng.random((P, ny)) < 0.8) if draw(st.booleans()) else None
    tile = draw(st.sampled_from([1, 2, 3, 8]))
    block = draw(st.sampled_from([1, 2, 5, 8]))
    return x, xv, y, yv, tile, block


@settings(max_examples=150, deadline=None)
@given(_sets())
def test_skipped_pairs_never_certify(case):
    x, xv, y, yv, tile, block = case
    x, xv, y = _t(x), _t(xv), _t(y)
    yv = None if yv is None else _t(yv)
    skip = dk.predrop_skip_plain(y, x, xv, tile, block, yv)
    P, nx, ny = x.shape[0], x.shape[1], y.shape[1]
    assert skip.shape == (P, -(-ny // block), -(-nx // tile))
    assert not _unsound_pairs(skip, _certified(y, x, xv), yv, tile, block)


def _sum_rule_ge(y, x, xv, tile, block):
    """Rule (b') written with >=: unsound, since two sums can round to the
    same value (+inf here) while every coordinate certifies."""
    inf = float("inf")
    xs = dk.row_sums(bf16_round(x).transpose(1, 2))
    ys = dk.row_sums(bf16_round(y).transpose(1, 2))
    tmin = dk._per_group(torch.where(xv, xs, inf), tile, inf, torch.amin)
    bmax = dk._per_group(ys, block, -inf, torch.amax)
    return tmin[:, None, :] >= bmax[:, :, None]


def test_unsound_variant_fails():
    """8-D rows of 5e37 against rows of 5.2e37: every coordinate certifies
    (the gap exceeds 2^-7 of the sum of magnitudes), and both rounded row
    sums overflow to +inf. The rule skips nothing; (b') with >= skips the
    certified pair, and the soundness check catches it."""
    x = torch.full((1, 1, 8), 5e37)
    y = torch.full((1, 1, 8), 5.2e37)
    xv = torch.ones((1, 1), dtype=torch.bool)
    cert = _certified(y, x, xv)
    assert bool(cert.all())
    assert float(dk.row_sums(bf16_round(x).transpose(1, 2))) == float("inf")
    assert not dk.predrop_skip_plain(y, x, xv, 1, 1).any()
    variant = _sum_rule_ge(y, x, xv, 1, 1)
    assert variant.all()
    assert _unsound_pairs(variant, cert, None, 1, 1) == [(0, 0, 0)]


def test_zero_block_is_skipped_whole():
    """The north-star's case: a partition's block of zero rows (some -0.0)
    against a zero skyline prefix is skipped whole, by (a') in every
    dimension, and nothing is certified."""
    y = torch.zeros((2, 1000, 8))
    y[:, ::3, 0] = -0.0
    x = torch.zeros((2, 512, 8))
    x[0, ::5, 3] = -0.0
    xv = torch.ones((2, 512), dtype=torch.bool)
    skip = dk.predrop_skip_plain(y, x, xv, dk.TILE_ROWS, dk.BLOCK_VICTIMS)
    assert skip.shape == (2, 4, 2) and bool(skip.all())
    out, keep, counts = dk.mp_predrop_plain(x, xv, y, torch.ones((2, 1000), dtype=torch.bool))
    assert int(counts.sum()) == 0 and bool(keep.all())


def test_predrop_cases_are_sound(rng):
    """The card test's pre-drop cases (d = 3 and 8) at the kernel's tile and
    block: no skipped pair certifies, and the zero case skips everything."""
    for d in (3, 8):
        for name, y3, x3, xv3 in predrop_cases(rng, d):
            if x3.shape[1] > 600:
                continue  # the per-dominator check is quadratic in Python
            y, x, xv = _t(y3), _t(x3), _t(xv3)
            skip = dk.predrop_skip_plain(y, x, xv, dk.TILE_ROWS, dk.BLOCK_VICTIMS)
            assert not _unsound_pairs(skip, _certified(y, x, xv), None, dk.TILE_ROWS,
                                      dk.BLOCK_VICTIMS), name
            if name == "zeros":
                assert bool(skip.all())


def _jax_flush_predrop(dom, dom_ok, block, bvalid):
    """The JAX package's flush pre-drop, as ``skyline_tpu/ops/sfs.py``'s mp
    branch writes it, per partition."""
    outs = []
    for p in range(block.shape[0]):
        pre = j_predrop(jnp.asarray(block[p]), jnp.asarray(dom[p]), jnp.asarray(dom_ok[p]))
        pre = pre & jnp.asarray(bvalid[p])
        keep = jnp.asarray(bvalid[p]) & ~pre
        outs.append((np.asarray(jnp.where(keep[:, None], jnp.asarray(block[p]), jnp.inf)),
                     np.asarray(keep), np.asarray(pre)))
    return [np.stack(a) for a in zip(*outs)]


def _per_block(pre, block):
    P, B = pre.shape
    padded = np.zeros((P, -(-B // block) * block), np.int64)
    padded[:, :B] = pre
    return padded.reshape(P, -1, block).sum(-1)


@pytest.mark.parametrize("kind", ["seeded", "adversarial"])
@pytest.mark.parametrize("d", [3, 8])
def test_fused_plain_matches_jax(rng, kind, d):
    if kind == "seeded":
        dom = rng.uniform(0, 100, size=(3, 300, d)).astype(F32)
        dom = np.sort(dom, axis=1)
        block = rng.uniform(0, 130, size=(3, 700, d)).astype(F32)
        cases = [("seeded", block, dom, rng.random((3, 300)) < 0.8)]
    else:
        cases = predrop_cases(rng, d)
    for name, block, dom, dom_ok in cases:
        bvalid = rng.random(block.shape[:2]) < 0.9
        block = np.where(bvalid[..., None], block, F32(np.inf)).astype(F32)
        want = _jax_flush_predrop(dom, dom_ok, block, bvalid)
        got = dk.mp_predrop_plain(_t(dom), _t(dom_ok), _t(block), _t(bvalid))
        assert got[0].numpy().tobytes() == want[0].tobytes(), name
        assert np.array_equal(got[1].numpy(), want[1]), name
        assert got[2].dtype == torch.int32
        assert np.array_equal(got[2].numpy(), _per_block(want[2], dk.BLOCK_VICTIMS)), name
        # the wrapper on a CPU tensor, and the flush's mp_predrop over it
        res = tsfs.mp_predrop(_t(dom), _t(dom_ok), _t(block), _t(bvalid))
        assert res[0].numpy().tobytes() == want[0].tobytes(), name
        assert np.array_equal(res[2].numpy(), want[2].sum(-1).astype(np.int32)), name
        if dom.shape[1] <= 512:  # the window merge core's prefix, vmapped
            jw = jax.vmap(jwin._mp_predrop)(*(jnp.asarray(a) for a in (dom, dom_ok, block,
                                                                       bvalid)))
            assert np.asarray(jw[0]).tobytes() == want[0].tobytes(), name
    if kind == "adversarial":
        x, y = adversarial_pairs(rng, d)
        assert dk.mp_predrop_plain(_t(x[None]), torch.ones((1, len(x)), dtype=torch.bool),
                                   _t(y[None]), torch.ones((1, len(y)), dtype=torch.bool))[2].sum() > 0


def test_wrapper_checks_rows_and_strides():
    """What the card's wrapper takes: float32 rows contiguous in their last
    two dimensions, a partition anywhere (a prefix of a wider buffer), and
    validity contiguous along its rows."""
    buf = torch.zeros((3, 1024, 8))
    view = dk._rows(buf[:, :512], "t", "dominators", 3)
    assert view.stride(0) == 1024 * 8
    assert dk._rows(torch.zeros((5, 4)), "t", "victims", 2).shape == (1, 5, 4)
    with pytest.raises(ValueError):
        dk._rows(buf[:, :, :4], "t", "dominators", 3)
    with pytest.raises(ValueError):
        dk._rows(buf.transpose(1, 2), "t", "dominators", 3)
    with pytest.raises(TypeError):
        dk._rows(buf.double(), "t", "dominators", 3)
    ok = torch.ones((3, 1024), dtype=torch.bool)
    assert dk._flags(ok[:, :512], "t", "validity", (3, 512)).stride(0) == 1024
    with pytest.raises(ValueError):
        dk._flags(ok[:, ::2], "t", "validity", (3, 512))
    with pytest.raises(ValueError):
        dk._flags(ok[:, :512].int(), "t", "validity", (3, 512))

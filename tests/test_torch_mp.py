"""The mixed-precision flush (``SKYLINE_MIXED_PRECISION``) against the JAX
package on the CPU: the bf16 row pre-drop ``strictly_dominated_bf16``
(mask and certified count) on seeded and margin-adversarial inputs,
``_mp_predrop``, the merge step and the SFS rounds with ``mp`` — against
the reference's Pallas cores in interpret mode, which reach the TPU
kernels' ``mp`` body — the grid summary of the flush prefilter bit for bit,
and the knobs. Every comparison is exact (bytes, masks, counts); no test
has a tolerance. The ``cuda``-marked tests hold the ``mp`` kernels and the
pre-drop kernel (both entries) to their plain versions on a card and skip
here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.ops import cascade as jcascade
from skyline_tpu.ops import dispatch as jdispatch
from skyline_tpu.ops import sfs as jsfs
from skyline_tpu.ops.dominance import strictly_dominated_bf16 as j_predrop
from skyline_tpu.stream import device_window as jdw
from skyline_tpu.stream import window as jwin
from skyline_tpu_torch.ops import dominance_kernels as dk
from skyline_tpu_torch.ops import sfs as tsfs
from skyline_tpu_torch.ops.dominance import bf16_round, strictly_dominated_bf16
from skyline_tpu_torch.stream import device_window as tdw
from skyline_tpu_torch.stream import window as twin
from skyline_tpu_torch.ops import cascade
from skyline_tpu_torch.utils import knobs

torch.set_num_threads(1)

F32 = np.float32
TINY_SUB = F32(2.0**-130)  # a float32 subnormal, kept by bf16 rounding


@pytest.fixture
def interpret(monkeypatch):
    """The JAX side's Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setenv("SKYLINE_PALLAS_INTERPRET", "1")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def adversarial_pairs(rng, d: int):
    """(dominators (n, d), victims (m, d)) f32 aimed at the bf16 margin: a
    base row and victims that differ from it, in one dimension or in all,
    by less than, at and just beyond one bf16 ulp and the 2^-7 / 2^-6
    bands; exact ties; -0.0/+0.0; NaN; +-inf; subnormals; values near the
    f32 maximum that round to bf16 infinity; and duplicate zero rows (the
    north-star's)."""
    base = rng.uniform(1.0, 100.0, size=(16, d)).astype(F32)
    xs, ys = [base], []
    for scale in (2.0**-9, 2.0**-8, 2.0**-7, 2.0**-6, 2.0**-5, 2.0**-4):
        for f in (1.0 - 2.0**-12, 1.0, 1.0 + 2.0**-12):
            step = (base * F32(scale * f)).astype(F32)
            ys.append(base + step)  # worse in every dimension
            one = base.copy()
            one[:, rng.integers(0, d)] += step[:, 0]
            ys.append(one)  # worse in one dimension only
            ys.append(np.nextafter(base + step, F32(np.inf)))
    ys.append(base.copy())  # exact ties
    ys.append(np.nextafter(base, F32(np.inf)))  # one f32 ulp worse
    zeros = np.zeros((8, d), F32)
    zeros[::2, 0] = -0.0
    xs.append(zeros)
    ys.append(zeros[::-1].copy())
    ys.append(np.full((4, d), TINY_SUB, F32))  # subnormals above a zero row
    ys.append(np.full((4, d), 1e-29, F32))  # just above the absolute term
    sub = np.full((4, d), TINY_SUB, F32)
    sub[1] *= F32(3.0)
    xs.append(sub)
    ys.append(np.full((4, d), F32(1e-30) * F32(1.5)))
    big = np.full((4, d), F32(3.39e38))
    big[1] = np.finfo(F32).max
    xs.append(big)
    ys.append(np.full((4, d), np.finfo(F32).max))
    ys.append(np.full((4, d), F32(3.3e38)))
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0], F32)
    xs.append(special[rng.integers(0, 6, size=(24, d))])
    ys.append(special[rng.integers(0, 6, size=(24, d))])
    return np.concatenate(xs), np.concatenate(ys)


def _predrop_both(y, x, xv):
    want = np.asarray(j_predrop(jnp.asarray(y), jnp.asarray(x), jnp.asarray(xv)))
    got = strictly_dominated_bf16(
        torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(xv)
    ).numpy()
    return want, got


# -- the row pre-drop ---------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 3, 8, 16])
def test_predrop_matches_jax_seeded(rng, d):
    x = rng.uniform(0, 100, size=(300, d)).astype(F32)
    y = rng.uniform(0, 120, size=(700, d)).astype(F32)
    xv = rng.random(300) < 0.8
    want, got = _predrop_both(y, x, xv)
    assert np.array_equal(got, want)
    assert got.sum() == want.sum() > 0


@pytest.mark.parametrize("d", [2, 3, 8])
def test_predrop_matches_jax_adversarial(rng, d):
    x, y = adversarial_pairs(rng, d)
    xv = np.ones(x.shape[0], bool)
    xv[::7] = False
    want, got = _predrop_both(y, x, xv)
    assert np.array_equal(got, want)
    # the margin decides some rows and refuses others (ties, in-band rows)
    assert 0 < got.sum() < got.size


def test_predrop_rounding_decides_the_margin():
    """A case where the bf16 rounding decides the verdict: y = x + 2^-7|x|
    in f32 is beyond the margin 2^-7 (|x| + |y|) only once y rounds up to
    the next bf16 value (1 + 2^-8 + 2^-20 rounds up; 1 + 2^-8 is a tie and
    rounds to even, down to 1). JAX's CPU run rounds at the converts (no
    excess precision), so both packages certify the same rows."""
    x = np.ones((1, 2), F32)
    y = np.array([[1 + 2**-8, 1 + 2**-8], [1 + 2**-8 + 2**-20] * 2, [1.03125, 1.03125],
                  [1.0234375, 1.0234375]], F32)
    want, got = _predrop_both(y, x, np.ones(1, bool))
    assert np.array_equal(got, want)
    assert got.tolist() == [False, False, True, True]
    assert bf16_round(torch.from_numpy(y[:2, 0])).tolist() == [1.0, 1.0078125]


def test_predrop_is_sound_and_never_certifies_ties(rng):
    """A certified row has an f32 strict dominator; a row and itself, or
    a row sharing one coordinate, never certify."""
    x = rng.random((400, 6)).astype(F32)
    y = rng.random((500, 6)).astype(F32)
    xv = rng.random(400) < 0.8
    got = strictly_dominated_bf16(torch.from_numpy(y), torch.from_numpy(x),
                                  torch.from_numpy(xv)).numpy()
    strict = (x[xv][:, None, :] < y[None, :, :]).all(axis=2).any(axis=0)
    assert not (got & ~strict).any() and got.sum() > 0
    pair = torch.tensor([[1.0, 2.0, 3.0], [1.0, 30.0, 40.0]])
    assert not strictly_dominated_bf16(pair, pair).any()


def test_predrop_chunks_over_victims(rng, monkeypatch):
    """A chunk smaller than the victim count gives the same mask."""
    from skyline_tpu_torch.ops import dominance

    x = rng.uniform(0, 10, size=(50, 4)).astype(F32)
    y = rng.uniform(0, 12, size=(333, 4)).astype(F32)
    full = strictly_dominated_bf16(torch.from_numpy(y), torch.from_numpy(x))
    monkeypatch.setattr(dominance, "_CHUNK_ELEMS", 50 * 7)
    assert torch.equal(strictly_dominated_bf16(torch.from_numpy(y), torch.from_numpy(x)), full)


def test_predrop_wrapper_batches_and_checks(rng):
    P, d = 3, 4
    x = torch.from_numpy(rng.uniform(0, 10, size=(P, 40, d)).astype(F32))
    y = torch.from_numpy(rng.uniform(0, 12, size=(P, 90, d)).astype(F32))
    xv = torch.from_numpy(rng.random((P, 40)) < 0.7)
    got = dk.strictly_dominated_bf16_kernel(y, x, xv)
    assert got.shape == (P, 90)
    for p in range(P):
        assert torch.equal(got[p], strictly_dominated_bf16(y[p], x[p], xv[p]))
        assert torch.equal(dk.strictly_dominated_bf16_kernel(y[p], x[p], xv[p]), got[p])


def test_mp_predrop_matches_jax(rng):
    P, S, B, d = 3, 1024, 512, 4
    sky = rng.uniform(0, 40, size=(P, S, d)).astype(F32)
    sv = np.arange(S)[None, :] < np.array([0, 300, 1024])[:, None]
    batch = rng.uniform(0, 60, size=(P, B, d)).astype(F32)
    bv = rng.random((P, B)) < 0.9
    want = jax.vmap(jwin._mp_predrop)(*(jnp.asarray(a) for a in (sky, sv, batch, bv)))
    got = twin._mp_predrop(*(torch.from_numpy(a) for a in (sky, sv, batch, bv)))
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.int32 and got[2][1] > 0 and got[2][0] == 0


# -- the merge step and the SFS rounds with mp --------------------------------------


def _merge_case(rng, d, grow):
    from test_torch_incremental import _merge_inputs

    return _merge_inputs(rng, d, grow)


@pytest.mark.parametrize("grow", [False, True])
@pytest.mark.parametrize("d", [3, 8])
def test_merge_step_active_mp_matches_jax(rng, d, grow):
    sky, valid, batch, bvalid, active, out_active = _merge_case(rng, d, grow)
    want = jwin.merge_step_active(
        *(jnp.asarray(a) for a in (sky, valid, batch, bvalid)), active, out_active, mp=True
    )
    got = twin.merge_step_active(
        *(torch.from_numpy(a) for a in (sky, valid, batch, bvalid)), active, out_active, True
    )
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    off = twin.merge_step_active(
        *(torch.from_numpy(a) for a in (sky, valid, batch, bvalid)), active, out_active
    )
    assert torch.equal(off[0], got[0]) and int(off[3].sum()) == 0


def test_merge_step_kernel_core_mp_matches_pallas(rng, interpret):
    """The K2 core with ``mp`` against ``_merge_step_pallas_core(mp=True)``
    in interpret mode (the TPU kernel's bf16 tile body)."""
    sky, valid, batch, bvalid, active, out_active = _merge_case(rng, 3, False)
    core = jax.jit(
        jax.vmap(lambda s, v, b, bv: jwin._merge_step_pallas_core(s, v, b, bv, out_active,
                                                                  mp=True))
    )
    want = core(*(jnp.asarray(a) for a in (sky[:, :active], valid[:, :active], batch, bvalid)))
    got = twin._merge_step_kernel_core(
        *(torch.from_numpy(a) for a in (sky[:, :active], valid[:, :active], batch, bvalid)),
        out_active, mp=True,
    )
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _sfs_state(rng, P, cap, d, counts):
    """(P, cap, d) sum-sorted skylines of ``counts`` rows, +inf padded."""
    from skyline_tpu_torch.ops.dominance import skyline_mask

    sky = np.full((P, cap, d), np.inf, F32)
    for p in range(P):
        x = rng.integers(0, 30, size=(4 * counts[p] + 64, d)).astype(F32)
        rows = x[skyline_mask(torch.from_numpy(x)).numpy()][: counts[p]]
        sky[p, : rows.shape[0]] = rows[np.argsort(rows.sum(1), kind="stable")]
        counts[p] = rows.shape[0]
    return sky, counts


@pytest.mark.parametrize("d", [3, 8])
def test_sfs_round_core_mp_matches_pallas(rng, d, interpret):
    """One partition's round with the pre-drop and K1/K2 ``mp``, against
    ``sfs_round_core(..., use_pallas=True, interp=True, mp=True)``."""
    cap, B, active = 2048, 512, 1024
    sky, counts = _sfs_state(rng, 1, cap, d, np.array([600]))
    block = rng.integers(0, 40, size=(B, d)).astype(F32)
    block = block[np.argsort(block.sum(1), kind="stable")]
    bvalid = np.arange(B) < 450
    block[~bvalid] = np.inf
    want = jsfs.sfs_round_core(
        jnp.asarray(sky[0]), jnp.asarray(counts[0], jnp.int32), jnp.asarray(block),
        jnp.asarray(bvalid), active, True, True, True,
    )
    got = tsfs.sfs_round_core(
        torch.from_numpy(sky[0].copy()), torch.tensor(counts[0]), torch.from_numpy(block),
        torch.from_numpy(bvalid), active, mp=True,
    )
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2]) > 0


@pytest.mark.parametrize("d", [3, 8])
def test_sfs_round_mp_matches_jax(rng, d):
    P, cap, B, active = 4, 1024, 256, 768
    sky, counts = _sfs_state(rng, P, cap, d, np.array([0, 50, 700, 300]))
    blocks = rng.integers(0, 40, size=(P, B, d)).astype(F32)
    for p in range(P):
        blocks[p] = blocks[p][np.argsort(blocks[p].sum(1), kind="stable")]
    bvalid = np.arange(B)[None, :] < np.array([256, 10, 0, 200])[:, None]
    blocks[~bvalid] = np.inf
    want = jsfs.sfs_round(
        jnp.asarray(sky), jnp.asarray(counts, jnp.int32), jnp.asarray(blocks),
        jnp.asarray(bvalid), active, mp=True,
    )
    got = tsfs.sfs_round(
        torch.from_numpy(sky.copy()), torch.from_numpy(counts), torch.from_numpy(blocks),
        torch.from_numpy(bvalid), active, mp=True,
    )
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].sum() > 0


@pytest.mark.parametrize("d", [3, 8])
def test_sfs_round_at_mp_matches_jax(rng, d):
    """The device-window rounds with ``mp``, single and all partitions."""
    P, cap, B, active = 3, 2048, 512, 1024
    sky, counts = _sfs_state(rng, P, cap, d, np.array([400, 0, 900]))
    n = 1500
    ws = rng.integers(0, 40, size=(n + 1024, d)).astype(F32)
    ws[n:] = np.inf
    bounds = np.array([0, 600, 601, n])
    for p in range(P):
        seg = ws[bounds[p] : bounds[p + 1]]
        ws[bounds[p] : bounds[p + 1]] = seg[np.argsort(seg.sum(1), kind="stable")]
    jc = counts.astype(np.int32)
    for p in range(P):
        off, width = int(bounds[p]), min(B, int(bounds[p + 1] - bounds[p]))
        want = jdw.sfs_round_at(jnp.asarray(sky[p]), jc[p], jnp.asarray(ws), off, width,
                                B=B, active=active, mp=True)
        got = tdw.sfs_round_at(torch.from_numpy(sky[p].copy()), torch.tensor(counts[p]),
                               torch.from_numpy(ws), off, width, B=B, active=active, mp=True)
        assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
        assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
    offs, widths = bounds[:-1], np.clip(np.diff(bounds), 0, B)
    want = jdw.sfs_round_at_vmapped(
        jnp.asarray(sky), jnp.asarray(jc), jnp.asarray(ws), jnp.asarray(offs.astype(np.int32)),
        jnp.asarray(widths.astype(np.int32)), B=B, active=active, mp=True,
    )
    got = tdw.sfs_round_at_vmapped(
        torch.from_numpy(sky.copy()), torch.from_numpy(counts), torch.from_numpy(ws),
        torch.from_numpy(offs), torch.from_numpy(widths), B=B, active=active, mp=True,
    )
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2])) and got[2].sum() > 0


# -- the grid summary ------------------------------------------------------------------


@pytest.mark.parametrize("d", [3, 4, 8])
def test_grid_summary_matches_jax_bit_for_bit(rng, d):
    """``(bounds, ux)`` equal to JAX's bytes: ragged counts, an empty
    partition, a single-value dimension, non-finite rows and values far
    from 1 (the 1e-6 step floor)."""
    P, cap = 5, 1024
    counts = np.array([0, 1, 37, 700, 1024])
    sky = np.full((P, cap, d), np.inf, F32)
    for p in range(P):
        sky[p, : counts[p]] = rng.uniform(-50, 5000, size=(counts[p], d))
    sky[2, :, 1] = F32(7.25)  # one value in a dimension
    sky[3, 5] = np.nan
    sky[3, 9, 0] = -np.inf
    sky[4, :, 0] *= F32(1e-7)
    sky[4, :, d - 1] += F32(3e7)
    for active in (1024, 40):
        want = jwin.grid_summary_device(jnp.asarray(sky), jnp.asarray(counts, jnp.int32), active)
        got = twin.grid_summary_device(torch.from_numpy(sky), torch.from_numpy(counts), active)
        assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
        assert got[1].dtype == torch.int32
        assert got[1].numpy().tobytes() == np.asarray(want[1]).tobytes()


def _fma_f32_f64(a, b, c):
    """float32 ``a * b + c`` rounded once, through float64: the product of
    a small integer and a float32 is exact there, 2Sum gives the sum's
    error, and rounding the sum to odd makes the float32 rounding a single
    one."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    return torch.where((err != 0) & even & torch.isfinite(s), torch.nextafter(s, toward),
                       s).float()


def _f32_bits(rng, n):
    return torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
                            .view(np.int32)).view(torch.float32)


def _fma_cases(rng, kind):
    """(a, b, c) for ``_fma_f32``: ``a`` the ladder's integers 0..GRID_BINS."""
    n = 1 << 20
    a = torch.from_numpy(rng.integers(0, twin.GRID_BINS + 1, n).astype(F32))
    if kind == "bits":  # every class: subnormals, both branches, +-inf, NaN
        return a, _f32_bits(rng, n), _f32_bits(rng, n)
    if kind == "cancelling":  # c within 70 ulps of -a*b, zero sums among them
        b = _f32_bits(rng, n)
        noise = torch.from_numpy(rng.integers(-70, 71, n).astype(np.int32))
        return a, b, ((-(a * b)).view(torch.int32) + noise).view(torch.float32)
    if kind == "ties":  # a*b halfway between two floats, c's sign breaks the tie
        b = _f32_bits(rng, n)
        p = a.double() * b.double()
        p32 = p.float().double()
        step = (torch.nextafter(p.float(), torch.where(p > p32, float("inf"),
                                                      float("-inf"))).double() - p32).abs()
        tie = torch.isfinite(p) & (p != p32) & (2 * (p - p32).abs() == step)
        a, b = a[tie], b[tie]
        tiny = torch.tensor([0.0, -0.0, 2.0**-149, -(2.0**-149), 2.0**-101, -(2.0**-101),
                             2.0**-100, -(2.0**-100), 2.0**-126, -(2.0**-126), 1e-30,
                             -1e-30], dtype=torch.float32)
        pick = torch.from_numpy(rng.integers(0, len(tiny), len(a)))
        return a, b, tiny[pick]
    fmax, fmin = float(np.finfo(F32).max), float(np.finfo(F32).tiny)
    edge = [0.0, 2.0**-149, fmin, 2.0**-101, 2.0**-100, 1.0, 1.0 + 2.0**-23,
            float(np.nextafter(F32(2.0**90), F32(0))), 2.0**90, 2.0**119,
            float(np.nextafter(F32(2.0**120), F32(0))), 2.0**120, fmax / 32, fmax,
            float("inf"), float("nan")]
    edge = torch.tensor(edge + [-v for v in edge] + [-0.0], dtype=torch.float32)
    a, b, c = torch.meshgrid(torch.tensor([0.0, 1.0, 3.0, float(twin.GRID_BINS)]), edge,
                             edge, indexing="ij")
    return a.flatten(), b.flatten(), c.flatten()


@pytest.mark.parametrize("kind", ["bits", "cancelling", "ties", "edges"])
def test_fma_f32_is_one_rounding(kind):
    """The grid ladder's float32 FMA equals the float64 single-rounding
    form bit for bit (any NaN for a NaN) over its domain, ``a`` in
    0..GRID_BINS and any ``b`` and ``c``: random bit patterns, sums that
    cancel, products halfway between two floats with a tiny ``c`` of
    either sign, and the edges of both branches, subnormals, +-inf, NaN."""
    a, b, c = _fma_cases(np.random.default_rng(18), kind)
    assert len(a) > 1000
    got, want = twin._fma_f32(a, b, c), _fma_f32_f64(a, b, c)
    same = (got.view(torch.int32) == want.view(torch.int32)) | (got.isnan() & want.isnan())
    assert bool(same.all()), (a[~same][:4], b[~same][:4], c[~same][:4])


def test_grid_codes_are_sound(rng):
    """Whenever every dimension has representative code < victim code, the
    representative strictly dominates the victim in f32."""
    d, cap, count = 5, 1024, 200
    sky = np.full((1, cap, d), np.inf, F32)
    rows = rng.random((count, d)).astype(F32)
    sky[0, :count] = rows
    bounds, ux = twin.grid_summary_device(torch.from_numpy(sky), torch.tensor([count]), cap)
    bounds, ux = bounds.numpy()[0], ux.numpy()[0]
    assert np.all(np.diff(bounds, axis=0) > 0)
    r = min(cap, twin.GRID_REPS)
    assert (ux[:count] <= twin.GRID_BINS).all() and ux.shape == (r, d)
    y = rng.random((800, d)).astype(F32) * F32(1.5)
    vy = (bounds[None, :, :] <= y[:, None, :]).sum(axis=1) - 1
    dropped = np.any(np.all(ux[None, :, :] < vy[:, None, :], axis=2), axis=1)
    strict = (rows[:r][None, :, :] < y[:, None, :]).all(axis=2).any(axis=1)
    assert not (dropped & ~strict).any() and dropped.sum() > 0


# -- the knobs ---------------------------------------------------------------------------


def test_knob_defaults(monkeypatch):
    monkeypatch.delenv("SKYLINE_MIXED_PRECISION", raising=False)
    monkeypatch.delenv("SKYLINE_FLUSH_PREFILTER", raising=False)
    assert knobs.mixed_precision_enabled(torch.device("cuda"))
    assert knobs.mixed_precision_enabled("cuda:0")
    assert not knobs.mixed_precision_enabled("cpu")
    assert not knobs.mixed_precision_enabled()
    # the reference's default off its accelerator
    assert knobs.mixed_precision_enabled("cpu") == jdispatch.mixed_precision_enabled()
    for d in (1, 2, 3, 8):
        assert cascade.applies("flush_prefilter", d=d) == jcascade.applies("flush_prefilter", d=d)
    for raw, want in (("1", True), ("0", False), ("off", False), ("yes", True)):
        monkeypatch.setenv("SKYLINE_MIXED_PRECISION", raw)
        assert knobs.mixed_precision_enabled("cpu") == want
        assert knobs.mixed_precision_enabled("cuda") == want
        assert jdispatch.mixed_precision_enabled() == want
        monkeypatch.setenv("SKYLINE_FLUSH_PREFILTER", raw)
        assert cascade.applies("flush_prefilter", d=4) == want == jcascade.applies(
            "flush_prefilter", d=4
        )


# -- on the card -------------------------------------------------------------------------


def predrop_cases(rng, d: int):
    """(name, victims (P, B, d), dominators (P, L, d), their validity) for
    the pre-drop: a block of zero rows (some -0.0) against zero dominators,
    subnormals, rows one bf16 ulp apart, the margin-adversarial rows, and
    dominator counts of 1, 511, 513, 777 and 4096 at P = 1, 3 and 8."""
    x, y = adversarial_pairs(rng, d)
    zeros = np.zeros((3, 600, d), F32)
    zeros[:, ::3, 0] = -0.0
    ulp = np.full((1, 256, d), 1.0, F32)
    ulp[0, 1::2] = 1.0078125  # the next bf16 value above 1
    sub = np.full((1, 64, d), TINY_SUB, F32)
    sub[0, ::2] *= F32(3.0)
    cases = [
        ("zeros", zeros, np.zeros((3, 512, d), F32)),
        ("ulp", ulp, np.concatenate([ulp[:, :8], np.zeros((1, 1, d), F32)], axis=1)),
        ("subnormal", np.concatenate([sub, np.full((1, 64, d), F32(1e-29))], axis=1), sub),
        ("adversarial", y[None], x[None]),
    ]
    pool = np.concatenate([x, y])
    for nx, P in ((1, 1), (511, 3), (513, 8), (777, 3), (4096, 1)):
        xs = pool[rng.integers(0, len(pool), size=(P, nx))]
        ys = pool[rng.integers(0, len(pool), size=(P, 700))]
        cases.append((f"nx{nx}_P{P}", ys, xs))
    out = []
    for name, ys, xs in cases:
        xv = rng.random(xs.shape[:2]) < 0.85
        out.append((name, ys, xs, xv))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 8, 16])
def test_mp_kernels_match_plain_on_card(rng, cuda_card, d):
    x, y = adversarial_pairs(rng, d)
    pts = torch.from_numpy(np.concatenate([x, y])).to(cuda_card)
    v = torch.ones(pts.shape[0], dtype=torch.bool, device=cuda_card)
    pt = pts.T.contiguous()
    want = dk.dominated_by_any_plain(pt, v)
    assert torch.equal(dk.dominated_by_any(pt, v, mp=True), want)
    assert torch.equal(dk.dominated_by_any(pt, v, mp=False), want)
    yt = torch.from_numpy(np.ascontiguousarray(y.T)).to(cuda_card)
    assert torch.equal(dk.dominated_by_rect(pt, v, yt, mp=True),
                       dk.dominated_by_rect_plain(pt, v, yt))
    assert torch.equal(dk.skyline_mask_kernel(pts, v, mp=True), dk.skyline_mask_plain(pts, v))
    xs, ys = torch.from_numpy(x).to(cuda_card), torch.from_numpy(y).to(cuda_card)
    xv = torch.ones(xs.shape[0], dtype=torch.bool, device=cuda_card)
    assert torch.equal(dk.strictly_dominated_bf16_kernel(ys, xs, xv),
                       strictly_dominated_bf16(ys, xs, xv))
    for name, y3, x3, xv3 in predrop_cases(rng, d):
        ys, xs = torch.from_numpy(y3).to(cuda_card), torch.from_numpy(x3).to(cuda_card)
        xv = torch.from_numpy(xv3).to(cuda_card)
        assert torch.equal(dk.strictly_dominated_bf16_kernel(ys, xs, xv),
                           dk.strictly_dominated_bf16_plain(ys, xs, xv)), name
        bv = torch.from_numpy(rng.random(y3.shape[:2]) < 0.9).to(cuda_card)
        # the dominators as a prefix of a wider buffer, read in place
        wide = torch.cat([xs, xs], dim=1)[:, : xs.shape[1]]
        wide_v = torch.cat([xv, xv], dim=1)[:, : xs.shape[1]]
        got = dk.mp_predrop_kernel(wide, wide_v, ys, bv)
        want = dk.mp_predrop_plain(xs, xv, ys, bv)
        assert got[0].cpu().numpy().tobytes() == want[0].cpu().numpy().tobytes(), name
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]), name

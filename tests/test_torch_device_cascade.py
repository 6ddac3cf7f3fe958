"""The port's device sorted dominance cascade (``ops/device_cascade.py``)
against the JAX package's on the CPU: masks byte for byte against JAX's
``device_cascade_mask`` (its pure-jnp path, and a few cases with its Pallas
tiles in interpret mode) over uniform, correlated and anti-correlated rows
at d in {3, 4, 8} with duplicates and invalid rows, the reference's
adversarial cases, the 2^24 equal-key band at block 8, NaN rows that
survive and the key radius; ``device_cascade_keep``'s union semantics; the
launch plan (one window pass and one scan a call, whatever the block
count), the band's ends on the device against their numpy form, the window
pass's worklist against a direct enumeration of its (group, tile) pairs,
the window pass and the scan against their references (the window pass
against the windowed K2 the port ran before and, through the whole core,
JAX's ``_cascade_core`` with its Pallas tiles in interpret mode; the scan
against the per-block host loop the port ran before, both kept here); and
the lazy
engine with host ingest, each flush row forced
and under ``auto``, against the JAX engine — answers, published digests and
the race's signatures. Every comparison is exact. The ``cuda``-marked test
holds the cascade on a card to the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.ops import device_cascade as jdc
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu.stream.batched import PartitionSet as JaxSet
from skyline_tpu_torch.ops import device_cascade as tdc
from skyline_tpu_torch.ops import dominance_kernels as dk
from skyline_tpu_torch.ops.dominance import dominated_by, skyline_mask
from skyline_tpu_torch.ops.dominance_kernels import row_sums
from skyline_tpu_torch.ops.sorted_sfs import sorted_sfs_keep
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream.batched import PartitionSet
from skyline_tpu_torch.utils.buckets import next_pow2

from conftest import assert_same_merge, fill_pset, gen_points, merge_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_mp(monkeypatch):
    """Both packages' defaults on the CPU (no bf16 pre-drop) unless a test
    sets it."""
    for k in ("SKYLINE_MIXED_PRECISION", "SKYLINE_DEVICE_CASCADE_BLOCK",
              "SKYLINE_SORTED_SFS", "SKYLINE_DEVICE_CASCADE", "SKYLINE_PALLAS_INTERPRET"):
        monkeypatch.delenv(k, raising=False)


def _both(x, valid=None):
    """(JAX mask, port mask) as numpy bools."""
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    want = np.asarray(jdc.device_cascade_mask(jnp.asarray(x), jv))
    got = tdc.device_cascade_mask(torch.from_numpy(x), tv).numpy()
    return want, got


@pytest.mark.parametrize("kind", ["uniform", "correlated", "anti"])
@pytest.mark.parametrize("d", [3, 4, 8])
def test_mask_matches_jax(rng, kind, d):
    x = gen_points(rng, 600, d, kind)
    x = np.concatenate([x, x[:37]])  # duplicates of real rows
    want, got = _both(x)
    assert np.array_equal(got, want), (kind, d)
    assert np.array_equal(got, skyline_mask(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("d", [3, 8])
def test_mask_matches_jax_with_valid(rng, d):
    x = gen_points(rng, 700, d, "anti")
    valid = rng.random(700) < 0.7
    want, got = _both(x, valid)
    assert np.array_equal(got, want) and not got[~valid].any()


@pytest.mark.parametrize("mp", ["0", "1"])
@pytest.mark.parametrize("d", [3, 6])
def test_mask_mixed_precision(monkeypatch, rng, mp, d):
    """With the bf16 pre-drop on both sides the masks stay the exact ones."""
    monkeypatch.setenv("SKYLINE_MIXED_PRECISION", mp)
    monkeypatch.setenv("SKYLINE_DEVICE_CASCADE_BLOCK", "64")
    x = (gen_points(rng, 900, d, "anti") * 64).round().astype(np.float32)
    want, got = _both(x)
    assert np.array_equal(got, want)


ADVERSARIAL = {
    "duplicates": np.repeat(
        np.array([[1, 9, 0], [9, 1, 0], [5, 5, 0], [2, 8, 0]], np.float32), 16, axis=0
    ),
    "zero-clump": np.concatenate([
        np.zeros((256, 4), np.float32), np.full((32, 4), 3.0, np.float32),
    ]),
    "equal-sums": np.array(
        [[0, 3, 1], [1, 2, 1], [2, 1, 1], [3, 0, 1], [1.5, 1.5, 1]], np.float32
    ).repeat(8, axis=0),
    "nan-inf": np.array(
        [[1, 1, 1], [np.nan, 0, 0], [np.inf, np.inf, np.inf], [0, np.nan, np.nan],
         [2, 2, 2], [np.inf, 0, 0]], np.float32,
    ),
    # mixed +/- inf rows have NaN row sums: their blocks are never skipped
    "mixed-inf": np.array(
        [[np.inf, -np.inf, 0], [-np.inf, np.inf, 0], [-np.inf, -np.inf, -np.inf],
         [0, 0, 0], [np.inf, -np.inf, 1]], np.float32,
    ),
    "signed-zero": np.array(
        [[-0.0, 0.0, 1.0], [0.0, -0.0, 1.0], [0.0, 0.0, 1.0], [1.0, 1.0, 1.0]], np.float32
    ),
    "single": np.array([[4, 2, 7]], np.float32),
    "empty": np.zeros((0, 5), np.float32),
}


@pytest.mark.parametrize("block", [None, "8"])
@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_mask_adversarial(monkeypatch, case, block):
    if block:
        monkeypatch.setenv("SKYLINE_DEVICE_CASCADE_BLOCK", block)
    x = ADVERSARIAL[case]
    want, got = _both(x)
    assert np.array_equal(got, want), case
    # byte for byte on the selected rows (the -0.0 fold is selection only)
    assert x[got].tobytes() == x[want].tobytes(), case


def test_valid_nan_rows_survive(rng):
    x = gen_points(rng, 64, 3, "uniform")
    x[10] = np.nan
    x[20, 1] = np.nan
    want, got = _both(x)
    assert got[10] and got[20] and np.array_equal(got, want)


@pytest.mark.parametrize("d", [3, 4, 8])
def test_radius_bounds_key_error(rng, d):
    """|f32 key - exact (f64) sum| <= r = (d - 1) * 2^-23 * sum|x| for the
    port's key and radius, on rows of mixed sign and magnitude."""
    x = (gen_points(rng, 4096, d, "anti") - 0.5) * np.float32(1e6)
    x[:64] *= np.float32(1e-30)
    t = torch.from_numpy(x)
    key = row_sums(t).double().numpy()
    radius = (torch.tensor((d - 1) * 2.0 ** -23) * row_sums(t.abs())).double().numpy()
    exact = x.astype(np.float64).sum(axis=1)
    assert (np.abs(key - exact) <= radius).all()


def test_equal_key_multi_block_band(monkeypatch):
    """Every row's f32 sum is 2^24 across several blocks of 8: the sort key
    orders nothing, the band spans every later block, and the three trailing
    rows tie the key with different exact sums."""
    monkeypatch.setenv("SKYLINE_DEVICE_CASCADE_BLOCK", "8")
    base = 16777216.0
    rows = [(base - j, float(j), 0.0) for j in range(2, 22)]
    rows += [(base, 0.5, 0.0), (base, 1.0, 0.0), (base, 0.75, 0.0)]
    x = np.array(rows, np.float32)
    assert (row_sums(torch.from_numpy(x)).numpy() == np.float32(base)).all()
    want, got = _both(x)
    assert np.array_equal(got, want)
    assert got[20] and not got[21] and not got[22]


@pytest.mark.parametrize("case", ["anti", "dups"])
def test_mask_against_pallas_interpret(monkeypatch, rng, case):
    """The JAX cascade through its Pallas tiles (interpret mode, its
    accelerator sizes: 1024-row blocks) against the port's plain path."""
    x = gen_points(rng, 300, 4, "anti")
    if case == "dups":
        x = np.concatenate([x, x[:16], np.zeros((40, 4), np.float32)])
    tport = tdc.device_cascade_mask(torch.from_numpy(x)).numpy()
    monkeypatch.setenv("SKYLINE_PALLAS_INTERPRET", "1")
    want = np.asarray(jdc.device_cascade_mask(jnp.asarray(x)))
    assert np.array_equal(tport, want)


# -- the launch plan --------------------------------------------------------------------


def _launch_plan_fixture():
    """64 rows: rows 0..31 are copies of the zero tuple (one candidate), then
    24 distinct rows of one sum, 25, whose blocks' bands reach each other;
    invalid +inf padding last."""
    dup = np.zeros((32, 3), np.float32)
    rest = np.stack([np.arange(1, 25), np.arange(24, 0, -1), np.zeros(24)], 1).astype(np.float32)
    x = np.concatenate([dup, rest])
    x = np.concatenate([x, np.full((64 - x.shape[0], 3), np.inf, np.float32)])
    return x, np.arange(64) < 56


@pytest.mark.parametrize("block", [8, 16, 64])
def test_scan_launch_plan(monkeypatch, block):
    """Every entry — the window pass (the full square and the band) and the
    scan (the pre-drop and the buffer) — is called once a call, whatever the
    block count (8, 4 or 1 blocks), mp off and on; the mask is
    ``skyline_mask``'s."""
    calls = []
    for name in ("cascade_windows", "cascade_scan"):
        real = getattr(tdc, name)

        def wrap(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(tdc, name, wrap)
    x, valid = _launch_plan_fixture()
    for mp in (False, True):
        calls.clear()
        keep = tdc._cascade_core(torch.from_numpy(x), torch.from_numpy(valid), block, mp)
        assert np.array_equal(keep.numpy(), skyline_mask(
            torch.from_numpy(x), torch.from_numpy(valid)).numpy())
        assert sorted(calls) == ["cascade_scan", "cascade_windows"], (block, mp, calls)


def _band_ends_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The numpy form the port computed on the host before: for each block b,
    one past the last later block j with lo[j] <= hi[b], else b + 1."""
    nb = lo.shape[0]
    end = np.arange(1, nb + 1)
    for b in range(nb - 1):
        hit = np.flatnonzero(lo[b + 1 :] <= hi[b])
        if hit.size:
            end[b] = b + 2 + hit[-1]
    return end


@pytest.mark.parametrize("nb", [1, 2, 7, 512])
@pytest.mark.parametrize("kind", ["random", "infinite", "empty", "equal"])
def test_band_ends_device_matches_numpy(rng, nb, kind):
    """``_band_ends`` (the (nb, nb) compare on the device) equals the numpy
    loop bit for bit: random sorted ranges, NaN-key blocks (lo = -inf, hi =
    +inf), empty blocks (lo = +inf, hi = -inf) and blocks of equal keys."""
    centre = np.sort(rng.random(nb).astype(np.float32)) * np.float32(100)
    width = (rng.random(nb) * 20).astype(np.float32)
    lo, hi = centre - width, centre + width
    if kind == "infinite":
        pick = rng.random(nb) < 0.2
        lo[pick], hi[pick] = -np.inf, np.inf
    elif kind == "empty":
        pick = rng.random(nb) < 0.4
        lo[pick], hi[pick] = np.inf, -np.inf
    elif kind == "equal":
        lo[:], hi[:] = np.float32(16777216.0), np.float32(16777216.0)
        lo[nb // 2 :] = np.float32(16777218.0)
        hi[nb // 2 :] = np.float32(16777218.0)
    got = tdc._band_ends(torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    assert np.array_equal(got, _band_ends_np(lo, hi))


def _windows_reference(cand, cand_ok, block, band_end):
    """The windowed K2's plain version the port ran before the window pass
    (``dominated_by_rect_windows_plain``), kept as the reference: one
    transposed dominator set with its validity, every block's victims as a
    partition of (nb, d, block), partition b against the valid rows
    ``[b * block, band_end[b] * block)`` (clipped to the set)."""
    n, d = cand.shape
    xt = cand.T.contiguous()
    yt = cand.reshape(-1, block, d).transpose(1, 2).contiguous()
    out = torch.zeros((n // block, block), dtype=torch.bool)
    for p, end in enumerate(band_end.tolist()):
        b, e = p * block, min(end * block, n)
        if e > b and cand_ok[b:e].any():
            out[p] = dominated_by(yt[p].T, xt[:, b:e].T, cand_ok[b:e])
    return out.reshape(n)


def _window_rows(rng, n, d, holes=True):
    """n sorted-ish candidate rows: anti-correlated, a tenth all-NaN (the
    non-candidates) and, with ``holes``, a run of NaN rows long enough to
    leave groups without a candidate."""
    x = (gen_points(rng, n, d, "anti") * 64).round().astype(np.float32)
    x = x[np.argsort(x.sum(axis=1), kind="stable")]
    x[rng.random(n) < 0.1] = np.nan
    if holes:
        x[n // 3 : n // 3 + n // 4] = np.nan
    return torch.from_numpy(x)


@pytest.mark.parametrize("windows", ["band", "self", "empty", "clipped"])
@pytest.mark.parametrize("d", [3, 8])
def test_windowed_k2_plain_matches_each_window(rng, d, windows):
    """The window pass's plain version equals ``dominated_by_rect_plain``
    over each block's window of the row-major candidates, rows ``[b *
    block, band_end[b] * block)`` clipped to the set (the block alone,
    bands of several blocks, empty windows, ends past the last block), and
    the windowed K2 it replaced."""
    block, nb = 16, 6
    cand = _window_rows(rng, block * nb, d)
    band_end = {"band": [2, 4, 6, 6, 6, 6], "self": [1, 2, 3, 4, 5, 6],
                "empty": [0, 1, 2, 3, 4, 5], "clipped": [9, 9, 4, 9, 6, 7]}[windows]
    ends = torch.tensor(band_end, dtype=torch.int32)
    got = dk.cascade_windows(cand, block, ends)
    ok = ~torch.isnan(cand).any(dim=1)
    for b, end in enumerate(band_end):
        s, e = b * block, min(end * block, block * nb)
        victims = cand[s : s + block].T.contiguous()
        want = (dk.dominated_by_rect_plain(cand[s:e].T.contiguous(), ok[s:e].contiguous(),
                                           victims)
                if e > s else torch.zeros(block, dtype=torch.bool))
        assert torch.equal(got[s : s + block], want), (b, s, e)
    assert torch.equal(got, _windows_reference(cand, ok, block, ends))


@pytest.mark.parametrize("block", [8, 32, 64])
@pytest.mark.parametrize("d", [2, 3, 8])
def test_window_pass_plain_matches_reference_and_jax(monkeypatch, rng, d, block):
    """Through the whole core on seeded rows with duplicates, NaN and invalid
    rows (blocks of 8-64 rows: every window off the 256-row tile grid): the
    row-major window pass's plain version equals the windowed K2 it
    replaced on the core's own candidates and band ends, and the port's
    mask equals JAX's ``_cascade_core`` with its Pallas tiles in interpret
    mode, mp off and on. Exact."""
    x = gen_points(rng, 400, d, "anti")
    x = np.concatenate([x, x[:50], np.zeros((30, d), np.float32)])
    x[rng.integers(0, x.shape[0], 12)] = np.nan
    n_pad = next_pow2(x.shape[0], min_cap=64)
    x = np.concatenate([x, np.full((n_pad - x.shape[0], d), np.inf, np.float32)])
    valid = (np.arange(n_pad) < 480) & (rng.random(n_pad) < 0.95)
    seen = []
    real = tdc.cascade_windows

    def spy(cand, blk, band_end, mp=False):
        out = real(cand, blk, band_end, mp=mp)
        seen.append((cand, band_end, out))
        return out

    monkeypatch.setattr(tdc, "cascade_windows", spy)
    for mp in (False, True):
        seen.clear()
        keep = tdc._cascade_core(torch.from_numpy(x), torch.from_numpy(valid), block, mp)
        (cand, band_end, got), = seen
        ok = ~torch.isnan(cand).any(dim=1)
        assert torch.equal(got, _windows_reference(cand, ok, block, band_end)), mp
        want = np.asarray(jdc._cascade_core(jnp.asarray(x), jnp.asarray(valid), block, mp,
                                            True, True))
        assert np.array_equal(keep.numpy(), want), mp


def _worklist_direct(cand, block, band_end):
    """Each (group, tile) pair the window pass must walk: every group of
    ``BLOCK_VICTIMS`` rows of block b with a row free of NaN, against every
    ``TILE_ROWS``-row tile that meets rows ``[b * block, min(band_end[b] *
    block, N))``."""
    n = cand.shape[0]
    real = ~torch.isnan(cand).any(dim=1)
    pairs = set()
    gpb = -(-block // dk.BLOCK_VICTIMS)
    for b, end in enumerate(band_end.tolist()):
        s, e = b * block, min(end * block, n)
        for g in range(gpb):
            lo = s + g * dk.BLOCK_VICTIMS
            if e > s and real[lo : min(lo + dk.BLOCK_VICTIMS, s + block)].any():
                pairs |= {(b * gpb + g, t) for t in range(s // dk.TILE_ROWS,
                                                          -(-e // dk.TILE_ROWS))}
    return pairs


@pytest.mark.parametrize("case", ["long", "short", "tiny_blocks", "empty"])
def test_worklist_items_cover_each_window_tile(rng, case):
    """The window pass's worklist (``cascade_worklist_plain``, what its
    summary kernel emits) covers each (group, window tile) pair exactly
    once: a group's pieces are disjoint and contiguous, at most
    ``WINDOW_PIECES`` of them, all but the last of one length and that
    length no shorter than ``PIECE_TILES`` tiles unless the window is;
    groups without a candidate and empty windows have none."""
    block, nb = {"long": (512, 16), "short": (1024, 8), "tiny_blocks": (8, 64),
                 "empty": (256, 8)}[case]
    cand = _window_rows(rng, block * nb, 3, holes=case != "short")
    idx = np.arange(nb)
    ends = {"long": np.minimum(nb, idx + 1 + rng.integers(0, nb, nb)),
            "short": np.minimum(nb, idx + 1 + (idx % 2)),
            "tiny_blocks": np.minimum(nb, idx + 1 + rng.integers(0, 40, nb)),
            "empty": idx}[case]
    if case == "long":
        ends[0] = nb  # one window over every tile
    band_end = torch.from_numpy(ends.astype(np.int32))
    items = dk.cascade_worklist_plain(cand, block, band_end)
    covered = [(g, t) for g, t0, t1 in items for t in range(t0, t1)]
    assert len(covered) == len(set(covered))
    assert set(covered) == _worklist_direct(cand, block, band_end)
    by_group = {}
    for g, t0, t1 in items:
        by_group.setdefault(g, []).append((t0, t1))
    for g, pieces in by_group.items():
        span = pieces[-1][1] - pieces[0][0]
        assert len(pieces) <= dk.WINDOW_PIECES
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:])), (g, pieces)
        sizes = [t1 - t0 for t0, t1 in pieces]
        assert len(set(sizes[:-1])) <= 1 and sizes[-1] <= sizes[0]
        assert min(sizes[0], span) >= min(dk.PIECE_TILES, span)
    if case == "long":
        assert max(len(p) for p in by_group.values()) == dk.WINDOW_PIECES
    if case == "empty":
        assert items == []


def test_windowed_k2_and_scan_refuse_bad_operands():
    cand = torch.zeros((16, 3))
    ends = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        dk.cascade_windows(cand, 8, ends.long())
    with pytest.raises(ValueError, match="band_end"):
        dk.cascade_windows(cand, 8, ends[:1])
    with pytest.raises(ValueError, match="whole blocks"):
        dk.cascade_windows(cand[:12], 8, ends)
    with pytest.raises(ValueError, match="whole blocks"):
        dk.cascade_scan(torch.zeros((12, 3)), torch.ones(12, dtype=torch.bool), 8)
    with pytest.raises(ValueError, match="alive"):
        dk.cascade_scan(torch.zeros((16, 3)), torch.ones(8, dtype=torch.bool), 8)


def _per_block_scan(cand: torch.Tensor, block: int, mp: bool) -> torch.Tensor:
    """The port's per-block host loop before the scan kernel, kept as the
    reference: the blocks' key ranges and candidate counts read to the host,
    and per block with candidates the pre-drop (mp, a buffer), the buffer
    pass, the full square and the band, the survivors appended."""
    n_pad, d = cand.shape
    cand_ok = ~torch.isnan(cand).any(dim=1)
    key = row_sums(cand)
    radius = torch.tensor((d - 1) * 2.0 ** -23, dtype=torch.float32) * row_sums(cand.abs())
    lo = torch.where(cand_ok, key - radius, float("inf")).reshape(-1, block).amin(1).numpy()
    hi = torch.where(cand_ok, key + radius, float("-inf")).reshape(-1, block).amax(1).numpy()
    band_end = _band_ends_np(lo, hi)
    n_cand = cand_ok.reshape(-1, block).sum(1).numpy()
    buf = torch.full((n_pad, d), np.inf, dtype=torch.float32)
    count = 0
    alive_all = torch.zeros(n_pad, dtype=torch.bool)
    ones = torch.ones(block, dtype=torch.bool)
    for b in np.flatnonzero(n_cand):
        s, e = int(b) * block, (int(b) + 1) * block
        blk, alive = cand[s:e], cand_ok[s:e]
        if count:
            ok = torch.ones(count, dtype=torch.bool)
            if mp:
                pre = min(count, 512)
                alive = alive & ~dk.strictly_dominated_bf16_plain(blk, buf[:pre], ok[:pre])
            alive = alive & ~dk.dominated_by_rect_plain(buf[:count].T.contiguous(), ok,
                                                        blk.T.contiguous())
        alive = alive & ~dk.dominated_by_any_plain(blk.T.contiguous(), ones)
        be = int(band_end[b]) * block
        if be > e:
            alive = alive & ~dk.dominated_by_rect_plain(cand[e:be].T.contiguous(),
                                                        cand_ok[e:be], blk.T.contiguous())
        alive_all[s:e] = alive
        m = int(alive.sum())
        buf[count : count + m] = blk[alive]
        count += m
    return alive_all


SCAN_CASES = sorted(set(ADVERSARIAL) - {"empty"}) + ["anti_d4", "dups_d3", "uniform_d8"]


def _scan_case(rng, case):
    if case in ADVERSARIAL:
        return ADVERSARIAL[case]
    kind, d = case.split("_d")
    x = gen_points(rng, 500, int(d), "uniform" if kind == "uniform" else "anti")
    if kind == "dups":
        x = np.concatenate([x, x[:60], np.zeros((40, 3), np.float32)])
    return (x * 64).round().astype(np.float32)


@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("mp", [False, True])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_plain_matches_per_block_loop(monkeypatch, rng, case, mp, block):
    """``cascade_scan_plain`` after the windowed full square and band gives
    the per-block loop's survivors bit for bit, mp off and on, on the
    adversarial cases and random ones with duplicates; the whole mask is
    ``skyline_mask``'s."""
    x = _scan_case(rng, case)
    seen = []
    real = tdc.cascade_scan

    def spy(cand, alive, blk, mp_):
        out = real(cand, alive, blk, mp_)
        seen.append((cand.clone(), out))
        return out

    monkeypatch.setattr(tdc, "cascade_scan", spy)
    n_pad = max(next_pow2(x.shape[0], min_cap=64), block)
    xp = np.concatenate([x, np.full((n_pad - x.shape[0], x.shape[1]), np.inf, np.float32)])
    valid = np.arange(n_pad) < x.shape[0]
    keep = tdc._cascade_core(torch.from_numpy(xp), torch.from_numpy(valid), block, mp)
    (cand, got), = seen
    assert torch.equal(got, _per_block_scan(cand, block, mp)), case
    assert np.array_equal(keep.numpy(), skyline_mask(
        torch.from_numpy(xp), torch.from_numpy(valid)).numpy())


@pytest.mark.parametrize("victims", ["finite", "inf", "nan"])
@pytest.mark.parametrize("tile", ["nan", "invalid"])
def test_kernel_skips_inert_tiles(rng, tile, victims):
    """The scan hands K1/K2 all-NaN rows (non-candidates) and invalid rows
    (the buffer past its count); the value kernel's summary rule
    (``tile_skip_plain``) skips every such dominator tile against any victim
    block, so they cost the summary pass only."""
    d, n = 8, 3 * dk.TILE_ROWS
    x = rng.random((1, d, n)).astype(np.float32)
    valid = np.ones((1, n), bool)
    if tile == "nan":
        x[:] = np.nan
    else:
        valid[:] = False
    y = rng.random((1, d, 2 * dk.BLOCK_VICTIMS)).astype(np.float32)
    y[..., :7] = {"finite": 0.5, "inf": np.inf, "nan": np.nan}[victims]
    skip = dk.tile_skip_plain(torch.from_numpy(x), torch.from_numpy(valid),
                              torch.from_numpy(y), dk.TILE_ROWS, dk.BLOCK_VICTIMS)
    assert skip.all()


# -- union keep ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [3, 6])
def test_keep_union_semantics(rng, d):
    old = gen_points(rng, 200, d, "anti")
    old = old[skyline_mask(torch.from_numpy(old)).numpy()]
    rows = gen_points(rng, 300, d, "uniform")
    keep = tdc.device_cascade_keep(rows, old, "cpu")
    assert np.array_equal(keep, jdc.device_cascade_keep(rows, old))
    assert np.array_equal(keep, sorted_sfs_keep(rows, old))


def test_keep_empty_old_and_rows(rng):
    rows = gen_points(rng, 150, 4, "uniform")
    keep = tdc.device_cascade_keep(rows, np.empty((0, 4), np.float32), "cpu")
    assert np.array_equal(keep, jdc.device_cascade_keep(rows, np.empty((0, 4), np.float32)))
    assert tdc.device_cascade_keep(rows[:0], rows, "cpu").shape == (0,)


def test_keep_duplicate_of_old_survives():
    old = np.array([[1, 1, 1]], np.float32)
    rows = np.array([[1, 1, 1], [2, 2, 2]], np.float32)
    keep = tdc.device_cascade_keep(rows, old, "cpu")
    assert keep[0] and not keep[1]
    assert np.array_equal(keep, jdc.device_cascade_keep(rows, old))


def test_default_device_is_the_card():
    """Without a card the entry point raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        tdc.device_cascade_keep(np.ones((2, 3), np.float32), np.ones((1, 3), np.float32))


# -- the lazy engine, each flush row --------------------------------------------------------

FLUSH_ROWS = {
    "sorted_on": {"SKYLINE_SORTED_SFS": "on"},
    "cascade_on": {"SKYLINE_DEVICE_CASCADE": "on"},
    "both_off": {"SKYLINE_SORTED_SFS": "off", "SKYLINE_DEVICE_CASCADE": "off"},
    "both_auto": {},
    "cascade_auto_sorted_off": {"SKYLINE_SORTED_SFS": "off"},
}


def _drive(engine, windows, chunk=400):
    out, sizes = [], []
    base = 0
    for i, x in enumerate(windows):
        ids = np.arange(base, base + len(x), dtype=np.int64)
        base += len(x)
        for s in range(0, len(x), chunk):
            engine.process_records(ids[s : s + chunk], x[s : s + chunk])
        engine.process_trigger(f"q{i},0")
        out += engine.poll_results()
        sizes.append(np.asarray(engine.pset.sky_counts()).tolist())
    return out, sizes


def _flush_signatures(pset):
    prof = pset._flush_prof
    if prof is None:
        return None
    return sorted((k[0], k[1], k[2], c) for k, (c, _) in prof.snapshot_counts().items())


@pytest.mark.parametrize("row", sorted(FLUSH_ROWS))
@pytest.mark.parametrize("d", [3, 8])
def test_lazy_engine_matches_jax(monkeypatch, d, row):
    """Two windows through the lazy engine with host ingest: answers, local
    sizes and point bytes equal the JAX engine's, and so do the race's
    signatures (two flushes: each is an exploration or a forced path)."""
    for k, v in FLUSH_ROWS[row].items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(7 + d)
    windows = [gen_points(rng, 1500, d, "anti") * np.float32(1000) for _ in range(2)]
    common = dict(parallelism=4, algo="mr-angle", dims=d, domain_max=1000.0,
                  buffer_size=256, emit_skyline_points=True, flush_policy="lazy",
                  ingest="host")
    jeng, teng = JaxEngine(JaxConfig(**common)), SkylineEngine(
        EngineConfig(**common, device="cpu"))
    (wr, ws), (gr, gs) = _drive(jeng, windows), _drive(teng, windows)
    assert gs == ws
    for a, b in zip(wr, gr):
        assert (b["skyline_size"], b["optimality"]) == (a["skyline_size"], a["optimality"])
        pa = np.asarray(a["skyline_points"], np.float32)
        pb = np.asarray(b["skyline_points"], np.float32)
        assert pb.tobytes() == pa.tobytes()
    assert _flush_signatures(teng.pset) == _flush_signatures(jeng.pset)
    want_path = {"sorted_on": "sorted_sfs", "cascade_on": "device_cascade"}.get(row)
    if want_path:
        assert teng.pset.flush_paths == {want_path: 2}


@pytest.mark.parametrize("policy", ["lazy", "overlap"])
@pytest.mark.parametrize("mode", ["off", "on", "auto"])
def test_set_digest_matches_jax(monkeypatch, mode, policy):
    """The published merge digest of a set filled in one flush, the device
    cascade off, forced and racing (the host cascade out of play), equals
    the JAX set's."""
    monkeypatch.setenv("SKYLINE_SORTED_SFS", "off")
    monkeypatch.setenv("SKYLINE_DEVICE_CASCADE", mode)
    states = []
    for make in (lambda: JaxSet(3, 5, flush_policy=policy),
                 lambda: PartitionSet(3, 5, flush_policy=policy, device="cpu")):
        rng = np.random.default_rng(37)
        pset = make()
        fill_pset(pset, rng, gen_points(rng, 600, 5, "anti"), 3)
        fill_pset(pset, rng, gen_points(rng, 300, 5, "uniform"), 3)
        states.append(merge_state(pset))
    assert_same_merge(states[0], states[1], f"{mode}/{policy}")


# -- on the card -----------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("mp", ["0", "1"])
def test_cascade_on_card_matches_cpu(monkeypatch, rng, mp):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    monkeypatch.setenv("SKYLINE_MIXED_PRECISION", mp)
    for d in (3, 8):
        x = gen_points(rng, 5000, d, "anti")
        x = np.concatenate([x, x[:500], np.zeros((300, d), np.float32)])
        dk.reset_launches()
        got = tdc.device_cascade_mask(torch.from_numpy(x).cuda()).cpu().numpy()
        suffix = "_mp" if mp == "1" else ""
        # one launch of each entry a call
        for name in ("cascade_windows", "cascade_scan"):
            assert dk.LAUNCHES[name + suffix] == 1, (name, dict(dk.LAUNCHES))
        assert np.array_equal(got, tdc.device_cascade_mask(torch.from_numpy(x)).numpy())

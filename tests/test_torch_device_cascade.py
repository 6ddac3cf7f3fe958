"""The port's device sorted dominance cascade (``ops/device_cascade.py``)
against the JAX package's on the CPU: masks byte for byte against JAX's
``device_cascade_mask`` (its pure-jnp path, and a few cases with its Pallas
tiles in interpret mode) over uniform, correlated and anti-correlated rows
at d in {3, 4, 8} with duplicates and invalid rows, the reference's
adversarial cases, the 2^24 equal-key band at block 8, NaN rows that
survive and the key radius; ``device_cascade_keep``'s union semantics; the
launch plan of the port's scan (one host read, launches only for blocks with
candidates); and the lazy engine with host ingest, each flush row forced
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
from skyline_tpu_torch.ops.dominance import skyline_mask
from skyline_tpu_torch.ops.dominance_kernels import row_sums
from skyline_tpu_torch.ops.sorted_sfs import sorted_sfs_keep
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
from skyline_tpu_torch.stream.batched import PartitionSet

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


def test_scan_launch_plan(monkeypatch):
    """Blocks without candidates launch nothing; each block with candidates
    launches one K1, one buffer K2 once the buffer has rows, and one band K2
    where its band is not empty; the pre-drop runs with mp and a non-empty
    buffer. The summary is read to the host once."""
    calls = []
    for name in ("dominated_by_any", "dominated_by_rect", "strictly_dominated_bf16_kernel"):
        real = getattr(tdc, name)

        def wrap(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(tdc, name, wrap)
    reads = []
    real_band = tdc._band_ends
    monkeypatch.setattr(tdc, "_band_ends", lambda lo, hi: reads.append(1) or real_band(lo, hi))
    # block 8: rows 0..31 are copies of the zero tuple (one candidate), then
    # 24 distinct rows of one sum, 25, in three blocks whose bands reach each
    # other; invalid padding last
    dup = np.zeros((32, 3), np.float32)
    rest = np.stack([np.arange(1, 25), np.arange(24, 0, -1), np.zeros(24)], 1).astype(np.float32)
    x = np.concatenate([dup, rest])
    n_pad = 64
    x = np.concatenate([x, np.full((n_pad - x.shape[0], 3), np.inf, np.float32)])
    valid = np.arange(n_pad) < 56
    for mp in (False, True):
        calls.clear()
        reads.clear()
        keep = tdc._cascade_core(torch.from_numpy(x), torch.from_numpy(valid), 8, mp)
        assert np.array_equal(keep.numpy(), skyline_mask(
            torch.from_numpy(x), torch.from_numpy(valid)).numpy())
        # candidates lie in blocks 0 (the zero tuple), 4, 5 and 6: K1 on each;
        # a buffer K2 on 4, 5 and 6 and a band K2 on 4 and 5
        assert calls.count("dominated_by_any") == 4 and reads == [1]
        assert calls.count("dominated_by_rect") == 5
        assert calls.count("strictly_dominated_bf16_kernel") == (3 if mp else 0)


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
        assert dk.LAUNCHES["dominated_by_any" + ("_mp" if mp == "1" else "")] > 0
        assert np.array_equal(got, tdc.device_cascade_mask(torch.from_numpy(x)).numpy())

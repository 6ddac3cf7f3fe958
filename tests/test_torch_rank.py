"""The rank cascade of the port (``skyline_tpu_torch.ops.dominance_kernels``
K4–K7, the plain rank predicate, the rank knob and the K7 dispatch) against
the JAX package: ``rank_transform`` and the rank Pallas kernels run in
interpret mode on the CPU, as ``tests/test_pallas_vmap.py`` runs them.
Exact equality (tolerance 0) on inputs made from a seed with numpy: ties,
duplicates, invalid rows, ``-0.0`` and rank sums past float32's 2^24 limit.

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA kernel
runs only on a card (the ``cuda``-marked test at the end).
"""

import os
import stat
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.analysis import registry as jreg
from skyline_tpu.ops.pallas_dominance import (
    dominated_by_any_rank_pallas,
    dominated_by_rank_pallas,
    rank_transform as j_rank_transform,
    skyline_mask_rank_pallas,
)
from skyline_tpu_torch.ops import dispatch as tdispatch
from skyline_tpu_torch.ops import dominance_kernels as dk
from skyline_tpu_torch.ops.dominance import dominated_by_rank, rank_dominance_mask, skyline_mask
from skyline_tpu_torch.utils import knobs

torch.set_num_threads(1)

TILES = dict(row_tile=256, col_tile=512, interpret=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(rng, n, d, kind):
    """Integer rows: ``ties`` from a tiny domain (duplicates, tied sums and
    ranks), ``wide`` from 0..10000; a few duplicated and ``-0.0`` rows."""
    hi = 6 if kind == "ties" else 10001
    x = rng.integers(0, hi, size=(n, d)).astype(np.float32)
    x[rng.integers(0, n, n // 10)] = x[rng.integers(0, n, n // 10)]
    x[: n // 50] = -0.0
    x[n // 50 : n // 25, 0] = -0.0
    return x


def _ranks(x, valid):
    return np.array(j_rank_transform(jnp.asarray(x), jnp.asarray(valid)))


def _rank_sorted(rt, valid):
    """Columns of a (d+1, N) rank matrix sorted by rank sum, invalid last:
    the order the reference's triangular tile skip needs."""
    keys = np.where(valid, rt[-1].astype(np.int64), np.iinfo(np.int64).max)
    order = np.argsort(keys, kind="stable")
    return np.ascontiguousarray(rt[:, order]), valid[order]


@pytest.mark.parametrize("kind", ["ties", "wide"])
@pytest.mark.parametrize("d", [3, 8])
def test_k4_rank_transform_matches_jax(rng, d, kind):
    n = 1000
    x = _rows(rng, n, d, kind)
    x[5] = np.inf  # a valid +inf row ranks with the invalid rows
    valid = rng.random(n) < 0.85
    got = dk.rank_transform(_t(x), _t(valid))
    assert got.dtype == torch.int32 and got.shape == (d + 1, n)
    assert got.numpy().tobytes() == _ranks(x, valid).tobytes()


@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("kind", ["ties", "wide"])
@pytest.mark.parametrize("d", [3, 8])
def test_k5_matches_pallas(rng, d, kind, triangular):
    n = 1024
    x = _rows(rng, n, d, kind)
    valid = rng.random(n) < 0.85
    rt = _ranks(x, valid)
    if triangular:
        rt, valid = _rank_sorted(rt, valid)
    want = np.asarray(
        dominated_by_any_rank_pallas(
            jnp.asarray(rt), jnp.asarray(valid), triangular=triangular, **TILES
        )
    )
    got = dk.dominated_by_any_rank(_t(rt), _t(valid), triangular=triangular).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["ties", "wide"])
@pytest.mark.parametrize("d", [3, 8])
def test_k6_matches_pallas(rng, d, kind):
    nx, ny = 512, 1536
    x = _rows(rng, nx + ny, d, kind)
    valid = rng.random(nx + ny) < 0.8
    rt = _ranks(x, valid)  # one universe for dominators and victims
    xt, xv, yt = rt[:, :nx], valid[:nx], rt[:, nx:]
    want = np.asarray(
        dominated_by_rank_pallas(jnp.asarray(xt), jnp.asarray(xv), jnp.asarray(yt), **TILES)
    )
    got = dk.dominated_by_rank_rect(_t(xt), _t(xv), _t(yt)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("d", [3, 8])
def test_batched_k5_k6_match_vmapped_pallas(rng, d):
    """The leading partition dimension stands where the reference vmaps
    the pallas_call."""
    P, nx, ny = 3, 512, 1024
    xs, ys, vs = [], [], []
    for _ in range(P):
        x = _rows(rng, nx + ny, d, "ties")
        v = rng.random(nx + ny) < 0.8
        rt = _ranks(x, v)
        xs.append(rt[:, :nx])
        ys.append(rt[:, nx:])
        vs.append(v[:nx])
    xt, yt, xv = np.stack(xs), np.stack(ys), np.stack(vs)
    rect = jax.vmap(lambda a, v, b: dominated_by_rank_pallas(a, v, b, **TILES))
    want = np.asarray(rect(jnp.asarray(xt), jnp.asarray(xv), jnp.asarray(yt)))
    got = dk.dominated_by_rank_rect(_t(xt), _t(xv), _t(yt)).numpy()
    assert got.shape == (P, ny) and np.array_equal(got, want)
    selfdom = jax.vmap(lambda a, v: dominated_by_any_rank_pallas(a, v, **TILES))
    want = np.asarray(selfdom(jnp.asarray(xt), jnp.asarray(xv)))
    got = dk.dominated_by_any_rank(_t(xt), _t(xv)).numpy()
    assert got.shape == (P, nx) and np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["ties", "wide"])
@pytest.mark.parametrize("d", [3, 4, 8])
@pytest.mark.parametrize("n", [700, 1024])
def test_k7_matches_pallas(rng, d, n, kind):
    x = _rows(rng, n, d, kind)
    valid = rng.random(n) < 0.9
    want = np.asarray(skyline_mask_rank_pallas(jnp.asarray(x), jnp.asarray(valid), **TILES))
    got = dk.skyline_mask_rank_kernel(_t(x), _t(valid)).numpy()
    assert np.array_equal(got, want)
    # the rank embedding is exact: K7 equals the value-space mask
    assert np.array_equal(got, skyline_mask(_t(x), _t(valid)).numpy())
    want = np.asarray(skyline_mask_rank_pallas(jnp.asarray(x), **TILES))
    assert np.array_equal(dk.skyline_mask_rank_kernel(_t(x)).numpy(), want)


@pytest.mark.parametrize("base", [2_097_152, 4_194_304])
def test_rank_sums_exact_past_f32_limit(base):
    """Rank sums of ~2^24 and ~2^25 that differ by exactly 1 are one ulp
    apart or tied in float32; the int32 predicate must resolve them, as the
    reference's does (``tests/test_pallas_vmap.py``)."""
    d, n = 8, 1024
    rt = np.zeros((d + 1, n), dtype=np.int32)
    rt[:d, 0] = base
    rt[d, 0] = d * base
    rt[:d, 1] = base
    rt[0, 1] = base + 1
    rt[d, 1] = d * base + 1
    rt[:d, 2] = base  # a duplicate of row 0: never dominated by it
    rt[d, 2] = d * base
    assert np.float32(d * base) == np.float32(d * base + 1)
    valid = np.zeros(n, dtype=bool)
    valid[:3] = True
    want = np.asarray(
        dominated_by_rank_pallas(jnp.asarray(rt), jnp.asarray(valid), jnp.asarray(rt), **TILES)
    )
    got = dk.dominated_by_rank_rect(_t(rt), _t(valid), _t(rt)).numpy()
    assert np.array_equal(got, want)
    assert got[1] and not got[0] and not got[2]
    assert np.array_equal(dk.dominated_by_any_rank(_t(rt), _t(valid)).numpy(), got)


def test_rank_predicate_matches_value_predicate(rng):
    """Over one universe, rank dominance is value dominance."""
    x = _rows(rng, 600, 4, "ties")
    rt = _t(_ranks(x, np.ones(600, bool)).T)
    from skyline_tpu_torch.ops.dominance import dominance_mask

    assert torch.equal(rank_dominance_mask(rt, rt), dominance_mask(_t(x), _t(x)))
    assert torch.equal(dominated_by_rank(rt[:100], rt), dominance_mask(_t(x), _t(x[:100])).any(0))


def test_cpu_path_launches_nothing(rng):
    dk.reset_launches()
    x = _rows(rng, 64, 3, "ties")
    v = np.ones(64, bool)
    rt = dk.rank_transform(_t(x), _t(v))
    dk.dominated_by_any_rank(rt, _t(v))
    dk.dominated_by_rank_rect(rt, _t(v), rt)
    dk.skyline_mask_rank_kernel(_t(x), _t(v))
    assert dk.LAUNCHES == {k: 0 for k in dk.LAUNCHES}


@pytest.mark.parametrize("bad", ["f32", "noncontig", "valid_shape", "y_rows"])
def test_rank_wrappers_reject_bad_inputs(bad):
    rt = torch.zeros((4, 32), dtype=torch.int32)
    v = torch.ones(32, dtype=torch.bool)
    y = torch.zeros((4, 16), dtype=torch.int32)
    if bad == "f32":
        args, err = (rt.float(), v), TypeError
    elif bad == "noncontig":
        args, err = (torch.zeros((32, 4), dtype=torch.int32).T, v), ValueError
    elif bad == "valid_shape":
        args, err = (rt, v[:5]), ValueError
    else:
        with pytest.raises(ValueError):
            dk.dominated_by_rank_rect(rt, v, torch.zeros((5, 16), dtype=torch.int32))
        return
    with pytest.raises(err):
        dk.dominated_by_any_rank(*args)
    with pytest.raises(err):
        dk.dominated_by_rank_rect(args[0], args[1], y)


def test_k4_k7_reject_bad_inputs():
    with pytest.raises(ValueError):
        dk.rank_transform(torch.zeros(8, 3), None)
    with pytest.raises(TypeError):
        dk.rank_transform(torch.zeros(8, 3, dtype=torch.float64), torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError):
        dk.skyline_mask_rank_kernel(torch.zeros(8, 3), torch.ones(7, dtype=torch.bool))


@pytest.mark.parametrize("raw", [None, "", "1", "true", " ON ", "yes", "0", "off", "No", "maybe"])
@pytest.mark.parametrize("default", [False, True])
def test_knob_parsing_matches_jax(raw, default):
    assert knobs.parse_bool(raw, default) == jreg.parse_bool(raw, default)


def test_rank_cascade_knob(monkeypatch):
    monkeypatch.delenv("SKYLINE_RANK_CASCADE", raising=False)
    assert knobs.rank_cascade() is False
    monkeypatch.setenv("SKYLINE_RANK_CASCADE", "1")
    assert knobs.rank_cascade() is True
    monkeypatch.setenv("SKYLINE_RANK_CASCADE", "bogus")
    knobs._warned.discard("SKYLINE_RANK_CASCADE")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert knobs.rank_cascade() is False
    assert any("SKYLINE_RANK_CASCADE" in str(w.message) for w in caught)


def test_mask_dispatch_picks_k7_on_the_card_only(rng, monkeypatch):
    """On a CUDA tensor the gate picks K7 over K3; a CPU tensor takes the
    plain mask whatever the gate says."""
    x = _t(_rows(rng, 300, 4, "ties"))
    v = torch.ones(300, dtype=torch.bool)
    calls = []
    monkeypatch.setattr(tdispatch, "on_cuda", lambda t: True)
    monkeypatch.setattr(tdispatch, "skyline_mask_kernel",
                        lambda *a, mp: calls.append(("K3", mp)))
    monkeypatch.setattr(tdispatch, "skyline_mask_rank_kernel", lambda *a: calls.append("K7"))
    monkeypatch.setenv("SKYLINE_MIXED_PRECISION", "1")
    # the quadratic kernel alone: under auto a concrete call on a card races
    # it against the device cascade
    monkeypatch.setenv("SKYLINE_DEVICE_CASCADE", "off")
    for gate in ("1", "0"):
        monkeypatch.setenv("SKYLINE_RANK_CASCADE", gate)
        tdispatch.skyline_mask_auto(x, v)
    assert calls == ["K7", ("K3", True)]
    monkeypatch.undo()
    monkeypatch.setenv("SKYLINE_RANK_CASCADE", "1")
    assert torch.equal(tdispatch.skyline_mask_auto(x, v), skyline_mask(x, v))


def _fake_nvcc(tmp_path, fail=False):
    """A stand-in compiler: writes the ``-o`` file and a ptxas line, or
    fails. Written once per test, before any build starts: rewriting a
    script that a running compiler is executing can fail that compiler."""
    script = tmp_path / "nvcc"
    body = (
        "echo 'nvcc: error' >&2; exit 3"
        if fail
        else 'out=""; prev=""; for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; '
        'prev="$a"; done; echo "ptxas info: Used 30 registers" >&2; echo lib > "$out"'
    )
    script.write_text(f"#!/bin/sh\n{body}\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_build_runs_one_compiler_per_source_and_caches(tmp_path, monkeypatch):
    monkeypatch.setattr(dk, "BUILD_DIR", tmp_path / "build")
    nvcc, calls = _fake_nvcc(tmp_path), []
    monkeypatch.setattr(dk, "_nvcc", lambda: calls.append(nvcc) or nvcc)
    built = dk.build()
    assert len(calls) == 1  # resolved once for every source
    assert set(built) == set(dk.SOURCES)
    for path, log in built.values():
        assert path.exists() and "registers" in log
    assert sorted(os.listdir(tmp_path / "build")) == sorted(p.name for p, _ in built.values())
    again = dk.build()
    assert {k: v[0] for k, v in again.items()} == {k: v[0] for k, v in built.items()}
    assert all(log == "" for _, log in again.values())
    assert len(calls) == 1  # a cached build needs no compiler


def test_build_raises_when_the_compiler_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(dk, "BUILD_DIR", tmp_path / "build")
    nvcc = _fake_nvcc(tmp_path, fail=True)
    monkeypatch.setattr(dk, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        dk.build()
    assert os.listdir(tmp_path / "build") == []


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 8, 16])
def test_rank_kernels_match_plain_on_card(rng, cuda_card, d):
    n = 3001  # ragged: no tile multiple
    x = torch.from_numpy(_rows(rng, n, d, "ties")).to(cuda_card)
    v = torch.from_numpy(rng.random(n) < 0.9).to(cuda_card)
    rt = dk.rank_transform(x, v)
    assert torch.equal(rt.cpu(), dk.rank_transform(x.cpu(), v.cpu()))
    assert torch.equal(dk.dominated_by_any_rank(rt, v), dk.dominated_by_any_rank_plain(rt, v))
    yt = rt[:, ::2].contiguous()
    assert torch.equal(
        dk.dominated_by_rank_rect(rt, v, yt), dk.dominated_by_rank_rect_plain(rt, v, yt)
    )
    assert torch.equal(dk.skyline_mask_rank_kernel(x, v), dk.skyline_mask_rank_plain(x, v))

"""The port's device mesh (``skyline_tpu_torch/parallel/mesh.py`` and
``pipeline.py``) against the JAX package's on the CPU.

JAX runs on the eight virtual CPU devices ``conftest.py`` makes; the port's
mesh puts every place on the CPU (``make_mesh(n, device="cpu")``). The
same seeded rows go through both at n in {1, 2, 4, 8}: the two-phase
step's ``local_keep`` and ``global_keep``, ``skyline_keep_np_sharded`` and
the window pipeline's mask, counts and order are compared bit for bit, on
ordinary rows and on the value hazards (+-inf, NaN, -0.0 against +0.0,
duplicates, ties of infinite sums and sums that round together).

The reference's blocked local mask misses a dominator with an equal sum
in a later block (pinned below); over several places its cross phase
prunes such a row again, so its ``global_keep`` is exact, but one place
answers with the local mask. The port's masks are exact, so
``local_keep`` is compared bit for bit where the reference's local phase
is one block, and otherwise held to the exact mask with the reference's
extra rows each shown to be such a miss."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.ops.block_skyline import skyline_mask_blocked as jax_blocked
from skyline_tpu.ops.dominance import skyline_mask as jax_skyline_mask
from skyline_tpu.parallel import make_mesh as jax_make_mesh
from skyline_tpu.parallel.mesh import build_two_phase as jax_two_phase
from skyline_tpu.parallel.mesh import shard_rows as jax_shard_rows
from skyline_tpu.parallel.mesh import skyline_keep_np_sharded as jax_keep_sharded
from skyline_tpu.parallel.pipeline import build_window_pipeline as jax_pipeline
from skyline_tpu_torch.ops.dispatch import skyline_keep_np
from skyline_tpu_torch.ops.dominance import skyline_mask
from skyline_tpu_torch.parallel import make_mesh, sharded_two_phase_skyline
from skyline_tpu_torch.parallel.mesh import (
    AXIS,
    Mesh,
    build_two_phase,
    shard_rows,
    skyline_keep_np_sharded,
)
from skyline_tpu_torch.parallel.pipeline import build_window_pipeline

from conftest import gen_points

torch.set_num_threads(1)

PLACES = [1, 2, 4, 8]
KINDS = ["uniform", "anti", "inf", "nan", "signed_zero", "mixed", "duplicates",
         "inf_ties", "round_ties"]


def mesh_rows(kind: str, d: int, n: int, seed: int = 0) -> np.ndarray:
    """(n, d) float32 rows of ``kind``: a workload shape, or one of the
    value hazards of the dominance comparisons."""
    rng = np.random.default_rng(seed + 17 * KINDS.index(kind))
    if kind in ("uniform", "anti"):
        return gen_points(rng, n, d, kind) * 1000.0
    x = (rng.integers(0, 6, (n, d)) / 4.0).astype(np.float32)
    if kind == "inf":
        x[rng.random((n, d)) < 0.1] = np.inf
        x[rng.random((n, d)) < 0.05] = -np.inf
    elif kind == "nan":
        x[rng.random((n, d)) < 0.08] = np.nan
    elif kind == "signed_zero":
        x[rng.random((n, d)) < 0.4] = 0.0
        x[rng.random((n, d)) < 0.3] = -0.0
    elif kind == "mixed":
        r = rng.random((n, d))
        x[r < 0.05] = np.inf
        x[(r >= 0.05) & (r < 0.1)] = np.nan
        x[(r >= 0.1) & (r < 0.3)] = -0.0
        x[(r >= 0.3) & (r < 0.35)] = -np.inf
    elif kind == "duplicates":
        x = np.repeat(x[: n // 8], 8, axis=0)
        rng.shuffle(x)
    elif kind == "inf_ties":
        # every sum +inf: the dominators of a row tie with it in sum order
        x[:, 0] = np.inf
    elif kind == "round_ties":
        # 1e8 absorbs the small coordinates: sums round together
        x[:, 0] = 1e8
    return np.ascontiguousarray(x, dtype=np.float32)


def _jax_step(n, local_block, cross_block):
    mesh = jax_make_mesh(n)
    return mesh, jax_two_phase(mesh, local_block=local_block, cross_block=cross_block)


def _both_two_phase(x, valid, n, local_block, cross_block):
    jmesh, jstep = _jax_step(n, local_block, cross_block)
    jl, jg = jstep(*jax_shard_rows(jmesh, x, valid))
    step = build_two_phase(make_mesh(n, device="cpu"), local_block=local_block,
                           cross_block=cross_block)
    tl, tg = step(x, valid)
    return (np.asarray(jl), np.asarray(jg)), (tl.numpy(), tg.numpy())


def _exact_local(x, valid, n):
    """Each place's exact local mask (the dense mask of its shard)."""
    out = []
    for xs, vs in zip(np.split(x, n), np.split(valid, n)):
        out.append(skyline_mask(torch.from_numpy(xs), torch.from_numpy(vs)).numpy())
    return np.concatenate(out)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", PLACES)
def test_two_phase_matches_jax(n, kind):
    """512 rows of d = 3, one in ten invalid: the reference's local phase is
    one block (512 // n rows), so both masks are exact and equal bit for
    bit; the global mask equals the unsharded mask."""
    x = mesh_rows(kind, 3, 512)
    valid = np.random.default_rng(n).random(512) < 0.9
    (jl, jg), (tl, tg) = _both_two_phase(x, valid, n, 512 // n, 128)
    assert np.array_equal(tl, jl) and np.array_equal(tg, jg)
    assert np.array_equal(tg, skyline_mask(torch.from_numpy(x), torch.from_numpy(valid)).numpy())
    assert not (tl & ~valid).any() and (tl | ~tg).all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 4])
def test_two_phase_small_blocks(n, kind):
    """Local blocks of 32 and cross blocks of 64. The port's local mask is
    each shard's exact mask; where the reference keeps more, each extra row
    has a dominator of equal sum in its shard (the reference's blocked-mask
    miss). Over several places the cross phase prunes those rows again and
    the global masks equal bit for bit; on one place the reference answers
    with its local mask (its shortcut), misses included, and the port with
    the exact one."""
    x = mesh_rows(kind, 3, 512)
    valid = np.ones(512, dtype=bool)
    (jl, jg), (tl, tg) = _both_two_phase(x, valid, n, 32, 64)
    if n > 1:
        assert np.array_equal(tg, jg)
    else:
        assert np.array_equal(jg, jl) and np.array_equal(tg, tl)
    assert np.array_equal(tl, _exact_local(x, valid, n))
    assert (jl | ~tl).all()
    per = 512 // n
    sums = x.sum(axis=1, dtype=np.float32)
    for j in np.flatnonzero(jl & ~tl):
        lo = (j // per) * per
        shard = x[lo : lo + per]
        dom = np.all(shard <= x[j], axis=1) & np.any(shard < x[j], axis=1)
        assert (sums[lo : lo + per][dom] == sums[j]).any()


def test_reference_blocked_mask_misses_equal_sum_dominators():
    """Found in the reference and not copied: ``skyline_mask_blocked``
    (``skyline_tpu/ops/block_skyline.py:67``) prunes block j only by
    blocks i <= j in sum order, so 64 rows (+inf, 1) ahead of their
    dominator (+inf, 0) in a later block survive. The port's mask, K3's
    plain version and the dense mask keep only the dominator."""
    from skyline_tpu_torch.ops.block_skyline import skyline_mask_blocked

    x = np.zeros((128, 2), np.float32)
    x[:, 0] = np.inf
    x[:, 1] = 1.0
    x[127, 1] = 0.0
    ref = np.asarray(jax_blocked(jnp.asarray(x), block=64))
    dense = np.asarray(jax_skyline_mask(jnp.asarray(x)))
    got = skyline_mask_blocked(torch.from_numpy(x), block=64).numpy()
    assert ref.sum() == 65 and dense.sum() == 1
    assert np.array_equal(got, dense)


def test_two_phase_with_interleaved_padding(rng):
    """Padding rows scattered over the shards never survive; both masks
    equal the reference's (its test_mesh.py case)."""
    x = np.full((256, 2), np.inf, np.float32)
    x[:200] = rng.uniform(0, 1000, size=(200, 2))
    valid = np.arange(256) < 200
    perm = rng.permutation(256)
    x, valid = x[perm], valid[perm]
    (jl, jg), (tl, tg) = _both_two_phase(x, valid, 4, 64, 64)
    assert np.array_equal(tl, jl) and np.array_equal(tg, jg)
    assert not (tg & ~valid).any()


@pytest.mark.parametrize("n", PLACES)
def test_keep_np_sharded_matches_jax(n):
    """The engine's meshed merge: the power-of-two pad (at least 1,024,
    a multiple of the place count), +inf pad rows and the sliced mask, at
    0, 1, 300 and 1,500 rows, equal the reference's and the flat
    ``skyline_keep_np``."""
    jmesh, mesh = jax_make_mesh(n), make_mesh(n, device="cpu")
    for rows in (0, 1, 300, 1500):
        x = mesh_rows("anti", 4, rows, seed=rows) if rows else np.zeros((0, 4), np.float32)
        want = jax_keep_sharded(jmesh, x)
        got = skyline_keep_np_sharded(mesh, x)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        if rows:
            assert np.array_equal(got, skyline_keep_np(x, "cpu"))


@pytest.mark.parametrize("kind", ["uniform", "mixed"])
@pytest.mark.parametrize("algo", ["mr-angle", "mr-grid", "mr-dim"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_window_pipeline_matches_jax(n, algo, kind):
    """Routing on the device, the stable place sort with invalid rows last,
    the two-phase: the global mask, both counts and the order equal the
    reference's bit for bit."""
    x = mesh_rows(kind, 3, 512, seed=3)
    if kind == "uniform":
        x = x / 1000.0 * 100.0
    valid = np.random.default_rng(5).random(512) < 0.85
    jstep = jax_pipeline(jax_make_mesh(n), algo=algo, domain_max=100.0,
                         local_block=512 // n, cross_block=128)
    jg, jlc, jgc, jo = jstep(jnp.asarray(x), jnp.asarray(valid))
    step = build_window_pipeline(make_mesh(n, device="cpu"), algo=algo, domain_max=100.0,
                                 local_block=512 // n, cross_block=128)
    tg, tlc, tgc, to = step(torch.from_numpy(x), torch.from_numpy(valid))
    assert np.array_equal(to.numpy(), np.asarray(jo))
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    assert (int(tlc), int(tgc)) == (int(jlc), int(jgc))


def test_mesh_value_semantics():
    """Equal meshes are equal and hash alike (the cached step is shared);
    shape, names, devices and shards follow the reference's mesh."""
    a, b = make_mesh(4, device="cpu"), make_mesh(4, device="cpu")
    assert a == b and hash(a) == hash(b) and a != make_mesh(2, device="cpu")
    ref = jax_make_mesh(4)
    assert a.axis_names == ref.axis_names == (AXIS,)
    assert a.shape == dict(ref.shape) and a.devices.shape == ref.devices.shape
    assert make_mesh(device="cpu").size == 1
    custom = make_mesh(2, axis="workers", device="cpu")
    assert custom.axis_names == ("workers",) and custom.shape == {"workers": 2}
    with pytest.raises(ValueError):
        Mesh(a.places, (3,), (AXIS,))
    x = mesh_rows("uniform", 3, 64)
    xs, vs = shard_rows(a, x, np.ones(64, bool))
    assert [s.shape[0] for s in xs] == [16] * 4
    assert np.array_equal(torch.cat(xs).numpy(), x) and all(v.all() for v in vs)
    with pytest.raises(ValueError, match="do not split"):
        shard_rows(a, x[:63], np.ones(63, bool))
    l1, g1 = sharded_two_phase_skyline(a, x, np.ones(64, bool))
    l2, g2 = sharded_two_phase_skyline(b, xs, vs)
    assert torch.equal(l1, l2) and torch.equal(g1, g2)

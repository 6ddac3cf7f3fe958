"""``SlidingSkyline``, K3 over a partition batch and the phase tracer of the
port, against the JAX package on the CPU, exact bytes.

``SlidingSkyline`` slide by slide (each result's skyline bytes, window end
and fill flag) and ``current_skyline`` with rows pending; K3's batch form
(``skyline_mask_kernel`` on (P, N, d)) — its plain version against K3 per
partition, against the reference's vmapped ``skyline_mask_pallas`` in
interpret mode (finite and NaN rows) and ``skyline_mask`` (infinite row
sums, where the Pallas kernel's positional skip is not exact), and its card
path (sort, gather, one launch, scatter) with
the launch replaced by plain K1. The ``cuda``-marked legs skip without a
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from skyline_tpu.metrics.tracing import Tracer as JaxTracer
from skyline_tpu.ops import skyline_np
from skyline_tpu.ops.dominance import skyline_mask as jax_skyline_mask
from skyline_tpu.ops.pallas_dominance import skyline_mask_pallas
from skyline_tpu.stream.sliding import SlidingSkyline as JaxSliding
from skyline_tpu.workload.generators import generate
from skyline_tpu_torch.metrics.tracing import NULL_TRACER, Tracer
from skyline_tpu_torch.ops import dominance_kernels as dk
from skyline_tpu_torch.stream.sliding import SlidingSkyline

from conftest import assert_same_set

torch.set_num_threads(1)

# coordinates that stress the kernels: signed zeros, infinities, NaN, ties
POOL = np.array([-np.inf, -1.0, -0.0, 0.0, 1.0, 2.0, np.inf, np.nan], np.float32)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# -- SlidingSkyline -------------------------------------------------------------


def test_rejects_misaligned_slide():
    with pytest.raises(ValueError):
        SlidingSkyline(window_size=100, slide=33, dims=2, device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlidingSkyline(window_size=100, slide=50, dims=2)


def _push_both(x, W, S, d, splits):
    want, got = JaxSliding(W, S, d), SlidingSkyline(W, S, d, device="cpu")
    rw, rg = [], []
    for chunk in np.array_split(x, splits):
        rw += want.push(chunk)
        rg += got.push(chunk)
    return want, got, rw, rg


@pytest.mark.parametrize("d,dist", [(2, "uniform"), (3, "anti_correlated"), (8, "anti_correlated")])
def test_every_slide_matches_jax(d, dist):
    """Ragged batches crossing slides, the ring wrapping twice: each
    slide's skyline bytes (slot order after the wrap), window end and fill
    flag equal the JAX package's, and the numpy oracle's set."""
    rng = np.random.default_rng(10 + d)
    W, S, n = 600, 200, 2000
    x = generate(dist, rng, n, d, 0, 1000)
    x[5:15] = x[0]  # duplicates in one bucket
    x[400:410, 0] = -0.0
    _, _, rw, rg = _push_both(x, W, S, d, 23)
    assert len(rg) == len(rw) == n // S
    for a, b in zip(rw, rg):
        assert b["window_end"] == a["window_end"]
        assert b["window_filled"] == a["window_filled"]
        assert b["skyline"].dtype == np.float32
        assert b["skyline"].tobytes() == np.asarray(a["skyline"]).tobytes()
        end = b["window_end"]
        assert_same_set(b["skyline"], skyline_np(x[max(0, end + 1 - W) : end + 1]))


def test_eviction_resurrects_shadowed_points():
    # a dominated point reappears once its dominator slides out
    sw = SlidingSkyline(window_size=4, slide=2, dims=2, device="cpu")
    dominator = np.array([[1.0, 1.0], [900.0, 900.0]], dtype=np.float32)
    shadowed = np.array([[5.0, 5.0], [800.0, 800.0]], dtype=np.float32)
    filler = np.array([[700.0, 600.0], [600.0, 700.0]], dtype=np.float32)
    sw.push(dominator)
    r2 = sw.push(shadowed)
    assert not any((r2[0]["skyline"] == [5.0, 5.0]).all(axis=1))
    r3 = sw.push(filler)
    assert any((r3[0]["skyline"] == [5.0, 5.0]).all(axis=1))


@pytest.mark.parametrize("stop", [1, 150, 200, 730, 1000, 1190])
def test_current_skyline_matches_jax(stop):
    """Before any slide, mid-slide, at a slide boundary (the cached window
    skyline) and after the ring wrapped with rows pending."""
    rng = np.random.default_rng(stop)
    x = generate("anti_correlated", rng, stop, 3, 0, 1000)
    want, got, _, _ = _push_both(x, 400, 200, 3, max(1, stop // 90))
    cur = got.current_skyline
    assert cur.tobytes() == np.asarray(want.current_skyline).tobytes()
    # the cache is the caller's copy: mutating it changes nothing
    cur[:] = -1.0
    assert got.current_skyline.tobytes() == np.asarray(want.current_skyline).tobytes()


def test_push_copies_pending_rows():
    sw = SlidingSkyline(window_size=100, slide=50, dims=2, device="cpu")
    batch = np.array([[10.0, 10.0]], dtype=np.float32)
    sw.push(batch)
    batch[:] = 0.0  # the caller reuses its buffer
    assert sw.current_skyline.tolist() == [[10.0, 10.0]]


# -- K3 over a partition batch ---------------------------------------------------


def _batch_case(rng, P, n, d):
    """(P, n, d) rows from the stress pool with duplicates, (P, n) validity
    with an empty partition and an invalid-but-finite tail."""
    x = POOL[rng.integers(0, POOL.size, size=(P, n, d))]
    x[:, n // 2 :] = x[:, : n - n // 2]  # duplicate rows
    valid = rng.random((P, n)) < 0.8
    if P > 1:
        valid[1] = False
    return np.ascontiguousarray(x, dtype=np.float32), valid


@st.composite
def _batches(draw):
    P = draw(st.integers(1, 4))
    n = draw(st.integers(0, 50))
    d = draw(st.sampled_from([1, 3, 8]))
    return _batch_case(np.random.default_rng(draw(st.integers(0, 2**32 - 1))), P, n, d)


@settings(max_examples=60, deadline=None)
@given(_batches())
def test_batched_plain_matches_k3_per_partition(case):
    x, v = case
    xt, vt = torch.from_numpy(x), torch.from_numpy(v)
    got = dk.skyline_mask_kernel(xt, vt)  # the CPU path: the plain version
    assert got.shape == v.shape and got.dtype == torch.bool
    for p in range(x.shape[0]):
        assert torch.equal(got[p], dk.skyline_mask_kernel(xt[p], vt[p]))
    assert torch.equal(dk.skyline_mask_kernel(xt), dk.skyline_mask_plain(xt, torch.ones_like(vt)))


def _card_path_on_cpu(monkeypatch):
    """Run the wrapper's card path on CPU tensors: the sort, gather,
    transpose and scatter as on the card, the launch replaced by plain K1
    on exactly the tensors the kernel would get."""
    calls = []

    def launch(name, x3, v2, y3, mp=False):
        assert x3.is_contiguous() and x3 is y3 and v2.shape == (x3.shape[0], x3.shape[2])
        calls.append((name, tuple(x3.shape), mp))
        return dk.dominated_by_any_plain(x3, v2)

    monkeypatch.setattr(dk, "_device_path", lambda t, name: True)
    monkeypatch.setattr(dk, "_launch", launch)
    return calls


@pytest.mark.parametrize("P,n,d", [(1, 257, 3), (3, 300, 4), (8, 64, 8), (2, 0, 3)])
def test_batched_card_path_is_one_launch(rng, monkeypatch, P, n, d):
    x, v = _batch_case(rng, P, n, d)
    want = dk.skyline_mask_plain(torch.from_numpy(x), torch.from_numpy(v))
    calls = _card_path_on_cpu(monkeypatch)
    got = dk.skyline_mask_kernel(torch.from_numpy(x), torch.from_numpy(v))
    assert torch.equal(got, want)
    assert calls == [("skyline_mask_kernel", (P, d, n), False)]
    # the unbatched form still launches with P = 1
    calls.clear()
    assert torch.equal(dk.skyline_mask_kernel(torch.from_numpy(x[0]), torch.from_numpy(v[0])), want[0])
    assert calls == [("skyline_mask_kernel", (1, d, n), False)]


def test_batched_matches_vmapped_pallas(rng):
    """The reference's slide step vmaps ``skyline_mask_pallas`` over the
    partitions; the port's batch form gives its masks on finite and NaN
    rows, duplicates, signed zeros, the north-star's zero block and an
    empty partition included."""
    x, v = _batch_case(rng, 3, 300, 8)
    x[~np.isnan(x) & ~np.isfinite(x)] = 2.0  # infinite sums: see below
    x[2, :100] = 0.0
    x[2, 100:110] = -0.0
    want = jax.vmap(lambda a, b: skyline_mask_pallas(a, b, interpret=True))(
        jnp.asarray(x), jnp.asarray(v)
    )
    got = dk.skyline_mask_kernel(torch.from_numpy(x), torch.from_numpy(v))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_batched_matches_reference_mask_on_infinite_sums(rng):
    """Rows with +inf and -inf coordinates: the port's batch form equals
    the reference's exact ``skyline_mask`` per partition."""
    x, v = _batch_case(rng, 3, 300, 8)
    want = jax.vmap(jax_skyline_mask)(jnp.asarray(x), jnp.asarray(v))
    got = dk.skyline_mask_kernel(torch.from_numpy(x), torch.from_numpy(v))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_reference_pallas_k3_misses_dominators_of_equal_infinite_sum():
    """The reference's ``skyline_mask_pallas`` skips by sorted position, so
    a dominator sorted after its victims on an equal key (+inf here) is
    never compared: it keeps all 1,024 rows, where its own
    ``skyline_mask``, the port's K3 (exact sum bounds, never position) and
    the oracle keep one."""
    x = np.full((1024, 2), np.inf, np.float32)
    x[:, 1] = 1.0
    x[1023, 1] = 0.0
    exact = np.asarray(jax_skyline_mask(jnp.asarray(x)))
    assert exact.sum() == 1 and exact[1023]
    assert np.array_equal(dk.skyline_mask_kernel(torch.from_numpy(x)).numpy(), exact)
    assert np.asarray(skyline_mask_pallas(jnp.asarray(x), interpret=True)).all()


@pytest.mark.parametrize("bad", ["valid_shape", "rank4", "f64"])
def test_batched_rejects_bad_inputs(bad):
    x, v = torch.zeros(2, 8, 3), torch.ones(2, 8, dtype=torch.bool)
    if bad == "valid_shape":
        args, err = (x, v[:, :5].contiguous()), ValueError
    elif bad == "rank4":
        args, err = (x[None], v[None]), ValueError
    else:
        args, err = (x.double(), v), TypeError
    with pytest.raises(err):
        dk.skyline_mask_kernel(*args)
    with pytest.raises(err):
        dk.skyline_mask_plain(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("P,n,d", [(1, 3001, 3), (3, 4097, 8), (8, 2500, 16)])
def test_batched_k3_on_card(rng, cuda_card, P, n, d):
    x, v = _batch_case(rng, P, n, d)
    xt, vt = torch.from_numpy(x).to(cuda_card), torch.from_numpy(v).to(cuda_card)
    before = dk.LAUNCHES["skyline_mask_kernel"]
    got = dk.skyline_mask_kernel(xt, vt)
    assert dk.LAUNCHES["skyline_mask_kernel"] == before + 1
    assert torch.equal(got, dk.skyline_mask_plain(xt, vt))
    for p in range(P):
        assert torch.equal(got[p], dk.skyline_mask_kernel(xt[p].contiguous(), vt[p].contiguous()))


# -- the phase tracer ------------------------------------------------------------


def test_tracer_reports_like_jax():
    got, want = Tracer(), JaxTracer()
    t = torch.zeros(4)
    for tr in (got, want):
        with tr.phase("route"):
            with tr.phase("inner"):
                pass
        with tr.phase("route"):
            pass
        with tr.device_phase("slide/step"):
            pass
        tr.add_ns("transfer", 2_000_000)
    with got.device_phase("slide/step", t):  # CPU tensors need no sync
        pass
    rg, rw = got.report(), want.report()
    assert list(rg) == list(rw) == ["inner", "route", "slide/step", "transfer"]
    assert [rg[k]["count"] for k in rg] == [1, 2, 2, 1]
    assert [rw[k]["count"] for k in rw] == [1, 2, 1, 1]
    assert rg["transfer"] == rw["transfer"] == {"total_ms": 2.0, "count": 1, "mean_ms": 2.0}
    got.reset()
    assert got.report() == {}
    with NULL_TRACER.phase("x"), NULL_TRACER.device_phase("y", t):
        pass
    assert NULL_TRACER.report() == {} and NULL_TRACER.sync_device is False

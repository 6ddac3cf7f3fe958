"""The pruned tournament-tree global merge against the JAX package, exact
bytes on the CPU: its functions one by one (``compact_tagged``,
``partition_summaries_device``, ``prune_witness_mask``, ``tree_pair_merge``,
``tree_stats_device``, ``tree_points_device``), the tree against the flat
pass in ``PartitionSet`` with the prefilter on and off, its pruning edge
cases, delta merges through the tree, and its counters. The ``cuda``-marked
twins (the tree on the card against the CPU) skip without a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.ops.dominance import compact_tagged as jcompact_tagged
from skyline_tpu.stream import window as jwin
from skyline_tpu.stream.batched import PartitionSet as JaxSet
from skyline_tpu_torch.ops.dominance import compact, compact_tagged
from skyline_tpu_torch.stream import window as twin
from skyline_tpu_torch.stream.batched import PartitionSet

from conftest import gen_points

torch.set_num_threads(1)

# the plane's counters both packages keep, compared after every stream
COUNTERS = (
    "merge_cache_hits", "merge_cache_misses", "merge_delta_merges", "merge_delta_rows",
    "merge_tree_merges", "merge_partitions_pruned", "last_tree_info",
    "last_dirty_fraction",
)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def merge_of(pset):
    """One global merge with points, as host arrays."""
    counts, surv, g, pts = pset.global_merge_stats(emit_points=True)
    return np.asarray(counts), np.asarray(surv), int(g), np.asarray(pts)


def assert_same_merge(a, b, ctx=""):
    assert np.array_equal(a[0], b[0]), f"counts diverge {ctx}"
    assert np.array_equal(a[1], b[1]), f"survivors diverge {ctx}"
    assert a[2] == b[2], f"global count diverges {ctx}"
    assert a[3].tobytes() == b[3].tobytes(), f"points diverge {ctx}"


def assert_same_counters(jset, tset):
    for name in COUNTERS:
        assert getattr(tset, name) == getattr(jset, name), name
    jw, tw = jset.last_prune_witness, tset.last_prune_witness
    assert (jw is None) == (tw is None)
    if jw is not None:
        assert np.array_equal(np.asarray(jw), tw)


# -- the functions ------------------------------------------------------------------


SPECIAL = np.array([0.0, -0.0, np.inf, np.nan, 1.0, 2.0, -1.0], np.float32)


@pytest.mark.parametrize("capacity", [5, 64, 100, 300])
def test_compact_tagged_matches_jax(rng, capacity):
    """Values, tags, validity and count against the JAX function; the values
    equal ``compact``'s bytes; padding tags are 0 (capacity below, at and
    above the kept count and the row count)."""
    n, d = 100, 3
    x = SPECIAL[rng.integers(0, len(SPECIAL), size=(n, d))]
    tags = rng.integers(1, 9, size=n).astype(np.int32)
    keep = rng.random(n) < 0.6
    jv, jt, jval, jc = jcompact_tagged(
        jnp.asarray(x), jnp.asarray(tags), jnp.asarray(keep), capacity
    )
    tv, tt, tval, tc = compact_tagged(
        torch.from_numpy(x), torch.from_numpy(tags), torch.from_numpy(keep), capacity
    )
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(tval.numpy(), np.asarray(jval)) and int(tc) == int(jc)
    assert tv.numpy().tobytes() == compact(torch.from_numpy(x), torch.from_numpy(keep),
                                           capacity)[0].numpy().tobytes()
    assert (tt.numpy()[~tval.numpy()] == 0).all()


def _stacked(rng, P, cap, d, counts, special=False):
    """(P, cap, d) +inf-padded rows with ``counts`` live rows each."""
    sky = np.full((P, cap, d), np.inf, np.float32)
    for p in range(P):
        if special:
            rows = SPECIAL[rng.integers(0, 6, size=(counts[p], d))]  # no -1
        else:
            rows = rng.integers(0, 20, size=(counts[p], d)).astype(np.float32)
        sky[p, : counts[p]] = rows
    return sky


@pytest.mark.parametrize("special", [False, True])
def test_partition_summaries_match_jax(rng, special):
    """Least corners, witnesses and sum bounds, compared BY VALUE: torch's
    minimum may give +0.0 where XLA keeps -0.0, and only comparisons read
    the summaries. Ties in the least row sum (integer rows) take the first
    row in both; partition 2 is empty."""
    P, cap, d, active = 5, 2048, 4, 1280
    counts = np.array([7, 1000, 0, 1, 1280])
    sky = _stacked(rng, P, cap, d, counts, special)
    want = np.asarray(jwin.partition_summaries_device(
        jnp.asarray(sky), jnp.asarray(counts.astype(np.int32)), active
    ))
    got = twin.partition_summaries_device(
        torch.from_numpy(sky), torch.from_numpy(counts), active
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[2]).all()


def test_prune_witness_mask_matches_jax(rng):
    """Random summaries with ties, empty (+inf) partitions and dead ones."""
    d, P = 3, 12
    for _ in range(20):
        summ = rng.integers(0, 4, size=(P, 2 * d + 2)).astype(np.float32)
        summ[:, d : 2 * d] = np.maximum(summ[:, d : 2 * d], summ[:, :d])
        summ[rng.random(P) < 0.2] = np.inf
        alive = rng.random(P) < 0.8
        jp, jw = jwin.prune_witness_mask(summ, alive, d)
        tp, tw = twin.prune_witness_mask(summ, alive, d)
        assert np.array_equal(tp, jp) and np.array_equal(tw, jw)


def _skyline_rows(rng, n, d, special=False):
    """``n`` rows (or fewer) forming a skyline, in random order."""
    from skyline_tpu_torch.ops.dominance import skyline_mask

    if special:
        x = SPECIAL[rng.integers(0, len(SPECIAL), size=(4 * n, d))]
    else:
        x = rng.integers(0, 30, size=(4 * n, d)).astype(np.float32)
        x[:, 0] = 30 - x[:, 1:].sum(1) / max(d - 1, 1) + rng.integers(0, 3, len(x))
    return x[skyline_mask(torch.from_numpy(x)).numpy()][:n]


def _pair_inputs(rng, d, wa, wb, acnt, bcnt, special=False, shared=0):
    a = np.full((wa, d), np.inf, np.float32)
    b = np.full((wb, d), np.inf, np.float32)
    ra = _skyline_rows(rng, acnt, d, special)
    rb = _skyline_rows(rng, bcnt, d, special)
    if shared and ra.shape[0] and rb.shape[0]:
        # rows equal across a and b: both copies survive, neither dominates
        k = min(shared, ra.shape[0], rb.shape[0])
        rb[:k] = ra[:k]
    a[: ra.shape[0]], b[: rb.shape[0]] = ra, rb
    apids = np.full(wa, 1, np.int32)
    bpids = np.full(wb, 4, np.int32)
    return a, apids, ra.shape[0], b, bpids, rb.shape[0]


PAIRS = {
    # name: (d, wa, wb, acnt, bcnt, special rows, rows shared by a and b)
    "plain": (3, 1024, 1280, 300, 700, False, 0),
    "special": (4, 1024, 1024, 200, 150, True, 0),
    "shared": (8, 1024, 1024, 400, 400, False, 60),
    "empty_a": (3, 1024, 1024, 0, 500, False, 0),
    "empty_b": (3, 1024, 1024, 500, 0, False, 0),
}


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("case", list(PAIRS))
def test_tree_pair_merge_matches_jax(rng, case, tight):
    """Values, partition ids and count against the JAX pair merge, on ±0.0,
    NaN and +inf rows, rows equal across a and b, an empty side, and
    ``out_cap`` exactly acnt + bcnt (``tight``)."""
    d, wa, wb, acnt, bcnt, special, shared = PAIRS[case]
    a, ap, acnt, b, bp, bcnt = _pair_inputs(rng, d, wa, wb, acnt, bcnt, special, shared)
    out_cap = max(acnt + bcnt, 1) if tight else twin._active_bucket(acnt + bcnt)
    jv, jp, jc = jwin.tree_pair_merge(
        jnp.asarray(a), jnp.asarray(ap), jnp.int32(acnt), jnp.asarray(b),
        jnp.asarray(bp), jnp.int32(bcnt), out_cap,
    )
    tv, tp, tc = twin.tree_pair_merge(
        torch.from_numpy(a), torch.from_numpy(ap).long(), torch.tensor(acnt),
        torch.from_numpy(b), torch.from_numpy(bp).long(), torch.tensor(bcnt), out_cap,
    )
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
    assert np.array_equal(tp.numpy(), np.asarray(jp)) and int(tc) == int(jc)


def test_tree_stats_and_points_match_jax(rng):
    P, w, d = 6, 1024, 3
    cnt = 700
    pids = np.sort(rng.integers(0, P, size=w)).astype(np.int32)
    vals = np.full((w, d), np.inf, np.float32)
    vals[:cnt] = rng.random((cnt, d))
    counts = rng.integers(0, 900, size=P)
    want = jwin.tree_stats_device(
        jnp.asarray(counts.astype(np.int32)), jnp.asarray(pids), jnp.int32(cnt), P
    )
    got = twin.tree_stats_device(
        torch.from_numpy(counts), torch.from_numpy(pids).long(), torch.tensor(cnt), P
    )
    assert np.array_equal(got.numpy(), np.asarray(want))
    for out_cap in (700, 1024, 4096):
        assert twin.tree_points_device(torch.from_numpy(vals), out_cap).numpy().tobytes() \
            == np.asarray(jwin.tree_points_device(jnp.asarray(vals), out_cap)).tobytes()


def test_sky_leaf_is_a_copy(rng):
    """A leaf outlives later in-place writes to the state (an SFS append)."""
    sky = torch.from_numpy(_stacked(rng, 2, 1024, 3, np.array([10, 20])))
    vals, pids, cnt = twin.extract_sky_leaf(sky, torch.tensor([10, 20]), 1, 1024)
    before = vals.clone()
    sky[1, 20:40] = 0.0
    assert torch.equal(vals, before) and int(cnt) == 20 and (pids == 1).all()


# -- PartitionSet -----------------------------------------------------------------


def _twins(P, d, **kw):
    return JaxSet(P, d, **kw), PartitionSet(P, d, device="cpu", **kw)


def _fill(sets, rng, x, P):
    pids = rng.integers(0, P, x.shape[0])
    for s in sets:
        for p in range(P):
            rows = np.ascontiguousarray(x[pids == p])
            if rows.shape[0]:
                s.add_batch(p, rows, x.shape[0], 0.0)
        s.flush_all()


@pytest.mark.parametrize("kind", ["uniform", "correlated", "anti"])
@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("prune", ["1", "0"])
def test_tree_matches_flat_and_jax(monkeypatch, kind, d, P, prune):
    """The tree (prefilter on and off) equals the flat pass byte for byte,
    and both equal the JAX package's tree, counters included. At d = 2 the
    knobs are inert (the flat pass is the sweep)."""
    monkeypatch.setenv("SKYLINE_MERGE_CACHE", "0")
    monkeypatch.setenv("SKYLINE_MERGE_PRUNE", prune)
    rng = np.random.default_rng(17)
    x = gen_points(rng, 1200, d, kind)
    monkeypatch.setenv("SKYLINE_MERGE_TREE", "1")
    js, ts = _twins(P, d)
    _fill([js, ts], np.random.default_rng(5), x, P)
    want, got = merge_of(js), merge_of(ts)
    assert_same_merge(want, got, "(tree, jax vs port)")
    assert_same_counters(js, ts)
    assert ts.merge_tree_merges == (1 if d > 2 else 0)
    monkeypatch.setenv("SKYLINE_MERGE_TREE", "0")
    flat = PartitionSet(P, d, device="cpu")
    _fill([flat], np.random.default_rng(5), x, P)
    assert_same_merge(merge_of(flat), got, "(port tree vs port flat)")
    assert flat.merge_tree_merges == 0 and flat.last_tree_info is None


def test_all_partitions_pruned_but_one(monkeypatch):
    """A near-origin partition whose witness dominates every other least
    corner prunes all of them: a one-leaf tree (levels 0), equal to the
    flat pass and to the JAX package; without the prefilter, 8 -> 4 -> 2 -> 1."""
    monkeypatch.setenv("SKYLINE_MERGE_CACHE", "0")
    P, d = 8, 4

    def build(cls_args, tree, prune):
        monkeypatch.setenv("SKYLINE_MERGE_TREE", tree)
        monkeypatch.setenv("SKYLINE_MERGE_PRUNE", prune)
        rng = np.random.default_rng(3)
        ps = cls_args()
        ps.add_batch(0, (rng.random((64, d)) * 0.01).astype(np.float32), 64, 0.0)
        for p in range(1, P):
            ps.add_batch(p, (0.5 + rng.random((400, d)) * 0.5).astype(np.float32), 4000, 0.0)
        ps.flush_all()
        return ps, merge_of(ps)

    port = lambda: PartitionSet(P, d, device="cpu")  # noqa: E731
    pruned_set, pruned = build(port, "1", "1")
    noprune_set, noprune = build(port, "1", "0")
    _, flat = build(port, "0", "1")
    jset, jpruned = build(lambda: JaxSet(P, d), "1", "1")
    assert_same_merge(pruned, flat, "(pruned tree vs flat)")
    assert_same_merge(noprune, flat, "(unpruned tree vs flat)")
    assert_same_merge(pruned, jpruned, "(port vs jax)")
    assert_same_counters(jset, pruned_set)
    assert pruned_set.last_tree_info["partitions_pruned"] == P - 1
    assert pruned_set.last_tree_info["levels"] == 0
    assert pruned_set.last_prune_witness.tolist() == [-1] + [0] * (P - 1)
    assert noprune_set.last_tree_info["levels"] == 3
    assert (pruned[1][1:] == 0).all()


def test_negative_zero_rows_survive_the_prune(monkeypatch):
    """The north-star shape in small: all-zero rows in partition 0, and
    ``-0.0`` zero vectors in other partitions. Partition 0's witness (a zero
    vector) does not strictly dominate a ``-0.0`` corner, so those
    partitions survive the prune in both packages, and every copy survives
    the merge."""
    monkeypatch.setenv("SKYLINE_MERGE_CACHE", "0")
    P, d = 4, 8
    rng = np.random.default_rng(8)
    rows2 = rng.integers(1, 9, size=(40, d)).astype(np.float32)
    sets = _twins(P, d)
    for s in sets:
        s.add_batch(0, np.zeros((50, d), np.float32), 50, 0.0)
        s.add_batch(1, np.full((3, d), -0.0, np.float32), 53, 0.0)
        s.add_batch(2, rows2, 93, 0.0)
        s.add_batch(3, np.concatenate([np.full((2, d), -0.0, np.float32),
                                       np.ones((5, d), np.float32)]), 100, 0.0)
        s.flush_all()
    want, got = merge_of(sets[0]), merge_of(sets[1])
    assert_same_merge(want, got)
    assert_same_counters(*sets)
    assert got[2] == 55 and got[1].tolist() == [50, 3, 0, 2]
    assert sets[1].last_prune_witness.tolist() == [-1, -1, 0, -1]


def test_single_nonempty_partition(monkeypatch):
    monkeypatch.setenv("SKYLINE_MERGE_CACHE", "0")
    P, d = 8, 3
    rng = np.random.default_rng(9)
    x = rng.random((700, d)).astype(np.float32)
    sets = _twins(P, d)
    for s in sets:
        s.add_batch(2, x, 700, 0.0)
        s.flush_all()
    assert_same_merge(merge_of(sets[0]), merge_of(sets[1]))
    assert sets[1].last_tree_info["levels"] == 0
    assert_same_counters(*sets)


@pytest.mark.parametrize("policy", ["incremental", "lazy", "overlap"])
def test_delta_merges_route_through_tree(monkeypatch, policy):
    """With the cache on, dirty skylines and cached clean segments merge as
    tree leaves: every answer equals the flat delta's and the JAX
    package's, over flush and trigger rounds with repeated triggers."""
    monkeypatch.setenv("SKYLINE_MERGE_CACHE", "1")
    P, d = 8, 3

    def run(make, tree):
        monkeypatch.setenv("SKYLINE_MERGE_TREE", tree)
        rng = np.random.default_rng(7)
        ps = make()
        out = []
        for rnd in range(5):
            x = rng.random((900, d)).astype(np.float32)
            pids = rng.integers(0, P, len(x))
            live = range(P) if rnd < 2 else range(rnd % P, (rnd % P) + 2)
            for p in live:
                rows = np.ascontiguousarray(x[pids == p])
                if rows.shape[0]:
                    ps.add_batch(p, rows, len(x), 0.0)
            ps.flush_all()
            out += [merge_of(ps), merge_of(ps)]
        return out, ps

    kw = dict(buffer_size=256, flush_policy=policy)
    port_tree, pt = run(lambda: PartitionSet(P, d, device="cpu", **kw), "1")
    port_flat, pf = run(lambda: PartitionSet(P, d, device="cpu", **kw), "0")
    jax_tree, jt = run(lambda: JaxSet(P, d, **kw), "1")
    for i, (a, b, c) in enumerate(zip(port_tree, port_flat, jax_tree)):
        assert_same_merge(a, b, f"(round {i}, tree vs flat)")
        assert_same_merge(a, c, f"(round {i}, port vs jax)")
    assert_same_counters(jt, pt)
    assert pt.merge_cache_hits == pf.merge_cache_hits == 5
    assert pt.merge_delta_merges == pf.merge_delta_merges > 0
    assert pt.merge_tree_merges > 0 and pf.merge_tree_merges == 0


# -- on the card --------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PAIRS))
def test_tree_pair_merge_on_card(rng, cuda_card, case):
    d, wa, wb, acnt, bcnt, special, shared = PAIRS[case]
    a, ap, acnt, b, bp, bcnt = _pair_inputs(rng, d, wa, wb, acnt, bcnt, special, shared)
    args = [torch.from_numpy(a), torch.from_numpy(ap).long(), torch.tensor(acnt),
            torch.from_numpy(b), torch.from_numpy(bp).long(), torch.tensor(bcnt)]
    want = twin.tree_pair_merge(*args, acnt + bcnt + 1)
    got = twin.tree_pair_merge(*(t.to(cuda_card) for t in args), acnt + bcnt + 1)
    assert all(torch.equal(w, g.cpu()) for w, g in zip(want, got))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 8])
def test_tree_merge_on_card_matches_cpu(cuda_card, d):
    rng = np.random.default_rng(d)
    x = gen_points(rng, 20000, d, "anti")
    sets = [PartitionSet(8, d, device=dv) for dv in ("cpu", "cuda")]
    _fill(sets, np.random.default_rng(1), x, 8)
    assert_same_merge(merge_of(sets[0]), merge_of(sets[1]))
    assert sets[1].last_tree_info == sets[0].last_tree_info

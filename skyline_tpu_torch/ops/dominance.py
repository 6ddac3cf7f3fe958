"""Dense dominance / skyline primitives in plain PyTorch.

Skyline semantics match the reference exactly (ServiceTuple.java:67-77):
*minimization* in all dimensions — tuple ``a`` **dominates** ``b`` iff
``a[k] <= b[k]`` for every dimension ``k`` AND ``a[k] < b[k]`` for at least one.
The skyline of a set is its non-dominated subset. Duplicates do not dominate
each other, so all copies of a duplicated skyline point survive.

Padding convention: invalid/padding rows hold ``PAD_VALUE = +inf`` in every
dimension. Under minimization a +inf row can never dominate anything, so
padding is dominance-neutral as a *dominator*; validity masks keep padding
out of the survivors.

These are the plain versions the hand-written kernels
(``ops/dominance_kernels.py``) are held against, and what the kernel
wrappers run when their tensors lie on the CPU — in value space and, for
the rank cascade, over int32 dense ranks. The pairwise passes are chunked
over dominators so the (chunk, M) comparison tensors stay bounded; the
result is the dense predicate's, bit for bit.

``strictly_dominated_bf16`` is the row pre-drop of the mixed-precision
flush (``SKYLINE_MIXED_PRECISION``): a certificate of strict dominance from
values rounded to bf16, with an explicit error margin. It is the plain
version of the pre-drop kernel (``ops/dominance_kernels.py``
``strictly_dominated_bf16_kernel``).
"""

from __future__ import annotations

import numpy as np
import torch

from skyline_tpu_torch.utils.devices import resolve_device

# +inf padding is dominance-neutral under minimization (see module docstring).
PAD_VALUE = float("inf")

# Elements of the (dominators, victims) comparison tensors per chunk.
_CHUNK_ELEMS = 1 << 24


def dominates(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Does point ``a`` dominate point ``b``? a, b: (d,). Scalar bool."""
    return torch.all(a <= b) & torch.any(a < b)


def dominance_mask(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise dominance bitmask: x (N, d), y (M, d) -> (N, M) bool with
    ``dom[i, j] = x[i] dominates y[j]``. A loop over dimensions keeps the
    temporaries at (N, M) instead of (N, M, d)."""
    le = x[:, None, 0] <= y[None, :, 0]
    lt = x[:, None, 0] < y[None, :, 0]
    for k in range(1, x.shape[1]):
        le &= x[:, None, k] <= y[None, :, k]
        lt |= x[:, None, k] < y[None, :, k]
    return le & lt


def rank_dominance_mask(xr: torch.Tensor, yr: torch.Tensor) -> torch.Tensor:
    """Pairwise dominance over dense ranks: xr (N, d+1), yr (M, d+1) int32
    rows of ``d`` per-dimension ranks and their sum (one rank universe) ->
    (N, M) bool with ``dom[i, j] = all_k(xr[i, k] <= yr[j, k]) and
    xr[i, d] < yr[j, d]`` (all-<= with equal sums forces equal ranks)."""
    d = xr.shape[1] - 1
    dom = xr[:, None, d] < yr[None, :, d]
    for k in range(d):
        dom &= xr[:, None, k] <= yr[None, :, k]
    return dom


def _dominated_by_any(y, x, x_valid, mask_fn) -> torch.Tensor:
    """(M,) bool: some valid row of ``x`` dominates row j of ``y`` under
    ``mask_fn``, chunked over the dominators."""
    m, n = y.shape[0], x.shape[0]
    out = torch.zeros(m, dtype=torch.bool, device=y.device)
    step = max(1, _CHUNK_ELEMS // max(m, 1))
    for s in range(0, n, step):
        dom = mask_fn(x[s : s + step], y)
        if x_valid is not None:
            dom &= x_valid[s : s + step, None]
        out |= dom.any(dim=0)
    return out


def dominated_by(
    y: torch.Tensor, x: torch.Tensor, x_valid: torch.Tensor | None = None
) -> torch.Tensor:
    """For each point in ``y`` (M, d): is it dominated by ANY valid point in
    ``x`` (N, d)? ``x_valid``: (N,) bool or None (all valid). Returns (M,)."""
    return _dominated_by_any(y, x, x_valid, dominance_mask)


def dominated_by_rank(
    yr: torch.Tensor, xr: torch.Tensor, x_valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Rank-space ``dominated_by``: yr (M, d+1), xr (N, d+1) int32 ranks
    plus rank sum over one universe (``rank_dominance_mask``). Returns
    (M,)."""
    return _dominated_by_any(yr, xr, x_valid, rank_dominance_mask)


# The bf16 margin of the row pre-drop (``skyline_tpu/ops/dominance.py``
# _BF16_EPS, _BF16_TINY). bf16 round-to-nearest has unit roundoff 2^-8; a
# pair comparison sees both operands' representation error, bounded by
# u/(1-u) < 2^-7.9 of each bf16 magnitude, so 2^-7 strictly exceeds it (the
# margin arithmetic runs in f32 on exactly-converted bf16 values); the tiny
# term covers the absolute error of subnormals. An over-wide margin only
# leaves more rows to the exact passes — it never certifies a wrong drop.
_BF16_EPS = 2.0 ** -7
_BF16_TINY = 1e-30


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bf16 (round to nearest even, as XLA's
    convert and the card's ``__float2bfloat16_rn`` round) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def strictly_dominated_bf16(
    y: torch.Tensor, x: torch.Tensor, x_valid: torch.Tensor | None = None
) -> torch.Tensor:
    """For each row of ``y`` (M, d): is it CERTAINLY strictly dominated
    (strict in every dimension) by some valid row of ``x`` (N, d), certified
    from bf16 values with an explicit error margin? ``x_valid``: (N,) bool or
    None (all valid). Returns (M,) bool.

    The reference's arithmetic, operation by operation in float32 on the
    bf16-rounded values: ``(yb - xb) > 2^-7 * (|xb| + |yb|) + 1e-30`` in
    every dimension. True is a proof of f32 strict dominance; False means
    "unknown" — callers re-check False rows exactly. NaN rows and
    +inf-vs-+inf pairs fail every margin test, so they are never certified.
    Chunked over victims, one dimension at a time, so no temporary passes
    ``_CHUNK_ELEMS`` elements (64 MB of float32)."""
    m, n, d = y.shape[0], x.shape[0], y.shape[1]
    out = torch.zeros(m, dtype=torch.bool, device=y.device)
    if m == 0 or n == 0:
        return out
    eps = torch.tensor(_BF16_EPS, dtype=torch.float32, device=y.device)
    tiny = torch.tensor(_BF16_TINY, dtype=torch.float32, device=y.device)
    xb, yb = bf16_round(x), bf16_round(y)
    ax, ay = xb.abs(), yb.abs()
    step = max(1, _CHUNK_ELEMS // n)
    for s in range(0, m, step):
        yc, ac = yb[s : s + step], ay[s : s + step]
        dom = None
        for k in range(d):
            margin = (ax[:, None, k] + ac[None, :, k]) * eps + tiny
            lt = (yc[None, :, k] - xb[:, None, k]) > margin
            dom = lt if dom is None else dom & lt
        if x_valid is not None:
            dom &= x_valid[:, None]
        out[s : s + step] = dom.any(dim=0)
    return out


def skyline_mask(x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Survivor mask: ``out[j]`` = x[j] is valid and no valid point of ``x``
    dominates it. x: (N, d); valid: (N,) bool or None."""
    keep = ~dominated_by(x, x, x_valid=valid)
    if valid is not None:
        keep = keep & valid
    return keep


def pad_window(x, capacity: int, device="cuda"):
    """Pad an (n, d) window up to (capacity, d) with PAD_VALUE; return
    (values, valid) on ``device`` (the card unless the caller passes
    ``device="cpu"``)."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, dtype=np.float32))
    n, d = x.shape
    if n > capacity:
        raise ValueError(f"window of {n} rows exceeds capacity {capacity}")
    values = torch.full((capacity, d), PAD_VALUE, dtype=torch.float32)
    values[:n] = x
    valid = torch.arange(capacity) < n
    return values.to(device), valid.to(device)


def skyline_np(x: np.ndarray) -> np.ndarray:
    """Numpy oracle: exact skyline of (n, d) points, O(n^2 d), host-side —
    kept simple and obviously correct rather than fast."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if n == 0:
        return x
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        if not keep[i]:
            # dominated points are redundant dominators (transitivity)
            continue
        le = np.all(x[i] <= x, axis=1)
        lt = np.any(x[i] < x, axis=1)
        dominated = le & lt
        dominated[i] = False
        keep &= ~dominated
    return x[keep]


def _slots(keep: torch.Tensor, capacity: int):
    """Each row's slot in a stable compaction: (slots, count). A kept row's
    slot is its prefix-sum position; dropped rows and kept rows past
    ``capacity`` go to the spare slot ``capacity``."""
    pos = torch.cumsum(keep, dim=-1) - 1
    count = pos[..., -1] + 1 if keep.shape[-1] else keep.sum(dim=-1)
    return torch.where(keep & (pos < capacity), pos, capacity), count


def compact(x: torch.Tensor, keep: torch.Tensor, capacity: int):
    """Pack kept rows to the front of a fixed-size buffer, stably: kept rows
    first, in their original order (the JAX package's
    ``argsort(~keep, stable=True)`` order).

    x: (..., N, d), keep: (..., N) bool; leading dims are a batch (the
    partition axis). Returns (values (..., capacity, d), valid
    (..., capacity), count (...,) int64). Rows beyond ``count`` are
    PAD_VALUE; kept rows past ``capacity`` are dropped, as in the reference —
    callers size capacity to the worst case (or check ``count``).

    A prefix sum gives each kept row its slot; dropped rows scatter into one
    spare slot that is cut off, so no sort is needed."""
    d = x.shape[-1]
    dst, count = _slots(keep, capacity)
    vals = torch.full(
        (*x.shape[:-2], capacity + 1, d), PAD_VALUE, dtype=x.dtype, device=x.device
    )
    vals.scatter_(-2, dst.unsqueeze(-1).expand(*dst.shape, d), x)
    vals = vals[..., :capacity, :].contiguous()
    slot = torch.arange(capacity, device=x.device)
    valid = slot < torch.clamp(count, max=capacity).unsqueeze(-1)
    return vals, valid, count


def compact_tagged(x: torch.Tensor, tags: torch.Tensor, keep: torch.Tensor, capacity: int):
    """``compact`` threading an integer tag per row through the same stable
    prefix-sum scatter — the tournament-tree merge carries partition ids
    beside the survivors with it, so per-partition survivor counts fall out
    of a segment sum at the root. The values output equals
    ``compact(x, keep, capacity)[0]`` byte for byte; padding slots get tag 0.

    x: (N, d), tags: (N,), keep: (N,) bool. Returns (values (capacity, d),
    tags (capacity,), valid (capacity,), count)."""
    vals, valid, count = compact(x, keep, capacity)
    dst, _ = _slots(keep, capacity)
    tout = torch.zeros((capacity + 1,), dtype=tags.dtype, device=tags.device)
    tout.scatter_(0, dst, tags)
    tout = torch.where(valid, tout[:capacity], 0)
    return vals, tout, valid, count

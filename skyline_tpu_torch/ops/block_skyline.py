"""Large-window and sharded skyline computation: the chunked scan,
``skyline_large`` and the mesh's blocked mask and cross prune.

Counterpart of ``skyline_tpu/ops/block_skyline.py``.

``skyline_mask_scan`` is the dispatch's ``mask_scan`` row, the CPU's
fallback: one pass of dominator chunks against every row, a chunk skipped
when its least valid row sum exceeds every undecided victim's (a
dominator's sum never exceeds its victim's), with an optional bf16 margin
pre-pass over a short dominator prefix whose certified victims are final.

``skyline_mask_blocked`` and ``dominated_by_blocked`` are the two phases of
the device mesh's merge (``parallel/mesh.py``, ``parallel/multihost.py``):
each place's local mask over its shard, then its survivors pruned against
every place's gathered survivors. On a card the first is K3
(``skyline_mask_kernel``) over the whole shard and the second K2
(``dominated_by_rect``) over the whole gathered set — the kernels skip
tiles by their own exact bounds, so ``block`` does not reach them. On the
CPU both run the chunked scan's loop (``_dominated_chunks``), ``block``
dominator rows at a time. Both are exact whatever ``block`` is. The
reference's blocked mask skips a later block by its position in sum
order, so it keeps a row whose dominator has an equal sum (ties of
infinite sums, or sums that round together) and sits in a later block;
the mesh's cross phase prunes such a row again, so only the reference's
local mask differs, never its answer.

``skyline_large`` is the library op for a whole window: a host sum sort,
then append-only SFS rounds on the device (``ops/sfs.py``
``sfs_round_single``, K1 and K2 on a card) whose dominator prefix is
tightened from count reads two rounds behind, so the host never waits on
the round it just queued.
"""

from __future__ import annotations

import numpy as np
import torch

from skyline_tpu_torch.ops.dominance import PAD_VALUE
from skyline_tpu_torch.ops.dominance_kernels import (
    dominated_by_rect,
    row_sums,
    skyline_mask_kernel,
    strictly_dominated_bf16_kernel,
)
from skyline_tpu_torch.ops.sfs import _MP_PREFIX, sfs_round_single
from skyline_tpu_torch.utils.buckets import next_pow2
from skyline_tpu_torch.utils.devices import resolve_device, upload_async
from skyline_tpu_torch.utils.knobs import mixed_precision_enabled


def skyline_mask_scan(
    x: torch.Tensor,
    valid: torch.Tensor | None = None,
    chunk: int = 0,
    mp: bool = False,
) -> torch.Tensor:
    """Survivor mask of (N, d) points by a linear scan of dominator chunks
    against all rows (``chunk`` rows each; 0 picks ~2^28 / N, within
    [256, 4096]). A chunk whose least valid row sum exceeds the largest
    undecided valid row sum is skipped; the sums are read to the host once.
    ``mp`` first certifies rows strictly dominated, in bf16 margin
    arithmetic, by one of the first 512 rows — final and out of the skip
    bound. The mask is the same either way."""
    n, d = x.shape
    dev = x.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    if chunk <= 0:
        chunk = max(256, min(4096, (1 << 28) // max(n, 1)))
    nb = -(-n // chunk)
    padded = nb * chunk
    xp, vp = x.contiguous(), valid.contiguous()
    if padded != n:
        xp = torch.cat([xp, torch.full((padded - n, d), PAD_VALUE, dtype=x.dtype, device=dev)])
        vp = torch.cat([vp, torch.zeros((padded - n,), dtype=torch.bool, device=dev)])
    if mp:
        limit = min(padded, _MP_PREFIX)
        certified = vp & strictly_dominated_bf16_kernel(xp, xp[:limit], vp[:limit])
    else:
        certified = torch.zeros((padded,), dtype=torch.bool, device=dev)
    sums = torch.where(vp, row_sums(xp), float("inf"))
    victim_max = torch.where(vp & ~certified, sums, float("-inf")).amax()
    # the padding rows are invalid: they neither dominate nor survive, so
    # the compares take the n real rows only
    victims = xp[:n].T.contiguous()
    dom = _dominated_chunks(victims, vp[:n], sums[:n], victims, victim_max, chunk)
    return ~(dom | certified[:n]) & vp[:n]


def _dominated_chunks(xt, x_valid, x_sums, yt, victim_max, chunk: int) -> torch.Tensor:
    """(M,) bool: some valid column of ``xt`` (d, N) dominates column j of
    ``yt`` (d, M), by K2 (``dominated_by_rect``) over ``chunk`` dominators at
    a time. A chunk whose least sum (``x_sums``, +inf on invalid rows)
    exceeds ``victim_max``, the largest sum of a victim still undecided, is
    skipped (a dominator's sum never exceeds its victim's); the bounds are
    read to the host once, and a NaN bound never skips."""
    n = xt.shape[1]
    nb = -(-n // chunk)
    pad = torch.full((nb * chunk - n,), float("inf"), dtype=x_sums.dtype, device=x_sums.device)
    chunk_min = torch.cat([x_sums, pad]).reshape(nb, chunk).amin(dim=1)
    bounds = torch.cat([chunk_min, victim_max.reshape(1)]).tolist()
    dom = torch.zeros((yt.shape[1],), dtype=torch.bool, device=yt.device)
    for i in range(nb):
        if bounds[i] > bounds[-1]:
            continue
        s = slice(i * chunk, min((i + 1) * chunk, n))
        dom |= dominated_by_rect(xt[:, s].contiguous(), x_valid[s], yt)
    return dom


def skyline_mask_blocked(
    x: torch.Tensor, valid: torch.Tensor | None = None, block: int = 2048
) -> torch.Tensor:
    """Survivor mask of (N, d) points — valid and dominated by no valid
    point — in the caller's row order, the local phase of the mesh's merge.
    On a card one K3 launch over all N rows; on the CPU the chunked scan
    (``skyline_mask_scan``) with ``block``-row dominator chunks."""
    if x.device.type == "cuda":
        if valid is None:
            valid = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
        return skyline_mask_kernel(x.contiguous(), valid.contiguous())
    return skyline_mask_scan(x, valid, chunk=block)


def dominated_by_blocked(
    y: torch.Tensor,
    x: torch.Tensor,
    x_valid: torch.Tensor | None = None,
    block: int = 8192,
    y_valid: torch.Tensor | None = None,
    mp: bool = False,
) -> torch.Tensor:
    """(M,) bool: some valid row of ``x`` (N, d) dominates row j of ``y``
    (M, d) — the mesh's cross-shard prune. On a card one K2 launch over
    all N dominators; on the CPU ``block`` dominator rows at a time, a
    block skipped when its least valid row sum exceeds the largest
    undecided victim sum. ``y_valid`` narrows that bound to valid victims,
    so an invalid victim's verdict is unspecified: callers mask by victim
    validity. ``mp`` first certifies victims strictly dominated, in bf16
    margin arithmetic, by one of the first 512 dominator rows; they are
    final (OR-ed in) and leave the bound, and K2 counts as ``mp``. The
    verdict of every valid victim is the same either way."""
    m, n = y.shape[0], x.shape[0]
    dev = y.device
    if m == 0:
        return torch.zeros((0,), dtype=torch.bool, device=dev)
    if x_valid is None:
        x_valid = torch.ones((n,), dtype=torch.bool, device=dev)
    if mp:
        limit = min(n, _MP_PREFIX)
        certified = strictly_dominated_bf16_kernel(
            y.contiguous(), x[:limit].contiguous(), x_valid[:limit].contiguous()
        )
        if y_valid is not None:
            certified = certified & y_valid
    else:
        certified = torch.zeros((m,), dtype=torch.bool, device=dev)
    if n == 0:
        return certified
    if dev.type == "cuda":
        dom = dominated_by_rect(
            x.T.contiguous(), x_valid.contiguous(), y.T.contiguous(), mp=mp
        )
        return dom | certified
    live = ~certified if y_valid is None else y_valid & ~certified
    victim_max = torch.where(live, row_sums(y), float("-inf")).amax()
    x_sums = torch.where(x_valid, row_sums(x), float("inf"))
    return certified | _dominated_chunks(
        x.T.contiguous(), x_valid, x_sums, y.T.contiguous(), victim_max, block
    )


def skyline_large(
    x: np.ndarray,
    block: int = 0,
    dense_threshold: int = 8192,
    mp: bool | None = None,
    device="cuda",
) -> np.ndarray:
    """Exact skyline of an (N, d) numpy window, its rows in ascending
    row-sum order (stable): host sum sort, then one append-only SFS round
    per ``block`` rows on ``device`` (the card unless the caller passes
    ``"cpu"``). Sum-sorted, an appended row is final, so the buffer never
    shrinks and the work is O(N * S) for a skyline of S rows. Before round
    r the host reads the count after round r - 2 — work already finished
    while later rounds queued — to bound the dominator prefix.

    ``block=0`` scales the block with N on a card (16,384 to 65,536 rows);
    on the CPU it stays 8,192. At most ``dense_threshold`` rows take one
    K3 pass instead. ``mp=None`` reads ``SKYLINE_MIXED_PRECISION``; the
    result is the same either way."""
    dev = resolve_device(device)
    if mp is None:
        mp = mixed_precision_enabled(dev)
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x.shape
    if n == 0:
        return x
    if n <= dense_threshold:
        keep = skyline_mask_kernel(torch.from_numpy(x).to(dev), mp=mp)
        return x[keep.cpu().numpy()]

    order = np.argsort(x.sum(axis=1), kind="stable")
    xs = x[order]
    if block <= 0:
        if dev.type == "cuda":
            block = next_pow2(min(n, max(16384, min(n // 8, 65536))), min_cap=1024)
        else:
            block = 8192
    nb = -(-n // block)
    # worst case (nothing dominated) the appended prefix reaches n, and the
    # last round writes a full block at that offset
    cap = next_pow2(n + block, min_cap=1024)
    sky = torch.full((cap, d), PAD_VALUE, dtype=torch.float32, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    counts = []  # the count after each round, for the lag-2 reads
    for rnd in range(nb):
        blk = xs[rnd * block : (rnd + 1) * block]
        w = blk.shape[0]
        if w < block:
            blk = np.concatenate([blk, np.full((block - w, d), PAD_VALUE, np.float32)])
        bvalid = np.arange(block) < w
        if rnd >= 2:
            # entering count <= count after round r-2 plus round r-1's rows
            ub = int(counts[rnd - 2]) + block
        else:
            ub = rnd * block  # rows streamed so far bound the count
        active = min(cap, next_pow2(max(ub, 1), min_cap=1024))
        sky, count, _ = sfs_round_single(
            sky, count, upload_async(blk, dev), upload_async(bvalid, dev), active, mp
        )
        counts.append(count)
    k = int(count)  # the final sync
    return sky[:k].cpu().numpy()

"""Large-window skyline computation: the chunked scan and ``skyline_large``.

Counterpart of ``skyline_tpu/ops/block_skyline.py`` (``skyline_mask_scan``
and ``skyline_large``; ``skyline_mask_blocked`` and
``dominated_by_blocked`` serve only the multi-card merge, which is not
ported yet).

``skyline_mask_scan`` is the dispatch's ``mask_scan`` row, the CPU's
fallback: one pass of dominator chunks against every row, a chunk skipped
when its least valid row sum exceeds every undecided victim's (a
dominator's sum never exceeds its victim's), with an optional bf16 margin
pre-pass over a short dominator prefix whose certified victims are final.

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
    chunk_min = sums.reshape(nb, chunk).amin(dim=1)
    victim_max = torch.where(vp & ~certified, sums, float("-inf")).amax().reshape(1)
    bounds = torch.cat([chunk_min, victim_max]).tolist()
    xt = xp.T.contiguous()
    # the padding rows are invalid: they neither dominate nor survive, so
    # the compares take the n real rows only
    victims = xt[:, :n].contiguous()
    dom = torch.zeros((n,), dtype=torch.bool, device=dev)
    for i in range(nb):
        # NaN bounds compare False: such a chunk is never skipped
        if bounds[i] > bounds[-1]:
            continue
        s = slice(i * chunk, min((i + 1) * chunk, n))
        dom |= dominated_by_rect(xt[:, s].contiguous(), vp[s], victims)
    return ~(dom | certified[:n]) & vp[:n]


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

"""The plain reference: the skyline of a window, in plain PyTorch.

A row ``a`` dominates ``b`` when ``a <= b`` in every coordinate and ``a < b``
in one (every coordinate is minimised). The skyline keeps every row that no
row dominates; equal rows do not dominate each other, so copies of a
skyline row all stay. The scan sorts rows by their coordinate sum (a
dominator's sum is strictly smaller) and tests each block of candidates
against the survivors so far, then against the block itself.

This module imports nothing of the program. ``compare_dtype`` sets the
precision of the comparisons: ``torch.bfloat16`` makes the control, the
reference in the next precision below the float32 the configuration
states.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 4096


def _dominated(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(len(y),) bool: some row of ``x`` dominates the row of ``y``."""
    le = (x.unsqueeze(0) <= y.unsqueeze(1)).all(-1)
    lt = (x.unsqueeze(0) < y.unsqueeze(1)).any(-1)
    return (le & lt).any(1)


def skyline_mask(x: torch.Tensor, compare_dtype=torch.float32, block: int = BLOCK) -> torch.Tensor:
    """(n,) bool over the rows of ``x`` (n, d): the rows no row dominates,
    the comparisons made in ``compare_dtype``."""
    v = x.to(compare_dtype)
    order = torch.argsort(v.double().sum(1), stable=True)
    vs = v[order]
    keep = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    sky = vs[:0]
    for start in range(0, vs.shape[0], block):
        cand = vs[start : start + block]
        idx = torch.arange(start, start + cand.shape[0], device=x.device)
        for j in range(0, sky.shape[0], block):
            if idx.numel() == 0:
                break
            alive = ~_dominated(cand, sky[j : j + block])
            cand, idx = cand[alive], idx[alive]
        if idx.numel():
            alive = ~_dominated(cand, cand)
            cand, idx = cand[alive], idx[alive]
        keep[order[idx]] = True
        sky = torch.cat([sky, cand])
    return keep


def prefix_skylines(
    window: np.ndarray,
    chunk_rows: int,
    prefixes: list[int],
    device: str,
    compare_dtype=torch.float32,
) -> dict[int, np.ndarray]:
    """{k: the skyline rows of the window's first k chunks} for each k in
    ``prefixes``, as float32 host rows. The skyline of a union is the
    skyline of its parts' skylines, so each prefix extends the one before
    by a chunk: ``sky_k = skyline(sky_{k-1} + chunk_k)``."""
    want = set(prefixes)
    out: dict[int, np.ndarray] = {}
    sky = torch.empty((0, window.shape[1]), dtype=torch.float32, device=device)
    for k in range(1, max(want) + 1):
        chunk = torch.from_numpy(window[(k - 1) * chunk_rows : k * chunk_rows]).to(device)
        union = torch.cat([sky, chunk])
        sky = union[skyline_mask(union, compare_dtype)]
        if k in want:
            out[k] = sky.cpu().numpy()
    return out

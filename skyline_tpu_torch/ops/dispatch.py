"""The survivor-mask dispatch.

Minimal counterpart of ``skyline_tpu/ops/dispatch.py``. At d <= 2 every
device takes the sort-and-sweep (``ops/sweep2d.py``), as the reference does
before its backend check. Above that, a tensor on the
card goes through a hand-written kernel — K7 (the rank cascade) when
``SKYLINE_RANK_CASCADE`` is on, as the reference's cascade table picks
``mask_rank_pallas`` (``skyline_tpu/ops/cascade.py``), else K3 with its bf16
first pass when ``SKYLINE_MIXED_PRECISION`` is on (the default on a card) —
and a tensor on the CPU through the plain ``skyline_mask``. There is no
variant table, profiler race or tuner in the port yet; every variant of the
reference gives the same mask.
"""

from __future__ import annotations

import numpy as np
import torch

from skyline_tpu_torch.ops.dominance import skyline_mask
from skyline_tpu_torch.ops.dominance_kernels import (
    skyline_mask_kernel,
    skyline_mask_rank_kernel,
)
from skyline_tpu_torch.ops.sweep2d import skyline_mask_sweep
from skyline_tpu_torch.utils.buckets import next_pow2
from skyline_tpu_torch.utils.knobs import mixed_precision_enabled, rank_cascade


def on_cuda(x) -> bool:
    """True when ``x`` (a tensor or a device) lives on a CUDA card."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    return dev.type == "cuda"


def skyline_mask_auto(x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Survivor mask of (N, d) points: the sweep at d <= 2 on every device;
    above that K7 (rank cascade on) or K3 (``mp`` from
    ``SKYLINE_MIXED_PRECISION``) on a CUDA tensor, the plain
    ``skyline_mask`` on a CPU tensor."""
    if x.shape[1] <= 2:
        # no pairwise work at all: sort + prefix-min sweep, O(n log n)
        return skyline_mask_sweep(x, valid)
    if on_cuda(x):
        if rank_cascade():
            return skyline_mask_rank_kernel(x, valid)
        return skyline_mask_kernel(x, valid, mp=mixed_precision_enabled(x.device))
    return skyline_mask(x, valid)


def skyline_keep_np(x: np.ndarray, device) -> np.ndarray:
    """Survivor mask of a host (n, d) array: pad to a power-of-two capacity
    (floored at 1024, the reference's buckets), mask on ``device``, slice
    back."""
    n, d = x.shape
    if n == 0:
        return np.zeros((0,), dtype=bool)
    cap = next_pow2(n, min_cap=1024)
    pad = np.full((cap, d), np.inf, dtype=np.float32)
    pad[:n] = x
    valid = np.arange(cap) < n
    keep = skyline_mask_auto(
        torch.from_numpy(pad).to(device), torch.from_numpy(valid).to(device)
    )
    return keep.cpu().numpy()[:n]

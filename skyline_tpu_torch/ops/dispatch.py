"""The survivor-mask dispatch and the profiler race behind it.

Counterpart of ``skyline_tpu/ops/dispatch.py`` (its dispatch half; the
port's knobs live in ``utils/knobs.py``). ``skyline_mask_auto`` executes the
row that the cascade table picks (``ops/cascade.py`` ``resolve_mask``):

- d <= 2: the sort-and-sweep on every device (``ops/sweep2d.py``);
- a tensor on a card: K3 (``skyline_mask_kernel``, ``mp`` from
  ``SKYLINE_MIXED_PRECISION``) or K7 with ``SKYLINE_RANK_CASCADE`` on,
  raced under ``SKYLINE_DEVICE_CASCADE=auto`` against the device sorted
  cascade (``ops/device_cascade.py``);
- a tensor on the CPU: the host sorted cascade (``ops/sorted_sfs.py``),
  the chunked scan (``ops/block_skyline.py`` ``skyline_mask_scan``) and the
  device cascade, raced likewise under ``SKYLINE_SORTED_SFS`` and
  ``SKYLINE_DEVICE_CASCADE``.

The reference decides at its ``jax.jit`` boundary whether a call may race:
a concrete call explores and records, a traced one (the flat global merge)
swaps only on evidence already measured. Torch has no such boundary, so
the caller says which it is: ``traced=True`` marks a merge-time call site.
A racing call on a card synchronises inside its record, so the EMA holds
the card's time. Every row gives the same mask.
"""

from __future__ import annotations

import numpy as np
import torch

from skyline_tpu_torch.ops import cascade
from skyline_tpu_torch.ops.block_skyline import skyline_mask_scan
from skyline_tpu_torch.ops.device_cascade import device_cascade_mask
from skyline_tpu_torch.ops.dominance_kernels import (
    skyline_mask_kernel,
    skyline_mask_rank_kernel,
)
from skyline_tpu_torch.ops.sorted_sfs import sorted_skyline_mask_np
from skyline_tpu_torch.ops.sweep2d import skyline_mask_sweep
from skyline_tpu_torch.telemetry.profiler import KernelProfiler
from skyline_tpu_torch.utils.buckets import next_pow2
from skyline_tpu_torch.utils.knobs import mixed_precision_enabled


def on_cuda(x) -> bool:
    """True when ``x`` (a tensor or a device) lives on a CUDA card."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    return dev.type == "cuda"


def choose_variant(profiler, candidates, d: int, n: int, mp: bool = False,
                   backend: str | None = None):
    """Pick among ``candidates`` (variant names, in order of preference)
    under signature (d, N-bucket, backend, mp) from measured walls.

    A candidate without measured data runs next (the first listed that
    ``claim_explore`` grants), so each seeds its EMA once per signature;
    after that the least EMA wins. While an exploration is claimed and not
    yet recorded, other calls take the best measured candidate. Without a
    profiler the first candidate stands."""
    if profiler is None:
        return candidates[0]
    claim = getattr(profiler, "claim_explore", None)
    emas = []
    unmeasured = []
    for c in candidates:
        e = profiler.ema_ms(c, d, n, mp, backend)
        if e is None:
            unmeasured.append(c)
        else:
            emas.append((e, c))
    if not unmeasured:
        return min(emas)[1]
    if claim is None:
        # a profiler without the claim handshake: explore first
        return unmeasured[0]
    for c in unmeasured:
        if claim(c, d, n, mp, backend):
            return c
    # every unmeasured candidate is claimed by an exploration in flight
    if emas:
        return min(emas)[1]
    return candidates[0]


# the profiler skyline_mask_auto races on; a caller may share its own
# (register_profiler), otherwise a private one is made at first use
_MASK_PROFILER = None


def register_profiler(profiler) -> None:
    """Share ``profiler`` with the mask dispatch (last registration wins)."""
    global _MASK_PROFILER
    _MASK_PROFILER = profiler


def _mask_profiler():
    global _MASK_PROFILER
    if _MASK_PROFILER is None:
        _MASK_PROFILER = KernelProfiler()
    return _MASK_PROFILER


def _run_mask(variant: str, x, valid, mp: bool):
    """Execute one mask row."""
    if variant == "mask_pallas":
        return skyline_mask_kernel(x, valid, mp=mp)
    if variant == "mask_rank_pallas":
        return skyline_mask_rank_kernel(x, valid)
    if variant == "mask_device_cascade":
        return device_cascade_mask(x, valid)
    if variant == "sorted_sfs_mask":
        keep = sorted_skyline_mask_np(
            x.numpy(), None if valid is None else valid.numpy()
        )
        return torch.from_numpy(keep)
    return skyline_mask_scan(x, valid)


def skyline_mask_auto(
    x: torch.Tensor, valid: torch.Tensor | None = None, traced: bool = False
) -> torch.Tensor:
    """Survivor mask of (N, d) points through the row the cascade table
    picks for ``x``'s device. ``traced=True`` marks a merge-time call site
    (the reference's calls under ``jax.jit``): no exploration, no record.
    A racing call records its wall (synchronising a card first)."""
    if x.shape[1] <= 2:
        # no pairwise work at all: sort + prefix-min sweep, O(n log n)
        return skyline_mask_sweep(x, valid)
    n, d = x.shape
    card = on_cuda(x)
    backend = "cuda" if card else "cpu"
    # mp keys only the card's signatures, as in the reference
    mp = mixed_precision_enabled(x.device) if card else False
    prof = _mask_profiler()
    variant, rec = cascade.resolve_mask(d, n, not traced, prof, mp, device=backend)
    if not rec:
        return _run_mask(variant, x, valid, mp)
    with prof.record(variant, d, n, mp, backend=backend):
        out = _run_mask(variant, x, valid, mp)
        if card:
            torch.cuda.synchronize(x.device)  # the card's wall for the EMA
    return out


def skyline_keep_np(x: np.ndarray, device) -> np.ndarray:
    """Survivor mask of a host (n, d) array: pad to a power-of-two capacity
    (floored at 1024, the reference's buckets), mask on ``device`` (a
    concrete call: it may race and record), slice back."""
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


def skyline_of_np(x: np.ndarray, dims: int, device) -> np.ndarray:
    """Exact skyline points of a host (n, d) array (see
    ``skyline_keep_np``)."""
    if x.shape[0] == 0:
        return np.empty((0, dims), dtype=np.float32)
    return x[skyline_keep_np(x, device)]

"""Chip-group placement for the sharded streaming engine.

Counterpart of ``skyline_tpu/parallel/chips.py``. The
``distributed.ShardedEngine`` splits the partition set into ``chips``
contiguous groups and keeps each group's state on one device. This module
decides which device backs which chip index, and holds the one cross-chip
copy the two-level tournament needs: gathering the surviving chip-local
skylines onto the root device for the pairwise merge.

On the CPU every group lives on the CPU, as the reference's groups wrap
onto its forced host devices: the merge topology is the same, only the
copies are local.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from skyline_tpu_torch.utils.devices import resolve_device


def chip_devices(chips: int, device="cuda") -> list[torch.device]:
    """The device backing each chip index. On ``"cuda"`` the groups go
    round-robin over the visible cards (``cuda:c % n``): with at least
    ``chips`` cards each group has its own, with fewer they wrap —
    correctness never depends on the placement, only locality does. On
    ``"cpu"`` every group gets the CPU."""
    if chips < 1:
        raise ValueError(f"chips must be >= 1, got {chips}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * chips
    n = torch.cuda.device_count()
    return [torch.device("cuda", c % n) for c in range(chips)]


def chip_of(pid: int, group_size: int) -> int:
    """The chip owning global partition ``pid`` (contiguous blocks of
    ``group_size`` partitions per chip)."""
    return pid // group_size


def gather_to(device, tensors):
    """Every tensor of ``tensors`` on ``device``: the cross-chip copy
    feeding the tournament root (no copy where a tensor is already
    there)."""
    return [t.to(device) for t in tensors]


def on_device(dev):
    """``torch.cuda.device(dev)`` on a card (the current device for every
    implicit allocation, stream and event), a null context on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()

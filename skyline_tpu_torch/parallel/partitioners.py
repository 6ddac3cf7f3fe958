"""Spatial partition routing: MR-Dim, MR-Grid, MR-Angle.

Maps a whole window ``(N, d) -> (N,) int32`` of partition ids — the reference
computes the same keys tuple-at-a-time inside Flink's ``keyBy``
(PartitioningLogic, FlinkSkyline.java:669-877). Partition count convention:
``numPartitions = 2 * parallelism`` (FlinkSkyline.java:74-76).

Two forms, as in the JAX package:

- ``partition_ids_np`` — numpy, formula for formula with the JAX package's
  numpy twin; the host-ingest path routes with it.
- ``partition_ids`` — torch on the tensor's device (device ingest), operation
  for operation with the JAX package's compiled ``partition_ids``. Every
  reduction is written out in a fixed order, and XLA's rewrite of a division
  by a constant into a multiplication by its float32 reciprocal is written
  out too, so the CPU result equals the reference bit for bit. On CUDA,
  ``atan2`` may differ from the CPU by an ulp; a row near a partition edge
  may then route elsewhere, which moves local sizes and row order but never
  the global point set.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PARTITIONERS = ("mr-dim", "mr-grid", "mr-angle")


def _recip(v: float) -> float:
    """float32 reciprocal of float32(v) — what XLA multiplies by in place of
    dividing by the constant ``v``."""
    return float(np.float32(1.0) / np.float32(v))


def mr_dim(x: torch.Tensor, num_partitions: int, domain_max: float) -> torch.Tensor:
    """1-D range partitioning on dimension 0 (DimPartitioner.getKey,
    FlinkSkyline.java:686-713). The quotient is clamped in float32 before
    the cast, as XLA's saturating convert (NaN to 0) followed by the clip
    behaves: torch's CPU cast turns +inf and quotients past the int32 range
    into INT32_MIN, which the clip would send to partition 0, not P - 1."""
    p = torch.floor(x[:, 0] * _recip(domain_max / num_partitions))
    p = torch.where(torch.isnan(p), 0.0, p).clamp(0, num_partitions - 1)
    return p.to(torch.int32)


def mr_grid_cell(x: torch.Tensor, domain_max: float) -> torch.Tensor:
    """Raw 2^d midpoint-bitmask cell ids (GridPartitioner.getKey,
    FlinkSkyline.java:746-790), before the modulo."""
    bits = (x >= domain_max / 2.0).to(torch.int32)
    weights = 1 << torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return (bits * weights).sum(dim=1, dtype=torch.int32)


def mr_grid(x: torch.Tensor, num_partitions: int, domain_max: float) -> torch.Tensor:
    """Cell ids folded onto partitions with a modulo, so every tuple reaches
    a queried partition (the reference drops cells past
    ``num_partitions``)."""
    return (mr_grid_cell(x, domain_max) % num_partitions).to(torch.int32)


def mr_angle(x: torch.Tensor, num_partitions: int, domain_max: float) -> torch.Tensor:
    """Hyperspherical partitioning (AnglePartitioner.getKey,
    FlinkSkyline.java:803-876): ``phi_i = atan2(norm(v[i+1:]), v[i])``,
    normalised by pi/2, averaged, scaled by the partition count, clamped.
    The tail norms are a reversed cumulative sum of squares, accumulated
    from the last dimension down, as XLA's cumulative sum does."""
    n, d = x.shape
    if d < 2:
        return torch.zeros((n,), dtype=torch.int32, device=x.device)
    sq = x * x
    acc = sq[:, d - 1]
    tails = [acc]
    for k in range(d - 2, 0, -1):
        acc = acc + sq[:, k]
        tails.append(acc)
    tail_sq = torch.stack(tails[::-1], dim=1)  # column i: sum of squares past i
    phi = torch.atan2(torch.sqrt(tail_sq), x[:, : d - 1])
    if d == 2:
        # one angle, so no reduction separates the 1/(pi/2) and partition
        # count products, and XLA folds the two constants into one
        scale = np.float32(_recip(math.pi / 2.0)) * np.float32(num_partitions)
        p = torch.floor(phi[:, 0] * float(scale)).to(torch.int32)
        return torch.clamp(p, 0, num_partitions - 1)
    norm_phi = phi * _recip(math.pi / 2.0)
    total = norm_phi[:, 0]
    for k in range(1, d - 1):
        total = total + norm_phi[:, k]
    avg = total * _recip(d - 1)
    p = torch.floor(avg * float(num_partitions)).to(torch.int32)
    return torch.clamp(p, 0, num_partitions - 1)


_TORCH_PARTITIONERS = {"mr-dim": mr_dim, "mr-grid": mr_grid, "mr-angle": mr_angle}


def partition_ids(
    x: torch.Tensor, algo: str, num_partitions: int, domain_max: float
) -> torch.Tensor:
    """Partition ids of an (N, d) float32 tensor on its own device."""
    try:
        fn = _TORCH_PARTITIONERS[algo]
    except KeyError:
        raise ValueError(
            f"unknown partitioner {algo!r}; expected one of {sorted(PARTITIONERS)}"
        ) from None
    return fn(x, num_partitions, domain_max)


def partition_ids_np(
    x, algo: str, num_partitions: int, domain_max: float
):
    """Partition ids of a host (N, d) batch (see module docstring).

    MR-Grid folds the 2^d cell id onto partitions with a modulo, so every
    tuple reaches a queried partition (the reference uses the raw cell id
    and drops tuples past ``num_partitions``)."""
    x = np.asarray(x, dtype=np.float32)
    n, d = x.shape
    if algo == "mr-dim":
        width = domain_max / num_partitions
        p = np.floor(x[:, 0] / width).astype(np.int64)
        return np.clip(p, 0, num_partitions - 1).astype(np.int32)
    if algo == "mr-grid":
        bits = (x >= domain_max / 2.0).astype(np.int64)
        cell = bits @ (1 << np.arange(d, dtype=np.int64))
        return (cell % num_partitions).astype(np.int32)
    if algo == "mr-angle":
        if d < 2:
            return np.zeros((n,), dtype=np.int32)
        sq = (x * x).astype(np.float32)
        rev_cumsum = np.cumsum(sq[:, ::-1], axis=1)[:, ::-1]
        tail_norm = np.sqrt(rev_cumsum[:, 1:])
        phi = np.arctan2(tail_norm, x[:, : d - 1])
        avg = np.mean(phi / (np.pi / 2.0), axis=1, dtype=np.float32)
        p = np.floor(avg * np.float32(num_partitions)).astype(np.int64)
        return np.clip(p, 0, num_partitions - 1).astype(np.int32)
    raise ValueError(
        f"unknown partitioner {algo!r}; expected one of {sorted(PARTITIONERS)}"
    )

"""The benchmark's frozen copy of the stream generators' formulas and the
window pool built from a seed.

The formulas are the upstream producer's (``python/unified_producer.py``):
``uniform`` draws independent integers in [low, high] (:50-51); ``anti_correlated``
scales a random positive direction so that its sum lands in a band around the
hypercube's centre sum, of half-width ``eps * (high - low) * d`` with the
producer's dimension-dependent ``eps`` (:92-102), then truncates and clamps.
Every value is an integer held in float32, as the producer streams integers.
"""

from __future__ import annotations

import hashlib

import numpy as np


def band_epsilon(dims: int) -> float:
    if dims == 2:
        return 0.0005
    if dims == 3:
        return 0.05
    if dims == 4:
        return 0.9
    return dims * 0.005 * 100


def uniform(rng: np.random.Generator, n: int, dims: int, low: float, high: float) -> np.ndarray:
    return rng.integers(int(low), int(high) + 1, size=(n, dims)).astype(np.float32)


def anti_correlated(
    rng: np.random.Generator, n: int, dims: int, low: float, high: float
) -> np.ndarray:
    vals = rng.random(size=(n, dims))
    total = vals.sum(axis=1, keepdims=True)
    total = np.where(total == 0, 1.0, total)
    mean = (low + high) / 2.0 * dims
    slack = band_epsilon(dims) * (high - low) * dims
    target = rng.uniform(mean - slack, mean + slack, size=(n, 1))
    return np.clip(np.trunc(vals * (target / total)), low, high).astype(np.float32)


DISTRIBUTIONS = {"uniform": uniform, "anti_correlated": anti_correlated}


def window_pool(seed: int, data: dict, dims: int, windows: int, rows: int) -> list[np.ndarray]:
    """``windows`` distinct windows of ``rows`` rows each, drawn in turn from
    one generator seeded by ``seed``. ``data`` is the configuration's
    ``data`` block: ``distribution``, ``low`` and ``high``."""
    gen = DISTRIBUTIONS[data["distribution"]]
    rng = np.random.default_rng(seed)
    return [gen(rng, rows, dims, data["low"], data["high"]) for _ in range(windows)]


def pool_digest(pool: list[np.ndarray]) -> str:
    h = hashlib.sha256()
    for w in pool:
        h.update(np.ascontiguousarray(w).tobytes())
    return h.hexdigest()[:16]


def negative_zeros(pool: list[np.ndarray]) -> int:
    """Coordinates that are ``-0.0``: they route differently from ``0.0``."""
    return int(sum(int(np.count_nonzero((w == 0) & np.signbit(w))) for w in pool))

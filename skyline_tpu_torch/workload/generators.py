"""Vectorized synthetic stream generators — the three reference distributions.

Formula parity with python/unified_producer.py:50-123, vectorized over whole
batches with numpy instead of per-tuple faker calls:

- ``uniform``: independent integers in [d_min, d_max] (:50-51)
- ``correlated``: per-point base in [d_min, d_max] plus per-dimension noise in
  ±(1-rho)(d_max-d_min), truncated to int and clamped (:58-73); points hug the
  diagonal, easiest to prune
- ``anti_correlated``: a random positive direction vector scaled so its sum
  lands in a band around the hypercube-center sum, with the reference's
  dimension-dependent band thickness heuristic (2D: 0.0005, 3D: 0.05,
  4D: 0.9, else d*0.5 — :92-102), truncated and clamped; points hug the
  anti-diagonal, the documented worst case (pdf §5.6)

All generators return int-valued float32 arrays (the reference streams
integers as CSV; values stay exactly representable).
"""

from __future__ import annotations

import numpy as np

# Trigger injection interval (unified_producer.py:25)
QUERY_THRESHOLD = 1_000_000


def _epsilon(dimensions: int) -> float:
    # unified_producer.py:92-102
    if dimensions == 2:
        return 0.0005
    if dimensions == 3:
        return 0.05
    if dimensions == 4:
        return 0.9
    return dimensions * 0.005 * 100


def uniform(rng: np.random.Generator, n: int, dims: int, d_min: float, d_max: float):
    vals = rng.integers(int(d_min), int(d_max) + 1, size=(n, dims))
    return vals.astype(np.float32)


def correlated(
    rng: np.random.Generator,
    n: int,
    dims: int,
    d_min: float,
    d_max: float,
    rho: float = 0.9,
):
    base = rng.uniform(d_min, d_max, size=(n, 1))
    spread = (1.0 - rho) * (d_max - d_min)
    noise = rng.uniform(-spread, spread, size=(n, dims))
    vals = np.trunc(base + noise)  # int(val) truncates toward zero for v >= 0
    return np.clip(vals, d_min, d_max).astype(np.float32)


def anti_correlated(
    rng: np.random.Generator, n: int, dims: int, d_min: float, d_max: float
):
    eps = _epsilon(dims)
    vals = rng.random(size=(n, dims))
    total = vals.sum(axis=1, keepdims=True)
    total = np.where(total == 0, 1.0, total)
    mean = (d_min + d_max) / 2.0 * dims
    slack = eps * (d_max - d_min) * dims
    target = rng.uniform(mean - slack, mean + slack, size=(n, 1))
    scaled = vals * (target / total)
    return np.clip(np.trunc(scaled), d_min, d_max).astype(np.float32)


def qos(rng: np.random.Generator, n: int, dims: int, d_min: float, d_max: float):
    """QoS web-service workload (BASELINE.json config #5): latency,
    throughput, availability, price — the reference repo's titular use case
    (Flink-Skyline-**QoS**), though its producers only ship the three
    synthetic distributions.

    Skyline semantics are minimization in ALL dimensions, so
    higher-is-better attributes (throughput, availability) are flipped into
    the minimization space as ``d_max - value`` before emission. Shapes:
    latency is log-normal-ish (many fast services, a long slow tail);
    throughput anti-correlates with latency; availability is skewed toward
    the top of the range; price weakly correlates with quality. ``dims`` > 4
    appends uniform auxiliary attributes; ``dims`` < 4 truncates.
    """
    span = d_max - d_min
    # latency: lognormal scaled into the domain, clipped
    lat = d_min + np.clip(rng.lognormal(mean=0.0, sigma=0.8, size=n) / 6.0, 0, 1) * span
    # throughput: anti-correlated with latency + noise (maximize)
    thr = d_min + np.clip(1.0 - (lat - d_min) / span + rng.normal(0, 0.15, n), 0, 1) * span
    # availability: skewed high (maximize)
    avail = d_min + np.clip(rng.beta(8, 1.5, size=n), 0, 1) * span
    # price: weakly correlated with quality (minimize)
    qual = ((thr - d_min) + (avail - d_min)) / (2 * span)
    price = d_min + np.clip(0.3 * qual + 0.7 * rng.random(n), 0, 1) * span
    cols = [lat, d_max - (thr - d_min), d_max - (avail - d_min), price]
    if dims < 4:
        cols = cols[:dims]
    elif dims > 4:
        cols += [rng.uniform(d_min, d_max, size=n) for _ in range(dims - 4)]
    return np.clip(np.trunc(np.stack(cols, axis=1)), d_min, d_max).astype(np.float32)


def simple_correlated(
    rng: np.random.Generator, n: int, dims: int, d_min: float, d_max: float
):
    """P2's distinct correlated math (kafka_producer.py:58-64): INTEGER base
    in [d_min, d_max], per-dimension INTEGER offsets in ±10% of the domain,
    clamped — vs the unified producer's float base ± (1-rho)-scaled float
    noise. The offset window happens to coincide at rho=0.9, but the integer
    lattice and inclusive-bound sampling are P2's own."""
    offset = int((d_max - d_min) * 0.1)
    base = rng.integers(int(d_min), int(d_max) + 1, size=(n, 1))
    noise = rng.integers(-offset, offset + 1, size=(n, dims))
    return np.clip(base + noise, d_min, d_max).astype(np.float32)


def simple_anti_correlated(
    rng: np.random.Generator, n: int, dims: int, d_min: float, d_max: float
):
    """P2's anti-correlated (kafka_producer.py:77-88): every point scaled so
    its coordinate sum lands EXACTLY on the hypercube-center plane (no
    epsilon thickness band, unlike unified_producer.py:92-102) — a strictly
    harder skyline workload at d >= 4, where the unified band (eps 0.9) is
    wide enough to dilute the anti-correlation."""
    vals = rng.random(size=(n, dims))
    total = vals.sum(axis=1, keepdims=True)
    total = np.where(total == 0, 1.0, total)
    target = (d_min + d_max) / 2.0 * dims
    return np.clip(np.trunc(vals * (target / total)), d_min, d_max).astype(
        np.float32
    )


GENERATORS = {
    "uniform": uniform,
    "correlated": correlated,
    "anti_correlated": anti_correlated,
    "qos": qos,
    "simple_correlated": simple_correlated,
    "simple_anti_correlated": simple_anti_correlated,
}

# P2 (kafka_producer.py) shares P1's uniform math but has its own
# correlated / anti-correlated formulas; ``--variant simple`` maps the
# common CLI names onto them.
SIMPLE_VARIANT = {
    "uniform": "uniform",
    "correlated": "simple_correlated",
    "anti_correlated": "simple_anti_correlated",
}


def generate(
    method: str,
    rng: np.random.Generator,
    n: int,
    dims: int,
    d_min: float,
    d_max: float,
):
    """Dispatch by distribution name (the GenMethod enum, unified_producer.py:31-42)."""
    try:
        fn = GENERATORS[method.lower().replace("-", "_")]
    except KeyError:
        raise ValueError(
            f"unknown distribution {method!r}; expected one of {sorted(GENERATORS)}"
        ) from None
    return fn(rng, n, dims, d_min, d_max)

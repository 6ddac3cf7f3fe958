"""The comparison that decides ``correct``: each checked answer's points and
``skyline_size`` against the plain reference's skyline of the same prefix.

Both sides are multisets of float32 rows (``-0.0`` read as ``0.0``).
``wrong_rows`` counts the rows in one and not the other; an exact answer
reads 0, and the limit is 0.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

# each number compared: (limit, rule); "at_most" passes when value <= limit
LIMITS = {
    "wrong_rows": (0, "at_most"),
    "size_gap": (0, "at_most"),
    "missing_answers": (0, "at_most"),
    "answers_checked": (1, "at_least"),
}


def _rows(a: np.ndarray) -> Counter:
    return Counter(map(bytes, np.ascontiguousarray(a, dtype=np.float32) + np.float32(0.0)))


def wrong_rows(points: np.ndarray, reference: np.ndarray) -> int:
    """Size of the multiset difference between two row sets, both ways."""
    got, want = _rows(points), _rows(reference)
    return sum((got - want).values()) + sum((want - got).values())


def answer_points(result: dict, dims: int) -> np.ndarray:
    pts = result.get("skyline_points")
    if pts is None:
        return np.empty((0, dims), dtype=np.float32)
    return np.asarray(pts, dtype=np.float32).reshape(-1, dims)


def judge(readings: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit, rule}}) over ``readings``."""
    out, ok = {}, True
    for name, (limit, rule) in LIMITS.items():
        value = readings[name]
        passed = value <= limit if rule == "at_most" else value >= limit
        ok &= passed
        out[name] = {"value": value, "limit": limit, "rule": rule}
    return ok, out

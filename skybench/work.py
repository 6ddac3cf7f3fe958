"""The least work of a window's skyline, counted from the window's data
alone, and the least time the card could take for it.

bytes: every row read once (rows x d x 4) and the answer written once.
pairs: one comparison for each dominated row (its dominator), and for each
skyline row, every other skyline row whose coordinate sum is no larger than
its own, rows equal to it excluded: the comparisons an SFS scan over the
whole window needs to show that no row dominates it.
The floor is the larger of bytes over the card's bandwidth and pairs x d
over its float32 rate.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: dense rates at the 700 W power limit
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12


def window_work(rows: int, dims: int, skyline: np.ndarray) -> dict:
    """{bytes, pairs, floor_s, bound_by} of the skyline ``skyline`` (m, d)
    of a window of ``rows`` rows."""
    m = int(skyline.shape[0])
    nbytes = (rows + m) * dims * 4
    sky = np.ascontiguousarray(skyline, dtype=np.float32) + np.float32(0.0)
    sums = sky.astype(np.float64).sum(1)
    no_larger = np.searchsorted(np.sort(sums), sums, side="right")
    _, inverse, counts = np.unique(sky, axis=0, return_inverse=True, return_counts=True)
    equal = counts[inverse.reshape(-1)]
    pairs = (rows - m) + int((no_larger - equal).sum())
    bytes_s = nbytes / HBM_BYTES_S
    ops_s = pairs * dims / FP32_FLOPS
    return {
        "bytes": nbytes,
        "pairs": pairs,
        "floor_s": max(bytes_s, ops_s),
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
    }

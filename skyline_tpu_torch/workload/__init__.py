"""Synthetic workload generation (the reference's Python producer harness)."""

from skyline_tpu_torch.workload.generators import (
    QUERY_THRESHOLD,
    anti_correlated,
    correlated,
    generate,
    uniform,
)

__all__ = [
    "QUERY_THRESHOLD",
    "uniform",
    "correlated",
    "anti_correlated",
    "generate",
]

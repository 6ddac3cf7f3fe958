"""Hit and miss counts of the kernel build cache.

The port's counterpart of the reference's persistent-compile-cache counters
(``skyline_tpu/utils/compile_cache.py``), read by
``Telemetry.render_prometheus`` as ``compile_cache.hits`` and
``compile_cache.misses``. They count ``ops/dominance_kernels.build()``: a
hit is a source whose library was already built for its hash, a miss an
``nvcc`` run. Nothing builds on the CPU, so there both read 0.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counts = {"hits": 0, "misses": 0}  # guarded-by: _lock


def note_build(hit: bool) -> None:
    """Count one source's build: cached (``hit``) or compiled."""
    with _lock:
        _counts["hits" if hit else "misses"] += 1


def compile_cache_stats() -> dict:
    """{"hits": n, "misses": n} since the process started."""
    with _lock:
        return dict(_counts)

"""Per-phase tracing: device/host/transfer time accounting.

Counterpart of ``skyline_tpu/metrics/tracing.py``: named phase timers the
engines can nest, with ``report()`` returning totals suitable for logging
or embedding in results.

Device timing caveat: kernel launches return before the card finishes; a
phase that should count device time must synchronise the card before it
closes (use ``device_phase``) or the time lands in whichever phase later
forces the sync.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class Tracer:
    """Named phase timers.

    ``sync_device=True`` (default) makes ``device_phase`` synchronise the
    card of each CUDA tensor it is given, attributing queued device work to
    the phase that launched it. ``sync_device=False`` records launch wall
    only, leaving the device pipeline undisturbed (device time then lands
    in whichever later phase forces the sync)."""

    def __init__(self, sync_device: bool = True):
        self.sync_device = sync_device
        self._total_ns: dict[str, int] = defaultdict(int)
        self._count: dict[str, int] = defaultdict(int)
        self._stack: list[str] = []

    @contextmanager
    def phase(self, name: str):
        """Accumulate host wall time under ``name`` (nested phases overlap
        their parents by design)."""
        t0 = time.perf_counter_ns()
        self._stack.append(name)
        try:
            yield
        finally:
            self._stack.pop()
            self._total_ns[name] += time.perf_counter_ns() - t0
            self._count[name] += 1

    @contextmanager
    def device_phase(self, name: str, *tensors_to_sync):
        """Like ``phase`` but synchronises the card of each given CUDA
        tensor before closing, so queued device work is attributed here."""
        t0 = time.perf_counter_ns()
        self._stack.append(name)
        try:
            yield
        finally:
            self._stack.pop()
            if self.sync_device:
                for dev in {t.device for t in tensors_to_sync if t.device.type == "cuda"}:
                    torch.cuda.synchronize(dev)
            self._total_ns[name] += time.perf_counter_ns() - t0
            self._count[name] += 1

    def add_ns(self, name: str, ns: int) -> None:
        self._total_ns[name] += ns
        self._count[name] += 1

    def report(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_ms": self._total_ns[name] / 1e6,
                "count": self._count[name],
                "mean_ms": self._total_ns[name] / 1e6 / max(1, self._count[name]),
            }
            for name in sorted(self._total_ns)
        }

    def reset(self) -> None:
        self._total_ns.clear()
        self._count.clear()


class _NullTracer:
    """Zero-overhead stand-in so hot paths can call ``tracer.phase(...)``
    unconditionally; the sliding engine defaults to this."""

    sync_device = False

    @contextmanager
    def phase(self, name: str):
        yield

    @contextmanager
    def device_phase(self, name: str, *tensors_to_sync):
        yield

    def add_ns(self, name: str, ns: int) -> None:
        pass

    def report(self) -> dict:
        return {}

    def reset(self) -> None:
        pass


NULL_TRACER = _NullTracer()

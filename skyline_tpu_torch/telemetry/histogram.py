"""Fixed-bucket latency histograms with quantile estimation.

Counterpart of ``skyline_tpu/telemetry/histogram.py``. Per-phase totals
cannot answer "what does the p99 look like under load"; ``Histogram`` is
the shared distribution primitive for ingest batch time, query latency and
global-merge time.

Design points:

- **Lock-cheap**: one lock + one ``bisect`` + one int add per observe —
  the same cost class as ``metrics.collector.Counters.inc``; safe from
  any thread.
- **Fixed log-spaced buckets** (20 per decade, 1 µs .. ~17 min when the
  unit is ms): bounded memory, mergeable, directly exportable as
  Prometheus ``_bucket`` series.
- **Exact small-sample quantiles**: the first ``sample_cap``
  observations are also kept verbatim; while ``count <= sample_cap``
  quantiles are exact order statistics (numpy's linear interpolation),
  so a 5-window bench p50 is the true median, not a bucket estimate.
  Past the cap, quantiles interpolate within the bucket (bounded by the
  ~12% bucket spacing) and memory stays fixed.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

# log-spaced, 20 buckets/decade, spanning 1e-3 .. 1e6 (µs to ~17 min in ms)
DEFAULT_EDGES: tuple[float, ...] = tuple(10.0 ** (e / 20.0) for e in range(-60, 121))


class Histogram:
    """Thread-safe fixed-bucket histogram with quantile estimation."""

    def __init__(
        self,
        name: str,
        unit: str = "ms",
        edges: tuple[float, ...] | None = None,
        sample_cap: int = 1024,
        labels: tuple[tuple[str, str], ...] | None = None,
    ):
        self.name = name
        self.unit = unit
        # optional fixed label set (e.g. (("stage", "ingest"),)): histograms
        # sharing a name but differing in labels render as one Prometheus
        # family with one series per label set
        self.labels = tuple(labels) if labels else None
        self._edges = tuple(edges) if edges is not None else DEFAULT_EDGES
        if any(b <= a for a, b in zip(self._edges, self._edges[1:])):
            raise ValueError("histogram edges must be strictly increasing")
        # counts[i] covers (edges[i-1], edges[i]]; counts[-1] is overflow
        self._counts = [0] * (len(self._edges) + 1)  # guarded-by: self._lock
        self._count = 0  # guarded-by: self._lock
        self._sum = 0.0  # guarded-by: self._lock
        self._min = float("inf")  # guarded-by: self._lock
        self._max = float("-inf")  # guarded-by: self._lock
        self._samples: list[float] = []  # guarded-by: self._lock
        self._sample_cap = max(0, int(sample_cap))
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._counts[bisect_left(self._edges, v)] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if self._count <= self._sample_cap:
                self._samples.append(v)

    def observe_many(self, values) -> None:
        for v in values:
            self.observe(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]); 0.0 when empty.

        Exact (numpy-style linear interpolation between order statistics)
        while every observation is still in the sample buffer; bucket
        interpolation afterwards, clamped to the observed min/max."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return 0.0
            if self._count <= self._sample_cap:
                s = sorted(self._samples)
                rank = q * (len(s) - 1)
                lo = int(rank)
                frac = rank - lo
                if lo + 1 >= len(s):
                    return s[-1]
                return s[lo] + (s[lo + 1] - s[lo]) * frac
            rank = q * self._count
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if cum + c >= rank:
                    lo = self._edges[i - 1] if i > 0 else self._min
                    hi = self._edges[i] if i < len(self._edges) else self._max
                    lo = max(lo, self._min)
                    hi = min(hi, self._max)
                    if hi < lo:
                        hi = lo
                    frac = min(1.0, max(0.0, (rank - cum) / c))
                    return lo + (hi - lo) * frac
                cum += c
            return self._max

    def percentiles(self, *ps: float) -> dict[str, float]:
        """``percentiles(50, 99)`` -> ``{"p50": ..., "p99": ...}``."""
        return {f"p{g:g}": self.quantile(g / 100.0) for g in ps}

    def snapshot(self) -> dict:
        """Summary dict for /stats and the dashboard tiles."""
        with self._lock:
            count, total = self._count, self._sum
        if count == 0:
            return {"count": 0}
        out = {
            "count": count,
            "sum": round(total, 3),
            "mean": round(total / count, 3),
            "min": round(self._min, 3),
            "max": round(self._max, 3),
        }
        for k, v in self.percentiles(50, 90, 99).items():
            out[k] = round(v, 3)
        return out

    def bucket_counts(self) -> list[tuple[float, int]]:
        """Cumulative ``(le, count)`` pairs for Prometheus exposition:
        every non-empty bucket plus the terminal ``+Inf``."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        out: list[tuple[float, int]] = []
        cum = 0
        for i, c in enumerate(counts[:-1]):
            cum += c
            if c:
                out.append((self._edges[i], cum))
        out.append((float("inf"), total))
        return out

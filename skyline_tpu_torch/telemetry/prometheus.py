"""Prometheus text exposition (format 0.0.4) for counters/gauges/histograms.

Counterpart of ``skyline_tpu/telemetry/prometheus.py``: the stdlib-only
renderer behind ``Telemetry.render_prometheus``. Conventional
naming: monotonic counters get a ``_total`` suffix, histograms expand to
``_bucket{le=...}`` / ``_sum`` / ``_count`` series, and every metric is
prefixed (default ``skyline_``) and sanitized to the Prometheus name
charset. Nested stats dicts flatten with ``_`` joins, so
``{"serve": {"reads_shed": 3}}`` exposes as ``skyline_serve_reads_shed``.
"""

from __future__ import annotations

import re

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize(name: str) -> str:
    out = _NAME_RE.sub("_", str(name))
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labels_text(labels) -> str:
    """Render a ((key, value), ...) label tuple as ``k1="v1",k2="v2"``."""
    if not labels:
        return ""
    parts = []
    for k, v in labels:
        val = str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        parts.append(f'{sanitize(k)}="{val}"')
    return ",".join(parts)


def flatten_gauges(doc: dict, prefix: str = "") -> dict[str, float]:
    """Flatten a nested stats dict into gauge samples: numbers kept (bools
    as 0/1), strings/lists/None dropped, sub-dicts joined with ``_``."""
    out: dict[str, float] = {}
    for k, v in doc.items():
        key = f"{prefix}_{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_gauges(v, key))
        elif isinstance(v, bool):
            out[key] = 1.0 if v else 0.0
        elif isinstance(v, (int, float)):
            out[key] = float(v)
    return out


def _labeled_family(lines: list[str], m: str, kind: str, series) -> None:
    """One labeled family: a single # TYPE line, then every label set's
    sample. ``series`` is ``[(((key, value), ...), sample), ...]``."""
    lines.append(f"# TYPE {m} {kind}")
    for labels, value in series:
        text = _labels_text(labels)
        brace = f"{{{text}}}" if text else ""
        lines.append(f"{m}{brace} {_fmt(value)}")


def render(
    counters: dict[str, float] | None = None,
    gauges: dict[str, float] | None = None,
    histograms=None,
    prefix: str = "skyline",
    labeled_counters=None,
    labeled_gauges=None,
) -> str:
    """Render one exposition document. ``histograms`` is an iterable of
    ``telemetry.histogram.Histogram``; ``labeled_counters`` /
    ``labeled_gauges`` map family name -> ``[(label tuple, value), ...]``
    (the fleet plane's per-chip ``skyline_chip_*{chip=...}`` series).
    Unlabeled output is byte-identical when both are absent/empty."""
    lines: list[str] = []
    for name in sorted(counters or {}):
        m = f"{prefix}_{sanitize(name)}_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_fmt(counters[name])}")
    for name in sorted(labeled_counters or {}):
        _labeled_family(
            lines, f"{prefix}_{sanitize(name)}_total", "counter",
            labeled_counters[name],
        )
    for name in sorted(gauges or {}):
        m = f"{prefix}_{sanitize(name)}"
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt(gauges[name])}")
    for name in sorted(labeled_gauges or {}):
        _labeled_family(
            lines, f"{prefix}_{sanitize(name)}", "gauge", labeled_gauges[name],
        )
    # group histograms into families: one # TYPE line per metric name, then
    # every label set's series. Unlabeled histograms are one-member families,
    # so their rendering is unchanged.
    families: dict[str, list] = {}
    for h in histograms or ():
        families.setdefault(f"{prefix}_{sanitize(h.name)}", []).append(h)
    for m, members in families.items():
        lines.append(f"# TYPE {m} histogram")
        for h in members:
            base = _labels_text(getattr(h, "labels", None))
            joiner = "," if base else ""
            for le, cum in h.bucket_counts():
                lines.append(f'{m}_bucket{{{base}{joiner}le="{_fmt(le)}"}} {cum}')
            brace = f"{{{base}}}" if base else ""
            lines.append(f"{m}_sum{brace} {repr(float(h.sum))}")
            lines.append(f"{m}_count{brace} {h.count}")
    return "\n".join(lines) + "\n"

"""Declarative SLOs with multi-window burn-rate evaluation (``GET /slo``).

Counterpart of ``skyline_tpu/telemetry/slo.py``; the dispatch tuner reads
its verdict. The serving-side series it samples (reads, sheds, restarts,
replication) stay empty until those planes are ported.

Nine objectives, each a row in a declarative table (targets are knobs,
see RUNBOOK §2j):

- ``read_p99``       — 99% of /skyline reads complete under
                       ``SKYLINE_SLO_READ_P99_MS`` (error budget 1%).
- ``freshness_p99``  — 99% of reads observe ``staleness_ms`` under
                       ``SKYLINE_SLO_FRESH_P99_MS`` (error budget 1%).
- ``shed_fraction``  — at most ``SKYLINE_SLO_SHED_FRACTION`` of read
                       attempts are shed (429).
- ``restart_rate``   — at most ``SKYLINE_SLO_RESTARTS_PER_HOUR`` supervised
                       restarts per hour.
- ``audit_divergence`` — at most ``SKYLINE_SLO_AUDIT_DIVERGENCE`` of
                       audited snapshots diverge from the host oracle
                       (RUNBOOK §2l; the budget exists only so burn math
                       is well-formed — any divergence should page).
- ``degraded_answers`` — at most ``SKYLINE_SLO_DEGRADED_ANSWERS`` of
                       answered queries publish chip-degraded (marked
                       ``partial``, RUNBOOK §2p) — the availability the
                       failover layer is accountable for.
- ``tenant_shed_fraction`` — at most ``SKYLINE_SLO_TENANT_SHED`` of
                       tenant-attributed read attempts are shed by the
                       per-tenant buckets (RUNBOOK §2q); ``evaluate()``
                       also carries a cumulative per-tenant breakdown so
                       the burning tenant is identifiable.
- ``replication_lag_p99`` — 99% of replica WAL-fold applications land
                       under ``SKYLINE_SLO_REPLICATION_LAG_P99_MS`` of
                       the frame's publish time (RUNBOOK §2s) — the
                       staleness a failover would inherit.
- ``promote_p99``    — 99% of supervisor promotions (fence raise →
                       replica serving) complete under
                       ``SKYLINE_SLO_PROMOTE_P99_MS`` (RUNBOOK §2s).

Evaluation is the standard SRE multi-window scheme: each ``evaluate()``
samples the cumulative counters, appends them to a bounded ring, and diffs
against the oldest retained sample inside a *fast* and a *slow* window
(``SKYLINE_SLO_FAST_WINDOW_S`` / ``SKYLINE_SLO_SLOW_WINDOW_S``). Per
window, ``burn_rate = bad_fraction / error_budget_fraction`` (for rate
SLOs: observed rate / allowed rate) — 1.0 means burning budget exactly as
fast as allowed. A breach requires burn > 1 on BOTH windows, so a brief
spike (fast window only) or old smoke (slow window only) doesn't page.

Everything is pull-driven: no background thread, no cost until someone
hits ``/slo`` or ``bench_compare`` evaluates the table. The clock is
injectable so tests drive the windows deterministically.
"""

from __future__ import annotations

import threading
import time
from collections import deque


def _hist_over(hist, threshold_ms: float) -> tuple[int, int]:
    """(total, over-threshold) observation counts from a Histogram's
    cumulative bucket series."""
    total = hist.count
    good = 0
    for le, cum in hist.bucket_counts():
        if le <= threshold_ms:
            good = cum
        else:
            break
    return total, max(0, total - good)


class SloEngine:
    """Samples cumulative telemetry into burn rates against the SLO table."""

    def __init__(self, telemetry, clock=None):
        from skyline_tpu_torch.utils.knobs import env_float

        self._telemetry = telemetry
        self._clock = clock if clock is not None else time.time
        self.fast_window_s = env_float("SKYLINE_SLO_FAST_WINDOW_S", 300.0)
        self.slow_window_s = env_float("SKYLINE_SLO_SLOW_WINDOW_S", 3600.0)
        # the declarative table: name -> (kind, target). "quantile" targets
        # are ms thresholds with a 1% error budget; "fraction" targets are
        # the budget themselves; "rate" targets are events/hour.
        self.table = {
            "read_p99": (
                "quantile", env_float("SKYLINE_SLO_READ_P99_MS", 50.0),
            ),
            "freshness_p99": (
                "quantile", env_float("SKYLINE_SLO_FRESH_P99_MS", 5000.0),
            ),
            "shed_fraction": (
                "fraction", env_float("SKYLINE_SLO_SHED_FRACTION", 0.05),
            ),
            "restart_rate": (
                "rate", env_float("SKYLINE_SLO_RESTARTS_PER_HOUR", 6.0),
            ),
            "audit_divergence": (
                "fraction",
                env_float("SKYLINE_SLO_AUDIT_DIVERGENCE", 0.0001),
            ),
            "degraded_answers": (
                "fraction",
                env_float("SKYLINE_SLO_DEGRADED_ANSWERS", 0.01),
            ),
            "tenant_shed_fraction": (
                "fraction", env_float("SKYLINE_SLO_TENANT_SHED", 0.05),
            ),
            "replication_lag_p99": (
                "quantile",
                env_float("SKYLINE_SLO_REPLICATION_LAG_P99_MS", 2000.0),
            ),
            "promote_p99": (
                "quantile", env_float("SKYLINE_SLO_PROMOTE_P99_MS", 1000.0),
            ),
        }
        self._admission = None  # serve-plane counters (reads_served/shed)
        self._lock = threading.Lock()
        # ring of (t_s, {slo: (total, bad)}) cumulative samples; sized to
        # cover the slow window at one sample per evaluate() call
        self._samples: deque = deque(maxlen=512)  # guarded-by: self._lock

    def attach_admission(self, admission) -> None:
        """The serving server shares its admission controller so shed
        counts join the table (idempotent; last attach wins)."""
        self._admission = admission

    # -- cumulative sampling ----------------------------------------------

    def _cumulative(self) -> dict:
        tel = self._telemetry
        out = {}
        read_hist = tel.histogram("serve_read_ms")
        out["read_p99"] = _hist_over(read_hist, self.table["read_p99"][1])
        fresh_hist = tel.histogram(
            "freshness_lag_ms", labels=(("stage", "read"),)
        )
        out["freshness_p99"] = _hist_over(
            fresh_hist, self.table["freshness_p99"][1]
        )
        shed = served = 0
        if self._admission is not None:
            c = self._admission.counters.snapshot()
            shed = int(c.get("reads_shed", 0))
            served = int(c.get("reads_served", 0))
        out["shed_fraction"] = (served + shed, shed)
        restarts = int(tel.counters.get("resilience.restarts"))
        out["restart_rate"] = (restarts, restarts)
        checks = int(tel.counters.get("audit.checks"))
        div = int(tel.counters.get("audit.divergence"))
        out["audit_divergence"] = (checks, div)
        answered = int(tel.counters.get("queries.answered"))
        degraded = int(tel.counters.get("degraded_answers"))
        out["degraded_answers"] = (answered, degraded)
        t_total = t_shed = 0
        if self._admission is not None:
            for row in self._admission.tenant_stats().values():
                t_total += int(row["admitted"]) + int(row["shed"])
                t_shed += int(row["shed"])
        out["tenant_shed_fraction"] = (t_total, t_shed)
        # cluster ops plane (RUNBOOK §2s): replica apply lag and
        # supervisor promotion wall — both real histograms, fed by
        # serve/replica.py and cluster/lease.py respectively; get-or-create
        # means zero-count rows outside a cluster (burn 0, no breach)
        lag_hist = tel.histogram("replica_tail_lag_ms")
        out["replication_lag_p99"] = _hist_over(
            lag_hist, self.table["replication_lag_p99"][1]
        )
        promote_hist = tel.histogram("cluster_time_to_promote_ms")
        out["promote_p99"] = _hist_over(
            promote_hist, self.table["promote_p99"][1]
        )
        return out

    def _window(self, samples, now_s: float, window_s: float, name: str):
        """Diff the newest sample against the oldest retained one inside
        ``window_s``; returns (span_s, total_delta, bad_delta)."""
        newest = samples[-1]
        base = None
        for t, cum in samples:
            if now_s - t <= window_s:
                base = (t, cum)
                break
        if base is None or base[0] >= newest[0]:
            # no history inside the window yet: treat all cumulative counts
            # as the window's own (cold-start semantics)
            total, bad = newest[1][name]
            return max(1e-9, min(window_s, now_s - samples[0][0]) or 1e-9), \
                total, bad
        t0, cum0 = base
        total0, bad0 = cum0[name]
        total1, bad1 = newest[1][name]
        return max(1e-9, newest[0] - t0), total1 - total0, bad1 - bad0

    # -- evaluation --------------------------------------------------------

    def evaluate(self, now_s: float | None = None) -> dict:
        now = self._clock() if now_s is None else now_s
        cum = self._cumulative()
        with self._lock:
            self._samples.append((now, cum))
            samples = list(self._samples)
        slos = {}
        any_breach = False
        for name, (kind, target) in self.table.items():
            windows = {}
            burns = []
            for label, wsec in (
                ("fast", self.fast_window_s), ("slow", self.slow_window_s),
            ):
                span_s, total, bad = self._window(samples, now, wsec, name)
                if kind == "rate":
                    rate_per_h = bad / (span_s / 3600.0)
                    burn = rate_per_h / target if target > 0 else 0.0
                    windows[label] = {
                        "window_s": wsec,
                        "span_s": round(span_s, 3),
                        "events": bad,
                        "rate_per_hour": round(rate_per_h, 4),
                        "burn_rate": round(burn, 4),
                    }
                else:
                    bad_frac = (bad / total) if total > 0 else 0.0
                    budget = target if kind == "fraction" else 0.01
                    burn = bad_frac / budget if budget > 0 else 0.0
                    windows[label] = {
                        "window_s": wsec,
                        "span_s": round(span_s, 3),
                        "total": total,
                        "bad": bad,
                        "bad_fraction": round(bad_frac, 6),
                        "burn_rate": round(burn, 4),
                    }
                burns.append(burn)
            breach = all(b > 1.0 for b in burns)
            any_breach = any_breach or breach
            slos[name] = {
                "kind": kind,
                "target": target,
                "error_budget": (
                    target if kind == "fraction"
                    else (None if kind == "rate" else 0.01)
                ),
                "windows": windows,
                "breach": breach,
            }
        doc = {
            "ok": not any_breach,
            "evaluated_at_s": round(now, 3),
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "slos": slos,
        }
        # cumulative per-tenant breakdown so a burning tenant_shed_fraction
        # row points at WHICH tenant is over budget (not burn-rate math —
        # the aggregate row owns the windows; this is attribution)
        if self._admission is not None:
            tenants = self._admission.tenant_stats()
            if tenants:
                doc["tenants"] = {
                    t: {
                        "admitted": row["admitted"],
                        "shed": row["shed"],
                        "shed_fraction": round(
                            row["shed"]
                            / max(1, row["admitted"] + row["shed"]),
                            6,
                        ),
                    }
                    for t, row in tenants.items()
                }
        return doc

"""Streaming workload characterization: what regime is the stream in NOW?

Counterpart of ``skyline_tpu/telemetry/workload.py``. Skyline strategy
selection hinges on distribution and cardinality signals ("Optimization
Strategies for Parallel Computation of Skylines", arxiv 2411.14968); the
dispatch tuner (``telemetry/tuner.py``) reads them from this lock-cheap
characterizer, fed from the ingest path, which maintains:

- **per-dimension quantile sketches**: fixed-bin histograms whose range is
  frozen from the first observed epoch (expanded by a margin, out-of-range
  values clamp to the edge bins), so quantile estimates are deterministic
  under a fixed input order — no reservoir sampling, no RNG;
- **a correlation estimate**: the ratio of row-sum variance to its
  independent-dimensions expectation ``d * mean(per-dim var)`` is
  ``1 + (d-1) * rho_bar`` for mean pairwise correlation ``rho_bar`` —
  one subtraction away from the signal that separates correlated
  (diagonal-hugging, ratio >> 1) from anti-correlated (constant-sum band,
  ratio -> 0) from independent (ratio ~= 1) streams;
- **within-row dispersion**: mean coefficient of variation across a row's
  coordinates. Wide-band anti-correlated streams at d >= 4 (see
  ``workload/generators._epsilon``) carry a shared per-row scale that
  drives the *raw* correlation positive; dispersion is scale-free and
  still separates them from truly correlated rows, whose coordinates
  hug each other (CV ~= noise/base, small);
- **dominance-rate and skyline-size trajectories**: one point per
  answered query (``note_query``), dominance rate =
  ``1 - skyline_size/records``.

Every ``epoch_rows`` sampled rows the accumulators close into an epoch
summary (kind, rho, dispersion, per-dim p50) kept in a bounded ring.
**Drift detection** compares consecutive summaries: a classification flip
or a per-dim p50 shift beyond ``drift_threshold`` (normalized by the
frozen sketch range) emits a flight-recorder entry and bumps the
``workload.drift`` counter (``skyline_workload_drift_total`` on
``/metrics``) — at most one drift event per epoch close.

Everything is host-side numpy on a bounded sample (``sample_cap`` rows
per batch, deterministic stride — never the full batch); nothing enters a
kernel, so published skyline bytes are untouched with the plane on or
off.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np

KINDS = ("uniform", "correlated", "anti_correlated")


class WorkloadCharacterizer:
    """Lock-cheap streaming regime classifier (see module docstring).

    Single ingest writer (the engine thread calls ``observe`` /
    ``note_query``); ``stats`` / ``regime`` may be called from HTTP reader
    threads, hence the lock. All knob reads happen once, at construction
    (the engine ctor), like every other observability gate.
    """

    def __init__(
        self,
        dims: int,
        counters=None,
        flight=None,
        epoch_rows: int | None = None,
        ring: int | None = None,
        sample_cap: int | None = None,
        bins: int = 64,
        sum_ratio_low: float | None = None,
        corr_threshold: float | None = None,
        disp_threshold: float | None = None,
        drift_threshold: float | None = None,
    ):
        from skyline_tpu_torch.utils.knobs import env_float, env_int

        self.dims = int(dims)
        self._counters = counters
        self._flight = flight
        self.epoch_rows = int(
            epoch_rows
            if epoch_rows is not None
            else env_int("SKYLINE_WORKLOAD_EPOCH_ROWS", 4096)
        )
        self.sample_cap = int(
            sample_cap
            if sample_cap is not None
            else env_int("SKYLINE_WORKLOAD_SAMPLE_CAP", 512)
        )
        self.bins = max(8, int(bins))
        self.sum_ratio_low = float(
            sum_ratio_low
            if sum_ratio_low is not None
            else env_float("SKYLINE_WORKLOAD_SUM_RATIO", 0.5)
        )
        self.corr_threshold = float(
            corr_threshold
            if corr_threshold is not None
            else env_float("SKYLINE_WORKLOAD_CORR_THRESHOLD", 0.25)
        )
        self.disp_threshold = float(
            disp_threshold
            if disp_threshold is not None
            else env_float("SKYLINE_WORKLOAD_DISP_THRESHOLD", 0.27)
        )
        self.drift_threshold = float(
            drift_threshold
            if drift_threshold is not None
            else env_float("SKYLINE_WORKLOAD_DRIFT_THRESHOLD", 0.2)
        )
        cap = max(2, int(ring if ring is not None else env_int("SKYLINE_WORKLOAD_RING", 64)))
        self._lock = threading.Lock()
        self._epochs: deque[dict] = deque(  # guarded-by: self._lock
            maxlen=cap
        )
        self._queries: deque[dict] = deque(  # guarded-by: self._lock
            maxlen=cap
        )
        # quantile-sketch bin edges, frozen at the first epoch close so the
        # sketch (and every quantile it answers) is a pure function of the
        # input order  # guarded-by: self._lock
        self._edges: np.ndarray | None = None
        self._lo: np.ndarray | None = None  # guarded-by: self._lock
        self._span: np.ndarray | None = None  # guarded-by: self._lock
        self._reset_epoch_locked()
        self.rows_seen = 0  # pre-sample ingest rows  # guarded-by: self._lock
        self.rows_sampled = 0  # guarded-by: self._lock
        self.epoch_seq = 0  # guarded-by: self._lock
        self.drift_total = 0  # guarded-by: self._lock
        if self._counters is not None:
            # register at ctor so /metrics exports the family at zero
            self._counters.inc("workload.drift", 0)
            self._counters.inc("workload.epochs", 0)

    # -- ingest side (engine thread) --------------------------------------

    def _reset_epoch_locked(self) -> None:
        d = self.dims
        # per-epoch accumulators over sampled rows  # guarded-by: self._lock
        self._n = 0
        self._sum = np.zeros(d)
        self._sumsq = np.zeros(d)
        self._rs_sum = 0.0
        self._rs_sumsq = 0.0
        self._disp_sum = 0.0
        self._min = np.full(d, np.inf)
        self._max = np.full(d, -np.inf)
        self._hist = np.zeros((d, self.bins), dtype=np.int64)

    def observe(self, values: np.ndarray) -> None:
        """Fold one ingest micro-batch (``(n, dims)`` array) into the
        current epoch. Rows beyond ``sample_cap`` are stride-subsampled
        (deterministic — row ``0, k, 2k, ...``)."""
        n = int(values.shape[0])
        if n == 0:
            return
        # the stride sample first, then float64: the reference's rows and
        # values, without converting the rows the sample skips
        x = np.asarray(values)
        if n > self.sample_cap:
            x = x[:: -(-n // self.sample_cap)]
        x = np.asarray(x, dtype=np.float64)
        rs = x.sum(axis=1)
        rm = rs / self.dims
        disp = float(np.sum(x.std(axis=1) / np.maximum(rm, 1e-9)))
        with self._lock:
            self.rows_seen += n
            self.rows_sampled += x.shape[0]
            self._n += x.shape[0]
            self._sum += x.sum(axis=0)
            self._sumsq += np.square(x).sum(axis=0)
            self._rs_sum += float(rs.sum())
            self._rs_sumsq += float(np.square(rs).sum())
            self._disp_sum += disp
            self._min = np.minimum(self._min, x.min(axis=0))
            self._max = np.maximum(self._max, x.max(axis=0))
            if self._edges is not None:
                q = ((x - self._lo) / self._span * self.bins).astype(np.int64)
                np.clip(q, 0, self.bins - 1, out=q)
                for j in range(self.dims):
                    self._hist[j] += np.bincount(q[:, j], minlength=self.bins)
            if self._n >= self.epoch_rows:
                self._close_epoch_locked()

    def note_query(self, skyline_size: int, records: int) -> None:
        """One answered query: append a (skyline size, dominance rate)
        trajectory point tagged with the epoch it was computed under."""
        rec = max(1, int(records))
        with self._lock:
            self._queries.append(
                {
                    "epoch": self.epoch_seq,
                    "skyline_size": int(skyline_size),
                    "records": int(records),
                    "dominance_rate": round(1.0 - int(skyline_size) / rec, 6),
                }
            )

    # -- epoch close / classification -------------------------------------

    def _close_epoch_locked(self) -> None:
        n = self._n
        mean = self._sum / n
        var = np.maximum(self._sumsq / n - np.square(mean), 0.0)
        rs_mean = self._rs_sum / n
        rs_var = max(self._rs_sumsq / n - rs_mean * rs_mean, 0.0)
        iid = self.dims * float(var.mean())
        ratio = rs_var / iid if iid > 0 else 1.0
        rho = (ratio - 1.0) / max(self.dims - 1, 1)
        rho = float(min(1.0, max(-1.0, rho)))
        disp = self._disp_sum / n
        if ratio < self.sum_ratio_low:
            kind = "anti_correlated"
        elif rho > self.corr_threshold:
            # wide-band anti streams (generators._epsilon at d >= 4) read
            # positively correlated on raw values because every row shares
            # one scale factor; scale-free dispersion separates them from
            # truly diagonal-hugging rows
            kind = "anti_correlated" if disp >= self.disp_threshold else "correlated"
        else:
            kind = "uniform"
        if self._edges is None:
            # freeze the sketch range on the first epoch (25% margin each
            # side); this epoch carries no sketch, so drift comparisons
            # start at epoch 2 — by construction, both sides of every
            # quantile diff come from the SAME bin grid
            span = np.maximum(self._max - self._min, 1e-9)
            self._lo = self._min - 0.25 * span  # unguarded-ok: _locked callee
            self._span = (self._max + 0.25 * span) - self._lo  # unguarded-ok: _locked callee
            self._edges = np.linspace(0.0, 1.0, self.bins + 1)
            p50 = None
        else:
            p50 = [round(float(v), 3) for v in self._quantile_locked(0.5)]
        self.epoch_seq += 1  # unguarded-ok: _locked callee
        summary = {
            "epoch": self.epoch_seq,
            "rows": n,
            "kind": kind,
            "rho": round(rho, 4),
            "sum_ratio": round(float(ratio), 4),
            "dispersion": round(float(disp), 4),
            "p50": p50,
        }
        prev = self._epochs[-1] if self._epochs else None
        self._epochs.append(summary)  # unguarded-ok: _locked callee
        if self._counters is not None:
            self._counters.inc("workload.epochs")
        drift = None
        if prev is not None:
            if prev["kind"] != kind:
                drift = {"reason": "kind_flip", "from": prev["kind"], "to": kind}
            elif prev["p50"] is not None and p50 is not None:
                shift = max(
                    abs(a - b) / float(s)
                    for a, b, s in zip(p50, prev["p50"], self._span)
                )
                if shift > self.drift_threshold:
                    drift = {"reason": "quantile_shift", "shift": round(shift, 4)}
        if drift is not None:
            self.drift_total += 1  # unguarded-ok: _locked callee
            drift["epoch"] = self.epoch_seq
            if self._counters is not None:
                self._counters.inc("workload.drift")
            if self._flight is not None:
                self._flight.note("workload.drift", **drift)
        self._reset_epoch_locked()

    def _quantile_locked(self, q: float) -> np.ndarray:
        """Per-dimension quantile from the frozen-bin sketch (linear
        interpolation inside the holding bin)."""
        out = np.zeros(self.dims)
        for j in range(self.dims):
            counts = self._hist[j]
            total = counts.sum()
            if total == 0:
                out[j] = float(self._lo[j])
                continue
            cum = np.cumsum(counts)
            target = q * total
            b = int(np.searchsorted(cum, target))
            b = min(b, self.bins - 1)
            prev_cum = cum[b - 1] if b > 0 else 0
            inside = (target - prev_cum) / max(counts[b], 1)
            frac = (b + min(max(inside, 0.0), 1.0)) / self.bins
            out[j] = float(self._lo[j] + frac * self._span[j])
        return out

    # -- read side (HTTP threads, EXPLAIN finalizer) ----------------------

    def regime(self) -> dict:
        """The compact regime tag EXPLAIN stamps on every answered query."""
        with self._lock:
            if not self._epochs:
                return {"kind": "unknown", "epoch": 0, "drift_total": self.drift_total}
            last = self._epochs[-1]
            return {
                "kind": last["kind"],
                "rho": last["rho"],
                "epoch": last["epoch"],
                "drift_total": self.drift_total,
            }

    def stats(self) -> dict:
        """The ``workload`` block of the engine's ``stats()``."""
        with self._lock:
            epochs = list(self._epochs)
            queries = list(self._queries)
            doc = {
                "rows_seen": self.rows_seen,
                "rows_sampled": self.rows_sampled,
                "epoch_rows": self.epoch_rows,
                "epochs_closed": self.epoch_seq,
                "drift_total": self.drift_total,
                "kind": epochs[-1]["kind"] if epochs else "unknown",
                "rho": epochs[-1]["rho"] if epochs else None,
                "epochs": epochs,
                "trajectory": queries,
            }
        if queries:
            doc["dominance_rate"] = queries[-1]["dominance_rate"]
            doc["skyline_size"] = queries[-1]["skyline_size"]
        return doc

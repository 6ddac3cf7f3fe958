"""Online audit plane: sampled shadow verification of published skylines
against the independent host oracle.

Counterpart of ``skyline_tpu/audit/``: the same sampling, records,
canaries and bundles. The oracle is host numpy on purpose: it is the
independent check of what the card computed.

Every answer the engine serves rides a cascade of byte-identity-critical
shortcuts — grid prefilter, bf16 margin pass, witness-pruned tournament
tree, epoch-keyed merge cache — each verified offline by property tests
and A/B benchmarks. This plane closes the loop ONLINE: in the serving
process, a knob-controlled fraction of published snapshots
(``SKYLINE_AUDIT_SAMPLE``) is recomputed from the engine's partition
state through an independent numpy oracle (``audit/oracle.py``; the
``SKYLINE_AUDIT_ORACLE`` knob picks the default full-rate sorted scan
or the original O(n²d) quadratic oracle, kept as the oracle-of-the-
oracle) and compared byte-for-byte after canonical row ordering.

A divergence increments ``skyline_audit_divergence_total``, burns the
``audit_divergence`` SLO, and freezes a self-contained repro bundle
under ``SKYLINE_AUDIT_DIR`` (checkpoint + WAL slice + EXPLAIN plan +
knob snapshot + both skylines — see ``bundle.py``), replayable offline
via ``python -m skyline_tpu_torch.audit replay <bundle>``. Synthetic canaries
(``canary.py``) with hand-known answers exercise every merge decision
path even when organic traffic is idle.

Validity discipline: a check only runs when the snapshot's
``source_key`` (the partition-epoch key at merge time) still equals the
live epoch key — under overlapped merges the state can advance past the
published bytes, and auditing a moved state would fabricate
divergences. Moved-state samples count as ``audit.skips``, never as
checks. The whole plane is host-side and post-publish: no kernel is
launched for a check, and a check never perturbs the state it verifies
(``PartitionSet.audit_state`` does not flush).
"""

from __future__ import annotations

import time

import numpy as np


def canonical_rows(a) -> np.ndarray:
    """Contiguous float32 rows in canonical (lexicographic) order, so two
    path-dependent row orderings of the same point set compare
    byte-for-byte."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
    if a.shape[0] <= 1:
        return a
    return np.ascontiguousarray(a[np.lexsort(a.T[::-1])])


def first_diff(published: np.ndarray, oracle: np.ndarray) -> dict | None:
    """First differing row between two canonically-ordered skylines, as a
    JSON-able record (None when byte-identical)."""
    pub = canonical_rows(published)
    orc = canonical_rows(oracle)
    if pub.shape == orc.shape and pub.tobytes() == orc.tobytes():
        return None
    m = min(pub.shape[0], orc.shape[0])
    idx = m  # default: one side is a strict prefix of the other
    for i in range(m):
        if pub[i].tobytes() != orc[i].tobytes():
            idx = i
            break
    return {
        "index": int(idx),
        "published_row": (
            pub[idx].tolist() if idx < pub.shape[0] else None
        ),
        "oracle_row": orc[idx].tolist() if idx < orc.shape[0] else None,
        "published_rows": int(pub.shape[0]),
        "oracle_rows": int(orc.shape[0]),
    }


class Auditor:
    """Engine-owned background auditor: organic sampled checks + canaries.

    Created by ``SkylineEngine.__init__`` when ``SKYLINE_AUDIT`` is on
    and a telemetry hub is attached; the engine calls ``maybe_check``
    at the tail of every result emission (after the answer is already out
    the door) and the engine's owner drives ``maybe_canary`` from its idle
    loop. Engine-thread only — no lock.
    """

    def __init__(self, engine, telemetry):
        from skyline_tpu_torch.utils.knobs import env_float, env_str

        self.engine = engine
        self.telemetry = telemetry
        self.sample = env_float("SKYLINE_AUDIT_SAMPLE", 1.0)
        self.canary_interval_s = env_float("SKYLINE_AUDIT_CANARY_S", 300.0)
        self.bundle_dir = env_str("SKYLINE_AUDIT_DIR", "artifacts/audit")
        # deterministic sampling accumulator — same trigger sequence, same
        # audited subset, every run (no RNG on the serving path)
        self._acc = 0.0
        self._last_canary_s: float | None = None
        self._bundle_seq = 0
        # the WAL directory divergence bundles freeze the segment slice of;
        # None = no WAL (the log is not ported yet, so it stays None)
        self.wal_dir: str | None = None

    # -- organic sampled checks -------------------------------------------

    def maybe_check(self, q) -> None:
        """Sampling gate: called per emitted result; runs ``check`` every
        ``1/sample`` results (deterministic accumulator)."""
        if self.sample <= 0.0:
            return
        self._acc += min(self.sample, 1.0)
        if self._acc < 1.0:
            return
        self._acc -= 1.0
        self.check(q)

    def check(self, q=None) -> dict | None:
        """Shadow-verify the latest published snapshot against the host
        oracle; returns the check record (None when no check could run).

        Observability must never take the answer down: callers wrap this
        defensively (engine) or let it raise (tests/replay).
        """
        store = self.engine.snapshots
        snap = store.latest() if store is not None else None
        if snap is None:
            return None
        tel = self.telemetry
        trace_id = snap.meta.get("trace_id")
        if snap.meta.get("partial"):
            # a chip-degraded snapshot (RUNBOOK §2p) is honestly marked —
            # it is the surviving chips' exact skyline, which by
            # construction differs from the full oracle, so checking it
            # would count marked degradation as a lying answer
            tel.inc("audit.skips")
            tel.flight.note(
                "audit.skip", reason="partial_snapshot",
                version=int(snap.version), trace_id=trace_id,
            )
            return None
        source_key = snap.source_key
        epoch_key = self.engine.pset.epoch_key
        if source_key is not None and source_key != epoch_key:
            # overlapped ingest flushed past the published bytes — the
            # snapshot is no longer a function of the live state, so a
            # comparison would fabricate a divergence
            tel.inc("audit.skips")
            tel.flight.note(
                "audit.skip", reason="state_moved", version=int(snap.version),
                trace_id=trace_id,
            )
            return None
        t0 = time.perf_counter_ns()
        skies, _ = self.engine.pset.audit_state()
        union = (
            np.concatenate([s for s in skies], axis=0)
            if skies
            else np.empty((0, self.engine.pset.dims), dtype=np.float32)
        )
        from skyline_tpu_torch.audit.oracle import oracle_fn, oracle_kind

        oracle = np.asarray(oracle_fn()(union), dtype=np.float32)
        published = np.asarray(snap.points, dtype=np.float32)
        diff = first_diff(published, oracle)
        ok = diff is None
        tel.inc("audit.checks")
        record = {
            "kind": "organic",
            "ok": ok,
            "trace_id": trace_id,
            "version": int(snap.version),
            "digest": snap.digest,
            "oracle": oracle_kind(),
            "published_rows": int(published.shape[0]),
            "oracle_rows": int(oracle.shape[0]),
            "first_diff": diff,
            "bundle": None,
        }
        if not ok:
            tel.inc("audit.divergence")
            record["bundle"] = self._freeze_bundle(snap, oracle, diff, q)
        tel.audit.add(record)
        # satellite: checks and divergences join /explain and /trace via
        # the audited snapshot's trace_id
        tel.spans.record(
            "audit/divergence" if not ok else "audit/check",
            t0, time.perf_counter_ns(), trace_id=trace_id, tid=4,
            args={"version": int(snap.version), "ok": ok},
        )
        tel.flight.note(
            "audit.divergence" if not ok else "audit.check",
            ok=ok, version=int(snap.version), trace_id=trace_id,
            bundle=record["bundle"],
        )
        return record

    def _freeze_bundle(self, snap, oracle, diff, q) -> str | None:
        """Freeze a divergence repro bundle; never raises (bundle failure
        must not mask the divergence signal that triggered it)."""
        try:
            from skyline_tpu_torch.audit.bundle import freeze_bundle

            self._bundle_seq += 1
            plan_doc = None
            if self.telemetry.explain is not None and snap.meta.get(
                "trace_id"
            ):
                plan_doc = self.telemetry.explain.by_trace(
                    snap.meta["trace_id"]
                )
            if plan_doc is None:
                plan_doc = self.telemetry.explain.by_version(
                    int(snap.version)
                )
            return freeze_bundle(
                self.engine, snap, oracle, diff,
                out_dir=self.bundle_dir,
                seq=self._bundle_seq,
                plan_doc=plan_doc,
                wal_dir=self.wal_dir,
            )
        except Exception:
            self.telemetry.inc("audit.bundle_errors")
            return None

    # -- synthetic canaries -----------------------------------------------

    def maybe_canary(self, now_s: float | None = None) -> bool:
        """Idle-loop hook: run one canary sweep when the interval elapsed
        (0 disables). Returns True when a sweep ran."""
        if self.canary_interval_s <= 0.0:
            return False
        now = time.monotonic() if now_s is None else now_s
        if self._last_canary_s is None:
            # first idle tick arms the timer; the sweep itself waits one
            # full interval so startup isn't front-loaded with canary work
            self._last_canary_s = now
            return False
        if now - self._last_canary_s < self.canary_interval_s:
            return False
        self._last_canary_s = now
        self.run_canaries()
        return True

    def run_canaries(self) -> list[dict]:
        """One sweep of every merge-path canary, each state built on the
        engine's device; returns the records."""
        from skyline_tpu_torch.audit.canary import run_canaries

        return run_canaries(self.telemetry, device=self.engine.device)

"""WAL-tailing read replicas: the serve plane's availability layer.

Counterpart of ``skyline_tpu/serve/replica.py``. The write path stays
single-owner (the engine publishes snapshots; the WAL persists every publish
transition with its row ORDER, digest and meta), so read replication is a
log-tailing problem: each ``SkylineReplica`` bootstraps from the newest
checkpoint barrier inlined in the WAL, then live-tails the publish-delta
stream through ``resilience.wal.WalTailer`` to maintain its own
``SnapshotStore`` + ``DeltaRing`` + read cache, serving ``/skyline`` /
``/deltas`` / ``/subscribe`` / ``/metrics`` on its own port. A replica does
no device work: it folds host rows, and importing it touches no CUDA state.

Honesty contract (the same spirit as the ``partial:true`` degraded-answer
contract):

- every response carries the freshness watermark (``staleness_ms``), which
  ages monotonically while the primary is down;
- reads older than the staleness fence (``SKYLINE_REPLICA_MAX_STALE_MS``)
  are refused with 503 + Retry-After — ``allow_stale`` bounds the client's
  tolerance, never the replica's own;
- replica snapshot bytes are identical to the primary's at every common
  version (delta records carry the published permutation; each fold is
  digest-verified), so a replica can never serve a plausible-but-wrong
  skyline;
- ``restored`` / ``partial`` / ``excluded_chips`` propagate byte-faithfully
  — a degraded primary answer is never laundered clean by a replica.

Failure handling: a torn WAL tail holds position (the writer is
mid-append); real corruption (``WalTailCorruption``), a pruned-under-us
segment (``WalSegmentGone``), a digest mismatch, or a broken version chain
all fall back to checkpoint re-bootstrap. The tail loop runs under the
``Supervisor`` (backoff, restart budget), and the subprocess CLI mode
(``bridge.worker --replica-of``) drains on SIGTERM.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from skyline_tpu_torch.resilience.faults import fault_point
from skyline_tpu_torch.resilience.wal import (
    WalError,
    WalTailer,
    rows_from_b64,
)


class ReplicaDivergence(WalError):
    """A tailed delta cannot extend the replica's state: version-chain gap
    or post-fold digest mismatch. Recovery is a full re-bootstrap."""


class SkylineReplica:
    """One read replica: WAL tailer + snapshot store + HTTP server.

    ``wal_dir``: the primary's WAL directory (shared filesystem).
    ``serve_config``: admission/ring knobs for the replica's own server
    (per-tenant buckets included). ``max_stale_ms``: the staleness fence;
    None reads ``SKYLINE_REPLICA_MAX_STALE_MS``. ``start=True`` launches
    the supervised tail thread; ``start=False`` lets tests drive
    ``bootstrap()`` / ``apply_available()`` deterministically.
    """

    def __init__(
        self,
        wal_dir: str,
        port: int = 0,
        host: str = "127.0.0.1",
        serve_config=None,
        telemetry=None,
        replica_id: str | None = None,
        max_stale_ms: float | None = None,
        poll_interval_s: float | None = None,
        max_restarts: int | None = None,
        backoff_base_s: float | None = None,
        start: bool = True,
        opslog=None,
        primary_head_cb=None,
    ):
        from skyline_tpu_torch.utils.knobs import env_float
        from skyline_tpu_torch.serve import (
            DeltaRing,
            ServeConfig,
            SkylineServer,
            SnapshotStore,
        )
        from skyline_tpu_torch.telemetry import Telemetry

        self.wal_dir = wal_dir
        self.replica_id = (
            replica_id if replica_id is not None else f"replica-{os.getpid()}"
        )
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        scfg = serve_config if serve_config is not None else ServeConfig()
        if max_stale_ms is None:
            max_stale_ms = env_float("SKYLINE_REPLICA_MAX_STALE_MS", 30_000.0)
        self.max_stale_ms = float(max_stale_ms)
        self.poll_interval_s = (
            env_float("SKYLINE_REPLICA_POLL_MS", 25.0) / 1000.0
            if poll_interval_s is None
            else poll_interval_s
        )
        self._max_restarts = max_restarts
        self._backoff_base_s = backoff_base_s
        self.store = SnapshotStore(history=scfg.history)
        self.ring = DeltaRing(self.store, capacity=scfg.delta_ring)
        # zero-copy read path (RUNBOOK §2u): map the PRIMARY's body store
        # (it lives beside the WAL, same shared filesystem) read-only and
        # serve the primary's exact bytes — the replica stops
        # re-serializing what the WAL already delivered byte-verified.
        # Staleness honesty is unaffected: version selection and the fence
        # still come from the replica's own folded store; the mapping only
        # replaces how a chosen version's bytes are produced.
        from skyline_tpu_torch.utils.knobs import env_bool

        self.bodystore = None
        if env_bool("SKYLINE_BODYSTORE", True):
            from skyline_tpu_torch.serve.bodystore import BodyStoreReader

            self.bodystore = BodyStoreReader(
                os.path.join(wal_dir, "bodystore.dat")
            )
        self.server = SkylineServer(
            self.store,
            deltas=self.ring,
            admission=scfg.admission(),
            stats_cb=self.stats,
            bridge=None,  # replicas cannot force merges: reads only
            port=port,
            host=host,
            telemetry=self.telemetry,
            read_cache=scfg.read_cache_entries,
            max_stale_ms=self.max_stale_ms,
            role="replica",
            bodystore=self.bodystore,
        )
        self.port = self.server.port
        # cluster role (RUNBOOK §2r): "replica" until a ClusterSupervisor
        # promotes this node to own the write path under a lease epoch
        self.role = "replica"
        self.promoted_epoch: int | None = None
        self._tailer: WalTailer | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.records_applied = 0
        self.bootstraps = 0
        self.rebootstraps = 0
        self.last_error: str | None = None
        self.supervisor = None
        # ops plane (RUNBOOK §2s): the shared cross-process journal (None
        # outside a cluster) and the primary-head callback that turns
        # "my head" into "versions behind the primary" for
        # skyline_replica_lag_versions{replica=...}
        self.opslog = opslog
        self.primary_head_cb = primary_head_cb
        self.last_lag_ms: float | None = None
        repl = getattr(self.telemetry, "replication", None)
        if repl is not None:
            repl.append(self)
        if start:
            self.start()

    # -- state maintenance (tail thread) -----------------------------------

    def bootstrap(self) -> None:
        """(Re-)build serving state from the WAL: newest checkpoint barrier
        snapshot + every delta after it, byte-exact, then leave the tailer
        positioned at the live tail.

        Starting at the newest barrier (not the oldest segment) is what
        makes corruption recoverable: a corrupt frame BEFORE the newest
        barrier is simply never re-read, and one AFTER it raises — the tail
        loop keeps serving the last verified state (honestly aging into the
        staleness fence) and retries until the primary's next barrier lands
        past the damage."""
        fault_point("replica.restore")
        if self._tailer is not None:
            self._tailer.close()
        self._tailer = WalTailer(self.wal_dir, self.replica_id)
        barrier_seq = self._newest_barrier_seq()
        if barrier_seq is not None:
            self._tailer.seek_to_segment(barrier_seq)
        records = self._tailer.poll()
        self._fold(records)
        self.bootstraps += 1
        if self.opslog is not None:
            self.opslog.record(
                "replica_bootstrap",
                replica=self.replica_id,
                head_version=self.store.head_version,
            )

    def _newest_barrier_seq(self) -> int | None:
        from skyline_tpu_torch.resilience.wal import (
            list_segments,
            segment_first_record,
        )

        best = None
        for seq, path in list_segments(self.wal_dir):
            rec = segment_first_record(path)
            if rec is not None and rec.get("type") == "ckpt" and "snap" in rec:
                best = seq
        return best

    def _fold(self, records: list) -> None:
        import numpy as np

        from skyline_tpu_torch.serve.deltas import Delta, apply_delta_record
        from skyline_tpu_torch.serve.snapshot import points_digest

        base = None
        base_idx = -1
        for i, rec in enumerate(records):
            if rec.get("type") == "ckpt" and "snap" in rec:
                base, base_idx = rec["snap"], i
        delta_recs = [
            r for r in records[base_idx + 1 :] if r.get("type") == "delta"
        ]
        if base is None and not delta_recs:
            return  # nothing published yet; keep tailing
        d = int(base["d"] if base is not None else delta_recs[0]["d"])
        points = (
            rows_from_b64(base["rows"], d)
            if base is not None
            else np.empty((0, d), dtype=np.float32)
        )
        version = int(base["version"]) if base is not None else 0
        watermark = int(base.get("watermark_id", -1)) if base is not None else -1
        ts = float(base["timestamp_ms"]) if base is not None else None
        event_wm = base.get("event_wm_ms") if base is not None else None
        meta = dict(base.get("meta", {})) if base is not None else {}
        ring_deltas = []
        for rec in delta_recs:
            entered = rows_from_b64(rec["entered"], int(rec["d"]))
            left = rows_from_b64(rec["left"], int(rec["d"]))
            ring_deltas.append(
                Delta(int(rec["from"]), int(rec["to"]), entered, left)
            )
            points = apply_delta_record(points, rec)
            if "digest" in rec and points_digest(points) != rec["digest"]:
                raise ReplicaDivergence(
                    f"bootstrap digest mismatch at version {rec['to']}"
                )
            version = int(rec["to"])
            watermark = int(rec.get("wm", watermark))
            ts = float(rec.get("ts", ts)) if rec.get("ts") is not None else ts
            event_wm = rec.get("ewm", event_wm)
            meta = dict(rec.get("meta", {}))
        self.store.restore_state(
            points,
            version,
            watermark_id=watermark,
            timestamp_ms=ts,
            meta=meta,
            event_wm_ms=event_wm,
        )
        self.ring.seed(ring_deltas, version)

    def _apply(self, rec: dict) -> None:
        """Fold one live-tailed record into the serving state."""
        from skyline_tpu_torch.serve.deltas import apply_delta_record
        from skyline_tpu_torch.serve.snapshot import points_digest

        kind = rec.get("type")
        if kind == "ckpt" and "snap" in rec:
            # a barrier we tailed PAST is redundant with the state we
            # already hold; cross-check the head version instead of
            # re-seating (re-seating would launder ``restored`` semantics)
            snap = rec["snap"]
            if int(snap["version"]) < self.store.head_version:
                raise ReplicaDivergence(
                    f"barrier regressed: {snap['version']} < "
                    f"{self.store.head_version}"
                )
            if int(snap["version"]) > self.store.head_version:
                # publishes we never saw (records lost to a skipped tear):
                # the barrier carries the full state — fold from it
                self._fold([rec])
            return
        if kind != "delta":
            return  # batch/commit/start records are ingest-plane lineage
        head = self.store.head_version
        if head == 0 and self.store.published == 0 and self.store.restores == 0:
            # tailer joined mid-stream with no barrier yet: fold from zero
            self._fold([rec])
            self.records_applied += 1
            return
        if int(rec["from"]) != head:
            raise ReplicaDivergence(
                f"version chain break: delta from {rec['from']} "
                f"but head is {head}"
            )
        prev = self.store.latest()
        points = apply_delta_record(
            prev.points if prev is not None else _empty(int(rec["d"])), rec
        )
        if "digest" in rec and points_digest(points) != rec["digest"]:
            raise ReplicaDivergence(
                f"digest mismatch applying delta to version {rec['to']}"
            )
        self.store.publish(
            points,
            watermark_id=int(rec["wm"]),
            now_ms=rec.get("ts"),
            event_wm_ms=rec.get("ewm"),
            **dict(rec.get("meta", {})),
        )
        if self.store.head_version != int(rec["to"]):
            raise ReplicaDivergence(
                f"version drift: published {self.store.head_version}, "
                f"record says {rec['to']}"
            )
        self.records_applied += 1
        if rec.get("ts") is not None:
            lag_ms = max(0.0, time.time() * 1000.0 - float(rec["ts"]))
            self.last_lag_ms = lag_ms
            self.telemetry.histogram("replica_tail_lag_ms", unit="ms").observe(
                lag_ms
            )

    def apply_available(self) -> int:
        """One tail-poll step: apply every newly completed record. Returns
        how many were applied. Raises on corruption/divergence (the
        supervised loop converts that to a re-bootstrap)."""
        if self._tailer is None:
            self.bootstrap()
            return 0
        recs = self._tailer.poll()
        for rec in recs:
            self._apply(rec)
        return len(recs)

    def _rebootstrap(self, err: Exception) -> None:
        """Corruption/divergence fallback: count it, then retry bootstrap
        until one verifies (the replica keeps serving its last good state,
        honestly aging, while damaged history waits for the primary's next
        barrier to land past it)."""
        self.last_error = f"{type(err).__name__}: {err}"
        self.rebootstraps += 1
        self.telemetry.inc("replica.rebootstraps")
        if self.opslog is not None:
            self.opslog.record(
                "replica_rebootstrap",
                replica=self.replica_id, error=self.last_error,
            )
        print(
            f"replica {self.replica_id}: {self.last_error}; re-bootstrapping",
            file=sys.stderr,
        )
        while not self._stop.is_set():
            try:
                self.bootstrap()
                return
            except WalError as e:
                self.last_error = f"{type(e).__name__}: {e}"
                self._stop.wait(self.poll_interval_s)

    def _incarnation(self, attempt: int):
        """One supervised life: bootstrap, then tail until stopped.
        WAL corruption and divergence re-bootstrap in place (counted);
        injected crashes propagate to the supervisor."""
        try:
            self.bootstrap()
        except WalError as e:
            self._rebootstrap(e)
        if attempt > 0:
            self.rebootstraps += 1
        while not self._stop.is_set():
            fault_point("replica.tail")
            try:
                n = self.apply_available()
            except WalError as e:
                self._rebootstrap(e)
                continue
            if n == 0:
                self._stop.wait(self.poll_interval_s)
        return None

    def start(self) -> None:
        from skyline_tpu_torch.resilience.supervisor import Supervisor

        self.supervisor = Supervisor(
            self._incarnation,
            max_restarts=self._max_restarts,
            backoff_base_s=self._backoff_base_s,
            telemetry=self.telemetry,
        )

        def _run():
            try:
                self.supervisor.run()
            except Exception as e:
                self.last_error = f"{type(e).__name__}: {e}"
                print(
                    f"replica {self.replica_id}: tail loop gave up: "
                    f"{self.last_error}",
                    file=sys.stderr,
                )

        self._thread = threading.Thread(
            target=_run, name=f"skyline-{self.replica_id}", daemon=True
        )
        self._thread.start()

    def promote(self, epoch: int) -> dict:
        """Promotion hook for the ``ClusterSupervisor`` (the fence is
        already raised past the deposed epoch, so the durable WAL tail
        can no longer move under us): stop the supervised tail thread,
        drain every durable record, and switch to the primary role.

        Returns ``{head_version, head_digest}`` — the byte-identity
        witness: because every fold is digest-verified against the
        primary's published bytes, the promoted head IS the deposed
        primary's last durable state plus replayed deltas, and the drills
        assert the sha256 matches an independent fold of the WAL."""
        from skyline_tpu_torch.serve.snapshot import points_digest

        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        try:
            if self._tailer is None:
                self.bootstrap()
            while self.apply_available():
                pass
        except WalError as e:
            # damaged tail at the worst moment: re-bootstrap from the
            # newest barrier (state before the damage stays byte-exact)
            self.last_error = f"{type(e).__name__}: {e}"
            self.rebootstraps += 1
            self.bootstrap()
        self.role = "primary"
        self.promoted_epoch = int(epoch)
        self.server.role = "primary"
        latest = self.store.latest()
        return {
            "head_version": self.store.head_version,
            "head_digest": (
                points_digest(latest.points) if latest is not None else None
            ),
        }

    def demote(self) -> None:
        """Rejoin as a follower after deposition — the honest path once
        this node's writer starts raising ``WalFencedError``. Restarts
        the supervised tail loop."""
        was_epoch = self.promoted_epoch
        self.role = "replica"
        self.promoted_epoch = None
        self.server.role = "replica"
        if self.opslog is not None:
            self.opslog.record(
                "demoted", replica=self.replica_id, epoch=was_epoch
            )
        if self._thread is None:
            self._stop = threading.Event()
            self.start()

    def wait_for_version(self, version: int, timeout_s: float = 10.0) -> bool:
        """Test/drill helper: block until the replica's head reaches
        ``version`` (True) or the timeout passes (False)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.store.head_version >= version:
                return True
            time.sleep(0.005)
        return False

    def labeled_series(self):
        """Per-replica Prometheus families (RUNBOOK §2s) — the tailer's
        in-memory stats made scrapable: ``skyline_replica_lag_ms{replica=}``,
        ``skyline_replica_lag_versions{replica=}`` (when a primary-head
        callback is wired), and the ``stale_frames_skipped`` /
        ``partial_retries`` / rebootstrap counts that were previously
        visible only in the stats dict."""
        labels = (("replica", str(self.replica_id)),)
        counters: dict = {}
        gauges: dict = {}

        def _c(name, value):
            counters.setdefault(name, []).append((labels, float(value)))

        def _g(name, value):
            gauges.setdefault(name, []).append((labels, float(value)))

        _c("replica_records_applied", self.records_applied)
        _c("replica_bootstraps", self.bootstraps)
        _c("replica_rebootstraps", self.rebootstraps)
        _g("replica_head_version", self.store.head_version)
        if self.last_lag_ms is not None:
            _g("replica_lag_ms", self.last_lag_ms)
        if self.primary_head_cb is not None:
            try:
                primary_head = int(self.primary_head_cb())
            except Exception:
                primary_head = None
            if primary_head is not None:
                _g(
                    "replica_lag_versions",
                    max(0, primary_head - self.store.head_version),
                )
        tailer = self._tailer
        if tailer is not None:
            try:
                ts = tailer.stats()
            except Exception:
                ts = {}
            _c("replica_stale_frames_skipped", ts.get("stale_frames_skipped", 0))
            _c("replica_partial_retries", ts.get("partial_retries", 0))
            _c("replica_frames_read", ts.get("frames_read", 0))
            _c("replica_segments_finished", ts.get("segments_finished", 0))
            _g("replica_tailer_segment_seq", ts.get("segment_seq", 0))
            _g("replica_tailer_position", ts.get("position", 0))
        return counters, gauges

    def stats(self) -> dict:
        out = {
            "replica": {
                "id": self.replica_id,
                "wal_dir": self.wal_dir,
                "role": self.role,
                "promoted_epoch": self.promoted_epoch,
                "head_version": self.store.head_version,
                "records_applied": self.records_applied,
                "bootstraps": self.bootstraps,
                "rebootstraps": self.rebootstraps,
                "max_stale_ms": self.max_stale_ms,
                "last_error": self.last_error,
            }
        }
        if self._tailer is not None:
            out["replica"]["tailer"] = self._tailer.stats()
        if self.supervisor is not None:
            out["replica"]["supervisor"] = self.supervisor.stats()
        return out

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if self._tailer is not None:
            self._tailer.close()
        repl = getattr(self.telemetry, "replication", None)
        if repl is not None and self in repl:
            repl.remove(self)
        self.server.close()
        if self.bodystore is not None:
            self.bodystore.close()


def _empty(d: int):
    import numpy as np

    return np.empty((0, max(d, 1)), dtype=np.float32)


def run_replica(
    wal_dir: str,
    port: int = 0,
    host: str = "127.0.0.1",
    serve_config=None,
    replica_id: str | None = None,
    install_signal_handlers: bool = True,
) -> int:
    """Blocking CLI entry (``bridge.worker --replica-of <wal_dir>``): run
    one replica until SIGTERM/SIGINT, then drain (close the tailer —
    withdrawing its retention ack — and the server) and exit 0."""
    import signal

    from skyline_tpu_torch.telemetry.opslog import OpsLog, opslog_enabled

    stop = threading.Event()
    ops = None
    if opslog_enabled():
        ops = OpsLog(wal_dir)
    replica = SkylineReplica(
        wal_dir,
        port=port,
        host=host,
        serve_config=serve_config,
        replica_id=replica_id,
        opslog=ops,
    )
    # this process's journal behind the replica surface's GET /ops
    replica.telemetry.opslog = ops
    if install_signal_handlers:

        def _drain(signum, frame):
            stop.set()

        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
    print(
        f"skyline replica {replica.replica_id}: serving on "
        f"{host}:{replica.port} (wal: {wal_dir})",
        file=sys.stderr,
    )
    try:
        while not stop.is_set():
            stop.wait(0.2)
    finally:
        replica.close()
        if ops is not None:
            ops.close()
    return 0

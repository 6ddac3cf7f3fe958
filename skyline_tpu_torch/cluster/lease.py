"""Lease/fencing plane: write-path high availability.

Counterpart of ``skyline_tpu/cluster/lease.py``: the same files beside the
WAL, the same records, so either package's writer, replica or supervisor
honours a lease or fence the other wrote. The write path has exactly one
owner at a time — the engine that appends to the WAL. This module makes
ownership EXPLICIT and REVOCABLE without ever allowing two writers to
interleave frames:

- ``LeasePlane`` manages two tiny JSON files beside the WAL segments:
  ``lease.json`` (who owns the write path, under which monotonic epoch,
  renewed until when) and ``fence.json`` (the minimum epoch the WAL still
  accepts). Both are written atomically (tmp + ``os.replace``) and
  fsynced, so a torn write can never produce a half-lease.
- ``FencedWalWriter`` is a ``WalWriter`` that carries the holder's epoch:
  every frame is stamped with the fencing token (``rec["fence"]``), and
  every append first checks the fence — a deposed primary's append is
  REJECTED with ``WalFencedError`` at the WAL layer, loudly counted
  (``cluster.fenced_writes`` → ``skyline_cluster_fenced_writes_total``),
  never silently dropped. The check is one ``os.stat`` per append
  (re-parsed only when the fence file changes), so the hot path costs
  about as much as the frame's own ``os.write``.
- ``ClusterSupervisor`` watches the lease from the read side: when it
  expires (primary dead or wedged), it raises the fence PAST the dead
  holder's epoch FIRST — from that instant the deposed primary cannot
  append even if it wakes up — then promotes the most-caught-up replica
  under the new epoch. Correctness of the promoted head needs no new
  machinery: replicas fold digest-verified deltas, so the promoted serve
  state is byte-identical to the deposed primary's last durable publish by
  construction.

Ordering is the whole proof: fence BEFORE lease BEFORE promote. A crash
between any two steps leaves the system safe — a raised fence without a
new lease just means the next supervisor tick promotes again under a
higher epoch. Host-side only: nothing here touches a device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

from skyline_tpu_torch.resilience.faults import fault_point
from skyline_tpu_torch.resilience.wal import WalError, WalWriter, list_segments

LEASE_FILE = "lease.json"
FENCE_FILE = "fence.json"


class LeaseLostError(WalError):
    """The holder's lease is gone: a higher epoch exists on disk (another
    writer was promoted) or the fence moved past the holder. The holder
    must demote itself to a replica; its writer will reject appends."""


class WalFencedError(WalError):
    """An append from a fenced (deposed) writer epoch. The frame was NOT
    written — rejection happens before the write syscall."""


def _now_ms() -> float:
    return time.time() * 1000.0


@dataclasses.dataclass
class LeaseRecord:
    epoch: int
    holder: str
    renewed_ms: float
    ttl_ms: float

    def expired(self, now_ms: float) -> bool:
        return now_ms - self.renewed_ms > self.ttl_ms

    def doc(self) -> dict:
        return {
            "epoch": self.epoch,
            "holder": self.holder,
            "renewed_ms": self.renewed_ms,
            "ttl_ms": self.ttl_ms,
        }


class LeasePlane:
    """The on-disk lease + fence beside a WAL directory.

    ``clock``: optional ``() -> now_ms`` override so tests and drills can
    expire leases deterministically instead of sleeping through TTLs.
    """

    def __init__(self, wal_dir: str, clock=None):
        self.wal_dir = wal_dir
        os.makedirs(wal_dir, exist_ok=True)
        self.clock = clock if clock is not None else _now_ms
        self._lock = threading.Lock()
        # (st_ino, st_mtime_ns, st_size) -> parsed fence epoch, so the
        # per-append fence check is one stat, not one parse. st_ino is
        # load-bearing: os.replace lands a new inode every raise, so two
        # same-size fence docs inside one mtime granule (coarse-timestamp
        # filesystems) still invalidate the cache
        self._fence_sig = None
        self._fence_epoch = 0

    # -- file plumbing -----------------------------------------------------

    def _path(self, name: str) -> str:
        return os.path.join(self.wal_dir, name)

    def _write_json(self, name: str, doc: dict) -> None:
        path = self._path(name)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # -- lease -------------------------------------------------------------

    def read_lease(self) -> LeaseRecord | None:
        try:
            with open(self._path(LEASE_FILE), encoding="utf-8") as f:
                doc = json.load(f)
            return LeaseRecord(
                int(doc["epoch"]), str(doc["holder"]),
                float(doc["renewed_ms"]), float(doc["ttl_ms"]),
            )
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return None

    def acquire(
        self, holder: str, ttl_ms: float, epoch: int | None = None
    ) -> LeaseRecord | None:
        """Take the lease. With ``epoch=None`` this is the polite path:
        refused (returns None) while another holder's lease is live, and
        the epoch always advances past the previous one — re-acquiring
        after one's own expiry bumps it too, because frames from the old
        epoch may still be racing toward the disk. With an explicit
        ``epoch`` (the supervisor's promotion path, fence already raised)
        the write is unconditional."""
        with self._lock:
            now = self.clock()
            cur = self.read_lease()
            if epoch is None:
                if cur is not None and cur.holder != holder and not cur.expired(now):
                    return None
                epoch = max(
                    (cur.epoch if cur is not None else 0), self.read_fence()
                ) + 1
            rec = LeaseRecord(int(epoch), holder, now, float(ttl_ms))
            self._write_json(LEASE_FILE, rec.doc())
            return rec

    def renew(self, rec: LeaseRecord) -> LeaseRecord:
        """Refresh ``rec``'s expiry. Raises ``LeaseLostError`` when disk
        disagrees — a higher epoch (someone promoted over us) or a fence
        past our epoch. Deposition is detected HERE, not at the append
        (though the append check also holds, belt and braces)."""
        with self._lock:
            cur = self.read_lease()
            if cur is not None and (
                cur.epoch > rec.epoch or cur.holder != rec.holder
            ):
                raise LeaseLostError(
                    f"lease lost: disk holds epoch {cur.epoch} "
                    f"({cur.holder!r}), we are epoch {rec.epoch}"
                )
            if self.read_fence() > rec.epoch:
                raise LeaseLostError(
                    f"lease lost: fence {self.read_fence()} is past our "
                    f"epoch {rec.epoch}"
                )
            out = LeaseRecord(rec.epoch, rec.holder, self.clock(), rec.ttl_ms)
            self._write_json(LEASE_FILE, out.doc())
            return out

    # -- fence -------------------------------------------------------------

    def read_fence(self) -> int:
        """Minimum epoch the WAL accepts (0 = never fenced). Stat-cached:
        the common case re-reads nothing."""
        path = self._path(FENCE_FILE)
        try:
            st = os.stat(path)
        except OSError:
            return 0
        sig = (st.st_ino, st.st_mtime_ns, st.st_size)
        if sig == self._fence_sig:
            return self._fence_epoch
        try:
            with open(path, encoding="utf-8") as f:
                epoch = int(json.load(f)["min_epoch"])
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return self._fence_epoch  # torn mid-replace: keep the last good
        self._fence_sig, self._fence_epoch = sig, epoch
        return epoch

    def raise_fence(self, min_epoch: int) -> int:
        """Monotonically raise the fence to ``min_epoch`` (never lowers).
        After this returns, any writer below ``min_epoch`` gets
        ``WalFencedError`` on its next append.

        The fence doc also records the durable CUT — newest segment seq +
        its byte size at raise time. Everything durable before the cut is
        the legitimate history the promoted head drains; a deposed
        writer's frame that raced the check-then-write window necessarily
        lands at/past the cut with a below-fence epoch, and every reader
        (tailer, replay) skips it. That closes the race the writer-side
        check alone cannot: a primary paused between its fence check and
        its ``os.write`` can still land a frame, but no reader will ever
        fold it."""
        with self._lock:
            cur = self.read_fence()
            if min_epoch > cur:
                segs = list_segments(self.wal_dir)
                cut_seq, cut_pos = 0, 0
                if segs:
                    cut_seq = segs[-1][0]
                    try:
                        cut_pos = os.path.getsize(segs[-1][1])
                    except OSError:
                        cut_pos = 0
                self._write_json(
                    FENCE_FILE,
                    {
                        "min_epoch": int(min_epoch),
                        "cut_seq": int(cut_seq),
                        "cut_pos": int(cut_pos),
                    },
                )
                self._fence_sig = None  # force a re-read next check
            return max(cur, min_epoch)

    def fence_doc(self) -> dict | None:
        """The full fence file (min_epoch + the durable cut) for the ops
        journal's ``fence_raised`` record; None when never fenced."""
        try:
            with open(self._path(FENCE_FILE), encoding="utf-8") as f:
                doc = json.load(f)
            return {
                "min_epoch": int(doc.get("min_epoch", 0)),
                "cut_seq": int(doc.get("cut_seq", 0)),
                "cut_pos": int(doc.get("cut_pos", 0)),
            }
        except (OSError, ValueError, json.JSONDecodeError):
            return None

    def doc(self) -> dict:
        rec = self.read_lease()
        return {
            "lease": rec.doc() if rec is not None else None,
            "fence": self.read_fence(),
            "expired": (
                rec.expired(self.clock()) if rec is not None else None
            ),
        }


class FencedWalWriter(WalWriter):
    """A ``WalWriter`` bound to a lease epoch: every frame carries the
    fencing token, and appends from a fenced epoch are rejected BEFORE
    the write syscall — plus re-checked AFTER it, so an append that
    raced a fence raise is reported rejected rather than silently
    trusted (readers enforce the same verdict via the fence cut).
    ``barrier()`` is covered too, with its check before the segment
    rotation, so a deposed primary can neither stamp a checkpoint
    barrier nor truncate the promoted writer's fresh segment."""

    def __init__(
        self,
        directory: str,
        epoch: int,
        *,
        plane: LeasePlane | None = None,
        opslog=None,
        **kw,
    ):
        self.plane = plane if plane is not None else LeasePlane(directory)
        self.epoch = int(epoch)
        self.fenced_writes = 0
        self.opslog = opslog
        super().__init__(directory, **kw)

    def _ops_rejected(self, fence: int, where: str) -> None:
        # the zombie's own durable confession: a fenced append is exactly
        # the split-brain evidence the ops timeline must carry
        if self.opslog is not None:
            self.opslog.record(
                "zombie_append_rejected",
                epoch=self.epoch, fence=fence, where=where,
            )

    def _check_fence(self) -> None:
        fence = self.plane.read_fence()
        if fence > self.epoch:
            self.fenced_writes += 1
            if self._telemetry is not None:
                self._telemetry.inc("cluster.fenced_writes")
            self._ops_rejected(fence, "pre_append")
            fault_point("wal.stale_fence")
            raise WalFencedError(
                f"append rejected: writer epoch {self.epoch} is behind "
                f"fence {fence} (another primary was promoted)"
            )

    def append(self, rec: dict) -> None:
        self._check_fence()
        if "fence" not in rec:
            rec = dict(rec)
            rec["fence"] = self.epoch
        super().append(rec)
        # re-check AFTER the write: a fence raised inside the
        # check-then-write window means this frame sits at/past the
        # fence's durable cut, so every reader skips it — report the
        # append as rejected, not silently lost. (If the frame landed
        # just BEFORE the cut it is legitimate drained history; treating
        # an applied write as failed is the safe side of that ambiguity —
        # the deposed caller demotes and re-bootstraps from the WAL.)
        fence = self.plane.read_fence()
        if fence > self.epoch:
            self.fenced_writes += 1
            if self._telemetry is not None:
                self._telemetry.inc("cluster.fenced_writes")
            self._ops_rejected(fence, "post_append")
            raise WalFencedError(
                f"append raced a fence raise: writer epoch {self.epoch} is "
                f"behind fence {fence}; readers will not fold frames past "
                "the fence cut"
            )

    def barrier(self, rec: dict) -> None:
        # check BEFORE rotating: ``barrier`` opens segment seq+1 with
        # O_TRUNC first, which after a promotion can be the NEW primary's
        # live segment — a deposed writer must be stopped before that
        self._check_fence()
        super().barrier(rec)

    def stats(self) -> dict:
        out = super().stats()
        out["epoch"] = self.epoch
        out["fenced_writes"] = self.fenced_writes
        return out


class LeaseKeeper:
    """Primary-side lease maintenance: acquire at startup, renew on a
    cadence from the worker's step/idle hooks. ``maybe_renew`` raises
    ``LeaseLostError`` when deposed — the worker demotes instead of
    writing on."""

    def __init__(
        self,
        plane: LeasePlane,
        holder: str,
        ttl_ms: float | None = None,
        renew_ms: float | None = None,
        telemetry=None,
    ):
        from skyline_tpu_torch.utils.knobs import env_float

        self.plane = plane
        self.holder = holder
        self.ttl_ms = (
            env_float("SKYLINE_CLUSTER_LEASE_TTL_MS", 3000.0)
            if ttl_ms is None
            else float(ttl_ms)
        )
        renew = (
            env_float("SKYLINE_CLUSTER_LEASE_RENEW_MS", 0.0)
            if renew_ms is None
            else float(renew_ms)
        )
        # a renew cadence slower than the TTL is self-deposition
        self.renew_ms = renew if renew > 0 else max(self.ttl_ms / 3.0, 1.0)
        self.telemetry = telemetry
        self.record: LeaseRecord | None = None

    def acquire(self) -> LeaseRecord | None:
        self.record = self.plane.acquire(self.holder, self.ttl_ms)
        return self.record

    @property
    def epoch(self) -> int:
        return self.record.epoch if self.record is not None else 0

    def maybe_renew(self, now_ms: float | None = None) -> bool:
        """Renew when due. Returns True when a renewal was written."""
        if self.record is None:
            return False
        now = self.plane.clock() if now_ms is None else now_ms
        if now - self.record.renewed_ms < self.renew_ms:
            return False
        t0 = time.perf_counter_ns()
        self.record = self.plane.renew(self.record)
        if self.telemetry is not None:
            self.telemetry.inc("cluster.lease_renewals")
            # renew latency is the lease plane's fsync tax; a p99 drift
            # here predicts spurious expiries before they happen
            self.telemetry.histogram(
                "cluster_lease_renew_ms", unit="ms"
            ).observe((time.perf_counter_ns() - t0) / 1e6)
        return True


class ClusterSupervisor:
    """Watches the lease beside a shared WAL and promotes the
    most-caught-up replica when it expires.

    ``replicas``: the ``serve.replica.SkylineReplica`` candidates (they
    all tail the same WAL, so after the promotion drain every candidate
    converges to the same durable tail; the head-version snapshot picks
    the one with the least catching up to do). ``tick()`` is the whole
    control loop — call it from a timer, an idle hook, or a drill.
    """

    def __init__(
        self,
        wal_dir: str,
        replicas,
        *,
        lease_ttl_ms: float | None = None,
        telemetry=None,
        clock=None,
        opslog=None,
    ):
        from skyline_tpu_torch.utils.knobs import env_float

        self.plane = LeasePlane(wal_dir, clock=clock)
        self.replicas = list(replicas)
        self.lease_ttl_ms = (
            env_float("SKYLINE_CLUSTER_LEASE_TTL_MS", 3000.0)
            if lease_ttl_ms is None
            else float(lease_ttl_ms)
        )
        self.telemetry = telemetry
        self.opslog = opslog
        self.promotions = 0
        self.last_promotion: dict | None = None
        self._lock = threading.Lock()

    def _ops(self, type_: str, **fields) -> None:
        if self.opslog is not None:
            self.opslog.record(type_, **fields)

    def _promoted(self):
        return next(
            (r for r in self.replicas if getattr(r, "role", "replica") == "primary"),
            None,
        )

    def tick(self) -> dict | None:
        """One supervision step: renew on behalf of a replica we already
        promoted, otherwise check expiry and promote. Returns the
        promotion doc when a promotion happened this tick, else None."""
        with self._lock:
            now = self.plane.clock()
            rec = self.plane.read_lease()
            mine = self._promoted()
            if rec is not None and not rec.expired(now):
                if mine is None or rec.holder != mine.replica_id:
                    return None  # someone else's live lease: not ours to touch
                try:
                    self.plane.renew(rec)
                    return None
                except LeaseLostError:
                    # another supervisor fenced past our promotee: demote
                    # the zombie primary and fall through to re-promotion
                    # under a higher epoch instead of crashing the
                    # caller's timer loop
                    demote = getattr(mine, "demote", None)
                    if demote is not None:
                        demote()
                    if self.telemetry is not None:
                        self.telemetry.inc("cluster.renewals_lost")
                    self._ops(
                        "lease_renew_lost",
                        epoch=rec.epoch, holder=rec.holder,
                        fence=self.plane.read_fence(),
                    )
            # lease absent or expired: the write path is ownerless
            fault_point("cluster.lease_expire")
            t0 = time.perf_counter_ns()
            candidates = [
                r for r in self.replicas
                if getattr(r, "role", "replica") != "primary"
            ]
            if not candidates:
                return None
            best = max(candidates, key=lambda r: r.store.head_version)
            new_epoch = max(
                (rec.epoch if rec is not None else 0), self.plane.read_fence()
            ) + 1
            self._ops(
                "lease_expired",
                epoch=rec.epoch if rec is not None else None,
                holder=rec.holder if rec is not None else None,
            )
            # fence FIRST: from here the deposed epoch cannot append, so
            # nothing the old primary does can interleave with the drain
            tf = time.perf_counter_ns()
            self.plane.raise_fence(new_epoch)
            fence_ms = (time.perf_counter_ns() - tf) / 1e6
            cut = self.plane.fence_doc() or {}
            self._ops(
                "fence_raised",
                epoch=new_epoch, fence=new_epoch,
                cut_seq=cut.get("cut_seq"), cut_pos=cut.get("cut_pos"),
                wall_ms=round(fence_ms, 3),
            )
            lease = self.plane.acquire(
                best.replica_id, self.lease_ttl_ms, epoch=new_epoch
            )
            info = best.promote(new_epoch)
            wall_ms = (time.perf_counter_ns() - t0) / 1e6
            self.promotions += 1
            doc = {
                "epoch": lease.epoch,
                "holder": best.replica_id,
                "deposed": rec.holder if rec is not None else None,
                "time_to_promote_ms": round(wall_ms, 3),
                "head_version": info.get("head_version"),
                "head_digest": info.get("head_digest"),
                "at_ms": now,
            }
            self.last_promotion = doc
            if self.telemetry is not None:
                self.telemetry.inc("cluster.promotions")
                # real histograms, not one-shot bench numbers: /slo's
                # promote_p99 row and the sentinel read these
                self.telemetry.histogram(
                    "cluster_time_to_promote_ms", unit="ms"
                ).observe(wall_ms)
                self.telemetry.histogram(
                    "cluster_fence_raise_ms", unit="ms"
                ).observe(fence_ms)
            self._ops(
                "promoted",
                epoch=lease.epoch, holder=best.replica_id,
                deposed=doc["deposed"], head_version=doc["head_version"],
                wall_ms=doc["time_to_promote_ms"],
            )
            return doc

    def doc(self) -> dict:
        out = self.plane.doc()
        out.update({
            "promotions": self.promotions,
            "last_promotion": self.last_promotion,
            "members": [
                {
                    "id": r.replica_id,
                    "role": getattr(r, "role", "replica"),
                    "head_version": r.store.head_version,
                }
                for r in self.replicas
            ],
        })
        return out


class ClusterStatus:
    """The hub object behind ``GET /cluster`` on both HTTP surfaces
    (``telemetry.cluster``): membership, lease holder, epoch, last
    promotion, plus the multi-host coordinator block when one is
    attached. Callbacks keep it passive — serving a doc can never
    perturb the planes it describes."""

    def __init__(self, node_id: str = "", role: str = "primary"):
        self.node_id = node_id
        self.role = role
        self.lease_cb = None  # () -> dict (LeasePlane.doc / Supervisor.doc)
        self.coordinator_cb = None  # () -> dict (ClusterPartitionSet.cluster_stats)
        self.telemetry = None

    def doc(self) -> dict:
        out: dict = {"enabled": True, "node": self.node_id, "role": self.role}
        if self.lease_cb is not None:
            try:
                out.update(self.lease_cb())
            except Exception as e:  # observability must not 500 the plane
                out["lease_error"] = f"{type(e).__name__}: {e}"
        if self.coordinator_cb is not None:
            try:
                out["hosts"] = self.coordinator_cb()
            except Exception as e:
                out["hosts_error"] = f"{type(e).__name__}: {e}"
        if self.telemetry is not None:
            snap = dict(self.telemetry.counters.snapshot())
            out["fenced_writes"] = int(snap.get("cluster.fenced_writes", 0))
            out["promotions_counted"] = int(snap.get("cluster.promotions", 0))
        return out

    def labeled_series(self):
        """Host-labeled Prometheus families (mirrors the fleet plane's
        per-chip families): records/pruned counters and skyline-size
        gauges per host, from the coordinator's per-host block."""
        if self.coordinator_cb is None:
            return {}, {}
        try:
            stats = self.coordinator_cb()
        except Exception:
            return {}, {}
        last = stats.get("last") or {}
        counters: dict = {}
        gauges: dict = {}
        for row in last.get("per_host", []):
            labels = (("host", str(row["host"])),)
            counters.setdefault("host_records", []).append(
                (labels, float(row.get("records", 0)))
            )
            counters.setdefault("host_pruned", []).append(
                (labels, 1.0 if row.get("pruned") else 0.0)
            )
            gauges.setdefault("host_skyline_size", []).append(
                (labels, float(row.get("skyline", 0)))
            )
        return counters, gauges

"""Durable cross-process ops journal: the control plane's record.

The port's copy of ``skyline_tpu/telemetry/opslog.py``, same frames and
records. Every control-plane transition (lease acquire, demotion,
quarantine, degraded publish, ...) lands beside the WAL, so a post-mortem
reconstructs "what happened between 14:02 and 14:03" across processes:

- ``OpsLog`` is an append-only, CRC-framed journal living beside the WAL
  (``<wal_dir>/ops/``), one file per writer incarnation
  (``ops-<pid>-<nonce>.log``), reusing the WAL's framing discipline:
  ``SKOP1\\n`` magic, ``<u32 len><u32 crc32(payload)>`` frames, one
  unbuffered ``os.write`` per record — an abandoned writer (SIGKILL)
  loses at most the frame being written, never a returned append.
  Every record carries a per-writer monotonic ``seq``, wall time
  (``t_ms``), the writer's process identity (``worker-<host>-<pid>``),
  and — where they exist — the epoch, the fencing token, and the query
  ``trace_id``, so a promotion drill reconstructs as ONE causal timeline
  across the supervisor, the deposed primary, and the promoted replica.
- ``read_ops`` merges every writer's journal into one timeline (sorted by
  wall time, then process id, then seq) with the WAL reader's torn-tail
  tolerance: each file is parsed up to its first short or CRC-mismatching
  frame (a crash artifact, counted, never fatal) — corruption in one
  writer's journal can never hide another writer's records.

Record vocabulary (the ``type`` field): ``lease_acquired``,
``lease_renew_lost``, ``lease_expired``, ``fence_raised``, ``promoted``,
``demoted``, ``replica_bootstrap``, ``replica_rebootstrap``,
``zombie_append_rejected``, ``chip_quarantined``, ``chip_failover``,
``host_migrated``, ``degraded_publish``. Free-form detail fields ride
along per type (the durable cut on ``fence_raised``, the head
version/digest on ``promoted``, ...).

Served as ``GET /ops[?since_seq=N]`` on both HTTP surfaces (RUNBOOK §2s);
``since_seq`` filters per writer (seq is monotone PER WRITER, so a poller
tracking each writer's high-water mark gets exactly the new records).
``python -m skyline_tpu_torch.opslog`` pretty-prints a journal directory, a
``/ops`` URL, or a saved JSON doc, and diffs two of them.

Knobs: ``SKYLINE_OPSLOG`` (master switch, default on),
``SKYLINE_OPSLOG_FSYNC`` (``always``/``batch``/``off``, default ``off`` —
one unbuffered write per record is durable against process death; pick
``always`` for power-loss durability at ~ms per record),
``SKYLINE_OPSLOG_MAX_BYTES`` (per-incarnation cap, default 8 MiB; past
it records are dropped and counted, never silently).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import zlib

_OPS_MAGIC = b"SKOP1\n"
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)
_OPS_SUBDIR = "ops"
_FILE_PREFIX = "ops-"
_FILE_SUFFIX = ".log"

FSYNC_POLICIES = ("always", "batch", "off")


def process_identity() -> str:
    """The cross-process writer identity every record carries."""
    return f"worker-{socket.gethostname()}-{os.getpid()}"


def ops_dir(wal_dir: str) -> str:
    return os.path.join(wal_dir, _OPS_SUBDIR)


def opslog_enabled() -> bool:
    from skyline_tpu_torch.utils.knobs import env_bool

    return env_bool("SKYLINE_OPSLOG", True)


class OpsLog:
    """Per-process append-only control-plane journal beside the WAL.

    Thread-safe: the supervisor timer, the replica tail thread, and the
    worker's step loop may all record transitions concurrently.
    """

    def __init__(
        self,
        wal_dir: str,
        process_id: str | None = None,
        fsync: str | None = None,
        max_bytes: int | None = None,
        telemetry=None,
    ):
        from skyline_tpu_torch.utils.knobs import env_int, env_str

        self.wal_dir = wal_dir
        self.directory = ops_dir(wal_dir)
        self.process_id = process_id or process_identity()
        policy = (
            env_str("SKYLINE_OPSLOG_FSYNC", "off") if fsync is None else fsync
        )
        if policy not in FSYNC_POLICIES:
            raise ValueError(
                f"opslog fsync must be one of {FSYNC_POLICIES}, got {policy!r}"
            )
        self.fsync_policy = policy
        self.max_bytes = (
            env_int("SKYLINE_OPSLOG_MAX_BYTES", 8_388_608)
            if max_bytes is None
            else int(max_bytes)
        )
        self._telemetry = telemetry
        self.appends = 0
        self.dropped = 0
        self.seq = 0
        self._lock = threading.Lock()
        self._dirty = False
        os.makedirs(self.directory, exist_ok=True)
        # a fresh file per incarnation: never append into a file a crashed
        # incarnation may have left torn (same rule as the WAL's segments)
        nonce = f"{int(time.time() * 1000) & 0xFFFFFF:06x}"
        base = f"{_FILE_PREFIX}{os.getpid()}-{nonce}"
        path = os.path.join(self.directory, base + _FILE_SUFFIX)
        k = 0
        while os.path.exists(path):  # pid+ms collision: disambiguate
            k += 1
            path = os.path.join(self.directory, f"{base}-{k}{_FILE_SUFFIX}")
        self.path = path
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
        os.write(self._fd, _OPS_MAGIC)
        self._bytes = len(_OPS_MAGIC)

    def record(
        self,
        type: str,
        *,
        epoch: int | None = None,
        fence: int | None = None,
        trace_id: str | None = None,
        **detail,
    ) -> dict | None:
        """Append one control-plane transition. Returns the record written
        (None when the journal is closed or over its size cap — counted,
        never raised: the ops plane must not take down the plane it
        observes)."""
        with self._lock:
            if self._fd is None:
                self.dropped += 1
                return None
            self.seq += 1
            rec: dict = {
                "seq": self.seq,
                "t_ms": time.time() * 1000.0,
                "type": str(type),
                "proc": self.process_id,
            }
            if epoch is not None:
                rec["epoch"] = int(epoch)
            if fence is not None:
                rec["fence"] = int(fence)
            if trace_id:
                rec["trace_id"] = trace_id
            for k, v in detail.items():
                if v is not None:
                    rec[k] = v
            payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
            frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
            if self._bytes + len(frame) > self.max_bytes:
                self.dropped += 1
                if self._telemetry is not None:
                    self._telemetry.inc("ops.dropped")
                return None
            try:
                os.write(self._fd, frame)  # unbuffered: one syscall per record
            except OSError:
                self.dropped += 1
                return None
            self._bytes += len(frame)
            self._dirty = True
            self.appends += 1
            if self._telemetry is not None:
                self._telemetry.inc("ops.appends")
            if self.fsync_policy == "always":
                os.fsync(self._fd)
                self._dirty = False
            return rec

    def flush(self, force: bool = False) -> None:
        with self._lock:
            if (
                self._fd is not None
                and self._dirty
                and (force or self.fsync_policy == "batch")
            ):
                os.fsync(self._fd)
                self._dirty = False

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                if self._dirty and self.fsync_policy != "off":
                    os.fsync(self._fd)
                os.close(self._fd)
                self._fd = None

    def stats(self) -> dict:
        return {
            "path": self.path,
            "process_id": self.process_id,
            "appends": self.appends,
            "dropped": self.dropped,
            "seq": self.seq,
            "bytes": self._bytes,
            "fsync_policy": self.fsync_policy,
        }


def _read_one(path: str) -> tuple[list[dict], bool]:
    """Parse one writer's journal file with the WAL's torn-tail tolerance:
    records up to the first short/CRC-bad/unparsable frame, plus whether
    the file was torn. An ``os.write`` crash leaves a frame PREFIX, so a
    tear is a crash artifact; full-length garbage is real corruption —
    either way the prefix before it is trustworthy and is returned."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], True
    if data[: len(_OPS_MAGIC)] != _OPS_MAGIC:
        return [], True
    out: list[dict] = []
    pos = len(_OPS_MAGIC)
    torn = False
    while pos < len(data):
        if pos + _FRAME.size > len(data):
            torn = True
            break
        length, crc = _FRAME.unpack_from(data, pos)
        start = pos + _FRAME.size
        payload = data[start : start + length]
        if len(payload) != length or zlib.crc32(payload) != crc:
            torn = True
            break
        try:
            rec = json.loads(payload.decode("utf-8"))
        except ValueError:
            torn = True
            break
        if isinstance(rec, dict):
            out.append(rec)
        pos = start + length
    return out, torn


def list_journals(wal_dir: str) -> list[str]:
    d = ops_dir(wal_dir)
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return []
    return sorted(
        os.path.join(d, n)
        for n in names
        if n.startswith(_FILE_PREFIX) and n.endswith(_FILE_SUFFIX)
    )


def read_ops(
    wal_dir: str,
    since_seq: int | None = None,
    limit: int | None = None,
) -> dict:
    """Merge every writer's journal into one causal timeline.

    Records sort by ``(t_ms, proc, seq)`` — wall time first so the
    cross-process story reads in order, then writer identity and the
    per-writer monotonic seq as deterministic tie-breakers. ``since_seq``
    filters PER WRITER (each writer's seq is monotone; a poller tracking
    per-writer high-water marks gets exactly the unseen suffix).
    ``limit`` keeps the newest N after filtering.
    """
    records: list[dict] = []
    torn = 0
    files = list_journals(wal_dir)
    for path in files:
        recs, was_torn = _read_one(path)
        if was_torn:
            torn += 1
        records.extend(recs)
    if since_seq is not None:
        records = [r for r in records if int(r.get("seq", 0)) > since_seq]
    records.sort(
        key=lambda r: (
            float(r.get("t_ms", 0.0)),
            str(r.get("proc", "")),
            int(r.get("seq", 0)),
        )
    )
    total = len(records)
    if limit is not None and limit >= 0 and total > limit:
        records = records[-limit:]
    return {
        "enabled": True,
        "writers": len(files),
        "torn": torn,
        "total": total,
        "records": records,
    }


def ops_doc(wal_dir: str | None, since_seq: int | None = None,
            limit: int | None = None) -> dict:
    """The ``GET /ops`` document: probe-friendly on non-cluster workers
    (``{"ok": true, "enabled": false}`` when no journal directory exists),
    and never raising — observability must not 500 the plane."""
    if not wal_dir:
        return {"ok": True, "enabled": False}
    try:
        if not os.path.isdir(ops_dir(wal_dir)):
            return {"ok": True, "enabled": False}
        doc = read_ops(wal_dir, since_seq=since_seq, limit=limit)
        doc["ok"] = True
        return doc
    except Exception as e:  # pragma: no cover - diagnostic path
        return {"ok": False, "enabled": True, "error": f"{type(e).__name__}: {e}"}


# --------------------------------------------------------------------------
# CLI: pretty-print / diff (python -m skyline_tpu_torch.opslog)
# --------------------------------------------------------------------------


def _load_source(src: str) -> dict:
    """A journal source: a WAL/ops directory, a ``/ops`` URL, a saved JSON
    file, or ``-`` for stdin."""
    import sys

    if src == "-":
        return json.load(sys.stdin)
    if src.startswith("http://") or src.startswith("https://"):
        import urllib.request

        with urllib.request.urlopen(src, timeout=10) as r:
            return json.loads(r.read().decode())
    if os.path.isdir(src):
        # accept the WAL dir or the ops/ subdir itself
        base = src
        if os.path.basename(os.path.normpath(src)) == _OPS_SUBDIR:
            base = os.path.dirname(os.path.normpath(src))
        return ops_doc(base)
    with open(src, encoding="utf-8") as f:
        return json.load(f)


def _fmt_record(rec: dict) -> str:
    t = rec.get("t_ms")
    when = (
        time.strftime("%H:%M:%S", time.localtime(t / 1000.0))
        + f".{int(t % 1000.0):03d}"
        if isinstance(t, (int, float))
        else "??:??:??"
    )
    core = {"seq", "t_ms", "type", "proc", "epoch", "fence", "trace_id"}
    extras = " ".join(
        f"{k}={rec[k]}" for k in sorted(rec) if k not in core
    )
    bits = [f"{when}", f"#{rec.get('seq', '?')}", f"{rec.get('type', '?'):<22}"]
    if "epoch" in rec:
        bits.append(f"epoch={rec['epoch']}")
    if "fence" in rec:
        bits.append(f"fence={rec['fence']}")
    bits.append(f"[{rec.get('proc', '?')}]")
    if rec.get("trace_id"):
        bits.append(f"trace={rec['trace_id']}")
    if extras:
        bits.append(extras)
    return "  ".join(bits)


def _key(rec: dict) -> tuple:
    return (str(rec.get("proc", "")), int(rec.get("seq", 0)))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m skyline_tpu_torch.opslog",
        description=(
            "Pretty-print or diff the cluster ops journal. SOURCE is a WAL "
            "directory (or its ops/ subdir), a /ops URL, a saved JSON doc, "
            "or '-' for stdin. Two sources diff by (proc, seq)."
        ),
    )
    ap.add_argument("sources", nargs="+", metavar="SOURCE")
    ap.add_argument("--since-seq", type=int, default=None,
                    help="per-writer seq floor (records with seq > N)")
    ap.add_argument("--json", action="store_true",
                    help="emit the merged doc as JSON instead of lines")
    a = ap.parse_args(argv)

    if len(a.sources) > 2:
        ap.error("give one SOURCE to print or two to diff")
    try:
        docs = [_load_source(s) for s in a.sources]
    except (OSError, ValueError) as e:
        print(f"opslog: {e}")
        return 2

    if len(docs) == 1:
        doc = docs[0]
        recs = doc.get("records", [])
        if a.since_seq is not None:
            recs = [r for r in recs if int(r.get("seq", 0)) > a.since_seq]
        if a.json:
            print(json.dumps({**doc, "records": recs}, indent=1))
            return 0
        if not doc.get("enabled", True):
            print("opslog: journal disabled (no ops/ directory)")
            return 0
        for rec in recs:
            print(_fmt_record(rec))
        print(
            f"-- {len(recs)} record(s), {doc.get('writers', '?')} writer(s), "
            f"{doc.get('torn', 0)} torn file(s)"
        )
        return 0

    old = {_key(r): r for r in docs[0].get("records", [])}
    new = {_key(r): r for r in docs[1].get("records", [])}
    removed = [old[k] for k in sorted(old.keys() - new.keys())]
    added = [new[k] for k in sorted(new.keys() - old.keys())]
    if a.json:
        print(json.dumps({"added": added, "removed": removed}, indent=1))
        return 0
    for rec in removed:
        print(f"- {_fmt_record(rec)}")
    for rec in added:
        print(f"+ {_fmt_record(rec)}")
    print(f"-- diff: +{len(added)} -{len(removed)} record(s)")
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI entry
    raise SystemExit(main())

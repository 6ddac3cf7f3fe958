"""CRC32-framed, segment-rotated write-ahead log for the worker.

The port's copy of ``skyline_tpu/resilience/wal.py``: the same frames,
segment names and records, so either package replays a log the other
wrote.

What goes in (one JSON record per frame):

- ``batch``  {lo, hi, digest}: a consumed data-topic span that the engine
  ingested, with a sha1 over the parsed (ids, values) arrays. Replay polls
  exactly ``hi - lo`` records from the committed offset and verifies the
  digest, so recovery can prove the re-ingested suffix is byte-identical
  to what the crashed incarnation saw (no duplicate, no lost tuples).
- ``commit`` {data_off, query_off}: consumed positions at a step boundary.
- ``delta``  a published snapshot transition (entered/left rows, base64 of
  the float32 bytes) — this is what persists the serve plane's
  ``DeltaRing`` across restarts.
- ``ckpt``   the checkpoint barrier: consumed offsets + the serving head
  snapshot inlined, written to a FRESH segment after every checkpoint
  save; all older segments are then deleted (truncation).
- ``start``  positions at worker construction (anchors the query topic's
  latest-reset offset for replay).

Frame format: ``<u32 len><u32 crc32(payload)>`` + payload. Appends go
through one unbuffered ``os.write`` per frame, so an abandoned writer (the
in-process crash model, and a real SIGKILL) loses at most the frame being
written — never a previously returned append. ``fsync`` policy:
``always`` (per append), ``batch`` (per worker step, via ``flush()``), or
``off`` (OS page cache only — still crash-safe against process death,
not against power loss).

The reader tolerates a torn tail: replay stops cleanly at the first short
or CRC-mismatching frame and reports how many segments were cut short.

Fencing (cluster mode): when a ``fence.json`` sits beside the segments
(written by the lease plane, ``cluster/lease.py``), readers enforce
it too. The fence doc
records the durable byte position at the moment the fence was raised
(``cut_seq``/``cut_pos``); any frame AT OR PAST that cut whose stamped
epoch (``rec["fence"]``) is below ``min_epoch`` is a deposed primary's
append that raced the fence check (check-then-write window) and is
SKIPPED — loudly counted, never folded — by both the tailer and replay.
Frames before the cut are the legitimate pre-fence history the promoted
head drained, whatever their epoch.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import struct
import sys
import time
import zlib

from skyline_tpu_torch.resilience.faults import fault_point

_SEGMENT_MAGIC = b"SKWL1\n"
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)
_SEGMENT_FMT = "wal-%08d.log"
_ACK_FMT = "tail-%s.ack"
_FENCE_FILE = "fence.json"  # written by cluster/lease.py beside the segments
FSYNC_POLICIES = ("always", "batch", "off")


class WalError(Exception):
    pass


class WalReplayError(WalError):
    """Recovery found the WAL and the bus in disagreement (gap in the
    recorded spans, bus ended early, or a replay digest mismatch)."""


class WalTailCorruption(WalError):
    """The tailer hit a *complete* frame with a bad CRC / unparsable
    payload, or a segment whose magic is wrong — definitive on-disk
    corruption, not a crash artifact (``os.write`` leaves prefixes, never
    full-length garbage frames). The tailer's owner must re-bootstrap."""


class WalSegmentGone(WalError):
    """The segment the tailer was mid-read on vanished (pruned under it).
    The tailer's position is unrecoverable; re-bootstrap from the newest
    barrier."""


def batch_digest(ids, values) -> str:
    """Content hash of one parsed ingest batch — the replay-equivalence
    currency (order-sensitive, dtype-pinned). It hashes the host arrays as
    the parser gave them (int64 ids, float32 values), never a device
    tensor or a re-cast copy, so a log written by either package digests
    the same bytes; anything else raises ``TypeError``."""
    import numpy as np

    if not (isinstance(ids, np.ndarray) and isinstance(values, np.ndarray)):
        raise TypeError(
            "batch_digest hashes the polled host arrays (numpy), got "
            f"{type(ids).__name__} / {type(values).__name__}"
        )
    if ids.dtype != np.int64 or values.dtype != np.float32:
        raise TypeError(
            "batch_digest hashes int64 ids and float32 values as parsed, got "
            f"{ids.dtype} / {values.dtype}"
        )
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(ids, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(values, dtype=np.float32).tobytes())
    return h.hexdigest()


def rows_to_b64(rows) -> str:
    import numpy as np

    return base64.b64encode(
        np.ascontiguousarray(rows, dtype=np.float32).tobytes()
    ).decode("ascii")


def rows_from_b64(s: str, dims: int):
    import numpy as np

    buf = base64.b64decode(s.encode("ascii"))
    return np.frombuffer(buf, dtype=np.float32).reshape(-1, max(dims, 1)).copy()


def _segment_seq(name: str) -> int | None:
    if name.startswith("wal-") and name.endswith(".log"):
        try:
            return int(name[4:-4])
        except ValueError:
            return None
    return None


def list_segments(directory: str) -> list[tuple[int, str]]:
    """(seq, path) of every WAL segment, ascending."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    out = []
    for n in names:
        seq = _segment_seq(n)
        if seq is not None:
            out.append((seq, os.path.join(directory, n)))
    out.sort()
    return out


def _ack_files(directory: str) -> list[str]:
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return [
        os.path.join(directory, n)
        for n in names
        if n.startswith("tail-") and n.endswith(".ack")
    ]


def tail_retention_floor(directory: str, ttl_s: float | None = None) -> int | None:
    """Lowest segment any live tailer still needs, or ``None`` when no
    tailer is registered. A tailer that acked segment N has fully consumed
    everything < N+1, so its floor is ``acked + 1``. Ack files older than
    ``ttl_s`` (mtime) belong to dead tailers and are ignored AND removed,
    so an abandoned replica cannot pin retention forever."""
    floor: int | None = None
    now = time.time()
    for path in _ack_files(directory):
        try:
            if ttl_s is not None and now - os.path.getmtime(path) > ttl_s:
                os.unlink(path)
                continue
            with open(path, "r", encoding="utf-8") as f:
                acked = int(json.load(f).get("seq", -1))
        except (OSError, ValueError):
            continue  # mid-replace or malformed: skip this tailer this round
        need = acked + 1
        if floor is None or need < floor:
            floor = need
    return floor


def ack_ages_s(directory: str) -> dict[str, float]:
    """``{tailer_id: seconds since its retention ack was refreshed}`` —
    the replication plane's liveness gauge (RUNBOOK §2s): a growing ack
    age is a stalled or dead tailer still pinning segment retention."""
    out: dict[str, float] = {}
    now = time.time()
    for path in _ack_files(directory):
        name = os.path.basename(path)
        tailer = name[len("tail-"):-len(".ack")] or name
        try:
            out[tailer] = max(0.0, now - os.path.getmtime(path))
        except OSError:
            continue  # withdrawn mid-scan
    return out


class _FenceView:
    """Read-side view of ``fence.json``: ``(min_epoch, cut_seq, cut_pos)``
    or ``None`` when the directory is unfenced (non-cluster mode — the
    common case costs one failing ``os.stat``). Stat-cached like the
    writer's fence check; the signature includes ``st_ino`` because
    ``os.replace`` always lands a new inode, so two same-size fence docs
    inside one mtime granule still invalidate the cache."""

    __slots__ = ("path", "_sig", "_doc")

    def __init__(self, directory: str):
        self.path = os.path.join(directory, _FENCE_FILE)
        self._sig = None
        self._doc: tuple[int, int, int] | None = None

    def read(self) -> tuple[int, int, int] | None:
        try:
            st = os.stat(self.path)
        except OSError:
            return None
        sig = (st.st_ino, st.st_mtime_ns, st.st_size)
        if sig == self._sig:
            return self._doc
        try:
            with open(self.path, encoding="utf-8") as f:
                doc = json.load(f)
            parsed = (
                int(doc["min_epoch"]),
                int(doc.get("cut_seq", 0)),
                int(doc.get("cut_pos", 0)),
            )
        except (OSError, ValueError, KeyError):
            return self._doc  # torn mid-replace: keep the last good view
        self._sig, self._doc = sig, parsed
        return parsed


def _frame_is_stale(
    fence: tuple[int, int, int] | None, seq: int, pos: int, rec: dict
) -> bool:
    """A deposed primary's post-fence frame: located at/past the fence's
    durable cut, stamped with an epoch below ``min_epoch`` (frames with
    no stamp count as epoch 0 — in a fenced directory every legitimate
    writer stamps)."""
    if fence is None:
        return False
    min_epoch, cut_seq, cut_pos = fence
    return (seq, pos) >= (cut_seq, cut_pos) and int(rec.get("fence", 0)) < min_epoch


class WalWriter:
    """Single-threaded appender (the worker's ingest thread owns it)."""

    def __init__(
        self,
        directory: str,
        segment_bytes: int = 4_194_304,
        fsync: str = "batch",
        telemetry=None,
        tailer_ttl_s: float | None = None,
    ):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync must be one of {FSYNC_POLICIES}, got {fsync!r}")
        self.directory = directory
        self.segment_bytes = max(int(segment_bytes), len(_SEGMENT_MAGIC) + 1)
        self.fsync_policy = fsync
        self._telemetry = telemetry
        self.tailer_ttl_s = tailer_ttl_s
        self.appends = 0
        self.segments_created = 0
        self.segments_truncated = 0
        self.segments_retained = 0
        self._fd: int | None = None
        self._seg_seq = 0
        self._seg_bytes = 0
        self._dirty = False  # frames written since the last fsync
        os.makedirs(directory, exist_ok=True)
        existing = list_segments(directory)
        # a fresh segment per writer: never append into a segment a crashed
        # incarnation may have left torn
        self._open_segment((existing[-1][0] + 1) if existing else 1)

    def _open_segment(self, seq: int) -> None:
        if self._fd is not None:
            self._fsync_if(self.fsync_policy != "off")
            os.close(self._fd)
            fault_point("wal.rotate_during_tail")
        path = os.path.join(self.directory, _SEGMENT_FMT % seq)
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        os.write(self._fd, _SEGMENT_MAGIC)
        self._seg_seq = seq
        self._seg_bytes = len(_SEGMENT_MAGIC)
        self.segments_created += 1

    def append(self, rec: dict) -> None:
        payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
        frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        os.write(self._fd, frame)  # unbuffered: one write syscall per frame
        self._seg_bytes += len(frame)
        self._dirty = True
        fault_point("wal.post_append")
        self.appends += 1
        if self._telemetry is not None:
            self._telemetry.inc("wal.appends")
        if self.fsync_policy == "always":
            self._fsync()
        if self._seg_bytes >= self.segment_bytes:
            self._open_segment(self._seg_seq + 1)

    def flush(self, force: bool = False) -> None:
        """The per-step durability point under the ``batch`` policy
        (``force=True``: fsync regardless of policy — the shutdown path)."""
        self._fsync_if(force or self.fsync_policy == "batch")

    def _fsync_if(self, cond: bool) -> None:
        if cond and self._dirty and self._fd is not None:
            self._fsync()

    def _fsync(self) -> None:
        fault_point("wal.pre_fsync")
        os.fsync(self._fd)
        self._dirty = False

    def barrier(self, rec: dict) -> None:
        """Checkpoint barrier: rotate to a fresh segment, write ``rec``
        (type ``ckpt``) as its first record, fsync it (always — the
        truncation below deletes the only other copy of the serve head),
        then delete every older segment a live tailer has already
        consumed. Segments a registered tailer (``tail-*.ack``) still
        needs are retained past the barrier — they get pruned by a later
        barrier once the tailer acks past them (or its ack goes stale
        per ``tailer_ttl_s``)."""
        self._open_segment(self._seg_seq + 1)
        keep = self._seg_seq
        self.append(rec)
        self._fsync()
        floor = tail_retention_floor(self.directory, self.tailer_ttl_s)
        if floor is not None and floor < keep:
            keep = floor
        for seq, path in list_segments(self.directory):
            if seq < keep:
                try:
                    os.unlink(path)
                except OSError as e:  # pragma: no cover - fs race
                    print(f"wal: could not truncate {path}: {e}", file=sys.stderr)
                    continue
                self.segments_truncated += 1
                if self._telemetry is not None:
                    self._telemetry.inc("wal.truncated")
            elif seq < self._seg_seq:
                self.segments_retained += 1
                if self._telemetry is not None:
                    self._telemetry.inc("wal.retained")

    def close(self) -> None:
        if self._fd is not None:
            self._fsync_if(self.fsync_policy != "off")
            os.close(self._fd)
            self._fd = None

    def stats(self) -> dict:
        return {
            "appends": self.appends,
            "segment_seq": self._seg_seq,
            "segment_bytes": self._seg_bytes,
            "segments_created": self.segments_created,
            "segments_truncated": self.segments_truncated,
            "segments_retained": self.segments_retained,
            "fsync_policy": self.fsync_policy,
        }


def read_records(directory: str) -> tuple[list[dict], int]:
    """Replay every intact record, oldest first. Returns ``(records,
    torn)`` where ``torn`` counts segments cut short by a bad header,
    short frame, or CRC mismatch. Reading stops entirely at the first
    tear — records physically after a tear are not trustworthy in
    sequence (only the final segment of a crashed run can legitimately
    be torn, and it is by definition last). In a fenced directory,
    post-cut frames from a deposed epoch are skipped (see the module
    docstring) so replay agrees with the promoted head's history."""
    records: list[dict] = []
    torn = 0
    stale = 0
    fence = _FenceView(directory).read()
    for seq, path in list_segments(directory):
        with open(path, "rb") as f:
            data = f.read()
        if data[: len(_SEGMENT_MAGIC)] != _SEGMENT_MAGIC:
            torn += 1
            break
        pos = len(_SEGMENT_MAGIC)
        ok = True
        while pos < len(data):
            if pos + _FRAME.size > len(data):
                ok = False
                break
            length, crc = _FRAME.unpack_from(data, pos)
            start = pos + _FRAME.size
            payload = data[start : start + length]
            if len(payload) != length or zlib.crc32(payload) != crc:
                ok = False
                break
            try:
                rec = json.loads(payload.decode("utf-8"))
            except ValueError:
                ok = False
                break
            if _frame_is_stale(fence, seq, pos, rec):
                stale += 1
            else:
                records.append(rec)
            pos = start + length
        if not ok:
            torn += 1
            break
    if stale:
        print(
            f"wal: replay skipped {stale} stale post-fence frame(s) from a "
            "deposed writer epoch",
            file=sys.stderr,
        )
    return records, torn


def segment_first_record(path: str) -> dict | None:
    """Parse just the first frame of a segment (None when missing, torn,
    or corrupt). Barrier segments carry the checkpoint record first, so
    this is how a bootstrapping tailer finds the newest barrier without
    replaying — or trusting — the history before it."""
    try:
        with open(path, "rb") as f:
            head = f.read(len(_SEGMENT_MAGIC) + _FRAME.size)
            if (
                len(head) < len(_SEGMENT_MAGIC) + _FRAME.size
                or head[: len(_SEGMENT_MAGIC)] != _SEGMENT_MAGIC
            ):
                return None
            length, crc = _FRAME.unpack_from(head, len(_SEGMENT_MAGIC))
            payload = f.read(length)
    except OSError:
        return None
    if len(payload) != length or zlib.crc32(payload) != crc:
        return None
    try:
        return json.loads(payload.decode("utf-8"))
    except ValueError:
        return None


class WalTailer:
    """Live follower of a ``WalWriter``'s directory from another process.

    Torn-tail discipline — an abandoned ``os.write`` leaves a frame
    *prefix*, never a full-length frame with a bad CRC, so a short frame
    is disambiguated by segment position:

    - short frame at the tail of the NEWEST segment: the writer is
      mid-append (or dead mid-append); hold position and retry next poll.
    - short frame with a newer segment already on disk: a crash artifact
      that will never complete; re-read once (the bytes are final), then
      skip to the next segment — same loss semantics ``read_records``
      gives the primary on restart.
    - full-length frame failing CRC/JSON, or a complete segment with bad
      magic: real corruption → ``WalTailCorruption`` (owner re-bootstraps).

    Registration: the tailer drops ``tail-<id>.ack`` (atomic
    ``os.replace``) recording the highest segment it has fully consumed;
    ``WalWriter.barrier()`` retains anything past that floor. ``close()``
    withdraws the registration.

    Fencing: in a fenced directory the tailer enforces the fence on read
    — frames at/past the fence's durable cut with a deposed epoch are
    skipped and counted (``stale_frames_skipped``), never folded, so
    every tailer agrees byte-for-byte with the promoted head."""

    def __init__(self, directory: str, tailer_id: str):
        self.directory = directory
        self.tailer_id = tailer_id
        self._ack_path = os.path.join(directory, _ACK_FMT % tailer_id)
        self._seq: int | None = None  # segment currently being read
        self._pos = 0  # byte offset of the next unread frame
        self.frames_read = 0
        self.segments_finished = 0
        self.partial_retries = 0
        self.stale_frames_skipped = 0
        self._fence = _FenceView(directory)
        self._cur_fence: tuple[int, int, int] | None = None
        self._ack(-1)  # register before reading: pins retention from t0

    def _ack(self, seq: int) -> None:
        tmp = self._ack_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"seq": seq, "id": self.tailer_id}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._ack_path)

    def _segments_from(self, seq: int | None) -> list[tuple[int, str]]:
        segs = list_segments(self.directory)
        if seq is None:
            return segs
        return [(s, p) for s, p in segs if s >= seq]

    def seek_to_segment(self, seq: int) -> None:
        """Position at the start of segment ``seq`` (bootstrap entry:
        the caller read a barrier snapshot and tails everything after)."""
        self._seq = seq
        self._pos = 0
        if seq > 0:
            self._ack(seq - 1)

    def poll(self, max_records: int | None = None) -> list[dict]:
        """Return every newly completed record since the last poll (empty
        when the writer is idle or mid-append). Raises
        ``WalTailCorruption`` / ``WalSegmentGone`` per the class
        docstring."""
        out: list[dict] = []
        while max_records is None or len(out) < max_records:
            if self._seq is None:
                segs = self._segments_from(None)
                if not segs:
                    break
                self._seq, self._pos = segs[0][0], 0
            path = os.path.join(self.directory, _SEGMENT_FMT % self._seq)
            # list for newer segments BEFORE reading: only a rotation
            # witnessed before the read makes the bytes final, so a torn
            # frame in them is an authoritative tear. Listing after would
            # race a live writer that completes the frame and rotates
            # between the read and the listing — and drop good frames.
            later = self._segments_from(self._seq + 1)
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except FileNotFoundError:
                later = self._segments_from(self._seq + 1)
                if later and self._pos == 0:
                    # never started this segment; a barrier pruned it while
                    # we were idle at its boundary — resume at the next one
                    self._seq, self._pos = later[0][0], 0
                    continue
                if later:
                    raise WalSegmentGone(
                        f"segment {self._seq} pruned mid-read at {self._pos}"
                    )
                break  # directory empty/young: nothing to read yet
            # fence view AFTER the data read: a stale frame can only land
            # after the fence doc (and its durable cut) hit the disk, so
            # any such frame in ``data`` is guaranteed visible to this
            # fence read — no ordering window
            self._cur_fence = self._fence.read()
            n, complete = self._scan(data, later_exists=bool(later), out=out)
            if not complete:
                break  # holding at a live tail
            # segment exhausted (tear skipped or cleanly done): advance
            self.segments_finished += 1
            self._ack(self._seq)
            self._seq = later[0][0] if later else self._seq + 1
            self._pos = 0
            if not later:
                break  # next segment not on disk yet
        return out

    def _scan(self, data: bytes, later_exists: bool, out: list[dict]) -> tuple[int, bool]:
        """Consume complete frames from ``data`` starting at ``self._pos``
        into ``out``. Returns ``(frames, segment_complete)`` where
        ``segment_complete`` means the tailer is done with this segment
        (fully parsed, or its tear is authoritative and skipped)."""
        if self._pos == 0:
            if len(data) < len(_SEGMENT_MAGIC):
                if later_exists:
                    return 0, True  # magic never completed; crash artifact
                return 0, False
            if data[: len(_SEGMENT_MAGIC)] != _SEGMENT_MAGIC:
                raise WalTailCorruption(
                    f"segment {self._seq}: bad magic {data[:6]!r}"
                )
            self._pos = len(_SEGMENT_MAGIC)
        frames = 0
        while self._pos < len(data):
            if self._pos + _FRAME.size > len(data):
                break  # short header
            length, crc = _FRAME.unpack_from(data, self._pos)
            start = self._pos + _FRAME.size
            payload = data[start : start + length]
            if len(payload) != length:
                break  # short payload
            if zlib.crc32(payload) != crc:
                raise WalTailCorruption(
                    f"segment {self._seq} @ {self._pos}: CRC mismatch"
                )
            try:
                rec = json.loads(payload.decode("utf-8"))
            except ValueError as e:
                raise WalTailCorruption(
                    f"segment {self._seq} @ {self._pos}: bad JSON ({e})"
                ) from None
            if _frame_is_stale(self._cur_fence, self._seq, self._pos, rec):
                # a deposed primary's append raced the fence raise: the
                # promoted head's drain excluded it, so folding it here
                # would silently diverge every tailer from the primary
                self.stale_frames_skipped += 1
            else:
                out.append(rec)
                frames += 1
                self.frames_read += 1
            self._pos = start + length
        if self._pos >= len(data):
            return frames, later_exists  # fully parsed; done iff rotated away
        if later_exists:
            # frame prefix that can never complete: authoritative tear.
            # Count it and abandon the remainder of this segment.
            self.partial_retries += 1
            return frames, True
        return frames, False  # live tail: the writer may still finish it

    def stats(self) -> dict:
        return {
            "segment_seq": self._seq,
            "position": self._pos,
            "frames_read": self.frames_read,
            "segments_finished": self.segments_finished,
            "partial_retries": self.partial_retries,
            "stale_frames_skipped": self.stale_frames_skipped,
        }

    def close(self) -> None:
        try:
            os.unlink(self._ack_path)
        except OSError:
            pass

"""Shared snapshot body store: preserialized wire bodies, zero-copy reads.

Counterpart of ``skyline_tpu/serve/bodystore.py``, with the same file
layout, seqlock discipline and bytes. Instead of every ``/skyline`` read
running ``tolist()`` + ``json.dumps`` (or the csv line join) over the
snapshot, the PUBLISHER serializes each snapshot's wire bodies exactly
once — at publish time, off the read path — and every reader serves those
bytes back with a fence check and a buffer handoff. In-process readers
(``SkylineServer``) get the retained ``bytes`` objects directly; a reader
in another process maps the store file read-only (``BodyStoreReader``) and
serves the writer's exact bytes.

Bodies are keyed ``(version, format, points, explain)`` via :func:`fmt_code`.
The JSON bodies are the cached *prefix* the server splices its volatile
tail onto (``json.dumps(to_doc())[:-1]`` — see server._skyline); the two
explain flavors are byte-identical to their plain twins (the plan rides the
tail, never the prefix) and share one body frame under two directory
entries, preserving the four-tuple key scheme at zero extra bytes.

On-disk layout (``bodystore.dat``), all integers little-endian u64 unless
noted:

  [0, 4096)    header: magic ``SKYBODY1``, dir_slots, data_cap, data_off,
               generation, write_counter, data_cursor, reclaim_floor
  [4096, D)    directory: dir_slots 64-byte entries
               (seq, version, fmt u32, len u32, frame_off, fence)
  [D, D+cap)   body ring: frames ``fence | body | fence`` allocated
               cursor-forward with wraparound

Seqlock discipline. Each directory entry carries a seq word the writer
makes odd before mutating and even after — a reader seeing an odd or
changed seq retries. Each body frame carries its fence word (the monotone
frame counter) before and after the body, so a reader that copied bytes
mid-overwrite sees torn fences. Fences alone cannot catch a NEW frame
written strictly inside an old frame's span (old fences intact, body
scribbled), so the writer additionally publishes ``reclaim_floor`` — the
smallest fence value still intact — BEFORE reusing any ring region; a
reader accepts a copy only if ``entry.fence >= reclaim_floor`` after the
copy completed. Torn/retried/missed reads are counted and fall back to the
Python serialization path — the store can only ever serve exact bytes or
nothing.

Encoders. The row encoder is the native host helper
(``skyline_tpu_torch/native/fastcsv.cpp`` ``sky_format_rows``) behind the
reference's first-use parity check: the first block each process encodes
is re-encoded in Python and compared byte for byte, and any mismatch turns
the native path off for good. Native bodies count ``native_rows``; without
the library (no compiler) or after a mismatch every body comes from the
pure-Python encoders (``python_rows``) — the same bytes either way.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import threading

import numpy as np

from skyline_tpu_torch.native import ROWS_CSV, ROWS_JSON

_MAGIC = b"SKYBODY1"
_HEADER_BYTES = 4096
_ENTRY_BYTES = 64
_ENTRY = struct.Struct("<QQIIQQ")  # seq, version, fmt, len, frame_off, fence
_U64 = struct.Struct("<Q")

# header field offsets (after the 8-byte magic)
_H_DIR_SLOTS = 8
_H_DATA_CAP = 16
_H_DATA_OFF = 24
_H_GENERATION = 32
_H_WRITE_COUNTER = 40
_H_DATA_CURSOR = 48
_H_RECLAIM_FLOOR = 56

FMT_JSON_POINTS = 0
FMT_JSON_NOPOINTS = 1
FMT_JSON_POINTS_EXPLAIN = 2
FMT_JSON_NOPOINTS_EXPLAIN = 3
FMT_CSV = 4
_FMT_COUNT = 5


def fmt_code(fmt: str, include_points: bool = True, explain: bool = False) -> int:
    """Map the serve plane's ``(format, points, explain)`` read key onto a
    directory format code (``version`` completes the four-tuple)."""
    if fmt == "csv":
        return FMT_CSV
    code = FMT_JSON_POINTS if include_points else FMT_JSON_NOPOINTS
    if explain:
        code += 2
    return code


# -- wire-body encoders (native with byte-identical Python fallback) --------

_native_state = {"checked": False, "ok": False}
_native_lock = threading.Lock()


def _rows_native(points: np.ndarray, mode: int):
    """``native.format_rows_native`` behind the first-use parity check:
    the first array each process serializes is re-encoded in Python and
    compared byte-for-byte; any mismatch permanently disables the native
    path (counted by the caller). Serving plausible-but-wrong bytes is the
    one failure mode a body cache must not have."""
    from skyline_tpu_torch.utils.knobs import env_bool

    if not env_bool("SKYLINE_BODYSTORE_NATIVE", True):
        return None
    from skyline_tpu_torch.native import format_rows_native

    out = format_rows_native(points, mode)
    if out is None:
        return None
    verify_always = env_bool("SKYLINE_BODYSTORE_VERIFY", False)
    if not _native_state["checked"] or verify_always:
        ref = _rows_python(points, mode)
        with _native_lock:
            _native_state["checked"] = True
            _native_state["ok"] = out == ref
        if out != ref:
            return None
    elif not _native_state["ok"]:
        return None
    return out


def _rows_python(points: np.ndarray, mode: int) -> bytes:
    if mode == ROWS_JSON:
        return json.dumps(points.tolist()).encode()
    from skyline_tpu_torch.bridge.wire import format_tuple_line

    return "\n".join(
        format_tuple_line(i, row) for i, row in enumerate(points)
    ).encode()


def points_json(points: np.ndarray, counters=None) -> bytes:
    """The JSON points array, byte-identical to
    ``json.dumps(points.tolist())``."""
    out = _rows_native(points, ROWS_JSON)
    if out is not None:
        if counters is not None:
            counters["native_rows"] += 1
        return out
    if counters is not None:
        counters["python_rows"] += 1
    return _rows_python(points, ROWS_JSON)


def csv_body(snap, counters=None) -> bytes:
    """The full ``format=csv`` response body, byte-identical to the serve
    handler's newline-joined ``format_tuple_line`` loop."""
    out = _rows_native(snap.points, ROWS_CSV)
    if out is not None:
        if counters is not None:
            counters["native_rows"] += 1
        return out
    if counters is not None:
        counters["python_rows"] += 1
    return _rows_python(snap.points, ROWS_CSV)


def json_prefix(snap, include_points: bool = True, counters=None) -> bytes:
    """The cacheable JSON body prefix — the full doc minus its closing
    brace, byte-identical to ``json.dumps(snap.to_doc(...))[:-1].encode()``.
    Splicing the preserialized points array after ``doc_head()`` relies on
    the Snapshot contract that ``points`` is the doc's final key."""
    head = json.dumps(snap.doc_head()).encode()
    if not include_points:
        return head[:-1]
    return head[:-1] + b', "points": ' + points_json(snap.points, counters)


def _new_counters() -> dict:
    return {
        "hits": 0,
        "misses": 0,
        "torn_reads": 0,
        "retries": 0,
        "publishes": 0,
        "bodies_published": 0,
        "bytes_published": 0,
        "ring_wraps": 0,
        "oversize_skipped": 0,
        "native_rows": 0,
        "python_rows": 0,
        "remaps": 0,
    }


class _Mapped:
    """Shared mmap plumbing: header field access + the seqlock read path."""

    def __init__(self):
        self._mm = None
        self._dir_slots = 0
        self._data_cap = 0
        self._data_off = 0
        self.counters = _new_counters()

    # -- raw field access --------------------------------------------------

    def _h_get(self, off: int) -> int:
        return _U64.unpack_from(self._mm, off)[0]

    def _h_put(self, off: int, value: int) -> None:
        _U64.pack_into(self._mm, off, value)

    def _slot_off(self, version: int, fmt: int) -> int:
        slot = (version * _FMT_COUNT + fmt) % self._dir_slots
        return _HEADER_BYTES + slot * _ENTRY_BYTES

    # -- seqlock read path -------------------------------------------------

    def _read_entry(self, version: int, fmt: int, retries: int):
        """One (version, fmt) lookup under the seqlock + fence + reclaim
        discipline. Returns the body bytes (one buffer copy, zero
        serialization) or None (miss / torn past the retry bound)."""
        mm = self._mm
        if mm is None:
            return None
        eoff = self._slot_off(version, fmt)
        c = self.counters
        for _ in range(max(1, retries)):
            s1 = _U64.unpack_from(mm, eoff)[0]
            if s1 & 1:  # writer mid-update
                c["retries"] += 1
                continue
            _, ver, efmt, ln, frame, fence = _ENTRY.unpack_from(mm, eoff)
            if _U64.unpack_from(mm, eoff)[0] != s1:
                c["retries"] += 1
                continue
            if ver != version or efmt != fmt or s1 == 0:
                return None  # slot holds another key: a plain miss
            if self._h_get(_H_RECLAIM_FLOOR) > fence:
                c["torn_reads"] += 1
                return None  # ring already swept this frame
            pre = _U64.unpack_from(mm, frame)[0]
            body = bytes(mm[frame + 8 : frame + 8 + ln])
            post = _U64.unpack_from(mm, frame + 8 + ln)[0]
            if (
                pre != fence
                or post != fence
                or self._h_get(_H_RECLAIM_FLOOR) > fence
            ):
                # overwritten under us: the fence words (or the reclaim
                # floor published before any reuse) caught the tear
                c["torn_reads"] += 1
                continue
            return body
        return None

    def stats(self) -> dict:
        return dict(self.counters)


class BodyStore(_Mapped):
    """Writer side (plus the in-process zero-copy read side).

    ``path=None`` keeps the store purely in-process (no other process to feed —
    bodies are still preserialized at publish time and retained for the
    local server). ``attach(store)`` subscribes to the snapshot store's
    publish hook; every publish serializes the JSON prefixes (with and
    without points) and the csv body once and installs five directory keys.
    """

    def __init__(
        self,
        path: str | None = None,
        data_bytes: int | None = None,
        dir_slots: int | None = None,
        keep: int | None = None,
        retries: int | None = None,
    ):
        super().__init__()
        from skyline_tpu_torch.utils.knobs import env_int

        self.path = path
        self._data_cap = (
            env_int("SKYLINE_BODYSTORE_BYTES", 8 << 20)
            if data_bytes is None
            else int(data_bytes)
        )
        self._dir_slots = max(
            _FMT_COUNT,
            env_int("SKYLINE_BODYSTORE_SLOTS", 512)
            if dir_slots is None
            else int(dir_slots),
        )
        self._keep = max(
            1,
            env_int("SKYLINE_BODYSTORE_KEEP", 4) if keep is None else int(keep),
        )
        self._retries = (
            env_int("SKYLINE_BODYSTORE_RETRIES", 4)
            if retries is None
            else int(retries)
        )
        self._lock = threading.Lock()
        # in-process retained bodies: {(version, fmt): bytes} for the last
        # ``keep`` versions — the local server serves these with zero
        # copies; the mmap ring below exists for readers in other processes
        self._recent: dict[tuple[int, int], bytes] = {}
        self._file = None
        self._frames: list[tuple[int, int, int]] = []  # (fence, start, end)
        self._cursor = 0
        self._fence = 0
        if path is not None:
            self._create(path)

    def _create(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        data_off = _HEADER_BYTES + self._dir_slots * _ENTRY_BYTES
        data_off = (data_off + 4095) // 4096 * 4096
        total = data_off + self._data_cap + 16
        # recreate under a FRESH inode (never truncate in place): a reader
        # still mapping the old incarnation keeps a fully valid frozen view
        # of the old bytes (no SIGBUS if the new file is smaller), misses
        # on new versions, re-stats, sees the new inode, and remaps
        try:
            os.unlink(path)
        except OSError:
            pass
        f = open(path, "w+b")
        f.truncate(total)
        self._file = f
        self._mm = mmap.mmap(f.fileno(), total)
        self._mm[0:8] = _MAGIC
        self._h_put(_H_DIR_SLOTS, self._dir_slots)
        self._h_put(_H_DATA_CAP, self._data_cap)
        self._h_put(_H_DATA_OFF, data_off)
        self._h_put(_H_GENERATION, int.from_bytes(os.urandom(7), "little"))
        self._h_put(_H_RECLAIM_FLOOR, 0)
        self._data_off = data_off

    # -- publish side ------------------------------------------------------

    def attach(self, store) -> "BodyStore":
        """Subscribe to a ``SnapshotStore``: every publish lands its wire
        bodies here synchronously (publish-time serialization is the whole
        point — the cost moves off the read path)."""
        store.on_publish(lambda prev, snap: self.put_snapshot(snap))
        return self

    def put_snapshot(self, snap) -> None:
        c = self.counters
        with self._lock:
            head = json_prefix(snap, include_points=False, counters=c)
            pts = points_json(snap.points, counters=c)
            prefix_points = head + b', "points": ' + pts
            csv = csv_body(snap, counters=c)
            v = snap.version
            self._put_body(
                v, (FMT_JSON_POINTS, FMT_JSON_POINTS_EXPLAIN), prefix_points
            )
            self._put_body(
                v, (FMT_JSON_NOPOINTS, FMT_JSON_NOPOINTS_EXPLAIN), head
            )
            self._put_body(v, (FMT_CSV,), csv)
            for fmt, body in (
                (FMT_JSON_POINTS, prefix_points),
                (FMT_JSON_NOPOINTS, head),
                (FMT_JSON_POINTS_EXPLAIN, prefix_points),
                (FMT_JSON_NOPOINTS_EXPLAIN, head),
                (FMT_CSV, csv),
            ):
                self._recent[(v, fmt)] = body
            floor = v - self._keep + 1
            for key in [k for k in self._recent if k[0] < floor]:
                del self._recent[key]
            c["publishes"] += 1
            c["bodies_published"] += 3
            c["bytes_published"] += len(prefix_points) + len(head) + len(csv)

    def _put_body(self, version: int, fmts: tuple, body: bytes) -> None:
        """Write one body frame and point each fmt's directory entry at it.
        Caller holds the writer lock."""
        if self._mm is None:
            return
        need = 8 + len(body) + 8
        if need > self._data_cap:
            self.counters["oversize_skipped"] += 1
            return
        if self._cursor + need > self._data_cap:
            # wrap: frames stranded between the cursor and capacity stay
            # intact (and readable) until the new cycle sweeps over them
            self._cursor = 0
            self.counters["ring_wraps"] += 1
        start, end = self._cursor, self._cursor + need
        # reclaim: any frame whose span the new one touches is about to be
        # scribbled — publish the new floor BEFORE the first byte lands so
        # a reader mid-copy can detect the sweep (see module docstring)
        floor = None
        while self._frames and self._overlaps(self._frames[0], start, end):
            floor = self._frames.pop(0)[0] + 1
        if floor is not None:
            self._h_put(_H_RECLAIM_FLOOR, floor)
        self._fence += 1
        fence = self._fence
        frame = self._data_off + start
        _U64.pack_into(self._mm, frame, fence)
        self._mm[frame + 8 : frame + 8 + len(body)] = body
        _U64.pack_into(self._mm, frame + 8 + len(body), fence)
        self._frames.append((fence, start, end))
        self._cursor = end
        self._h_put(_H_WRITE_COUNTER, fence)
        self._h_put(_H_DATA_CURSOR, self._cursor)
        for fmt in fmts:
            eoff = self._slot_off(version, fmt)
            seq = _U64.unpack_from(self._mm, eoff)[0]
            _U64.pack_into(self._mm, eoff, seq + 1)  # odd: update in flight
            _ENTRY.pack_into(
                self._mm, eoff, seq + 1, version, fmt, len(body), frame, fence
            )
            _U64.pack_into(self._mm, eoff, seq + 2)

    @staticmethod
    def _overlaps(frame: tuple, start: int, end: int) -> bool:
        return frame[1] < end and frame[2] > start

    # -- read side ---------------------------------------------------------

    def get(self, version: int, fmt: int):
        """In-process read: the retained bytes object when the version is
        recent (zero copies), else the mmap ring (one copy)."""
        body = self._recent.get((version, fmt))
        if body is None:
            body = self._read_entry(version, fmt, self._retries)
        if body is None:
            self.counters["misses"] += 1
            return None
        self.counters["hits"] += 1
        return body

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._file is not None:
            self._file.close()
            self._file = None


class BodyStoreReader(_Mapped):
    """Read-only cross-process view: maps the primary's store file and
    serves the primary's exact bytes by ``(version, fmt)``. Opens lazily
    and re-stats on miss, so a reader started before the writer (or
    across a primary restart, which recreates the file under a fresh
    generation) converges without coordination."""

    def __init__(self, path: str, retries: int | None = None):
        super().__init__()
        from skyline_tpu_torch.utils.knobs import env_int

        self.path = path
        self._retries = (
            env_int("SKYLINE_BODYSTORE_RETRIES", 4)
            if retries is None
            else int(retries)
        )
        self._ino = None
        self._generation = None
        self._open()

    def _open(self) -> bool:
        self.close()
        try:
            st = os.stat(self.path)
            f = open(self.path, "rb")
        except OSError:
            return False
        try:
            mm = mmap.mmap(f.fileno(), st.st_size, prot=mmap.PROT_READ)
        except (OSError, ValueError):
            f.close()
            return False
        if mm[0:8] != _MAGIC:
            mm.close()
            f.close()
            return False
        self._file = f
        self._mm = mm
        self._ino = st.st_ino
        self._dir_slots = _U64.unpack_from(mm, _H_DIR_SLOTS)[0]
        self._data_off = _U64.unpack_from(mm, _H_DATA_OFF)[0]
        self._generation = _U64.unpack_from(mm, _H_GENERATION)[0]
        return True

    def _maybe_remap(self) -> None:
        """On miss: if the primary recreated the file (new inode or
        generation), swing the mapping over to the live incarnation."""
        try:
            st = os.stat(self.path)
        except OSError:
            return
        if self._mm is None or st.st_ino != self._ino:
            if self._open():
                self.counters["remaps"] += 1

    def get(self, version: int, fmt: int):
        body = self._read_entry(version, fmt, self._retries)
        if body is None:
            self._maybe_remap()
            body = self._read_entry(version, fmt, self._retries)
        if body is None:
            self.counters["misses"] += 1
            return None
        self.counters["hits"] += 1
        return body

    def close(self) -> None:
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
            self._mm = None
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None


__all__ = [
    "BodyStore",
    "BodyStoreReader",
    "FMT_CSV",
    "FMT_JSON_NOPOINTS",
    "FMT_JSON_NOPOINTS_EXPLAIN",
    "FMT_JSON_POINTS",
    "FMT_JSON_POINTS_EXPLAIN",
    "csv_body",
    "fmt_code",
    "json_prefix",
    "points_json",
]

"""Native host helper (ctypes): CSV parse and format, RecordBatch framing
and CRC32C, built from ``fastcsv.cpp`` on first use.

The port's own copy of ``skyline_tpu/native``. ``parse_tuples_native(text,
dims)`` parses a newline-joined batch of data-plane lines into (ids,
values, dropped); the produce, consume and serve planes use the other
entry points below. The library builds with ``g++`` into
``skyline_tpu_torch/_build/``, named by a hash of the source, the flags and
the host CPU (``-march=native`` code is only loaded where it was built), so
an edit rebuilds and a checkout never carries a stale binary. ``get_lib()``
returns None when no compiler is present or the build fails; callers then
use the Python parser and encoders — the host component is optional, as in
the reference. ``build_error()`` says why it is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastcsv.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False
_error: str | None = None


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def library_path() -> Path:
    """Where the library for this source, these flags and this CPU lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(f"{platform.machine()}|{_cpu_model()}".encode())
    digest.update(_SRC.read_bytes())
    return BUILD_DIR / f"fastcsv_{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    global _error
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except subprocess.CalledProcessError as e:
        _error = f"g++ failed: {e.stderr.decode(errors='replace')[-2000:]}"
        return False
    except (OSError, subprocess.SubprocessError) as e:
        _error = f"g++ unavailable: {e}"
        return False
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
    return True


def build_error() -> str | None:
    """Why ``get_lib()`` returned None (None when it loaded or was not tried)."""
    return _error


def get_lib():
    """The loaded ctypes library, building it if needed; None if unavailable."""
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            _error = f"load failed: {e}"
            return None
        lib.sky_parse_tuples.restype = ctypes.c_int64
        lib.sky_parse_tuples.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
        ]
        # the produce-, consume- and serve-plane helpers: a library built
        # from this source always has every symbol
        lib.sky_crc32c.restype = ctypes.c_uint32
        lib.sky_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.sky_encode_records.restype = ctypes.c_int64
        lib.sky_encode_records.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        lib.sky_format_tuples.restype = ctypes.c_int64
        lib.sky_format_tuples.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sky_format_rows.restype = ctypes.c_int64
        lib.sky_format_rows.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.sky_parse_recordbatches.restype = ctypes.c_int64
        lib.sky_parse_recordbatches.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
    return _lib


def parse_tuples_native(text: bytes, dims: int, max_rows: int):
    """Parse a newline-separated byte buffer. Returns (ids, values, dropped)
    or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ids = np.empty(max_rows, dtype=np.int64)
    values = np.empty((max_rows, dims), dtype=np.float32)
    dropped = ctypes.c_int64(0)
    n = lib.sky_parse_tuples(
        text,
        len(text),
        dims,
        max_rows,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(dropped),
    )
    return ids[:n], values[:n], int(dropped.value)


def crc32c_native(data: bytes):
    """CRC32C (Castagnoli) via the native lib (hardware CRC instruction on
    x86); None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.sky_crc32c(data, len(data)))


def format_tuples_native(ids: np.ndarray, values: np.ndarray):
    """Format data-plane lines ``"id,v1,...,vd"`` from int64 arrays
    (ids (n,), values (n, d)) — the produce-plane twin of
    ``parse_tuples_native``. Returns ``(blob, offsets)`` where record i is
    ``blob[offsets[i]:offsets[i+1]]``, or None if the library is
    unavailable (callers fall back to Python formatting)."""
    lib = get_lib()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=np.int64)
    n, d = values.shape
    out = np.empty(n * (d + 1) * 21 + 64, dtype=np.uint8)
    offsets = np.empty(n + 1, dtype=np.int64)
    w = lib.sky_format_tuples(
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        d,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.shape[0],
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if w < 0:
        return None
    return out[:w].tobytes(), offsets


ROWS_JSON = 0
ROWS_CSV = 1


def format_rows_native(points: np.ndarray, mode: int):
    """Serialize a (k, d) float32 row block into one wire body — the serve
    plane's publish-time body serializer (serve/bodystore.py). ``mode``
    ``ROWS_JSON`` yields the JSON points array byte-identical to
    ``json.dumps(points.tolist())``; ``ROWS_CSV`` yields the ``format=csv``
    block byte-identical to newline-joined ``wire.format_tuple_line(i, row)``.
    Returns bytes, or None if the library is unavailable (callers
    fall back to the Python encoders)."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    k, d = pts.shape
    # 27 bytes of float repr + separators/brackets per field, plus row ids
    cap = k * (d + 1) * 32 + 64
    buf = ctypes.create_string_buffer(cap)
    n = lib.sky_format_rows(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        k,
        d,
        int(mode),
        buf,
        cap,
    )
    if n < 0:
        return None
    return buf.raw[:n]


# per-record frame overhead bound used to size native encode outputs and
# the blob produce path's batch grouping: <=2B length + 3 fixed +
# <=2B offsetDelta + <=2B valueLen + 1 header count, padded generously
RECORD_FRAME_OVERHEAD = 24


def encode_records_from_blob(blob: bytes, offsets):
    """Kafka RecordBatch v2 record frames straight from a value blob +
    prefix offsets (record i = ``blob[offsets[i]:offsets[i+1]]``; offsets
    may be absolute into a larger blob — the native encoder reads
    ``values + offsets[i]`` directly). None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    n = offs.shape[0] - 1
    out = np.empty(
        int(offs[-1] - offs[0]) + RECORD_FRAME_OVERHEAD * n + 64,
        dtype=np.uint8,
    )
    w = lib.sky_encode_records(
        blob,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.shape[0],
    )
    if w < 0:
        return None
    return out[:w].tobytes()


def parse_recordbatches_native(
    blob: bytes, min_offset: int, dims: int, verify_crc: bool = False
):
    """Consume-plane zero-copy path: one fetch response's RecordBatch v2
    blob -> (ids (n,) int64, values (n, d) float32, dropped, next_offset)
    with the CSV values parsed in native code — no per-record Python
    objects between broker and engine (the twin of the produce plane's
    ``format_tuples_native`` + ``encode_records_from_blob``). Skips records
    below ``min_offset`` (a fetch can return a batch that starts earlier
    than the requested offset); ``next_offset`` is the fetch-position
    advance. Returns None if the library is unavailable; raises
    ValueError on corrupt framing/CRC exactly like
    bridge/kafkalite/protocol.py decode_record_batches."""
    lib = get_lib()
    if lib is None:
        return None
    # framing minimum is ~10 bytes/record (7 frame + "0,0"), so len/9 rows
    # always covers a single-pass parse of the whole blob
    max_rows = len(blob) // 9 + 1
    ids = np.empty(max_rows, dtype=np.int64)
    values = np.empty((max_rows, dims), dtype=np.float32)
    dropped = ctypes.c_int64(0)
    next_off = ctypes.c_int64(min_offset)
    n = lib.sky_parse_recordbatches(
        blob,
        len(blob),
        min_offset,
        dims,
        1 if verify_crc else 0,
        max_rows,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(dropped),
        ctypes.byref(next_off),
    )
    if n == -2:
        raise ValueError("unsupported record magic")
    if n == -3:
        raise ValueError("record batch CRC32C mismatch")
    if n < 0:
        raise ValueError(f"malformed record batch (native rc={n})")
    # copy the filled prefix: a slice view would pin the whole len/9-row
    # buffer (sized for the framing minimum, 3-6x the real row count at
    # 8-D) for as long as the engine holds the batch
    return (
        ids[:n].copy(),
        values[:n].copy(),
        int(dropped.value),
        int(next_off.value),
    )


def encode_records_native(values: list[bytes]):
    """Kafka RecordBatch v2 record frames for value-only records (the
    produce-plane hot loop); None if unavailable. Byte-identical to the
    Python loop in bridge/kafkalite/protocol.py (golden-bytes tested)."""
    n = len(values)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(v) for v in values], out=offsets[1:])
    return encode_records_from_blob(b"".join(values), offsets)

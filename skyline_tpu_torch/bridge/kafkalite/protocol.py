"""Kafka wire-protocol primitives (pure Python, no dependencies).

Implements the subset of the REAL Kafka protocol needed for a
producer/consumer data plane — the same wire format Kafka 3.7 brokers
(the reference's docker-setup pin, docker-compose.yml:4) speak:

- request/response framing: ``int32 size`` + header
  (``api_key int16, api_version int16, correlation_id int32,
  client_id nullable-string``)
- primitive codecs: big-endian ints, (nullable) strings, (nullable) bytes,
  arrays, zigzag varints/varlongs
- **RecordBatch v2** (magic=2) encode/decode, including the CRC32C
  checksum over attributes..end — the current on-disk/on-wire record
  format (KIP-98). Compression attributes are not implemented (codec 0
  only), matching the reference harness which never enables compression.

Only NON-FLEXIBLE api versions are used by kafkalite (flexible versions
add tagged fields + compact encodings): Produce v3, Fetch v4, Metadata v1,
ListOffsets v1, ApiVersions v0. A real broker accepts all of these, and a
real modern client can talk to the embedded broker after ApiVersions
negotiation caps it to the same set.
"""

from __future__ import annotations

import struct

# api keys (the Kafka protocol's stable ids)
API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_API_VERSIONS = 18

# error codes
ERR_NONE = 0
ERR_OFFSET_OUT_OF_RANGE = 1
ERR_UNKNOWN_TOPIC_OR_PARTITION = 3
ERR_MESSAGE_TOO_LARGE = 10
ERR_UNSUPPORTED_VERSION = 35

# ListOffsets sentinel timestamps
TS_LATEST = -1
TS_EARLIEST = -2


# -- CRC32C (Castagnoli) ----------------------------------------------------
# slice-by-8 tables: ~one order of magnitude over the byte-at-a-time loop in
# CPython, which matters because the checksum runs on every produced and
# consumed batch. A native crc32c module is preferred when importable.

_CRC32C_POLY = 0x82F63B78


def _make_crc32c_tables():
    t0 = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        t0.append(c)
    tables = [t0]
    for k in range(1, 8):
        prev = tables[k - 1]
        tables.append([t0[prev[n] & 0xFF] ^ (prev[n] >> 8) for n in range(256)])
    return tables


_T = _make_crc32c_tables()


def _crc32c_py(data: bytes) -> int:
    crc = 0xFFFFFFFF
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    n = len(data)
    i = 0
    end8 = n - (n % 8)
    while i < end8:
        crc ^= (
            data[i]
            | (data[i + 1] << 8)
            | (data[i + 2] << 16)
            | (data[i + 3] << 24)
        )
        crc = (
            t7[crc & 0xFF]
            ^ t6[(crc >> 8) & 0xFF]
            ^ t5[(crc >> 16) & 0xFF]
            ^ t4[(crc >> 24) & 0xFF]
            ^ t3[data[i + 4]]
            ^ t2[data[i + 5]]
            ^ t1[data[i + 6]]
            ^ t0[data[i + 7]]
        )
        i += 8
    while i < n:
        crc = t0[(crc ^ data[i]) & 0xFF] ^ (crc >> 8)
        i += 1
    return crc ^ 0xFFFFFFFF


def _resolve_crc32c():
    """Fastest available CRC32C: the crc32c wheel, else the repo's native
    helper (hardware CRC32 instruction, skyline_tpu_torch/native/fastcsv.cpp),
    else the pure-Python slice-by-8 loop. Resolved once on first call."""
    try:  # pragma: no cover - wheel not in the baked image
        from crc32c import crc32c as wheel  # type: ignore

        return wheel
    except ImportError:
        pass
    try:
        from skyline_tpu_torch.native import crc32c_native

        if crc32c_native(b"probe") is not None:
            return crc32c_native
    except Exception:  # pragma: no cover - any native failure -> Python
        pass
    return _crc32c_py


_records_encoder_impl: list | None = None


def _records_encoder():
    """The native value-only record-frame encoder, resolved once (None when
    the native lib is unavailable — callers then keep the Python loop
    without re-probing per batch)."""
    global _records_encoder_impl
    if _records_encoder_impl is None:
        fn = None
        try:
            from skyline_tpu_torch.native import encode_records_native, get_lib

            lib = get_lib()
            if lib is not None:
                fn = encode_records_native
        except Exception:  # pragma: no cover - any native failure -> Python
            fn = None
        _records_encoder_impl = [fn]
    return _records_encoder_impl[0]


_crc32c_impl = None


def crc32c(data: bytes) -> int:
    global _crc32c_impl
    if _crc32c_impl is None:
        _crc32c_impl = _resolve_crc32c()
    return _crc32c_impl(data)


# -- primitive writers ------------------------------------------------------


class Writer:
    __slots__ = ("_parts",)

    def __init__(self):
        self._parts: list[bytes] = []

    def raw(self, b: bytes) -> "Writer":
        self._parts.append(b)
        return self

    def int8(self, v: int) -> "Writer":
        return self.raw(struct.pack(">b", v))

    def int16(self, v: int) -> "Writer":
        return self.raw(struct.pack(">h", v))

    def int32(self, v: int) -> "Writer":
        return self.raw(struct.pack(">i", v))

    def int64(self, v: int) -> "Writer":
        return self.raw(struct.pack(">q", v))

    def uint32(self, v: int) -> "Writer":
        return self.raw(struct.pack(">I", v))

    def boolean(self, v: bool) -> "Writer":
        return self.int8(1 if v else 0)

    def string(self, s: str | None) -> "Writer":
        if s is None:
            return self.int16(-1)
        b = s.encode("utf-8")
        return self.int16(len(b)).raw(b)

    def bytes_(self, b: bytes | None) -> "Writer":
        if b is None:
            return self.int32(-1)
        return self.int32(len(b)).raw(b)

    def array(self, items, write_item) -> "Writer":
        if items is None:
            return self.int32(-1)
        self.int32(len(items))
        for it in items:
            write_item(self, it)
        return self

    def varint(self, v: int) -> "Writer":
        # zigzag int32/64
        z = (v << 1) ^ (v >> 63)
        while True:
            b = z & 0x7F
            z >>= 7
            if z:
                self._parts.append(bytes((b | 0x80,)))
            else:
                self._parts.append(bytes((b,)))
                return self

    def build(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def _take(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise EOFError(f"need {n} bytes at {self.pos}, have {len(b)}")
        self.pos += n
        return b

    def int8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def int16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def int32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def int64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def uint32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def boolean(self) -> bool:
        return self.int8() != 0

    def string(self) -> str | None:
        n = self.int16()
        if n < 0:
            return None
        return self._take(n).decode("utf-8")

    def bytes_(self) -> bytes | None:
        n = self.int32()
        if n < 0:
            return None
        return self._take(n)

    def array(self, read_item) -> list | None:
        n = self.int32()
        if n < 0:
            return None
        return [read_item(self) for _ in range(n)]

    def varint(self) -> int:
        shift = 0
        z = 0
        while True:
            b = self._take(1)[0]
            z |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (z >> 1) ^ -(z & 1)

    def remaining(self) -> int:
        return len(self.data) - self.pos


# -- request/response framing ----------------------------------------------


def encode_request(
    api_key: int,
    api_version: int,
    correlation_id: int,
    client_id: str | None,
    body: bytes,
) -> bytes:
    w = Writer()
    w.int16(api_key).int16(api_version).int32(correlation_id).string(client_id)
    payload = w.build() + body
    return struct.pack(">i", len(payload)) + payload


def encode_response(correlation_id: int, body: bytes) -> bytes:
    payload = struct.pack(">i", correlation_id) + body
    return struct.pack(">i", len(payload)) + payload


def read_frame(sock) -> bytes | None:
    """Read one length-prefixed frame from a socket; None on clean EOF."""
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            if hdr:
                raise EOFError("partial frame header")
            return None
        hdr += chunk
    (size,) = struct.unpack(">i", hdr)
    buf = bytearray()
    while len(buf) < size:
        chunk = sock.recv(min(65536, size - len(buf)))
        if not chunk:
            raise EOFError("connection closed mid-frame")
        buf += chunk
    return bytes(buf)


# -- RecordBatch v2 ---------------------------------------------------------
# layout (KIP-98): baseOffset int64 | batchLength int32 |
# partitionLeaderEpoch int32 | magic int8 (=2) | crc uint32 (CRC32C of
# everything after this field) | attributes int16 | lastOffsetDelta int32 |
# baseTimestamp int64 | maxTimestamp int64 | producerId int64 |
# producerEpoch int16 | baseSequence int32 | numRecords int32 | records


def _uvarint(z: int) -> bytes:
    """Unsigned LEB128 of an already-zigzagged value."""
    out = bytearray()
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_record_batch(
    records: list[tuple[bytes | None, bytes | None]],
    base_offset: int = 0,
    base_timestamp: int = 0,
) -> bytes:
    """records: list of (key, value); headers always empty (the harness
    uses value-only messages, unified_producer.py:174).

    The record loop is the producer data plane's hot path (one iteration
    per message) — built with preassembled byte fragments and a zigzag
    varint inline fast path instead of per-record Writer objects
    (~2.5x, benchmarks/e2e_transport.py drives it)."""
    n_records = len(records)
    parts: list[bytes] = []
    loop_records = records
    if _records_encoder() is not None and all(
        k is None and v is not None for k, v in records
    ):
        # the data plane: value-only messages — one native call builds all
        # record frames (byte-identical; golden-bytes tested)
        native_blob = _records_encoder()([v for _, v in records])
        if native_blob is not None:
            parts.append(native_blob)
            loop_records = []
    for i, (key, value) in enumerate(loop_records):
        # attributes=0, timestampDelta=0, offsetDelta=zigzag(i)
        rb = b"\x00\x00" + (
            bytes((i << 1,)) if i < 64 else _uvarint(i << 1)
        )
        rb += b"\x01" if key is None else _uvarint(len(key) << 1) + key
        rb += b"\x01" if value is None else _uvarint(len(value) << 1) + value
        rb += b"\x00"  # headers count
        parts.append(_uvarint(len(rb) << 1))
        parts.append(rb)
    records_bytes = b"".join(parts)
    return _wrap_record_batch(
        records_bytes, n_records, base_offset, base_timestamp
    )


def _wrap_record_batch(
    records_bytes: bytes,
    n_records: int,
    base_offset: int,
    base_timestamp: int,
) -> bytes:
    """RecordBatch v2 header + CRC around preassembled record frames."""
    after_crc = (
        Writer()
        .int16(0)  # attributes: no compression, create-time timestamps
        .int32(n_records - 1)  # lastOffsetDelta
        .int64(base_timestamp)
        .int64(base_timestamp)
        .int64(-1)  # producerId
        .int16(-1)  # producerEpoch
        .int32(-1)  # baseSequence
        .int32(n_records)
        .raw(records_bytes)
        .build()
    )
    crc = crc32c(after_crc)
    tail = Writer().int32(-1).int8(2).uint32(crc).raw(after_crc).build()
    # batchLength counts partitionLeaderEpoch(4)+magic(1)+crc(4)+after_crc
    return Writer().int64(base_offset).int32(len(tail)).raw(tail).build()


def encode_record_batch_blob(
    blob: bytes,
    offsets,
    base_offset: int = 0,
    base_timestamp: int = 0,
) -> bytes | None:
    """RecordBatch v2 straight from a value blob + prefix offsets (record i
    is ``blob[offsets[i]:offsets[i+1]]``, key=None) — the zero-rejoin twin
    of ``encode_record_batch`` for the native produce plane. Returns None
    when the native encoder is unavailable (callers slice and fall back)."""
    from skyline_tpu_torch.native import encode_records_from_blob

    records_bytes = encode_records_from_blob(blob, offsets)
    if records_bytes is None:
        return None
    return _wrap_record_batch(
        records_bytes, len(offsets) - 1, base_offset, base_timestamp
    )


def iter_batch_spans(data: bytes):
    """Yield ``(start, length, n_records)`` for each complete RecordBatch v2
    blob in ``data``, reading only fixed-offset header fields (no record
    parse). Network-supplied lengths/counts are clamped: a batchLength
    below the v2 header size (49) or past the buffer ends iteration (a
    malformed frame must not spin or walk the log backward), and negative
    numRecords counts as 0."""
    pos = 0
    n = len(data)
    while pos + 61 <= n:
        (batch_len,) = struct.unpack_from(">i", data, pos + 8)
        if batch_len < 49 or pos + 12 + batch_len > n:
            break
        # numRecords sits at base(8)+len(4) + leaderEpoch(4)+magic(1)+crc(4)
        # +attributes(2)+lastOffsetDelta(4)+baseTs(8)+maxTs(8)+producerId(8)
        # +producerEpoch(2)+baseSequence(4) = offset 57
        (cnt,) = struct.unpack_from(">i", data, pos + 57)
        yield pos, 12 + batch_len, max(cnt, 0)
        pos += 12 + batch_len


def count_records(data: bytes) -> int:
    """Total record count of a concatenation of RecordBatch v2 blobs (see
    ``iter_batch_spans`` for the clamping rules)."""
    return sum(cnt for _, _, cnt in iter_batch_spans(data))


def decode_record_batches(
    data: bytes, verify_crc: bool = True
) -> list[tuple[int, bytes | None, bytes | None]]:
    """Decode a concatenation of RecordBatch v2 blobs into
    ``[(absolute_offset, key, value), ...]``. Tolerates a trailing partial
    batch (brokers may truncate at fetch max_bytes)."""
    out: list[tuple[int, bytes | None, bytes | None]] = []
    r = Reader(data)
    while r.remaining() >= 12:
        base_offset = r.int64()
        batch_len = r.int32()
        if r.remaining() < batch_len:
            break  # truncated tail
        batch = Reader(r.data, r.pos)
        r.pos += batch_len
        batch.int32()  # partitionLeaderEpoch
        magic = batch.int8()
        if magic != 2:
            raise ValueError(f"unsupported record magic {magic}")
        crc = batch.uint32()
        after = batch.data[batch.pos : batch.pos + batch_len - 9]
        if verify_crc and crc32c(after) != crc:
            raise ValueError("record batch CRC32C mismatch")
        batch.int16()  # attributes
        batch.int32()  # lastOffsetDelta
        batch.int64()  # baseTimestamp
        batch.int64()  # maxTimestamp
        batch.int64()  # producerId
        batch.int16()  # producerEpoch
        batch.int32()  # baseSequence
        n = batch.int32()
        # hot loop: records are decoded with inlined varint reads over the
        # raw buffer (one Reader + several method calls per record costs
        # ~2x the whole decode at 10^5 records/fetch; this loop and
        # ``check_crcs=False`` together roughly double consumer throughput)
        buf = data
        p = batch.pos
        append = out.append
        for _ in range(n):
            z = buf[p]  # record length varint
            p += 1
            if z & 0x80:
                shift = 7
                z &= 0x7F
                while True:
                    b = buf[p]
                    p += 1
                    z |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
            rec_end = p + ((z >> 1) ^ -(z & 1))
            p += 1  # attributes
            while buf[p] & 0x80:  # timestampDelta (skipped)
                p += 1
            p += 1
            z = buf[p]  # offsetDelta
            p += 1
            if z & 0x80:
                shift = 7
                z &= 0x7F
                while True:
                    b = buf[p]
                    p += 1
                    z |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
            offset_delta = (z >> 1) ^ -(z & 1)
            z = buf[p]  # key length
            p += 1
            if z & 0x80:
                shift = 7
                z &= 0x7F
                while True:
                    b = buf[p]
                    p += 1
                    z |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
            klen = (z >> 1) ^ -(z & 1)
            if klen >= 0:
                key = buf[p : p + klen]
                p += klen
            else:
                key = None
            z = buf[p]  # value length
            p += 1
            if z & 0x80:
                shift = 7
                z &= 0x7F
                while True:
                    b = buf[p]
                    p += 1
                    z |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
            vlen = (z >> 1) ^ -(z & 1)
            if vlen >= 0:
                value = buf[p : p + vlen]
                p += vlen
            else:
                value = None
            append((base_offset + offset_delta, key, value))
            p = rec_end  # headers (if any) are skipped
    return out

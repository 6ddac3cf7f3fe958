"""Pure-Python Kafka producer/consumer over the real wire protocol.

The client half of kafkalite (see protocol.py): enough of a Kafka client
to run the reference's data plane — value-only string messages on
single-partition topics, earliest/latest offset reset, client-side
``max_request_size`` enforcement mirroring kafka-python's (and the
reference result sink's ``max.request.size=10485760``,
FlinkSkyline.java:177-183). Talks to any broker supporting the
non-flexible api versions in protocol.py: the embedded ``broker.Broker``
or a real Kafka <= 3.x.

Partitioning: all records go to partition 0. The reference's topics are
single-partition (docker-compose auto-creation defaults), and the engine
does its own spatial partitioning downstream — Kafka partitions were never
the parallelism mechanism in this system (SURVEY.md §2.6).
"""

from __future__ import annotations

import socket
import threading
import time

from skyline_tpu_torch.bridge.kafkalite import protocol as P


class KafkaLiteError(Exception):
    pass


class MessageSizeTooLargeError(KafkaLiteError):
    pass


class KafkaLiteConnectionError(KafkaLiteError):
    """The broker connection died (reset, refused, closed mid-frame)."""


class _Connection:
    """One framed request/response socket with correlation-id matching.

    Transport faults (connection reset, broker restart) are retried with
    bounded exponential backoff: the socket is torn down, re-dialed, and
    the request re-sent. Every request in this protocol subset is
    idempotent except Produce, and the producer's ``flush`` already
    restores unacked records on error — a duplicate Produce can only
    happen when the broker acked and the ack was lost in transit, the
    standard at-least-once window every Kafka client has with retries on.
    """

    def __init__(
        self,
        bootstrap: str,
        client_id: str,
        timeout_s: float = 30.0,
        retries: int | None = None,
        backoff_s: float | None = None,
    ):
        from skyline_tpu_torch.utils.knobs import env_float, env_int

        host, _, port = bootstrap.partition(":")
        self._addr = (host, int(port or 9092))
        self._timeout_s = timeout_s
        self._retries = env_int("SKYLINE_KAFKA_RETRIES", 5) if retries is None else retries
        self._backoff_s = (
            env_float("SKYLINE_KAFKA_BACKOFF_S", 0.05)
            if backoff_s is None else backoff_s
        )
        self.reconnects = 0
        self._sock: socket.socket | None = None
        self.client_id = client_id
        self._corr = 0
        self._lock = threading.Lock()
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection(self._addr, timeout=self._timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def request(self, api_key: int, api_version: int, body: bytes) -> P.Reader:
        with self._lock:
            last: Exception | None = None
            for attempt in range(self._retries + 1):
                if attempt:
                    time.sleep(self._backoff_s * (2.0 ** (attempt - 1)))
                    self.reconnects += 1
                try:
                    if self._sock is None:
                        self._connect()
                    self._corr += 1
                    corr = self._corr
                    self._sock.sendall(
                        P.encode_request(
                            api_key, api_version, corr, self.client_id, body
                        )
                    )
                    frame = P.read_frame(self._sock)
                    if frame is None:
                        raise KafkaLiteConnectionError("broker closed connection")
                except (OSError, KafkaLiteConnectionError) as e:
                    last = e
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                    continue
                r = P.Reader(frame)
                got = r.int32()
                if got != corr:
                    # protocol corruption, not a transport fault: don't retry
                    raise KafkaLiteError(f"correlation mismatch {got} != {corr}")
                return r
            raise KafkaLiteConnectionError(
                f"broker at {self._addr[0]}:{self._addr[1]} unreachable after "
                f"{self._retries} retries: {last}"
            ) from last

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class KafkaLiteProducer:
    """Batching producer: ``send`` buffers, ``flush`` ships one Produce
    request per topic (one RecordBatch v2 per partition)."""

    def __init__(
        self,
        bootstrap: str,
        max_request_size: int = 10_485_760,
        linger_records: int = 4096,
        client_id: str = "kafkalite-producer",
    ):
        self._conn = _Connection(bootstrap, client_id)
        self.max_request_size = max_request_size
        self.linger_records = linger_records
        self._buf: dict[str, list[bytes]] = {}
        self._lock = threading.Lock()

    def send(self, topic: str, value: str | bytes) -> None:
        v = value.encode("utf-8") if isinstance(value, str) else value
        if len(v) > self.max_request_size:
            raise MessageSizeTooLargeError(
                f"{len(v)} bytes > max_request_size {self.max_request_size}"
            )
        with self._lock:
            self._buf.setdefault(topic, []).append(v)
            should_flush = len(self._buf[topic]) >= self.linger_records
        if should_flush:
            self.flush()

    def send_many(self, topic: str, values) -> None:
        """Batch ``send``: one lock acquisition + size check per slice
        instead of per record (the per-record path is ~45% of producer CLI
        time at stream rates). Buffers are filled in ``linger_records``
        slices so flushed batches stay the same size ``send`` produces."""
        vs = [v.encode("utf-8") if isinstance(v, str) else v for v in values]
        for v in vs:
            if len(v) > self.max_request_size:
                raise MessageSizeTooLargeError(
                    f"{len(v)} bytes > max_request_size "
                    f"{self.max_request_size}"
                )
        i, n = 0, len(vs)
        while i < n:
            with self._lock:
                buf = self._buf.setdefault(topic, [])
                room = max(self.linger_records - len(buf), 1)
                buf.extend(vs[i : i + room])
                should_flush = len(buf) >= self.linger_records
            i += room
            if should_flush:
                self.flush()

    def send_blob(self, topic: str, blob: bytes, offsets) -> None:
        """Produce a whole formatted batch from one value blob + prefix
        offsets (record i = ``blob[offsets[i]:offsets[i+1]]``) without
        materializing per-record bytes objects — the zero-copy pairing for
        the native CSV formatter (native/fastcsv.cpp). Splits into
        max_request_size-bounded RecordBatches; falls back to ``send_many``
        when the native record encoder is unavailable. Flushes buffered
        sends first so ordering with ``send`` is preserved."""
        import numpy as np

        from skyline_tpu_torch.bridge.kafkalite.protocol import (
            encode_record_batch_blob,
        )

        self.flush()
        offs = np.ascontiguousarray(offsets, dtype=np.int64)
        n = offs.shape[0] - 1
        if n <= 0:
            return
        # greedy grouping under the request cap, counting per-record frame
        # overhead at its bound (native encoder sizing); the conservative
        # headroom only shrinks groups — a single record is judged by its
        # ACTUAL encoded batch below, so records near the cap that
        # send/send_many would accept are accepted here too
        from skyline_tpu_torch.native import RECORD_FRAME_OVERHEAD

        budget = max(self.max_request_size - 4096, 1)
        adj = offs + RECORD_FRAME_OVERHEAD * np.arange(n + 1, dtype=np.int64)
        i = 0
        while i < n:
            j = int(np.searchsorted(adj, adj[i] + budget, side="right")) - 1
            j = max(j, i + 1)
            batch = encode_record_batch_blob(
                blob, offs[i : j + 1],
                base_timestamp=int(time.time() * 1000),
            )
            if batch is not None and len(batch) > self.max_request_size:
                if j > i + 1:  # conservative group overshot: halve and retry
                    budget = max(budget // 2, 1)
                    continue
                raise MessageSizeTooLargeError(
                    f"single record encodes to {len(batch)} bytes "
                    f"> max_request_size {self.max_request_size}"
                )
            if batch is None:
                # native encoder unavailable: per-record fallback
                ot = offs.tolist()
                self.send_many(
                    topic, [blob[ot[k] : ot[k + 1]] for k in range(i, n)]
                )
                self.flush()
                return
            self._produce_batch(topic, batch)
            i = j

    def flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, {}
        pending = dict(buf)  # un-sent topics restored if a send fails
        try:
            self._flush_topics(buf, pending)
        except Exception:
            # put every unacked record back so a caller catching the error
            # can retry flush() without losing data (kafka-python keeps
            # unacked batches across transient faults too)
            with self._lock:
                for topic, values in pending.items():
                    self._buf.setdefault(topic, [])[:0] = values
            raise

    def _flush_topics(self, buf: dict, pending: dict) -> None:
        for topic, values in buf.items():
            if not values:
                pending.pop(topic, None)
                continue
            batch = P.encode_record_batch(
                [(None, v) for v in values],
                base_timestamp=int(time.time() * 1000),
            )
            if len(batch) > self.max_request_size:
                # not retryable as-is: restoring would wedge every retry
                pending.pop(topic, None)
                raise MessageSizeTooLargeError(
                    f"batch of {len(values)} records is {len(batch)} bytes "
                    f"> max_request_size {self.max_request_size}"
                )
            try:
                self._produce_batch(topic, batch)
            except MessageSizeTooLargeError:
                # acked as failed: do NOT restore (a too-large batch
                # would wedge every retry); drop it like kafka-python
                pending.pop(topic, None)
                raise
            pending.pop(topic, None)  # acked: nothing to restore for this topic

    def _produce_batch(self, topic: str, batch: bytes) -> None:
        """One Produce request carrying one preassembled RecordBatch."""
        body = (
            P.Writer()
            .string(None)  # transactional_id
            .int16(1)  # acks
            .int32(30_000)  # timeout_ms
            .array(
                [(topic, batch)],
                lambda w, t: w.string(t[0]).array(
                    [(0, t[1])],
                    lambda w, p: w.int32(p[0]).bytes_(p[1]),
                ),
            )
            .build()
        )
        r = self._conn.request(P.API_PRODUCE, 3, body)

        def read_pr(rr: P.Reader):
            part = rr.int32()
            err = rr.int16()
            base = rr.int64()
            rr.int64()  # log_append_time
            return part, err, base

        responses = r.array(
            lambda rr: (rr.string(), rr.array(read_pr))
        )
        for _name, prs in responses or []:
            for _part, err, _base in prs or []:
                if err == P.ERR_MESSAGE_TOO_LARGE:
                    raise MessageSizeTooLargeError(
                        f"broker rejected batch for {topic}: message too large"
                    )
                if err != P.ERR_NONE:
                    raise KafkaLiteError(
                        f"produce to {topic} failed: error {err}"
                    )

    def close(self) -> None:
        self.flush()
        self._conn.close()


class KafkaLiteConsumer:
    """Single-topic, partition-0 consumer with earliest/latest reset."""

    def __init__(
        self,
        topic: str,
        bootstrap: str,
        auto_offset_reset: str = "earliest",
        client_id: str = "kafkalite-consumer",
        fetch_max_bytes: int = 16 * 1024 * 1024,
        check_crcs: bool = False,
    ):
        """``check_crcs``: verify each fetched batch's CRC32C before
        decoding. Off by default — TCP already checksums the stream and the
        pure-Python CRC is ~35% of fetch decode time (kafka-python exposes
        the same knob as ``check_crcs``); the wire-compat tests pin CRC
        correctness on both the produce and the log-storage side."""
        self.topic = topic
        self.check_crcs = check_crcs
        self._conn = _Connection(bootstrap, client_id)
        self._reset = auto_offset_reset
        # _offset is the FETCH position (next offset to request from the
        # broker), not the consumed position: it advances past records that
        # were decoded into _pending but not yet delivered to the caller.
        # Anything offset-visible to users (position(), a future commit or
        # seek) must go through the delivered position, which backs out the
        # undelivered pending records.
        self._offset: int | None = None
        # decoded-but-undelivered records: a fetch response can carry far
        # more than one poll's max_records (16 MB of 2-D tuples is ~600k
        # lines); without this buffer every poll would re-fetch and
        # re-decode the same blob just to deliver its next 64k slice
        self._pending: list[str] = []
        # None = unprobed; set once on first poll_arrays (static per process)
        self._arrays_ok: bool | None = None
        self.fetch_max_bytes = fetch_max_bytes
        # Metadata request auto-creates the topic on the embedded broker,
        # matching the reference's auto-create reliance
        self._conn.request(
            P.API_METADATA,
            1,
            P.Writer().array([topic], lambda w, t: w.string(t)).build(),
        )
        # resolve the reset position NOW: a latest-reset consumer must skip
        # only what predates its subscription, not what predates its first
        # poll (the reference's query consumer relies on this,
        # FlinkSkyline.java:92-97)
        self._position()

    def _position(self) -> int:
        if self._offset is None:
            ts = P.TS_EARLIEST if self._reset == "earliest" else P.TS_LATEST
            body = (
                P.Writer()
                .int32(-1)  # replica_id
                .array(
                    [(self.topic, [(0, ts)])],
                    lambda w, t: w.string(t[0]).array(
                        t[1], lambda w, p: w.int32(p[0]).int64(p[1])
                    ),
                )
                .build()
            )
            r = self._conn.request(P.API_LIST_OFFSETS, 1, body)

            def read_pr(rr: P.Reader):
                return rr.int32(), rr.int16(), rr.int64(), rr.int64()

            responses = r.array(lambda rr: (rr.string(), rr.array(read_pr)))
            offset = 0
            for _name, prs in responses or []:
                for _part, err, _ts, off in prs or []:
                    if err != P.ERR_NONE:
                        raise KafkaLiteError(f"list_offsets error {err}")
                    offset = off
            self._offset = offset
        return self._offset

    def position(self) -> int:
        """The consumer-visible position: the offset of the next record the
        CALLER will receive — the fetch position minus the decoded-but-
        undelivered pending records. This (not ``_offset``) is the value an
        offset commit or position report must use."""
        return self._position() - len(self._pending)

    def seek(self, offset: int) -> None:
        """Reposition to ``offset`` (consumer-visible coordinates). Drops
        any decoded-but-undelivered records — after a seek the next poll
        delivers exactly the record at ``offset``. This is the WAL-replay
        entry point: resume from the last committed position."""
        self._pending.clear()
        self._offset = max(0, int(offset))

    def _fetch(self, offset: int, timeout_ms: int) -> list[bytes]:
        """One fetch request at ``offset``; returns the raw RecordBatch
        blobs (usually one). OFFSET_OUT_OF_RANGE (log truncated/reset under
        us) re-resolves the position for the next poll and yields no blob —
        ``_pending`` is structurally empty whenever a fetch runs (both poll
        flavors early-return/drain it first), so already-decoded records
        were served before the reset was observable: the normal
        at-least-once behavior."""
        body = (
            P.Writer()
            .int32(-1)  # replica_id
            .int32(timeout_ms)  # max_wait
            .int32(1)  # min_bytes
            .int32(self.fetch_max_bytes)
            .int8(0)  # isolation_level
            .array(
                [(self.topic, [(0, offset, self.fetch_max_bytes)])],
                lambda w, t: w.string(t[0]).array(
                    t[1],
                    lambda w, p: w.int32(p[0]).int64(p[1]).int32(p[2]),
                ),
            )
            .build()
        )
        r = self._conn.request(P.API_FETCH, 4, body)
        r.int32()  # throttle_time_ms

        def read_pr(rr: P.Reader):
            part = rr.int32()
            err = rr.int16()
            hw = rr.int64()
            rr.int64()  # last_stable_offset
            rr.array(lambda a: (a.int64(), a.int64()))  # aborted txns
            blob = rr.bytes_() or b""
            return part, err, hw, blob

        responses = r.array(lambda rr: (rr.string(), rr.array(read_pr)))
        blobs: list[bytes] = []
        for _name, prs in responses or []:
            for _part, err, _hw, blob in prs or []:
                if err == P.ERR_OFFSET_OUT_OF_RANGE:
                    self._offset = None
                    continue
                if err != P.ERR_NONE:
                    raise KafkaLiteError(f"fetch error {err}")
                if blob:
                    blobs.append(blob)
        return blobs

    def poll(
        self, max_records: int = 65536, timeout_ms: int = 100
    ) -> list[str]:
        if self._pending:
            out = self._pending[:max_records]
            del self._pending[:max_records]
            return out
        offset = self._position()
        out: list[str] = []
        for blob in self._fetch(offset, timeout_ms):
            # decode the WHOLE blob once: records past max_records go to
            # the pending buffer (served by later polls), not back to the
            # broker for a redundant re-fetch + re-decode
            for abs_off, _key, value in P.decode_record_batches(
                blob, verify_crc=self.check_crcs
            ):
                if abs_off < offset:
                    continue
                target = out if len(out) < max_records else self._pending
                # errors="replace", not strict: a non-UTF-8 value must
                # degrade to a dropped/malformed record downstream exactly
                # like poll_arrays() counts it — not raise and kill the
                # consume loop while the array plane survives the same
                # record
                target.append((value or b"").decode("utf-8", errors="replace"))
                self._offset = abs_off + 1
        return out

    def poll_arrays(self, dims: int, timeout_ms: int = 100):
        """Data-plane poll straight to numpy: one fetch, decoded AND
        CSV-parsed in native code (``native.parse_recordbatches_native``)
        into ``(ids (n,) int64, values (n, dims) float32, dropped)`` — the
        consume-plane twin of the producer's ``send_blob``, with zero
        per-record Python objects between broker and engine. Returns None
        when the native library is unavailable (callers fall back to
        ``poll()`` + line parsing). If line-based ``poll()`` left
        decoded-but-undelivered records pending, those are drained first
        through the line parser so mixing the APIs stays ordered. Unlike
        ``poll()`` there is no pending buffer: the whole fetch blob is
        parsed and delivered in one call (the worker drains the topic
        anyway), so ``max_records`` slicing does not apply."""
        import numpy as np

        from skyline_tpu_torch.bridge.wire import parse_tuple_lines
        from skyline_tpu_torch.native import parse_recordbatches_native

        if self._arrays_ok is None:  # availability is static per process
            self._arrays_ok = parse_recordbatches_native(b"", 0, 1) is not None
        if not self._arrays_ok:
            return None
        if self._pending:
            lines, self._pending = self._pending, []
            return parse_tuple_lines(lines, dims)
        offset = self._position()
        chunks: list[tuple] = []
        for blob in self._fetch(offset, timeout_ms):
            ids, values, dropped, next_off = parse_recordbatches_native(
                blob, offset, dims, verify_crc=self.check_crcs
            )
            if next_off > offset:
                self._offset = next_off
            chunks.append((ids, values, dropped))
        if not chunks:
            return (
                np.empty(0, dtype=np.int64),
                np.empty((0, dims), dtype=np.float32),
                0,
            )
        if len(chunks) == 1:
            return chunks[0]
        return (
            np.concatenate([c[0] for c in chunks]),
            np.concatenate([c[1] for c in chunks]),
            sum(c[2] for c in chunks),
        )

    def close(self) -> None:
        self._conn.close()

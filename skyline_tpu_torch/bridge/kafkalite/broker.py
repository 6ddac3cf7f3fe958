"""Embedded Kafka broker speaking the real wire protocol (see protocol.py).

The reference deploys Kafka 3.7.2 in KRaft mode with 10 MB message caps
(docker-setup/docker-compose.yml:2-21); this broker stands in for it where
no JVM/docker exists: an in-process (or standalone, see ``main``) TCP
server with in-memory single-replica logs, auto-created topics, and the
same ``message.max.bytes`` enforcement (``ERR_MESSAGE_TOO_LARGE`` past the
cap). It serves kafkalite clients and any real Kafka client restricted to
the implemented api versions (Produce<=3, Fetch<=4, Metadata<=1,
ListOffsets<=1, ApiVersions 0).

Not implemented (not needed by the harness): consumer groups/coordination,
transactions, compression, multi-broker replication, TLS/SASL.
"""

from __future__ import annotations

import socketserver
import struct
import threading
import time

from skyline_tpu_torch.bridge.kafkalite import protocol as P

DEFAULT_MAX_MESSAGE_BYTES = 10_485_760  # docker-compose.yml:20-21


class _PartitionLog:
    """Append-only in-memory log of record batches."""

    __slots__ = ("batches", "next_offset", "lock")

    def __init__(self):
        # (base_offset, last_offset, batch_bytes)
        self.batches: list[tuple[int, int, bytes]] = []
        self.next_offset = 0
        self.lock = threading.Lock()

    def append(self, batch_bytes: bytes) -> int:
        """Re-stamp the batch's base offset to the log end; returns it.

        CRC is NOT verified here: consumers verify on decode, and for the
        in-process producer the checksum was computed a microsecond ago —
        re-verifying would just double the data plane's checksum cost.
        Record counting reads only the fixed-offset header fields
        (numRecords at byte 57 of each batch, per the v2 layout) — a full
        record decode per produce would make the broker's data plane pay
        the parse cost twice."""
        spans = list(P.iter_batch_spans(batch_bytes))
        n_records = sum(cnt for _, _, cnt in spans)
        if not n_records:
            return self.next_offset
        with self.lock:
            base = self.next_offset
            # rewrite each batch's baseOffset in place (first 8 bytes of a
            # batch); crc does not cover it, so no re-checksum is needed —
            # exactly why the v2 format excludes baseOffset from the crc.
            # Multi-batch record sets (legal from real clients) restamp
            # every batch so fetch offsets stay monotonic.
            parts = []
            off = base
            for start, length, cnt in spans:
                parts.append(struct.pack(">q", off))
                parts.append(batch_bytes[start + 8 : start + length])
                off += cnt
            stamped = b"".join(parts)
            last = base + n_records - 1
            self.batches.append((base, last, stamped))
            self.next_offset = last + 1
            return base

    def read_from(self, offset: int, max_bytes: int) -> bytes:
        out = []
        size = 0
        with self.lock:
            for base, last, blob in self.batches:
                if last < offset:
                    continue
                if out and size + len(blob) > max_bytes:
                    break
                out.append(blob)
                size += len(blob)
                if size >= max_bytes:
                    break
        return b"".join(out)


class _BrokerState:
    def __init__(self, max_message_bytes: int):
        self.topics: dict[str, dict[int, _PartitionLog]] = {}
        self.lock = threading.Lock()
        self.max_message_bytes = max_message_bytes

    def partition(self, topic: str, part: int, create: bool = True) -> _PartitionLog | None:
        with self.lock:
            t = self.topics.get(topic)
            if t is None:
                if not create:
                    return None
                t = self.topics[topic] = {}
            log = t.get(part)
            if log is None:
                if not create:
                    return None
                log = t[part] = _PartitionLog()
            return log


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        state: _BrokerState = self.server.state  # type: ignore[attr-defined]
        while True:
            try:
                frame = P.read_frame(self.request)
            except (EOFError, ConnectionError, OSError):
                return
            if frame is None:
                return
            r = P.Reader(frame)
            api_key = r.int16()
            api_version = r.int16()
            corr = r.int32()
            r.string()  # client_id
            try:
                body = self._dispatch(state, api_key, api_version, r)
            except Exception:
                # malformed request: drop the connection (a real broker
                # logs + closes too)
                return
            self.request.sendall(P.encode_response(corr, body))

    def _dispatch(self, state, api_key, api_version, r: P.Reader) -> bytes:
        if api_key == P.API_API_VERSIONS:
            # KIP-511: a v>0 (possibly flexible) ApiVersions request must be
            # answered UNSUPPORTED_VERSION in the v0 body so real clients
            # retry with v0 instead of misparsing a v0 body as flexible
            if api_version > 0:
                return (
                    P.Writer()
                    .int16(P.ERR_UNSUPPORTED_VERSION)
                    .array([], lambda w, _i: None)
                    .build()
                )
            return self._api_versions()
        if api_key == P.API_METADATA and api_version <= 1:
            return self._metadata(state, r)
        if api_key == P.API_PRODUCE and api_version <= 3:
            return self._produce(state, r)
        if api_key == P.API_FETCH and api_version <= 4:
            return self._fetch(state, r)
        if api_key == P.API_LIST_OFFSETS and api_version <= 1:
            return self._list_offsets(state, r)
        # honest refusal for anything newer/unknown
        return P.Writer().int16(P.ERR_UNSUPPORTED_VERSION).build()

    def _api_versions(self) -> bytes:
        w = P.Writer()
        w.int16(P.ERR_NONE)
        supported = [
            (P.API_PRODUCE, 0, 3),
            (P.API_FETCH, 0, 4),
            (P.API_LIST_OFFSETS, 0, 1),
            (P.API_METADATA, 0, 1),
            (P.API_API_VERSIONS, 0, 0),
        ]
        w.array(
            supported,
            lambda w, it: w.int16(it[0]).int16(it[1]).int16(it[2]),
        )
        return w.build()

    def _metadata(self, state: _BrokerState, r: P.Reader) -> bytes:
        topics = r.array(lambda rr: rr.string())
        host, port = self.server.server_address[:2]  # type: ignore[attr-defined]
        with state.lock:
            known = sorted(state.topics)
        if topics is None or len(topics) == 0:
            names = known
        else:
            names = topics
            # Metadata auto-creates requested topics (the broker config the
            # reference relies on: producers/consumers never create topics
            # explicitly)
            for t in names:
                state.partition(t, 0, create=True)
        w = P.Writer()
        w.array(
            [(0, str(host), int(port), None)],
            lambda w, b: w.int32(b[0]).string(b[1]).int32(b[2]).string(b[3]),
        )
        w.int32(0)  # controller_id

        def write_topic(w: P.Writer, name: str):
            with state.lock:
                parts = sorted(state.topics.get(name, {0: None}))
            w.int16(P.ERR_NONE).string(name).boolean(False)
            w.array(
                parts,
                lambda w, p: (
                    w.int16(P.ERR_NONE)
                    .int32(p)
                    .int32(0)  # leader
                    .array([0], lambda w, rid: w.int32(rid))  # replicas
                    .array([0], lambda w, rid: w.int32(rid))  # isr
                ),
            )

        w.array(names, write_topic)
        return w.build()

    def _produce(self, state: _BrokerState, r: P.Reader) -> bytes:
        r.string()  # transactional_id
        r.int16()  # acks (all treated as acks=1: append then respond)
        r.int32()  # timeout_ms
        topic_results = []

        def read_partition(rr: P.Reader):
            part = rr.int32()
            record_set = rr.bytes_()
            return part, record_set

        def read_topic(rr: P.Reader):
            name = rr.string()
            parts = rr.array(read_partition)
            return name, parts

        for name, parts in r.array(read_topic) or []:
            part_results = []
            for part, record_set in parts or []:
                if record_set is not None and len(record_set) > state.max_message_bytes:
                    part_results.append((part, P.ERR_MESSAGE_TOO_LARGE, -1))
                    continue
                log = state.partition(name, part, create=True)
                base = log.append(record_set) if record_set else log.next_offset
                part_results.append((part, P.ERR_NONE, base))
            topic_results.append((name, part_results))

        w = P.Writer()
        w.array(
            topic_results,
            lambda w, t: w.string(t[0]).array(
                t[1],
                lambda w, pr: (
                    w.int32(pr[0]).int16(pr[1]).int64(pr[2]).int64(-1)
                ),  # partition, error, base_offset, log_append_time
            ),
        )
        w.int32(0)  # throttle_time_ms
        return w.build()

    def _fetch(self, state: _BrokerState, r: P.Reader) -> bytes:
        r.int32()  # replica_id
        max_wait_ms = r.int32()
        min_bytes = r.int32()
        r.int32()  # max_bytes (request-level)
        r.int8()  # isolation_level

        def read_partition(rr: P.Reader):
            return rr.int32(), rr.int64(), rr.int32()  # part, offset, max_bytes

        def read_topic(rr: P.Reader):
            return rr.string(), rr.array(read_partition)

        requests = r.array(read_topic) or []

        def collect(create: bool):
            results, total = [], 0
            for name, parts in requests:
                part_results = []
                for part, offset, pmax in parts or []:
                    log = state.partition(name, part, create=create)
                    if log is None:
                        part_results.append(
                            (part, P.ERR_UNKNOWN_TOPIC_OR_PARTITION, 0, b"")
                        )
                        continue
                    if offset > log.next_offset:
                        part_results.append(
                            (part, P.ERR_OFFSET_OUT_OF_RANGE, log.next_offset, b"")
                        )
                        continue
                    blob = log.read_from(offset, pmax)
                    total += len(blob)
                    part_results.append((part, P.ERR_NONE, log.next_offset, blob))
                results.append((name, part_results))
            return results, total

        results, total = collect(create=True)
        if total < max(min_bytes, 1):
            # honor max_wait/min_bytes long-polling in spirit: short bounded
            # waits so idle consumers don't spin the broker
            deadline = time.time() + min(max_wait_ms, 500) / 1000.0
            while total < max(min_bytes, 1) and time.time() < deadline:
                time.sleep(0.005)
                results, total = collect(create=False)

        w = P.Writer()
        w.int32(0)  # throttle_time_ms
        w.array(
            results,
            lambda w, t: w.string(t[0]).array(
                t[1],
                lambda w, pr: (
                    w.int32(pr[0])
                    .int16(pr[1])
                    .int64(pr[2])  # high_watermark
                    .int64(pr[2])  # last_stable_offset
                    .array([], lambda w, _a: None)  # aborted_transactions
                    .bytes_(pr[3])
                ),
            ),
        )
        return w.build()

    def _list_offsets(self, state: _BrokerState, r: P.Reader) -> bytes:
        r.int32()  # replica_id

        def read_partition(rr: P.Reader):
            return rr.int32(), rr.int64()  # partition, timestamp

        def read_topic(rr: P.Reader):
            return rr.string(), rr.array(read_partition)

        results = []
        for name, parts in r.array(read_topic) or []:
            part_results = []
            for part, ts in parts or []:
                log = state.partition(name, part, create=True)
                if ts == P.TS_EARLIEST:
                    first = log.batches[0][0] if log.batches else 0
                    part_results.append((part, P.ERR_NONE, 0, first))
                else:  # latest (or timestamp lookup, answered as latest)
                    part_results.append((part, P.ERR_NONE, -1, log.next_offset))
            results.append((name, part_results))

        w = P.Writer()
        w.array(
            results,
            lambda w, t: w.string(t[0]).array(
                t[1],
                lambda w, pr: (
                    w.int32(pr[0]).int16(pr[1]).int64(pr[2]).int64(pr[3])
                ),
            ),
        )
        return w.build()


class Broker:
    """In-process broker: ``with Broker() as b: ... b.address``."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        max_message_bytes: int = DEFAULT_MAX_MESSAGE_BYTES,
        state: "_BrokerState | None" = None,
    ):
        """``state``: carry an existing ``_BrokerState`` (topic logs) into a
        new broker instance — the broker-restart half of the client
        reconnect tests, standing in for Kafka's on-disk log surviving a
        broker bounce."""

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self._server.state = (  # type: ignore[attr-defined]
            state if state is not None else _BrokerState(max_message_bytes)
        )
        self._thread: threading.Thread | None = None

    @property
    def state(self) -> _BrokerState:
        return self._server.state  # type: ignore[attr-defined]

    @property
    def address(self) -> str:
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> "Broker":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> "Broker":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv=None):
    """Standalone broker CLI (the docker-compose Kafka service's role for
    bare-metal bring-up): ``python -m skyline_tpu_torch.bridge.kafkalite.broker
    [--host H] [--port P] [--max-message-bytes N]``."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9092)
    ap.add_argument(
        "--max-message-bytes", type=int, default=DEFAULT_MAX_MESSAGE_BYTES
    )
    args = ap.parse_args(argv)
    b = Broker(args.host, args.port, args.max_message_bytes)
    import sys

    print(f"kafkalite broker listening on {b.address}", file=sys.stderr)
    try:
        b._server.serve_forever()
    except KeyboardInterrupt:
        b.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""In-memory topic bus — the fake-Kafka bridge for tests and single-process runs.

Provides the same minimal produce/consume surface the worker needs from Kafka
(SURVEY.md §4's "end-to-end single-host tests with fake Kafka"): named topics,
append-only logs, per-consumer offsets, at-least-once in-order delivery —
mirroring the reference's topic semantics (ordered per partition,
FlinkSkyline.java:84-97) without a broker.
"""

from __future__ import annotations

import itertools
import threading
from collections import defaultdict


class MemoryBus:
    """Thread-safe named append-only string logs with offset-based consumers."""

    def __init__(self):
        self._topics: dict[str, list[str]] = defaultdict(list)
        self._lock = threading.Lock()
        self._consumer_seq = itertools.count()
        self._offsets: dict[tuple, int] = {}

    def produce(self, topic: str, message: str) -> None:
        with self._lock:
            self._topics[topic].append(message)

    def produce_many(self, topic: str, messages) -> None:
        with self._lock:
            self._topics[topic].extend(messages)

    def consumer(self, topic: str, from_beginning: bool = True) -> "MemoryConsumer":
        """New consumer handle; ``from_beginning=False`` mirrors Kafka's
        offsets=latest (query topic, FlinkSkyline.java:95)."""
        with self._lock:
            cid = next(self._consumer_seq)
            start = 0 if from_beginning else len(self._topics[topic])
            self._offsets[(topic, cid)] = start
        return MemoryConsumer(self, topic, cid)

    def _poll(self, topic: str, cid: int, max_records: int) -> list[str]:
        with self._lock:
            off = self._offsets[(topic, cid)]
            log = self._topics[topic]
            batch = log[off : off + max_records]
            self._offsets[(topic, cid)] = off + len(batch)
        return batch

    def _position(self, topic: str, cid: int) -> int:
        with self._lock:
            return self._offsets[(topic, cid)]

    def _seek(self, topic: str, cid: int, offset: int) -> None:
        with self._lock:
            self._offsets[(topic, cid)] = max(0, int(offset))

    def size(self, topic: str) -> int:
        with self._lock:
            return len(self._topics[topic])


class MemoryConsumer:
    def __init__(self, bus: MemoryBus, topic: str, cid: int):
        self._bus = bus
        self.topic = topic
        self._cid = cid

    def poll(self, max_records: int = 65536) -> list[str]:
        return self._bus._poll(self.topic, self._cid, max_records)

    def position(self) -> int:
        """Offset of the next record this consumer will receive — same
        contract as ``KafkaLiteConsumer.position`` (the resilience layer's
        commit/replay currency)."""
        return self._bus._position(self.topic, self._cid)

    def seek(self, offset: int) -> None:
        return self._bus._seek(self.topic, self._cid, offset)

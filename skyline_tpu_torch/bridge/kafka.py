"""Kafka transport: the production bridge onto the reference's topics.

Mirrors the reference's Kafka wiring exactly — bootstrap ``localhost:9092``,
data topic consumed from earliest, query topic from latest, 10 MB max request
size on the result producer (FlinkSkyline.java:84-97, 177-183;
docker-setup/docker-compose.yml:20-21) — so the reference's own Python
harness (producers, collector) works unchanged against this engine.

Backend selection: kafka-python when installed (a real JVM broker
deployment), otherwise the bundled pure-Python ``kafkalite`` client, which
speaks the same wire protocol (RecordBatch v2, Produce/Fetch/Metadata/
ListOffsets) against either a real broker or the embedded
``kafkalite.Broker``. Both paths expose the same produce/consumer surface
as ``MemoryBus``.
"""

from __future__ import annotations

DEFAULT_BOOTSTRAP = "localhost:9092"
MAX_REQUEST_SIZE = 10_485_760  # 10 MB, matching FlinkSkyline.java:179

try:  # pragma: no cover - exercised only where kafka-python is installed
    from kafka import KafkaConsumer as _KafkaConsumer
    from kafka import KafkaProducer as _KafkaProducer

    HAVE_KAFKA = True
except ImportError:
    _KafkaConsumer = None
    _KafkaProducer = None
    HAVE_KAFKA = False


class KafkaBus:
    """Same produce/consumer surface as MemoryBus, backed by a real broker
    over the Kafka wire protocol (kafka-python or bundled kafkalite)."""

    def __init__(self, bootstrap: str = DEFAULT_BOOTSTRAP):
        self.bootstrap = bootstrap
        if HAVE_KAFKA:  # pragma: no cover - not in the baked image
            self._producer = _KafkaProducer(
                bootstrap_servers=bootstrap,
                # str OR bytes: the producer CLI's native formatter emits
                # bytes lines (kafkalite's send accepts both natively)
                value_serializer=lambda s: (
                    s if isinstance(s, bytes) else s.encode("utf-8")
                ),
                max_request_size=MAX_REQUEST_SIZE,
            )
            self._lite = False
        else:
            from skyline_tpu_torch.bridge.kafkalite import KafkaLiteProducer

            self._producer = KafkaLiteProducer(
                bootstrap, max_request_size=MAX_REQUEST_SIZE
            )
            self._lite = True

    def produce(self, topic: str, message: str) -> None:
        self._producer.send(topic, message)
        self._producer.flush()

    def produce_many(self, topic: str, messages) -> None:
        send_many = getattr(self._producer, "send_many", None)
        if send_many is not None:
            send_many(topic, messages)
        else:  # pragma: no cover - kafka-python path, not in the baked image
            for m in messages:
                self._producer.send(topic, m)
        self._producer.flush()

    def produce_blob(self, topic: str, blob: bytes, offsets) -> None:
        """Produce records from one value blob + prefix offsets (the native
        formatter's output) without per-record bytes objects where the
        backend supports it (kafkalite ``send_blob``)."""
        send_blob = getattr(self._producer, "send_blob", None)
        if send_blob is not None:
            send_blob(topic, blob, offsets)
            return
        ot = list(offsets)  # pragma: no cover - kafka-python path
        self.produce_many(
            topic, [blob[ot[i] : ot[i + 1]] for i in range(len(ot) - 1)]
        )

    def consumer(self, topic: str, from_beginning: bool = True):
        reset = "earliest" if from_beginning else "latest"
        if HAVE_KAFKA:  # pragma: no cover - not in the baked image
            c = _KafkaConsumer(
                topic,
                bootstrap_servers=self.bootstrap,
                auto_offset_reset=reset,
                value_deserializer=lambda b: b.decode("utf-8"),
            )
            return _KafkaConsumerAdapter(c)
        from skyline_tpu_torch.bridge.kafkalite import KafkaLiteConsumer

        return KafkaLiteConsumer(topic, self.bootstrap, auto_offset_reset=reset)

    def close(self) -> None:
        self._producer.close()


class _KafkaConsumerAdapter:  # pragma: no cover - kafka-python only
    def __init__(self, consumer):
        self._consumer = consumer
        self.topic = next(iter(consumer.subscription()), None)

    def poll(self, max_records: int = 65536) -> list[str]:
        batches = self._consumer.poll(timeout_ms=100, max_records=max_records)
        out: list[str] = []
        for records in batches.values():
            out.extend(r.value for r in records)
        return out

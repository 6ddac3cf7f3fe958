"""kafkalite: a dependency-free Kafka wire-protocol client + embedded broker.

The J9 transport (FlinkSkyline.java:84-97, 177-183) exercised for REAL —
actual TCP, actual Kafka framing, actual RecordBatch v2 with CRC32C — in an
image without kafka-python or a JVM broker. ``bridge.kafka.KafkaBus``
prefers kafka-python when installed and falls back to these clients, so the
same CLI flags drive either stack.
"""

from skyline_tpu_torch.bridge.kafkalite.broker import Broker
from skyline_tpu_torch.bridge.kafkalite.client import (
    KafkaLiteConsumer,
    KafkaLiteError,
    KafkaLiteProducer,
    MessageSizeTooLargeError,
)

__all__ = [
    "Broker",
    "KafkaLiteConsumer",
    "KafkaLiteError",
    "KafkaLiteProducer",
    "MessageSizeTooLargeError",
]

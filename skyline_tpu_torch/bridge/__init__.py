"""Transport plane: the in-memory bus (tests, single-process runs), Kafka
through kafka-python or the bundled kafkalite, the wire formats, and the
worker."""

from skyline_tpu_torch.bridge.memory import MemoryBus

__all__ = ["MemoryBus", "SkylineWorker"]


def __getattr__(name):
    # SkylineWorker imports the engine, which imports bridge.wire; resolving
    # the worker lazily keeps that cycle out of package-import time.
    if name == "SkylineWorker":
        from skyline_tpu_torch.bridge.worker import SkylineWorker

        return SkylineWorker
    raise AttributeError(name)

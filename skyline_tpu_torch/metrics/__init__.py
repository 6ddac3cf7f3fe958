"""Metrics of the port: the phase tracer (``tracing.py``), the named
counters and the result-JSON → CSV collector (``collector.py``, also the
``python -m skyline_tpu_torch.metrics.collector`` CLI, so this package
imports none of its modules), and the /stats HTTP server
(``httpstats.py``)."""

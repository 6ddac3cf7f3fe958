"""Metrics of the port: the phase tracer (``tracing.py``) and the named
counters (``collector.py``)."""

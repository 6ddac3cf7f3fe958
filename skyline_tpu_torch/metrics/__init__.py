"""Metrics of the port: the phase tracer (``tracing.py``)."""

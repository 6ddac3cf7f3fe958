"""Telemetry of the port: the per-signature kernel profiler the dispatch
race reads (``profiler.py``)."""

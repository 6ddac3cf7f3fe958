"""Rows of every window completed in the measured window over its whole
time, engine construction, ingest, triggers and answers included."""


def read(run):
    return run.rows / run.elapsed_s if run.elapsed_s > 0 else None

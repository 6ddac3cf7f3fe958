"""Host time in ``process_records`` over the measured window, per
1,000,000 rows ingested."""


def read(run):
    if not run.rows:
        return None
    return run.ingest_s * 1e3 / run.rows * 1e6

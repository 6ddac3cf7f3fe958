"""95th percentile, over every answer in the measured window, of the time
from ``process_trigger`` to the ``poll_results`` that returns the answer."""

import numpy as np


def read(run):
    if not run.latencies_ms:
        return None
    return float(np.percentile(np.asarray(run.latencies_ms, dtype=np.float64), 95))

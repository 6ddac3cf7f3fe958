"""Row encoding of the write-ahead log's records.

Counterpart of ``rows_to_b64`` and ``rows_from_b64`` in
``skyline_tpu/resilience/wal.py``: a (n, d) float32 row block as the
base64 of its bytes, as the ``delta`` and ``ckpt`` records carry it
(``serve/deltas.py``). The log itself (framing, segments, replay, fencing)
is not ported yet.
"""

from __future__ import annotations

import base64

import numpy as np


def rows_to_b64(rows) -> str:
    return base64.b64encode(
        np.ascontiguousarray(rows, dtype=np.float32).tobytes()
    ).decode("ascii")


def rows_from_b64(s: str, dims: int):
    buf = base64.b64decode(s.encode("ascii"))
    return np.frombuffer(buf, dtype=np.float32).reshape(-1, max(dims, 1)).copy()


__all__ = ["rows_from_b64", "rows_to_b64"]

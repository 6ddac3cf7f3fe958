"""Crash safety: the pieces of ``skyline_tpu/resilience/`` ported so far.

- ``faults`` — the deterministic fault-injection registry (named kill
  points, ``SKYLINE_FAULT_PLAN``), with the reference's sites in the
  partition set's flush, the snapshot store's publish and the checkpoint
  writer;
- ``wal`` — only the row encoding of the log's records (``rows_to_b64``,
  ``rows_from_b64``), which the serving plane's delta records use.

The log, the checkpoint manager and the supervisor are not ported yet.
This ``__init__`` stays stdlib-only because ``stream/batched.py`` imports
``faults`` on its hot path.
"""

from __future__ import annotations

from skyline_tpu_torch.resilience.faults import (
    KILL_POINTS,
    FaultPlan,
    InjectedCrash,
    active_plan,
    clear,
    fault_fired,
    fault_point,
    install_from_env,
    install_plan,
)

__all__ = [
    "FaultPlan",
    "InjectedCrash",
    "KILL_POINTS",
    "active_plan",
    "clear",
    "fault_fired",
    "fault_point",
    "install_from_env",
    "install_plan",
]

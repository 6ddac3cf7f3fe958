"""Crash safety: WAL + auto-checkpoint + supervised restart.

The port's copy of ``skyline_tpu/resilience/``. Recovery is a provable
property: re-ingesting a replayed stream suffix into a restored partition
state reproduces the uninterrupted run's skyline byte for byte, so the
chaos tests (``tests/test_torch_resilience.py``) assert bit-identical final
results across injected crashes.

Pieces (each importable on its own; this ``__init__`` stays stdlib-only
because ``stream/batched.py`` imports ``faults`` on its hot path):

- ``faults``      deterministic fault-injection registry (named kill
                  points, ``SKYLINE_FAULT_PLAN``)
- ``wal``         CRC32-framed, segment-rotated append-only log of
                  consumed offsets + batch digests + published deltas
- ``checkpoints`` retain-N checkpoint manager with CRC-verified restore
                  onto the engine's device and fallback to the previous
                  good checkpoint
- ``chip_wal``    the sharded engine's per-chip journals: the writer
                  (``ChipWalPlane``) and the barrier check every
                  resilient boot runs
- ``health``      per-chip health scores and quarantine (``ChipHealth``)
- ``supervisor``  exponential-backoff restart loop with a bounded budget
"""

from __future__ import annotations

from dataclasses import dataclass

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

WAL_SUBDIR = "wal"  # WAL segments live under <checkpoint_dir>/wal


@dataclass(frozen=True)
class ResilienceConfig:
    """The worker's durability knobs (built by JobConfig.resilience_config;
    an empty ``checkpoint_dir`` means resilience is off and none of the
    other fields matter)."""

    checkpoint_dir: str
    checkpoint_interval_s: float = 30.0  # 0 = shutdown/manual only
    checkpoint_retain: int = 3
    wal_fsync: str = "batch"  # always | batch (per step) | off
    wal_segment_bytes: int = 4_194_304


__all__ = [
    "FaultPlan",
    "InjectedCrash",
    "KILL_POINTS",
    "ResilienceConfig",
    "WAL_SUBDIR",
    "active_plan",
    "clear",
    "fault_fired",
    "fault_point",
    "install_from_env",
    "install_plan",
]

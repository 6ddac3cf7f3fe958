"""Environment knobs of the port.

The port's own copy of the JAX package's knob parsing
(``skyline_tpu/analysis/registry.py`` ``parse_bool``, ``env_bool``,
``env_int`` and ``env_float``, same truthy and falsy words) and the knobs
the port reads. Knobs are read lazily, when a flush or a merge runs, never
at import.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple

_TRUTHY = frozenset(("1", "true", "yes", "on"))
_FALSY = frozenset(("0", "false", "no", "off"))

_warned: set[str] = set()


def parse_bool(raw: str | None, default=False):
    """``raw`` as a boolean: one of the truthy or falsy words (any case,
    surrounding blanks ignored), else ``default``."""
    if raw is None:
        return default
    s = raw.strip().lower()
    if s == "" or (s not in _FALSY and s not in _TRUTHY):
        return default
    return s in _TRUTHY


def env_bool(name: str, default=False):
    """The boolean environment variable ``name``; an unrecognised value
    warns once and gives ``default``."""
    v = os.environ.get(name)
    if v is not None and v.strip() != "":
        s = v.strip().lower()
        if s not in _FALSY and s not in _TRUTHY and name not in _warned:
            _warned.add(name)
            warnings.warn(
                f"ignoring {name}={v!r}: not a recognized boolean; using the default",
                stacklevel=2,
            )
    return parse_bool(v, default)


def _env_parsed(name: str, default, parse, what: str):
    """The environment variable ``name`` read by ``parse``; an unset or
    blank value gives ``default``, an unparsable one warns once (it is not
    ``what``) and gives ``default``."""
    v = os.environ.get(name)
    if v is None or v.strip() == "":
        return default
    try:
        return parse(v)
    except ValueError:
        if name not in _warned:
            _warned.add(name)
            warnings.warn(
                f"ignoring {name}={v!r}: not {what}; using the default",
                stacklevel=3,
            )
        return default


def env_int(name: str, default=0):
    """The integer environment variable ``name``."""
    return _env_parsed(name, default, int, "an integer")


def env_float(name: str, default=0.0):
    """The float environment variable ``name``."""
    return _env_parsed(name, default, float, "a number")


def rank_cascade() -> bool:
    """``SKYLINE_RANK_CASCADE`` selects the dense-rank dominance cascade
    (K4–K7) for the device-ingest flush and the global merge. Off by
    default, as in the reference (``skyline_tpu/ops/dispatch.py``)."""
    return env_bool("SKYLINE_RANK_CASCADE", False)


def flush_stage_depth() -> int:
    """``SKYLINE_STAGE_DEPTH``: how many incremental flush rounds the host
    assembles and uploads ahead of the round in flight. 1 = double
    buffering (the default, as in the reference); 0 assembles and launches
    strictly in order."""
    return max(0, env_int("SKYLINE_STAGE_DEPTH", 1))


def mixed_precision_enabled(device=None) -> bool:
    """``SKYLINE_MIXED_PRECISION``: the bf16 margin passes of the flush —
    the row pre-drop (``strictly_dominated_bf16``) and the kernels' bf16
    first pass (K1–K3 ``mp``), both exact, so the answer is the same either
    way. An explicit value wins on every device; otherwise it is on where
    ``device`` is a CUDA card and off on the CPU — the reference's
    ``on_tpu()`` default carried to the port's accelerator
    (``skyline_tpu/ops/dispatch.py``)."""
    # imported here: the transport's processes read knobs without torch
    from skyline_tpu_torch.utils.devices import device_type

    return env_bool("SKYLINE_MIXED_PRECISION", device_type(device) == "cuda")


def flush_prefilter_enabled() -> bool:
    """``SKYLINE_FLUSH_PREFILTER``: the quantized-grid prefilter ahead of
    the flush — pending host rows whose grid cell a representative cell of
    their partition's skyline strictly dominates are dropped before any
    merge kernel. On by default, as in the reference; the answer bytes are
    the same either way."""
    return env_bool("SKYLINE_FLUSH_PREFILTER", True)


# -- the global-merge plane ---------------------------------------------------
#
# These read the environment only. The set reads the plane through the
# dispatch table (``ops/cascade.py`` ``merge_cache_on``, ``delta_applies``,
# ``merge_tree_on``, ``gate("partition_prune")``), where a tuner override
# acts on a knob the environment left unset.


def merge_cache_enabled() -> bool:
    """``SKYLINE_MERGE_CACHE``: the epoch-keyed global-merge cache — a
    repeated trigger over unchanged state answers from the cache with no
    kernel launch, and a partly dirty state merges the cached global skyline
    with the dirty partitions. On by default, as in the reference; the
    answer bytes are the same either way."""
    return env_bool("SKYLINE_MERGE_CACHE", True)


def delta_dirty_cutoff() -> float:
    """``SKYLINE_DELTA_CUTOFF``: the largest share of dirty partitions the
    delta merge takes; above it the full merge runs. 0.75 by default, as in
    the reference; 0 turns the delta merge off and keeps the exact hit."""
    return env_float("SKYLINE_DELTA_CUTOFF", 0.75)


def merge_tree_enabled() -> bool:
    """``SKYLINE_MERGE_TREE``: the pruned tournament-tree global merge at
    d > 2 (pairs of partition skylines, two K2 passes each on a card) in
    place of one survivor-mask pass over the whole union. On by default, as
    in the reference; ``0`` gives the flat merge (K3 or K7 on a card) with
    the same answer bytes."""
    return env_bool("SKYLINE_MERGE_TREE", True)


def merge_prune_enabled() -> bool:
    """``SKYLINE_MERGE_PRUNE``: the witness prefilter ahead of the tree —
    a partition whose least corner another partition's witness row strictly
    dominates is dropped whole. On by default, as in the reference."""
    return env_bool("SKYLINE_MERGE_PRUNE", True)


def chip_prune_enabled() -> bool:
    """``SKYLINE_CHIP_PRUNE``: the chip-level witness prefilter of the
    sharded engine's two-level merge (``distributed/sharded.py``): a chip
    whose least corner another chip's witness row strictly dominates ships
    nothing to the root. On by default, as in the reference; the answer
    bytes are the same either way."""
    return env_bool("SKYLINE_CHIP_PRUNE", True)


def host_prune_enabled() -> bool:
    """``SKYLINE_CLUSTER_HOST_PRUNE``: the host-level witness prefilter of
    the cluster merge (``cluster/coordinator.py``, through the dispatch
    table's ``host_prune`` gate). On by default, as in the reference."""
    return env_bool("SKYLINE_CLUSTER_HOST_PRUNE", True)


def query_overlap_enabled() -> bool:
    """``SKYLINE_QUERY_OVERLAP``: a trigger launches the global merge and
    returns; the engine harvests it at the next ingest (if its stats have
    landed), trigger or result poll. On by default, as in the reference;
    ``0`` blocks at every trigger. The results are the same either way."""
    return env_bool("SKYLINE_QUERY_OVERLAP", True)


# -- the sharded engine's chip planes -------------------------------------------
#
# Read lazily, at the merge launch, the failover or the attach that uses them,
# as in the reference (``skyline_tpu/ops/dispatch.py``,
# ``skyline_tpu/resilience/health.py``).


def chip_barrier_policy() -> str:
    """``SKYLINE_CHIP_BARRIER``: when the sharded engine writes its chip
    journals' consistency barriers (``resilience/chip_wal.py``): ``merge``
    (the default) after every complete two-level merge, ``checkpoint`` only
    at checkpoints, ``off`` no chip journals at all. Any other value reads
    as ``merge``."""
    v = env_str("SKYLINE_CHIP_BARRIER", "merge")
    return v if v in ("merge", "checkpoint", "off") else "merge"


def chip_merge_deadline_ms() -> float:
    """``SKYLINE_CHIP_MERGE_DEADLINE_MS``: each chip's budget for its
    level-1 merge. ``0`` (the default) runs the chips' merges in turn with
    no bound; above it each runs on a watchdog thread, and a chip that
    misses the budget after its retries is left out of the answer, which
    is published marked partial."""
    return max(0.0, env_float("SKYLINE_CHIP_MERGE_DEADLINE_MS", 0.0))


def chip_merge_retries() -> int:
    """``SKYLINE_CHIP_MERGE_RETRIES``: extra level-1 attempts after a
    chip's merge fails inside its deadline; 1 by default."""
    return max(0, env_int("SKYLINE_CHIP_MERGE_RETRIES", 1))


def chip_merge_backoff_ms() -> float:
    """``SKYLINE_CHIP_MERGE_BACKOFF_MS``: the first wait before a retry,
    doubled at each; 50 ms by default."""
    return max(0.0, env_float("SKYLINE_CHIP_MERGE_BACKOFF_MS", 50.0))


def chip_hedge_ms() -> float:
    """``SKYLINE_CHIP_HEDGE_MS``: above 0, a level-1 attempt still running
    after this long gets a second attempt beside it, and the first to take
    the chip's lock computes; 0 (the default) hedges nothing."""
    return max(0.0, env_float("SKYLINE_CHIP_HEDGE_MS", 0.0))


def failover_lock_ms() -> float:
    """``SKYLINE_CHIP_FAILOVER_LOCK_MS``: how long a failover waits for
    the chip's lock (a merge attempt may still hold it) before it defers
    to the next merge launch or idle tick; 5000 ms by default."""
    return max(0.0, env_float("SKYLINE_CHIP_FAILOVER_LOCK_MS", 5000.0))


def chip_failover_enabled() -> bool:
    """``SKYLINE_CHIP_FAILOVER``: online failover — a quarantined chip's
    partition group is rebuilt on a healthy chip's device at the next
    merge launch (or worker idle tick) and the slot heals. On by default;
    ``0`` leaves a quarantined chip out of every answer."""
    return env_bool("SKYLINE_CHIP_FAILOVER", True)


def chip_fail_threshold() -> int:
    """``SKYLINE_CHIP_FAIL_THRESHOLD``: consecutive merge failures that
    quarantine a chip; 1 by default."""
    return max(1, env_int("SKYLINE_CHIP_FAIL_THRESHOLD", 1))


def chip_quarantine_score() -> float:
    """``SKYLINE_CHIP_QUARANTINE_SCORE``: a chip whose health score falls
    below it is quarantined; 0.5 by default."""
    return env_float("SKYLINE_CHIP_QUARANTINE_SCORE", 0.5)


def chip_straggler_factor() -> float:
    """``SKYLINE_CHIP_STRAGGLER_FACTOR``: a level-1 wall above this many
    times the other chips' median EMA counts as a straggle; 4 by
    default."""
    return env_float("SKYLINE_CHIP_STRAGGLER_FACTOR", 4.0)


def chip_heartbeat_ms() -> float:
    """``SKYLINE_CHIP_HEARTBEAT_MS``: a chip whose last merge or flush is
    older than this while another chip's is fresher is quarantined at the
    next health tick; 30 s by default."""
    return env_float("SKYLINE_CHIP_HEARTBEAT_MS", 30000.0)


def fleet_enabled() -> bool:
    """``SKYLINE_FLEET``: the sharded engine's per-chip fleet plane
    (``telemetry/fleet.py``), with a telemetry hub. Host-side counts
    around the two-level merge; on by default."""
    return env_bool("SKYLINE_FLEET", True)


def fleet_imbalance_threshold() -> float:
    """``SKYLINE_FLEET_IMBALANCE_THRESHOLD``: the imbalance index (most
    loaded chip over the mean) past which the fleet plane notes a flight
    entry, once per excursion; 2 by default."""
    return env_float("SKYLINE_FLEET_IMBALANCE_THRESHOLD", 2.0)


def fleet_ring() -> int:
    """``SKYLINE_FLEET_RING``: merges in the fleet plane's rolling skew
    score, at least 2; 64 by default."""
    return max(2, env_int("SKYLINE_FLEET_RING", 64))


# -- the dispatch cascade's modes ----------------------------------------------


def _mode(name: str) -> str:
    """An ``auto|on|off`` knob, exact lower case; any other value reads as
    ``auto``, as the reference's readers do (``skyline_tpu/ops/
    dispatch.py``)."""
    v = os.environ.get(name)
    return v if v in ("auto", "on", "off") else "auto"


def sorted_sfs_mode() -> str:
    """``SKYLINE_SORTED_SFS``: the host sorted-order SFS cascade
    (``ops/sorted_sfs.py``) at d > 2. ``auto`` (the default) races it
    against the other candidates on measured walls, ``on`` forces it,
    ``off`` excludes it. Host numpy, so only concrete calls on the CPU
    ever take it."""
    return _mode("SKYLINE_SORTED_SFS")


def device_cascade_mode() -> str:
    """``SKYLINE_DEVICE_CASCADE``: the device sorted dominance cascade
    (``ops/device_cascade.py``). ``auto`` (the default) races it on
    measured walls — concrete calls explore and record, merge-time calls
    swap it in only on evidence already measured — ``on`` forces it
    everywhere, ``off`` excludes it."""
    return _mode("SKYLINE_DEVICE_CASCADE")


def sorted_sfs_block() -> int:
    """``SKYLINE_SORTED_SFS_BLOCK``: the host cascade's largest scan block
    (rows per in-block exact tile), at least 64; 8192 by default."""
    return max(64, env_int("SKYLINE_SORTED_SFS_BLOCK", 8192))


def device_cascade_block() -> int:
    """``SKYLINE_DEVICE_CASCADE_BLOCK``: the device cascade's scan block,
    rounded up to a power of two, at least 8; 2048 by default."""
    from skyline_tpu_torch.utils.buckets import next_pow2

    return next_pow2(max(1, env_int("SKYLINE_DEVICE_CASCADE_BLOCK", 2048)), min_cap=8)


# -- the observability plane ----------------------------------------------------
#
# Read once, when an engine is built (``stream/engine.py``), as in the
# reference (``skyline_tpu/ops/dispatch.py``). Each plane is host-side
# bookkeeping around work already timed; the answers are the same with any
# of them off.


def freshness_enabled() -> bool:
    """``SKYLINE_FRESHNESS``: the event-time freshness lineage
    (``telemetry/freshness.py``) — per-batch event-time stamps through
    ingest, flush, merge and publish, and the
    ``skyline_freshness_lag_ms{stage=...}`` histograms. On by default."""
    return env_bool("SKYLINE_FRESHNESS", True)


def kernel_profile_enabled() -> bool:
    """``SKYLINE_KERNEL_PROFILE``: the per-dispatch-signature kernel
    profiler (``telemetry/profiler.py``) around every ``flush/merge_kernel``
    dispatch, with a ``kernel/<variant>`` span each. Two clock reads and a
    lock per dispatch; on by default."""
    return env_bool("SKYLINE_KERNEL_PROFILE", True)


def explain_enabled() -> bool:
    """``SKYLINE_EXPLAIN``: one EXPLAIN ``QueryPlan`` per trigger
    (``telemetry/explain.py``), with a telemetry hub. On by default."""
    return env_bool("SKYLINE_EXPLAIN", True)


def audit_enabled() -> bool:
    """``SKYLINE_AUDIT``: the audit plane's counters and ``audit`` block,
    with a telemetry hub. On by default."""
    return env_bool("SKYLINE_AUDIT", True)


def workload_enabled() -> bool:
    """``SKYLINE_WORKLOAD``: the streaming workload characterizer
    (``telemetry/workload.py``) — a stride sample of at most
    ``SKYLINE_WORKLOAD_SAMPLE_CAP`` rows of each ingest batch. On by
    default."""
    return env_bool("SKYLINE_WORKLOAD", True)


def tuner_enabled() -> bool:
    """``SKYLINE_TUNER``: the closed-loop dispatch tuner
    (``telemetry/tuner.py``), with a telemetry hub. It pins only table rows
    with a registered oracle and stays passive until a workload epoch has
    closed and ``SKYLINE_TUNER_EPOCH_S`` has elapsed. On by default."""
    return env_bool("SKYLINE_TUNER", True)


def profile_cost_enabled() -> bool:
    """``SKYLINE_PROFILE_COST``: the kernel profiler also keeps, once per
    signature, the merge step's flops and bytes reckoned from its shapes.
    Off by default."""
    return env_bool("SKYLINE_PROFILE_COST", False)


def env_str(name: str, default=None):
    """The string environment variable ``name``; unset or empty gives
    ``default``."""
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v


# -- the registry ----------------------------------------------------------------
#
# Every environment variable the port reads, with the effective value when it
# is unset (None: the reader branches on its presence). The audit plane's
# repro bundles record each one's set value beside this default
# (``audit/bundle.py`` ``knob_snapshot``). The defaults are the reference's
# (``skyline_tpu/analysis/registry.py``); ``tests/test_torch_audit.py`` holds
# each entry to it and to the literal default at every read site, and this
# table to the set of names the port reads.


class Knob(NamedTuple):
    name: str
    default: object


KNOBS: tuple[Knob, ...] = tuple(
    Knob(n, d)
    for n, d in (
        # the kernels, the flush and the merge plane
        ("SKYLINE_RANK_CASCADE", False),
        ("SKYLINE_STAGE_DEPTH", 1),
        ("SKYLINE_MIXED_PRECISION", None),
        ("SKYLINE_FLUSH_PREFILTER", True),
        ("SKYLINE_MERGE_CACHE", True),
        ("SKYLINE_DELTA_CUTOFF", 0.75),
        ("SKYLINE_MERGE_TREE", True),
        ("SKYLINE_MERGE_PRUNE", True),
        ("SKYLINE_CHIP_PRUNE", True),
        ("SKYLINE_CHIP_BARRIER", "merge"),
        ("SKYLINE_CHIP_MERGE_DEADLINE_MS", 0.0),
        ("SKYLINE_CHIP_MERGE_RETRIES", 1),
        ("SKYLINE_CHIP_MERGE_BACKOFF_MS", 50.0),
        ("SKYLINE_CHIP_HEDGE_MS", 0.0),
        ("SKYLINE_CHIP_FAILOVER", True),
        ("SKYLINE_CHIP_FAILOVER_LOCK_MS", 5000.0),
        ("SKYLINE_CHIP_FAIL_THRESHOLD", 1),
        ("SKYLINE_CHIP_QUARANTINE_SCORE", 0.5),
        ("SKYLINE_CHIP_STRAGGLER_FACTOR", 4.0),
        ("SKYLINE_CHIP_HEARTBEAT_MS", 30000.0),
        ("SKYLINE_FLEET", True),
        ("SKYLINE_FLEET_IMBALANCE_THRESHOLD", 2.0),
        ("SKYLINE_FLEET_RING", 64),
        ("SKYLINE_CLUSTER_HOST_PRUNE", True),
        ("SKYLINE_CLUSTER_MIGRATION_BUDGET", 8),
        ("SKYLINE_CLUSTER_LEASE_TTL_MS", 3000.0),
        ("SKYLINE_CLUSTER_LEASE_RENEW_MS", 0.0),
        # the multi-host mesh (parallel/multihost.py)
        ("SKYLINE_COORDINATOR", None),
        ("SKYLINE_NUM_PROCESSES", None),
        ("SKYLINE_PROCESS_ID", None),
        ("SKYLINE_QUERY_OVERLAP", True),
        ("SKYLINE_SORTED_SFS", "auto"),
        ("SKYLINE_DEVICE_CASCADE", "auto"),
        ("SKYLINE_SORTED_SFS_BLOCK", 8192),
        ("SKYLINE_DEVICE_CASCADE_BLOCK", 2048),
        # the observability plane
        ("SKYLINE_FRESHNESS", True),
        ("SKYLINE_KERNEL_PROFILE", True),
        ("SKYLINE_EXPLAIN", True),
        ("SKYLINE_AUDIT", True),
        ("SKYLINE_WORKLOAD", True),
        ("SKYLINE_TUNER", True),
        ("SKYLINE_PROFILE_COST", False),
        ("SKYLINE_FLIGHT_RING", 256),
        ("SKYLINE_EXPLAIN_RING", 256),
        ("SKYLINE_AUDIT_RING", 256),
        ("SKYLINE_WORKLOAD_SAMPLE_CAP", 512),
        ("SKYLINE_WORKLOAD_EPOCH_ROWS", 4096),
        ("SKYLINE_WORKLOAD_RING", 64),
        ("SKYLINE_WORKLOAD_SUM_RATIO", 0.5),
        ("SKYLINE_WORKLOAD_DRIFT_THRESHOLD", 0.2),
        ("SKYLINE_WORKLOAD_DISP_THRESHOLD", 0.27),
        ("SKYLINE_WORKLOAD_CORR_THRESHOLD", 0.25),
        ("SKYLINE_TUNER_EPOCH_S", 5.0),
        ("SKYLINE_TUNER_MAX_MOVES", 2),
        ("SKYLINE_TUNER_HYSTERESIS", 2),
        ("SKYLINE_TUNER_CUTOFF_STEP", 0.1),
        ("SKYLINE_TUNER_EXPLORE_ON_DRIFT", True),
        ("SKYLINE_SLO_READ_P99_MS", 50.0),
        ("SKYLINE_SLO_FRESH_P99_MS", 5000.0),
        ("SKYLINE_SLO_SHED_FRACTION", 0.05),
        ("SKYLINE_SLO_TENANT_SHED", 0.05),
        ("SKYLINE_SLO_RESTARTS_PER_HOUR", 6.0),
        ("SKYLINE_SLO_AUDIT_DIVERGENCE", 0.0001),
        ("SKYLINE_SLO_DEGRADED_ANSWERS", 0.01),
        ("SKYLINE_SLO_REPLICATION_LAG_P99_MS", 2000.0),
        ("SKYLINE_SLO_PROMOTE_P99_MS", 1000.0),
        ("SKYLINE_SLO_FAST_WINDOW_S", 300.0),
        ("SKYLINE_SLO_SLOW_WINDOW_S", 3600.0),
        # fault injection
        ("SKYLINE_FAULT_PLAN", None),
        ("SKYLINE_FAULT_SLOW_MS", 250.0),
        ("SKYLINE_FAULT_HANG_S", 3600.0),
        # the serving plane
        ("SKYLINE_BODYSTORE_BYTES", 8 << 20),
        ("SKYLINE_BODYSTORE_SLOTS", 512),
        ("SKYLINE_BODYSTORE_KEEP", 4),
        ("SKYLINE_BODYSTORE_RETRIES", 4),
        ("SKYLINE_BODYSTORE_NATIVE", True),
        ("SKYLINE_BODYSTORE_VERIFY", False),
        ("SKYLINE_SERVE_READY_TIMEOUT_S", 10.0),
        ("SKYLINE_SERVE_SHUTDOWN_TIMEOUT_S", 10.0),
        ("SKYLINE_SERVE_HEADER_TIMEOUT_S", 10.0),
        ("SKYLINE_SERVE_SSE_QUEUE", 64),
        ("SKYLINE_CLUSTERVIEW_MEMBERS", None),
        ("SKYLINE_CLUSTERVIEW_TIMEOUT_S", 2.0),
        ("SKYLINE_CLUSTERVIEW_OPS_TAIL", 64),
        # the read replicas
        ("SKYLINE_REPLICA_MAX_STALE_MS", 30000.0),
        ("SKYLINE_REPLICA_POLL_MS", 25.0),
        # the audit plane
        ("SKYLINE_AUDIT_SAMPLE", 1.0),
        ("SKYLINE_AUDIT_CANARY_S", 300.0),
        ("SKYLINE_AUDIT_DIR", "artifacts/audit"),
        ("SKYLINE_AUDIT_ORACLE", "sorted"),
        # the transport (kafkalite)
        ("SKYLINE_KAFKA_RETRIES", 5),
        ("SKYLINE_KAFKA_BACKOFF_S", 0.05),
        # the worker's body store, the WAL, the supervisor and the ops journal
        ("SKYLINE_BODYSTORE", True),
        ("SKYLINE_WAL_TAILER_TTL_S", 600.0),
        ("SKYLINE_SUPERVISOR_MAX_RESTARTS", 5),
        ("SKYLINE_SUPERVISOR_BACKOFF_S", 0.5),
        ("SKYLINE_SUPERVISOR_BACKOFF_CAP_S", 30.0),
        ("SKYLINE_OPSLOG", True),
        ("SKYLINE_OPSLOG_FSYNC", 'off'),
        ("SKYLINE_OPSLOG_MAX_BYTES", 8_388_608),
        # the job's flags (utils/config.py), each the JobConfig field's default
        ("SKYLINE_PARALLELISM", 4),
        ("SKYLINE_ALGO", 'mr-angle'),
        ("SKYLINE_INPUT_TOPIC", 'input-tuples'),
        ("SKYLINE_QUERY_TOPIC", 'queries'),
        ("SKYLINE_OUTPUT_TOPIC", 'output-skyline'),
        ("SKYLINE_DOMAIN", 1000.0),
        ("SKYLINE_DIMS", 2),
        ("SKYLINE_BOOTSTRAP", 'localhost:9092'),
        ("SKYLINE_BUFFER_SIZE", 4096),
        ("SKYLINE_EMIT_SKYLINE_POINTS", False),
        ("SKYLINE_QUERY_TIMEOUT_MS", 0.0),
        ("SKYLINE_GRID_PREFILTER", False),
        ("SKYLINE_INITIAL_CAPACITY", 0),
        ("SKYLINE_FLUSH_POLICY", 'incremental'),
        ("SKYLINE_OVERLAP_ROWS", 262144),
        ("SKYLINE_INGEST", 'auto'),
        ("SKYLINE_MESH", 0),
        ("SKYLINE_MESH_CHIPS", 0),
        ("SKYLINE_CLUSTER_HOSTS", 0),
        ("SKYLINE_STATS_PORT", 0),
        ("SKYLINE_WINDOW", 0),
        ("SKYLINE_SLIDE", 0),
        ("SKYLINE_EMIT_PER_SLIDE", False),
        ("SKYLINE_MAX_DRAIN_POLLS", 256),
        ("SKYLINE_SERVE", -1),
        ("SKYLINE_SERVE_READ_RATE", 0.0),
        ("SKYLINE_SERVE_READ_BURST", 256),
        ("SKYLINE_SERVE_MAX_QUERIES", 2),
        ("SKYLINE_SERVE_QUERY_QUEUE", 8),
        ("SKYLINE_SERVE_QUERY_DEADLINE_MS", 10000.0),
        ("SKYLINE_SERVE_DELTA_RING", 128),
        ("SKYLINE_SERVE_HISTORY", 64),
        ("SKYLINE_SERVE_READ_CACHE", 64),
        ("SKYLINE_SERVE_TENANT_RATE", 0.0),
        ("SKYLINE_SERVE_TENANT_BURST", 64),
        ("SKYLINE_REPLICAS", 0),
        ("SKYLINE_REPLICA_OF", ''),
        ("SKYLINE_TRACE_OUT", ''),
        ("SKYLINE_TRACE_RING", 4096),
        ("SKYLINE_JAX_PROFILE_DIR", ''),
        ("SKYLINE_CHECKPOINT_DIR", ''),
        ("SKYLINE_CHECKPOINT_INTERVAL_S", 30.0),
        ("SKYLINE_CHECKPOINT_RETAIN", 3),
        ("SKYLINE_WAL_FSYNC", 'batch'),
        ("SKYLINE_WAL_SEGMENT_BYTES", 4_194_304),
    )
)

"""Environment knobs of the port: the registry and its accessors.

The port's copy of the JAX package's registry
(``skyline_tpu/analysis/registry.py``): every environment variable the
port reads is declared once in ``KNOBS`` (name, type, default,
applicability, RUNBOOK anchor), and ``env_str``, ``env_bool``, ``env_int``
and ``env_float`` are the only readers. An accessor refuses an undeclared
name with ``LookupError``, as the reference's do; the knob lint
(``skyline_tpu_torch/analysis/knob_lint.py``) checks the same names
statically. Knobs are read lazily, when a flush or a merge runs, never at
import.

Parsing, as in the reference: a boolean's ``0/false/no/off`` (any case)
are False, ``1/true/yes/on`` True, unset or empty means the call site's
default and anything else warns once and means it too; an unparsable int
or float warns once and means the default.

This module stays stdlib-only: the transport's processes read knobs
without torch.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

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


def _warn_once(name: str, raw: str, why: str, stacklevel: int) -> None:
    """Warn once per knob; ``stacklevel`` points at the accessor's caller."""
    if name not in _warned:
        _warned.add(name)
        warnings.warn(f"ignoring {name}={raw!r}: {why}; using the default",
                      stacklevel=stacklevel)


def _raw(name: str) -> str | None:
    knob(name)  # an undeclared read fails fast, even at runtime
    return os.environ.get(name)


def env_str(name: str, default=None):
    """The string knob ``name``; unset or empty gives ``default``."""
    v = _raw(name)
    if v is None or v == "":
        return default
    return v


def env_bool(name: str, default=False):
    """The boolean knob ``name``; an unrecognised value warns once and
    gives ``default``."""
    v = _raw(name)
    if v is not None and v.strip() != "":
        s = v.strip().lower()
        if s not in _FALSY and s not in _TRUTHY:
            _warn_once(name, v, "not a recognized boolean", 3)
    return parse_bool(v, default)


def _env_parsed(name: str, default, parse, what: str):
    """The knob ``name`` read by ``parse``; an unset or blank value gives
    ``default``, an unparsable one warns once (it is not ``what``) and
    gives ``default``."""
    v = _raw(name)
    if v is None or v.strip() == "":
        return default
    try:
        return parse(v)
    except ValueError:
        _warn_once(name, v, f"not {what}", 4)
        return default


def env_int(name: str, default=0):
    """The integer knob ``name``."""
    return _env_parsed(name, default, int, "an integer")


def env_float(name: str, default=0.0):
    """The float knob ``name``."""
    return _env_parsed(name, default, float, "a number")


# accessor names the knob lint recognizes as sanctioned read sites
ACCESSORS = ("env_str", "env_bool", "env_int", "env_float")


def is_set(name: str) -> bool:
    """True when the environment sets the declared knob ``name`` to a
    non-blank value (for a reader whose precedence depends on presence)."""
    v = _raw(name)
    return v is not None and v.strip() != ""


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


def sorted_sfs_mode() -> str:
    """``SKYLINE_SORTED_SFS``: the host sorted-order SFS cascade
    (``ops/sorted_sfs.py``) at d > 2. ``auto`` (the default) races it
    against the other candidates on measured walls, ``on`` forces it,
    ``off`` excludes it. Host numpy, so only concrete calls on the CPU
    ever take it. Any other value reads as ``auto``, as the reference's
    readers do (``skyline_tpu/ops/dispatch.py``)."""
    v = env_str("SKYLINE_SORTED_SFS", "auto")
    return v if v in ("auto", "on", "off") else "auto"


def device_cascade_mode() -> str:
    """``SKYLINE_DEVICE_CASCADE``: the device sorted dominance cascade
    (``ops/device_cascade.py``). ``auto`` (the default) races it on
    measured walls — concrete calls explore and record, merge-time calls
    swap it in only on evidence already measured — ``on`` forces it
    everywhere, ``off`` excludes it. Any other value reads as ``auto``."""
    v = env_str("SKYLINE_DEVICE_CASCADE", "auto")
    return v if v in ("auto", "on", "off") else "auto"


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


# -- the registry ----------------------------------------------------------------
#
# Every environment variable the port reads, with the effective value when it
# is unset (None: the reader branches on its presence). The audit plane's
# repro bundles record each one's set value beside this default
# (``audit/bundle.py`` ``knob_snapshot``). The declarations are the
# reference's (``skyline_tpu/analysis/registry.py``), the descriptions the
# port's; ``tests/test_torch_audit.py`` holds each default to the reference's
# and to the literal default at every read site, and this table to the set of
# names the port reads; ``--knob-doc`` writes it to ``docs/KNOBS_TORCH.md``.


@dataclass(frozen=True)
class Knob:
    """One declared runtime knob, with the reference's fields.

    ``default`` is the effective value when the variable is unset (None:
    the call site branches on presence, e.g. ``SKYLINE_MIXED_PRECISION``'s
    device-dependent auto). ``job_field`` names the ``JobConfig`` field a
    flag-backed knob defaults from. ``external`` marks a variable another
    system owns: read through the accessor, exempt from the dead-knob
    check."""

    name: str
    type: str  # bool | int | float | str | enum
    default: object
    description: str
    applies_to: str
    runbook: str = ""
    choices: tuple = ()
    job_field: str = ""
    external: bool = False

    def __post_init__(self):
        if self.type not in ("bool", "int", "float", "str", "enum"):
            raise ValueError(f"{self.name}: bad type {self.type!r}")
        if self.type == "enum" and not self.choices:
            raise ValueError(f"{self.name}: enum knob needs choices")


def _k(name, type, default, description, applies_to, **kw) -> Knob:
    return Knob(name, type, default, description, applies_to, **kw)


KNOBS: tuple[Knob, ...] = (
    # the kernels, the flush and the merge plane
    _k('SKYLINE_RANK_CASCADE', 'bool', False,
       'dense-rank dominance cascade (K4-K7) for the device-ingest flush '
       'and the global merge (default off, as in the reference)',
       'engine/cuda', runbook='§2'),
    _k('SKYLINE_STAGE_DEPTH', 'int', 1,
       'flush rounds staged ahead of the in-flight merge kernel (0 = no '
       'staging, 1 = double buffering)',
       'engine', runbook='§2e'),
    _k('SKYLINE_MIXED_PRECISION', 'bool', None,
       "bf16 margin passes of the flush (the row pre-drop and the kernels' "
       'bf16 first pass, K1-K3 mp); unset = auto (on for a CUDA card, off '
       'on the CPU)',
       'engine', runbook='§2g'),
    _k('SKYLINE_FLUSH_PREFILTER', 'bool', True,
       'quantized-grid host prefilter ahead of the flush merge kernels',
       'engine', runbook='§2g'),
    _k('SKYLINE_MERGE_CACHE', 'bool', True,
       'epoch-keyed global-merge result cache (repeated triggers launch '
       'zero kernels)',
       'engine', runbook='§2e'),
    _k('SKYLINE_DELTA_CUTOFF', 'float', 0.75,
       'max dirty-partition fraction for the delta-merge path; above it '
       'the full union merge runs',
       'engine', runbook='§2e'),
    _k('SKYLINE_MERGE_TREE', 'bool', True,
       'pruned tournament-tree global merge for d > 2 (0 = flat union '
       'merge, the A/B baseline)',
       'engine', runbook='§2f'),
    _k('SKYLINE_MERGE_PRUNE', 'bool', True,
       'witness-dominance partition prefilter ahead of the tree merge',
       'engine', runbook='§2f'),
    _k('SKYLINE_CHIP_PRUNE', 'bool', True,
       "chip-level witness prefilter in the sharded engine's two-level "
       'merge (a dominated chip never crosses the interconnect)',
       'engine/sharded', runbook='§2n'),
    _k('SKYLINE_CHIP_BARRIER', 'enum', 'merge',
       'when the sharded engine writes chip-consistency barrier records: '
       'merge (every two-level merge), checkpoint (checkpoint time only), '
       'off (no chip WAL plane)',
       'engine/sharded', runbook='§2n', choices=('merge', 'checkpoint', 'off')),
    _k('SKYLINE_CHIP_MERGE_DEADLINE_MS', 'float', 0.0,
       'per-chip level-1 merge deadline in the sharded tournament; a chip '
       'that misses it is excluded and the answer publishes marked partial '
       '(0 = unbounded, the byte-identity default)',
       'engine/sharded', runbook='§2p'),
    _k('SKYLINE_CHIP_MERGE_RETRIES', 'int', 1,
       'bounded retries per chip inside the merge deadline (transient '
       'faults get a second chance before exclusion)',
       'engine/sharded', runbook='§2p'),
    _k('SKYLINE_CHIP_MERGE_BACKOFF_MS', 'float', 50.0,
       'base backoff between per-chip merge retries (doubles per attempt)',
       'engine/sharded', runbook='§2p'),
    _k('SKYLINE_CHIP_HEDGE_MS', 'float', 0.0,
       'straggler hedge: launch a second attempt for a chip still running '
       'after this many ms (0 = no hedging)',
       'engine/sharded', runbook='§2p'),
    _k('SKYLINE_CHIP_FAILOVER', 'bool', True,
       "online partition-group failover: a quarantined chip's group is re- "
       'owned by a healthy chip at the next merge launch',
       'engine/sharded', runbook='§2p'),
    _k('SKYLINE_CHIP_FAILOVER_LOCK_MS', 'float', 5000.0,
       "bounded wait for a chip's merge lock before failover captures its "
       'group state (an in-flight merge attempt must drain first; past the '
       'bound failover defers to the next tick)',
       'engine/sharded', runbook='§2p'),
    _k('SKYLINE_CHIP_FAIL_THRESHOLD', 'int', 1,
       'consecutive per-chip merge failures/timeouts before quarantine',
       'resilience', runbook='§2p'),
    _k('SKYLINE_CHIP_QUARANTINE_SCORE', 'float', 0.5,
       'health score below which a chip quarantines (scores decay on '
       'failure/straggle, recover on clean merges)',
       'resilience', runbook='§2p'),
    _k('SKYLINE_CHIP_STRAGGLER_FACTOR', 'float', 4.0,
       "a chip's level-1 wall beyond this multiple of the peer-EMA median "
       'counts as a straggle (after a warmup of clean merges)',
       'resilience', runbook='§2p'),
    _k('SKYLINE_CHIP_HEARTBEAT_MS', 'float', 30000.0,
       'per-chip heartbeat staleness limit for the health tick (relative: '
       'the whole fleet idling does not quarantine anyone)',
       'resilience', runbook='§2p'),
    _k('SKYLINE_FLEET', 'bool', True,
       'per-chip fleet plane on the sharded engine: skyline_chip_* labeled '
       'metric families, imbalance index + skew ring, per-chip tournament '
       'spans, and GET /fleet',
       'telemetry', runbook='§2o'),
    _k('SKYLINE_FLEET_IMBALANCE_THRESHOLD', 'float', 2.0,
       'imbalance index (max/mean chip ingest load) above which a '
       'fleet.imbalance flight-recorder entry fires (edge-triggered per '
       'excursion)',
       'telemetry', runbook='§2o'),
    _k('SKYLINE_FLEET_RING', 'int', 64,
       'rolling skew ring capacity (per-merge imbalance samples behind the '
       'skew score)',
       'telemetry', runbook='§2o'),
    _k('SKYLINE_CLUSTER_HOST_PRUNE', 'bool', True,
       'host-level witness prefilter in the cluster merge: a host whose '
       'summary is witness-dominated ships zero rows to the coordinator '
       '(byte-identical either way)',
       'cluster', runbook='§2r'),
    _k('SKYLINE_CLUSTER_MIGRATION_BUDGET', 'int', 8,
       'max live partition-group migrations between hosts per coordinator '
       'lifetime (drain/checkpoint-slice/restore/fence cycles); guards '
       'against health-signal flapping thrashing state',
       'cluster', runbook='§2r'),
    _k('SKYLINE_CLUSTER_LEASE_TTL_MS', 'float', 3000.0,
       'write-lease time-to-live: the primary must renew within this '
       'window or the ClusterSupervisor fences its epoch and promotes the '
       'most-caught-up replica',
       'cluster', runbook='§2r'),
    _k('SKYLINE_CLUSTER_LEASE_RENEW_MS', 'float', 0.0,
       'primary lease renew cadence (0 = TTL/3); must be well under the '
       'TTL or the primary deposes itself',
       'cluster', runbook='§2r'),
    # the multi-host mesh (parallel/multihost.py)
    _k('SKYLINE_COORDINATOR', 'str', None,
       'torch.distributed rendezvous address (host:port) for multi-host '
       'runs',
       'parallel/multihost'),
    _k('SKYLINE_NUM_PROCESSES', 'int', None,
       'torch.distributed world size (None = not set)',
       'parallel/multihost'),
    _k('SKYLINE_PROCESS_ID', 'int', None,
       'torch.distributed rank of this process (None = not set)',
       'parallel/multihost'),
    _k('SKYLINE_QUERY_OVERLAP', 'bool', True,
       'overlapped query sync: launch the global merge at trigger time, '
       'harvest at emission',
       'engine', runbook='§2f'),
    _k('SKYLINE_SORTED_SFS', 'enum', 'auto',
       'host sorted-order SFS dominance cascade for d>2 (CPU tensors '
       'only): auto (per-(d,N,backend) choice from measured KernelProfiler '
       'wall data), on (force the sorted host path), off (device kernels '
       'only)',
       'engine', runbook='§2m', choices=('auto', 'on', 'off')),
    _k('SKYLINE_DEVICE_CASCADE', 'enum', 'auto',
       'device-side sorted dominance cascade (card and merge-time call '
       'sites): auto (per-(d,N,backend,mp) choice from measured '
       'KernelProfiler wall data; merge-time calls swap only on evidence '
       'already measured), on (force the cascade everywhere), off '
       '(quadratic kernels only)',
       'engine', runbook='§2t', choices=('auto', 'on', 'off')),
    _k('SKYLINE_SORTED_SFS_BLOCK', 'int', 8192,
       'max scan-block width of the sorted SFS cascade (the exact in-block '
       'pairwise tile; blocks start at 1024 and double up to this)',
       'engine', runbook='§2m'),
    _k('SKYLINE_DEVICE_CASCADE_BLOCK', 'int', 2048,
       'scan block size of the device cascade (buffer chunks, in-block '
       'pairwise tiles, and ambiguous-band tiles; rounded up to a power of '
       'two, at least 8)',
       'engine', runbook='§2t'),
    # the observability plane
    _k('SKYLINE_FRESHNESS', 'bool', True,
       'event-time freshness lineage: per-stage lag histograms '
       '(ingest/flush/merge/publish/read) and staleness_ms on /skyline',
       'telemetry', runbook='§2j'),
    _k('SKYLINE_KERNEL_PROFILE', 'bool', True,
       'per-dispatch-signature kernel profiler behind GET /profile',
       'telemetry', runbook='§2j'),
    _k('SKYLINE_EXPLAIN', 'bool', True,
       'per-query EXPLAIN plane: a causal QueryPlan per trigger (merge '
       'path, prune witnesses, cascade + kernel attribution, publish '
       'watermark) behind GET /explain and /skyline?explain=1',
       'telemetry', runbook='§2k'),
    _k('SKYLINE_AUDIT', 'bool', True,
       'online audit plane: sampled shadow verification of published '
       'snapshots against the host oracle, divergence repro bundles, and '
       'correctness canaries behind GET /audit',
       'audit', runbook='§2l'),
    _k('SKYLINE_WORKLOAD', 'bool', True,
       'streaming workload characterizer: per-dim quantile sketches, '
       'correlation estimate, uniform/correlated/anti_correlated '
       'classification, drift detection; the regime tag on every EXPLAIN '
       'plan',
       'telemetry', runbook='§2o'),
    _k('SKYLINE_TUNER', 'bool', True,
       'closed-loop dispatch tuner over the cascade table: pins measured '
       'EMA winners per signature and retunes table-scoped knobs per '
       'workload regime (0 = static dispatch, the A/B baseline)',
       'engine', runbook='§2v'),
    _k('SKYLINE_PROFILE_COST', 'bool', False,
       "keep the merge step's FLOPs and bytes, reckoned from its shapes, "
       'once per kernel-profiler signature',
       'telemetry', runbook='§2j'),
    _k('SKYLINE_FLIGHT_RING', 'int', 256,
       'flight-recorder ring capacity (last N engine decisions, '
       '/debug/flight and the crash dump)',
       'telemetry', runbook='§2j'),
    _k('SKYLINE_EXPLAIN_RING', 'int', 256,
       'EXPLAIN plan ring capacity (last N finalized query plans)',
       'telemetry', runbook='§2k'),
    _k('SKYLINE_AUDIT_RING', 'int', 256,
       'audit check-record ring capacity (last N verdicts on /audit)',
       'audit', runbook='§2l'),
    _k('SKYLINE_WORKLOAD_SAMPLE_CAP', 'int', 512,
       'max rows sampled per ingest batch (deterministic stride, no RNG)',
       'telemetry', runbook='§2o'),
    _k('SKYLINE_WORKLOAD_EPOCH_ROWS', 'int', 4096,
       'sampled rows per characterizer epoch (classification + drift check '
       'cadence)',
       'telemetry', runbook='§2o'),
    _k('SKYLINE_WORKLOAD_RING', 'int', 64,
       'epoch-summary and query-trajectory ring capacity',
       'telemetry', runbook='§2o'),
    _k('SKYLINE_WORKLOAD_SUM_RATIO', 'float', 0.5,
       'row-sum variance ratio below which the stream classifies '
       'anti_correlated (constant-sum band; 1.0 = independent dims)',
       'telemetry', runbook='§2o'),
    _k('SKYLINE_WORKLOAD_DRIFT_THRESHOLD', 'float', 0.2,
       'per-dim p50 shift (normalized by the frozen sketch range) beyond '
       'which consecutive epochs count as drift',
       'telemetry', runbook='§2o'),
    _k('SKYLINE_WORKLOAD_DISP_THRESHOLD', 'float', 0.27,
       'within-row coefficient-of-variation above which a positively '
       'correlated stream reclassifies as wide-band anti_correlated '
       '(shared per-row scale)',
       'telemetry', runbook='§2o'),
    _k('SKYLINE_WORKLOAD_CORR_THRESHOLD', 'float', 0.25,
       'mean pairwise correlation above which the stream classifies '
       'correlated (subject to the dispersion tiebreak)',
       'telemetry', runbook='§2o'),
    _k('SKYLINE_TUNER_EPOCH_S', 'float', 5.0,
       'min seconds between controller epochs (the tuner is also passive '
       'until the first workload epoch closes)',
       'engine', runbook='§2v'),
    _k('SKYLINE_TUNER_MAX_MOVES', 'int', 2,
       'max pin/knob moves per controller epoch (bounded-move rule)',
       'engine', runbook='§2v'),
    _k('SKYLINE_TUNER_HYSTERESIS', 'int', 2,
       'consecutive controller epochs a new workload regime must persist '
       'before the tuner switches context (drift-flip damping)',
       'engine', runbook='§2v'),
    _k('SKYLINE_TUNER_CUTOFF_STEP', 'float', 0.1,
       'max delta-cutoff movement per controller epoch when steering '
       'toward the observed dirty-fraction quantile',
       'engine', runbook='§2v'),
    _k('SKYLINE_TUNER_EXPLORE_ON_DRIFT', 'bool', True,
       'on a confirmed regime switch with no banked state, reset the '
       'mask/flush profiler signatures so the variant race re-runs under '
       'the new distribution',
       'engine', runbook='§2v'),
    _k('SKYLINE_SLO_READ_P99_MS', 'float', 50.0,
       'SLO target: serve read p99 latency threshold',
       'telemetry/slo', runbook='§2j'),
    _k('SKYLINE_SLO_FRESH_P99_MS', 'float', 5000.0,
       'SLO target: read-stage freshness lag p99 threshold',
       'telemetry/slo', runbook='§2j'),
    _k('SKYLINE_SLO_SHED_FRACTION', 'float', 0.05,
       'SLO target: max fraction of snapshot reads shed by admission',
       'telemetry/slo', runbook='§2j'),
    _k('SKYLINE_SLO_TENANT_SHED', 'float', 0.05,
       'SLO target: max fraction of tenant-attributed read attempts shed '
       'by the per-tenant buckets',
       'telemetry/slo', runbook='§2q'),
    _k('SKYLINE_SLO_RESTARTS_PER_HOUR', 'float', 6.0,
       'SLO target: supervised-restart rate ceiling',
       'telemetry/slo', runbook='§2j'),
    _k('SKYLINE_SLO_AUDIT_DIVERGENCE', 'float', 0.0001,
       'SLO target: max fraction of audited snapshots diverging from the '
       'host oracle',
       'telemetry/slo', runbook='§2l'),
    _k('SKYLINE_SLO_DEGRADED_ANSWERS', 'float', 0.01,
       'SLO target: max fraction of answered queries published chip- '
       'degraded (marked partial)',
       'telemetry/slo', runbook='§2p'),
    _k('SKYLINE_SLO_REPLICATION_LAG_P99_MS', 'float', 2000.0,
       'SLO target: 99% of replica WAL-fold applications land within this '
       "many ms of the frame's publish time (the staleness a failover "
       'would inherit)',
       'telemetry/slo', runbook='§2s'),
    _k('SKYLINE_SLO_PROMOTE_P99_MS', 'float', 1000.0,
       'SLO target: 99% of supervisor promotions (fence raise to replica '
       'serving) complete within this many ms',
       'telemetry/slo', runbook='§2s'),
    _k('SKYLINE_SLO_FAST_WINDOW_S', 'float', 300.0,
       'fast burn-rate window for the /slo evaluation',
       'telemetry/slo', runbook='§2j'),
    _k('SKYLINE_SLO_SLOW_WINDOW_S', 'float', 3600.0,
       'slow burn-rate window for the /slo evaluation',
       'telemetry/slo', runbook='§2j'),
    # fault injection
    _k('SKYLINE_FAULT_PLAN', 'str', None,
       'deterministic fault-injection plan, e.g. crash@flush.pre_merge:3 '
       '(comma-separated action@point:nth clauses; actions: crash, exit, '
       'corrupt, slow, hang; chip-scopable as point#chip; test/chaos use '
       'only)',
       'resilience', runbook='§2i'),
    _k('SKYLINE_FAULT_SLOW_MS', 'float', 250.0,
       'injected delay of a slow@ fault clause',
       'resilience', runbook='§2p'),
    _k('SKYLINE_FAULT_HANG_S', 'float', 3600.0,
       'cap on a hang@ fault clause (the hung thread parks on an event '
       'released by faults.clear())',
       'resilience', runbook='§2p'),
    # the serving plane
    _k('SKYLINE_BODYSTORE_BYTES', 'int', 8388608,
       'body-store data ring capacity in bytes; bodies larger than this '
       'skip the mmap (in-process retained bytes still serve them)',
       'serve', runbook='§2u'),
    _k('SKYLINE_BODYSTORE_SLOTS', 'int', 512,
       'body-store directory slots ((version, format) keys live at '
       '(version*5+fmt) mod slots)',
       'serve', runbook='§2u'),
    _k('SKYLINE_BODYSTORE_KEEP', 'int', 4,
       'snapshot versions whose wire bodies the primary retains in-process '
       '(zero-copy dict hits; older versions fall through to the mmap '
       'ring)',
       'serve', runbook='§2u'),
    _k('SKYLINE_BODYSTORE_RETRIES', 'int', 4,
       'bounded seqlock retries per body-store read before declaring a '
       'miss and falling back to Python serialization',
       'serve', runbook='§2u'),
    _k('SKYLINE_BODYSTORE_NATIVE', 'bool', True,
       'use the native sky_format_rows row serializer for body encoding (0 '
       'forces the byte-identical pure-Python encoders)',
       'serve', runbook='§2u'),
    _k('SKYLINE_BODYSTORE_VERIFY', 'bool', False,
       'verify EVERY native-encoded body against the Python encoder '
       '(default verifies only the first per process); mismatch disables '
       'the native path',
       'serve', runbook='§2u'),
    _k('SKYLINE_SERVE_READY_TIMEOUT_S', 'float', 10.0,
       'startup wait for the serving loop to bind its socket',
       'serve', runbook='§2d'),
    _k('SKYLINE_SERVE_SHUTDOWN_TIMEOUT_S', 'float', 10.0,
       'close() wait for the serving loop thread to drain',
       'serve', runbook='§2d'),
    _k('SKYLINE_SERVE_HEADER_TIMEOUT_S', 'float', 10.0,
       'per-connection wait for a complete request header block',
       'serve', runbook='§2d'),
    _k('SKYLINE_SERVE_SSE_QUEUE', 'int', 64,
       'per-subscriber event queue for GET /subscribe; a subscriber that '
       'falls further behind is drained and sent a resync event',
       'serve', runbook='§2q'),
    _k('SKYLINE_CLUSTERVIEW_MEMBERS', 'str', None,
       'comma-separated member base URLs the fleet-wide aggregation view '
       'scrapes for GET /cluster/overview (and the clusterview CLI '
       'default)',
       'telemetry/ops', runbook='§2s'),
    _k('SKYLINE_CLUSTERVIEW_TIMEOUT_S', 'float', 2.0,
       "per-request timeout when the clusterview scraper polls a member's "
       '/metrics, /cluster, /healthz, /ops',
       'telemetry/ops', runbook='§2s'),
    _k('SKYLINE_CLUSTERVIEW_OPS_TAIL', 'int', 64,
       'ops-journal records the clusterview scraper pulls per member '
       "(?limit= on each member's /ops)",
       'telemetry/ops', runbook='§2s'),
    # the read replicas
    _k('SKYLINE_REPLICA_MAX_STALE_MS', 'float', 30000.0,
       'replica staleness fence: reads whose snapshot is older than this '
       'are refused with 503 + Retry-After instead of served silently '
       'stale',
       'serve', runbook='§2q'),
    _k('SKYLINE_REPLICA_POLL_MS', 'float', 25.0,
       'replica WAL tail poll interval when no new frames are available',
       'serve', runbook='§2q'),
    # the audit plane
    _k('SKYLINE_AUDIT_SAMPLE', 'float', 1.0,
       'fraction of published snapshots shadow-verified (deterministic '
       'accumulator, not random; 0 disables organic checks)',
       'audit', runbook='§2l'),
    _k('SKYLINE_AUDIT_CANARY_S', 'float', 300.0,
       'seconds between synthetic known-answer canary sweeps over every '
       'merge path while the worker is idle (0 = off)',
       'audit', runbook='§2l'),
    _k('SKYLINE_AUDIT_DIR', 'str', 'artifacts/audit',
       'divergence repro-bundle directory (checkpoint + WAL slice + '
       'EXPLAIN plan + knob snapshot + both skylines)',
       'audit', runbook='§2l'),
    _k('SKYLINE_AUDIT_ORACLE', 'enum', 'sorted',
       'host oracle the auditor verifies answers against: sorted (dedup + '
       'sum-sorted scan, full-rate affordable) or quadratic (the O(n²d) '
       'oracle-of-the-oracle kept for tests)',
       'audit', runbook='§2l', choices=('sorted', 'quadratic')),
    # the transport (kafkalite)
    _k('SKYLINE_KAFKA_RETRIES', 'int', 5,
       'kafkalite transport reconnect attempts per request',
       'bridge', runbook='§2i'),
    _k('SKYLINE_KAFKA_BACKOFF_S', 'float', 0.05,
       'base kafkalite reconnect backoff (doubles per attempt)',
       'bridge', runbook='§2i'),
    # the worker's body store, the WAL, the supervisor and the ops journal
    _k('SKYLINE_BODYSTORE', 'bool', True,
       'zero-copy body store: serialize wire bodies once at publish time '
       'and serve them via fence-checked buffer handoffs (primary retained '
       "bytes; replicas map the primary's bodystore.dat)",
       'serve', runbook='§2u'),
    _k('SKYLINE_WAL_TAILER_TTL_S', 'float', 600.0,
       'staleness TTL on replica tail acks: barrier() keeps segments a '
       "live tailer hasn't consumed, but an ack older than this stops "
       'pinning retention (dead replica protection)',
       'resilience', runbook='§2q'),
    _k('SKYLINE_SUPERVISOR_MAX_RESTARTS', 'int', 5,
       'supervised-restart budget before giving up',
       'resilience', runbook='§2i'),
    _k('SKYLINE_SUPERVISOR_BACKOFF_S', 'float', 0.5,
       'base restart backoff (doubles per crash, plus jitter)',
       'resilience', runbook='§2i'),
    _k('SKYLINE_SUPERVISOR_BACKOFF_CAP_S', 'float', 30.0,
       'restart backoff ceiling',
       'resilience', runbook='§2i'),
    _k('SKYLINE_OPSLOG', 'bool', True,
       'durable cross-process ops journal beside the WAL: control-plane '
       'transitions '
       '(lease/fence/promote/demote/quarantine/migrate/degraded publish) '
       'as CRC-framed records, GET /ops on both HTTP surfaces',
       'telemetry/ops', runbook='§2s'),
    _k('SKYLINE_OPSLOG_FSYNC', 'enum', 'off',
       "ops-journal durability policy: 'off' relies on one unbuffered "
       "write per record (survives process death), 'always' fsyncs every "
       "record (power-loss durable, ~ms each), 'batch' fsyncs on flush()",
       'telemetry/ops', runbook='§2s', choices=('always', 'batch', 'off')),
    _k('SKYLINE_OPSLOG_MAX_BYTES', 'int', 8388608,
       'per-incarnation ops-journal size cap; past it records are dropped '
       'and counted (ops.dropped), never raised',
       'telemetry/ops', runbook='§2s'),
    # the job's flags (utils/config.py), each the JobConfig field's default
    _k('SKYLINE_PARALLELISM', 'int', 4,
       'worker parallelism',
       'job flag', job_field='parallelism'),
    _k('SKYLINE_ALGO', 'str', 'mr-angle',
       'partitioner algorithm',
       'job flag', job_field='algo'),
    _k('SKYLINE_INPUT_TOPIC', 'str', 'input-tuples',
       'input topic',
       'job flag', job_field='input_topic'),
    _k('SKYLINE_QUERY_TOPIC', 'str', 'queries',
       'query topic',
       'job flag', job_field='query_topic'),
    _k('SKYLINE_OUTPUT_TOPIC', 'str', 'output-skyline',
       'output topic',
       'job flag', job_field='output_topic'),
    _k('SKYLINE_DOMAIN', 'float', 1000.0,
       'domain max per dimension',
       'job flag', job_field='domain'),
    _k('SKYLINE_DIMS', 'int', 2,
       'tuple dimensionality',
       'job flag', job_field='dims'),
    _k('SKYLINE_BOOTSTRAP', 'str', 'localhost:9092',
       'Kafka bootstrap address',
       'job flag', job_field='bootstrap'),
    _k('SKYLINE_BUFFER_SIZE', 'int', 4096,
       'per-partition buffer size',
       'job flag', job_field='buffer_size'),
    _k('SKYLINE_EMIT_SKYLINE_POINTS', 'bool', False,
       'include skyline points in result JSON',
       'job flag', job_field='emit_skyline_points'),
    _k('SKYLINE_QUERY_TIMEOUT_MS', 'float', 0.0,
       'finalize overdue queries as partial results (0 = wait forever)',
       'job flag', job_field='query_timeout_ms'),
    _k('SKYLINE_GRID_PREFILTER', 'bool', False,
       "domain-midpoint dominance prefilter (the reference's disabled "
       'GridDominanceFilter, barrier-safe)',
       'job flag', job_field='grid_prefilter'),
    _k('SKYLINE_INITIAL_CAPACITY', 'int', 0,
       'pre-size per-partition skyline buffers',
       'job flag', job_field='initial_capacity'),
    _k('SKYLINE_FLUSH_POLICY', 'enum', 'incremental',
       'flush policy',
       'job flag', choices=('incremental', 'lazy', 'overlap'), job_field='flush_policy'),
    _k('SKYLINE_OVERLAP_ROWS', 'int', 262144,
       'rows between automatic flushes under flush-policy overlap',
       'job flag', job_field='overlap_rows'),
    _k('SKYLINE_INGEST', 'enum', 'auto',
       'where routing/sort/block assembly runs',
       'job flag', choices=('auto', 'host', 'device'), job_field='ingest'),
    _k('SKYLINE_MESH', 'int', 0,
       'shard partitions over this many devices (0 = single device)',
       'job flag', job_field='mesh'),
    _k('SKYLINE_MESH_CHIPS', 'int', 0,
       'sharded streaming engine: split partitions into this many per-chip '
       'groups with a two-level tournament merge (0 = single device)',
       'job flag', runbook='§2n', job_field='mesh_chips'),
    _k('SKYLINE_CLUSTER_HOSTS', 'int', 0,
       'multi-host cluster ingest: partition the stream across this many '
       'host-level partition groups with a third (host) tournament merge '
       'level (0 = single host)',
       'job flag', runbook='§2r', job_field='cluster_hosts'),
    _k('SKYLINE_STATS_PORT', 'int', 0,
       'serve live /stats JSON on this port (0 = off)',
       'job flag', runbook='§2b', job_field='stats_port'),
    _k('SKYLINE_WINDOW', 'int', 0,
       'sliding-window size in tuples (0 = unbounded)',
       'job flag', runbook='§2c', job_field='window_size'),
    _k('SKYLINE_SLIDE', 'int', 0,
       'slide in tuples (with SKYLINE_WINDOW)',
       'job flag', runbook='§2c', job_field='slide'),
    _k('SKYLINE_EMIT_PER_SLIDE', 'bool', False,
       'emit one result JSON per completed slide',
       'job flag', runbook='§2c', job_field='emit_per_slide'),
    _k('SKYLINE_MAX_DRAIN_POLLS', 'int', 256,
       'cap on trigger-pending data re-polls per worker step',
       'job flag', job_field='max_drain_polls'),
    _k('SKYLINE_SERVE', 'int', -1,
       'query-serving plane port (-1 = off, 0 = pick a free port)',
       'job flag', runbook='§2d', job_field='serve_port'),
    _k('SKYLINE_SERVE_READ_RATE', 'float', 0.0,
       'snapshot-read token rate per second (0 = unlimited)',
       'job flag', runbook='§2d', job_field='serve_read_rate'),
    _k('SKYLINE_SERVE_READ_BURST', 'int', 256,
       'snapshot-read token bucket capacity',
       'job flag', runbook='§2d', job_field='serve_read_burst'),
    _k('SKYLINE_SERVE_MAX_QUERIES', 'int', 2,
       'concurrent forced merges (POST /query)',
       'job flag', runbook='§2d', job_field='serve_max_queries'),
    _k('SKYLINE_SERVE_QUERY_QUEUE', 'int', 8,
       'queued forced merges beyond the concurrent cap',
       'job flag', runbook='§2d', job_field='serve_query_queue'),
    _k('SKYLINE_SERVE_QUERY_DEADLINE_MS', 'float', 10000.0,
       'deadline for an admitted forced merge',
       'job flag', runbook='§2d', job_field='serve_query_deadline_ms'),
    _k('SKYLINE_SERVE_DELTA_RING', 'int', 128,
       'snapshot transitions kept for /deltas catch-up',
       'job flag', runbook='§2d', job_field='serve_delta_ring'),
    _k('SKYLINE_SERVE_HISTORY', 'int', 64,
       'snapshot versions retained in the store',
       'job flag', runbook='§2d', job_field='serve_history'),
    _k('SKYLINE_SERVE_READ_CACHE', 'int', 64,
       'serialized-response LRU entries (0 disables)',
       'job flag', runbook='§2e', job_field='serve_read_cache'),
    _k('SKYLINE_SERVE_TENANT_RATE', 'float', 0.0,
       'per-tenant snapshot-read token rate per second, keyed on the '
       'X-Tenant header (0 = no per-tenant limit)',
       'job flag', runbook='§2q', job_field='serve_tenant_rate'),
    _k('SKYLINE_SERVE_TENANT_BURST', 'int', 64,
       'per-tenant snapshot-read token bucket capacity',
       'job flag', runbook='§2q', job_field='serve_tenant_burst'),
    _k('SKYLINE_REPLICAS', 'int', 0,
       'WAL-tailing read replicas spawned in-process by the worker '
       '(requires --checkpoint-dir and --serve)',
       'job flag', runbook='§2q', job_field='replicas'),
    _k('SKYLINE_REPLICA_OF', 'str', '',
       'run as a standalone read replica tailing this WAL directory '
       'instead of a worker (mutually exclusive with --replicas)',
       'job flag', runbook='§2q', job_field='replica_of'),
    _k('SKYLINE_TRACE_OUT', 'str', '',
       'write the span ring as Chrome trace-event JSON on shutdown',
       'job flag', runbook='§2b', job_field='trace_out'),
    _k('SKYLINE_TRACE_RING', 'int', 4096,
       'span ring capacity',
       'job flag', runbook='§2b', job_field='trace_ring'),
    _k('SKYLINE_JAX_PROFILE_DIR', 'str', '',
       'wrap each forced-query injection in torch.profiler and write its '
       "trace here (the reference's flag name)",
       'job flag', runbook='§2b', job_field='jax_profile_dir'),
    _k('SKYLINE_CHECKPOINT_DIR', 'str', '',
       'enable crash safety: WAL + periodic checkpoints under this '
       'directory (empty = off)',
       'job flag', runbook='§2i', job_field='checkpoint_dir'),
    _k('SKYLINE_CHECKPOINT_INTERVAL_S', 'float', 30.0,
       'seconds between automatic checkpoints (0 = only on clean shutdown '
       '/ manual)',
       'job flag', runbook='§2i', job_field='checkpoint_interval_s'),
    _k('SKYLINE_CHECKPOINT_RETAIN', 'int', 3,
       'checkpoints kept on disk (older ones pruned)',
       'job flag', runbook='§2i', job_field='checkpoint_retain'),
    _k('SKYLINE_WAL_FSYNC', 'enum', 'batch',
       'WAL durability: always (per append), batch (per worker step), off '
       '(OS page cache only)',
       'job flag', runbook='§2i', choices=('always', 'batch', 'off'), job_field='wal_fsync'),
    _k('SKYLINE_WAL_SEGMENT_BYTES', 'int', 4194304,
       'WAL segment rotation size',
       'job flag', runbook='§2i', job_field='wal_segment_bytes'),
    # the perf-trajectory sentinel (telemetry/sentinel.py)
    _k('SKYLINE_SENTINEL_WINDOW', 'int', 4,
       'perf-trajectory sentinel: rolling-baseline window (newest artifact '
       'compared against the median of up to N prior comparable rounds)',
       'telemetry', runbook='§2o'),
    _k('SKYLINE_SENTINEL_THRESHOLD', 'float', 0.3,
       'perf-trajectory sentinel: default max fractional regression vs the '
       'rolling baseline (per-metric rules can override)',
       'telemetry', runbook='§2o'),
    # the backend probe (utils/backend_probe.py)
    _k('SKYLINE_PROBE_CACHE_TTL_S', 'float', 3600.0,
       'TTL of the cross-process backend-probe verdict file under '
       'skyline_tpu_torch/_build/ (0 disables)',
       'utils/probe'),
    _k('SKYLINE_PROBE_TIMEOUT_S', 'float', 150.0,
       'backend-probe subprocess timeout',
       'utils/probe'),
    _k('BENCH_PROBE_TIMEOUT', 'float', 150.0,
       'legacy alias of SKYLINE_PROBE_TIMEOUT_S (lower precedence)',
       'utils/probe'),

)

_BY_NAME: dict[str, Knob] = {k.name: k for k in KNOBS}
if len(_BY_NAME) != len(KNOBS):  # a duplicate declaration is a bug, not data
    raise RuntimeError("duplicate knob declaration in KNOBS")


def knob(name: str) -> Knob:
    """The declaration behind ``name``; ``LookupError`` if it is not
    declared (the runtime mirror of the knob lint's undeclared-knob
    rule)."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise LookupError(
            f"env knob {name!r} is not declared in skyline_tpu_torch.utils.knobs.KNOBS"
        ) from None


def knob_names() -> tuple[str, ...]:
    return tuple(_BY_NAME)


def _fmt_default(k: Knob) -> str:
    if k.default is None:
        return "unset"
    if k.type == "bool":
        return "on" if k.default else "off"
    return repr(k.default) if isinstance(k.default, str) else str(k.default)


def knob_doc_markdown() -> str:
    """The port's knob table (``python -m skyline_tpu_torch.analysis
    --knob-doc`` writes it to ``docs/KNOBS_TORCH.md``; ``--check-doc``
    fails on drift)."""
    lines = [
        "# Runtime knobs of the PyTorch/CUDA port",
        "",
        "Autogenerated by `python -m skyline_tpu_torch.analysis --knob-doc` from",
        "`skyline_tpu_torch/utils/knobs.py` — edit the registry, not this file",
        "(`--check-doc` fails on drift). The JAX package's table is `docs/KNOBS.md`.",
        "",
        "Boolean knobs share one parser: `0/false/no/off` disable,",
        "`1/true/yes/on` enable, unset/empty/unrecognized mean the default.",
        "",
        "| Knob | Type | Default | Applies to | RUNBOOK | Description |",
        "|---|---|---|---|---|---|",
    ]
    for k in KNOBS:
        typ = k.type if not k.choices else "enum(" + "\\|".join(k.choices) + ")"
        lines.append(
            f"| `{k.name}` | {typ} | {_fmt_default(k)} | {k.applies_to} "
            f"| {k.runbook or '—'} | {k.description} |"
        )
    lines.append("")
    lines.append(f"{len(KNOBS)} knobs declared.")
    lines.append("")
    return "\n".join(lines)

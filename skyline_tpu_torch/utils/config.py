"""Job configuration — one validated config object for the whole system.

The reference's flag surface is Flink ``ParameterTool.fromArgs`` with inline
defaults (``--parallelism 4 --algo mr-angle --input-topic input-tuples
--query-topic queries --output-topic output-skyline --domain 1000.0
--dims 2``, FlinkSkyline.java:62-72) plus ``localhost:9092`` hardcoded in
five places and zero validation (SURVEY.md §5). Here the same flags (same
names, same defaults) parse into one dataclass with validation, env-var
overrides (``SKYLINE_<FLAG>``), and the broker address as a real setting.

The port's copy of ``skyline_tpu/utils/config.py``: the same flags,
environment defaults and validation, plus ``--device {cuda,cpu}`` (default
``cuda``; a ``cuda`` request without a card raises when the engine is
built, never falls back). Each environment read spells its default as a
literal, the reference registry's, which ``JobConfig``'s field defaults
equal (``tests/test_torch_worker.py`` holds both). ``--mesh-chips N`` runs
the sharded engine over the visible cards, ``--cluster-hosts H`` the
cluster engine (``--mesh-chips`` then the chips of each host), and
``--replicas N`` / ``--replica-of <wal_dir>`` the WAL-tailing read
replicas, and ``--mesh N`` the flat engine over a device mesh of the first
N cards (``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
import dataclasses

from skyline_tpu_torch.utils.knobs import env_bool, env_float, env_int, env_str
from skyline_tpu_torch.stream.engine import EngineConfig

_ALGOS = ("mr-dim", "mr-grid", "mr-angle")


@dataclasses.dataclass
class JobConfig:
    parallelism: int = 4
    algo: str = "mr-angle"
    input_topic: str = "input-tuples"
    query_topic: str = "queries"
    output_topic: str = "output-skyline"
    domain: float = 1000.0
    dims: int = 2
    bootstrap: str = "localhost:9092"
    buffer_size: int = 4096
    emit_skyline_points: bool = False
    # engine knobs beyond the reference's flag surface (each defaults to
    # the engine's own default so older invocations are unchanged)
    query_timeout_ms: float = 0.0  # 0 = wait forever (reference behavior)
    grid_prefilter: bool = False
    initial_capacity: int = 0
    flush_policy: str = "incremental"
    overlap_rows: int = 262144  # flush cadence under flush_policy=overlap
    ingest: str = "auto"  # auto|host|device (see EngineConfig.ingest)
    # worker runtime knobs
    mesh: int = 0  # >0: shard partitions over this many devices
    # >0: sharded streaming engine — split the partition set into this
    # many per-chip groups with a two-level tournament merge
    # (skyline_tpu_torch/distributed); mutually exclusive with mesh
    mesh_chips: int = 0
    # >0: cluster engine (skyline_tpu_torch/cluster) — partition ingest across
    # this many hosts with a host-level tournament merge on top; with
    # --checkpoint-dir the worker also runs the lease/fencing write-path
    # (mesh_chips then means chips per host); mutually exclusive with mesh
    cluster_hosts: int = 0
    stats_port: int = 0  # >0: serve /stats + /healthz on this port
    # sliding-window mode (both 0 = unbounded/tumbling, the reference's
    # semantics); window must be a multiple of slide
    window_size: int = 0
    slide: int = 0
    emit_per_slide: bool = False
    # cap on trigger-pending data re-polls per worker step; raise for
    # finite streams larger than max_drain_polls * poll size (~16.7M rows
    # at the defaults) so immediate triggers see the full ingest
    max_drain_polls: int = 256
    # query-serving plane (skyline_tpu_torch/serve): --serve <port> starts the
    # snapshot/delta/query HTTP server (-1 = off; 0 picks a free port)
    serve_port: int = -1
    serve_read_rate: float = 0.0  # snapshot-read tokens/s (0 = unlimited)
    serve_read_burst: int = 256
    serve_max_queries: int = 2  # concurrent forced merges
    serve_query_queue: int = 8  # queued forced merges beyond concurrent
    serve_query_deadline_ms: float = 10_000.0
    serve_delta_ring: int = 128  # retained snapshot transitions
    serve_history: int = 64  # retained snapshot versions
    serve_read_cache: int = 64  # serialized-response LRU entries (0 = off)
    # per-tenant admission (X-Tenant header -> per-tenant token bucket);
    # 0 = the global bucket only
    serve_tenant_rate: float = 0.0
    serve_tenant_burst: int = 64
    # read replication (skyline_tpu_torch/serve/replica): --replicas N spawns N
    # in-process WAL-tailing read replicas beside the engine (requires
    # --checkpoint-dir and --serve); --replica-of <wal_dir> turns this
    # process into a standalone read replica of that WAL instead of an
    # engine worker
    replicas: int = 0
    replica_of: str = ""
    # observability (skyline_tpu_torch/telemetry): Chrome trace-event export of
    # the per-query span ring, and opt-in device profiling of forced merges
    trace_out: str = ""  # write span ring as Chrome trace JSON on close
    trace_ring: int = 4096  # span ring capacity
    jax_profile_dir: str = ""  # profile each POST /query injection (torch.profiler)
    # crash safety (skyline_tpu_torch/resilience): --checkpoint-dir enables the
    # WAL + periodic auto-checkpointing; empty = off (the reference's
    # lose-everything behavior)
    checkpoint_dir: str = ""
    checkpoint_interval_s: float = 30.0  # 0 = shutdown/manual only
    checkpoint_retain: int = 3
    wal_fsync: str = "batch"  # always | batch (per step) | off
    wal_segment_bytes: int = 4_194_304
    # where the engine runs: the card unless the caller asks for the CPU
    device: str = "cuda"

    def __post_init__(self):
        if self.parallelism < 1:
            raise ValueError(f"parallelism must be >= 1, got {self.parallelism}")
        if self.algo not in _ALGOS:
            raise ValueError(f"algo must be one of {_ALGOS}, got {self.algo!r}")
        if self.dims < 1:
            raise ValueError(f"dims must be >= 1, got {self.dims}")
        if self.domain <= 0:
            raise ValueError(f"domain must be > 0, got {self.domain}")
        if self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {self.buffer_size}")
        if self.query_timeout_ms < 0:
            raise ValueError(
                f"query_timeout_ms must be >= 0, got {self.query_timeout_ms}"
            )
        if self.initial_capacity < 0:
            raise ValueError(
                f"initial_capacity must be >= 0, got {self.initial_capacity}"
            )
        if self.flush_policy not in ("incremental", "lazy", "overlap"):
            raise ValueError(
                "flush_policy must be incremental|lazy|overlap, "
                f"got {self.flush_policy!r}"
            )
        if self.overlap_rows < 1:
            raise ValueError(
                f"overlap_rows must be >= 1, got {self.overlap_rows}"
            )
        if self.ingest not in ("auto", "host", "device"):
            raise ValueError(
                f"ingest must be auto|host|device, got {self.ingest!r}"
            )
        if self.mesh < 0:
            raise ValueError(f"mesh must be >= 0, got {self.mesh}")
        if self.mesh_chips < 0:
            raise ValueError(
                f"mesh_chips must be >= 0, got {self.mesh_chips}"
            )
        if self.mesh and self.mesh_chips:
            # both shard the partition state across devices; the sharded
            # engine (--mesh-chips) owns its own placement, so a mesh on
            # top would double-shard
            raise ValueError(
                "--mesh and --mesh-chips are mutually exclusive"
            )
        if self.cluster_hosts < 0:
            raise ValueError(
                f"cluster_hosts must be >= 0, got {self.cluster_hosts}"
            )
        if self.cluster_hosts and self.mesh:
            # the cluster engine owns placement end to end (per-host
            # members pick their own devices); a mesh on top would
            # double-shard, same as --mesh-chips
            raise ValueError(
                "--cluster-hosts and --mesh are mutually exclusive"
            )
        if self.max_drain_polls < 1:
            raise ValueError(
                f"max_drain_polls must be >= 1, got {self.max_drain_polls}"
            )
        if self.serve_port < -1:
            raise ValueError(
                f"serve_port must be >= -1, got {self.serve_port}"
            )
        if self.serve_read_rate < 0:
            raise ValueError(
                f"serve_read_rate must be >= 0, got {self.serve_read_rate}"
            )
        if self.serve_read_burst < 1:
            raise ValueError(
                f"serve_read_burst must be >= 1, got {self.serve_read_burst}"
            )
        if self.serve_max_queries < 1:
            raise ValueError(
                f"serve_max_queries must be >= 1, got {self.serve_max_queries}"
            )
        if self.serve_query_queue < 0:
            raise ValueError(
                f"serve_query_queue must be >= 0, got {self.serve_query_queue}"
            )
        if self.serve_query_deadline_ms <= 0:
            raise ValueError(
                "serve_query_deadline_ms must be > 0, got "
                f"{self.serve_query_deadline_ms}"
            )
        if self.serve_delta_ring < 1 or self.serve_history < 1:
            raise ValueError(
                "serve_delta_ring and serve_history must be >= 1, got "
                f"{self.serve_delta_ring} / {self.serve_history}"
            )
        if self.trace_ring < 1:
            raise ValueError(
                f"trace_ring must be >= 1, got {self.trace_ring}"
            )
        if self.serve_tenant_rate < 0:
            raise ValueError(
                f"serve_tenant_rate must be >= 0, got {self.serve_tenant_rate}"
            )
        if self.serve_tenant_burst < 1:
            raise ValueError(
                f"serve_tenant_burst must be >= 1, got {self.serve_tenant_burst}"
            )
        if self.replicas < 0:
            raise ValueError(f"replicas must be >= 0, got {self.replicas}")
        if self.replicas and not self.checkpoint_dir:
            # replicas bootstrap from and tail the WAL; without a
            # checkpoint dir there is no WAL to tail
            raise ValueError("--replicas requires --checkpoint-dir")
        if self.replicas and self.serve_port < 0:
            raise ValueError(
                "--replicas requires the serve plane (--serve >= 0): "
                "replicas mirror published snapshots"
            )
        if self.replica_of and self.replicas:
            raise ValueError(
                "--replica-of and --replicas are mutually exclusive"
            )
        # the over-partitioning factor is owned by EngineConfig; validate
        # against it rather than a duplicated literal (a CPU config only
        # to count partitions: the device is resolved when the engine is
        # built, so parsing flags needs no card)
        num_partitions = EngineConfig(
            parallelism=self.parallelism, device="cpu"
        ).num_partitions
        if self.mesh and num_partitions % self.mesh:
            raise ValueError(
                f"num_partitions {num_partitions} must be divisible "
                f"by mesh size {self.mesh}"
            )
        if self.mesh_chips and num_partitions % self.mesh_chips:
            raise ValueError(
                f"num_partitions {num_partitions} must be divisible "
                f"by mesh_chips {self.mesh_chips}"
            )
        if self.cluster_hosts:
            if num_partitions % self.cluster_hosts:
                raise ValueError(
                    f"num_partitions {num_partitions} must be divisible "
                    f"by cluster_hosts {self.cluster_hosts}"
                )
            group = num_partitions // self.cluster_hosts
            if self.mesh_chips and group % self.mesh_chips:
                raise ValueError(
                    f"per-host partition group {group} must be divisible "
                    f"by mesh_chips {self.mesh_chips} (chips per host "
                    "under --cluster-hosts)"
                )
        if (self.window_size > 0) != (self.slide > 0):
            raise ValueError(
                "--window and --slide must be given together (both > 0)"
            )
        if self.window_size and self.window_size % self.slide:
            raise ValueError(
                f"window_size {self.window_size} must be a multiple of "
                f"slide {self.slide}"
            )
        if self.window_size and self.mesh_chips:
            # the sliding engine has no partition groups to shard
            raise ValueError(
                "sliding-window mode (--window/--slide) does not support "
                "--mesh-chips"
            )
        if self.window_size and self.cluster_hosts:
            # same reason: the sliding engine has no partition groups to
            # split across hosts
            raise ValueError(
                "sliding-window mode (--window/--slide) does not support "
                "--cluster-hosts"
            )
        if self.window_size and (
            self.grid_prefilter
            or self.flush_policy in ("lazy", "overlap")
            or self.initial_capacity
        ):
            # the sliding engine implements none of these; failing beats
            # an operator believing a filter is active when it is not
            raise ValueError(
                "sliding-window mode (--window/--slide) does not support "
                "--grid-prefilter, --flush-policy lazy/overlap, or "
                "--initial-capacity"
            )
        if self.checkpoint_interval_s < 0:
            raise ValueError(
                "checkpoint_interval_s must be >= 0, got "
                f"{self.checkpoint_interval_s}"
            )
        if self.checkpoint_retain < 1:
            raise ValueError(
                f"checkpoint_retain must be >= 1, got {self.checkpoint_retain}"
            )
        if self.wal_fsync not in ("always", "batch", "off"):
            raise ValueError(
                f"wal_fsync must be always|batch|off, got {self.wal_fsync!r}"
            )
        if self.wal_segment_bytes < 4096:
            raise ValueError(
                f"wal_segment_bytes must be >= 4096, got {self.wal_segment_bytes}"
            )
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda|cpu, got {self.device!r}")
        if self.window_size and self.checkpoint_dir:
            # utils/checkpoint.py serializes the tumbling engine's state;
            # the sliding engine's window ring is not covered — refuse
            # rather than write checkpoints that restore the wrong shape
            raise ValueError(
                "sliding-window mode (--window/--slide) does not support "
                "--checkpoint-dir"
            )

    def engine_config(self) -> EngineConfig:
        return EngineConfig(
            parallelism=self.parallelism,
            algo=self.algo,
            domain_max=self.domain,
            dims=self.dims,
            buffer_size=self.buffer_size,
            emit_skyline_points=self.emit_skyline_points,
            query_timeout_ms=self.query_timeout_ms,
            grid_prefilter=self.grid_prefilter,
            initial_capacity=self.initial_capacity,
            flush_policy=self.flush_policy,
            overlap_rows=self.overlap_rows,
            ingest=self.ingest,
            device=self.device,
        )

    def serve_config(self):
        """The ``serve.ServeConfig`` this job's serve knobs describe (the
        worker overrides its ``port`` with ``serve_port``)."""
        from skyline_tpu_torch.serve import ServeConfig

        return ServeConfig(
            port=max(0, self.serve_port),
            read_rate=self.serve_read_rate,
            read_burst=self.serve_read_burst,
            max_concurrent_queries=self.serve_max_queries,
            max_query_queue=self.serve_query_queue,
            query_deadline_ms=self.serve_query_deadline_ms,
            delta_ring=self.serve_delta_ring,
            history=self.serve_history,
            read_cache_entries=self.serve_read_cache,
            tenant_rate=self.serve_tenant_rate,
            tenant_burst=self.serve_tenant_burst,
        )

    def resilience_config(self):
        """The ``resilience.ResilienceConfig`` this job asks for, or None
        when crash safety is off (no --checkpoint-dir)."""
        if not self.checkpoint_dir:
            return None
        from skyline_tpu_torch.resilience import ResilienceConfig

        return ResilienceConfig(
            checkpoint_dir=self.checkpoint_dir,
            checkpoint_interval_s=self.checkpoint_interval_s,
            checkpoint_retain=self.checkpoint_retain,
            wal_fsync=self.wal_fsync,
            wal_segment_bytes=self.wal_segment_bytes,
        )

    def build_mesh(self):
        """The device mesh ``--mesh`` asks for (None when ``mesh`` is 0): a
        one-axis (``"part"``) ``parallel.mesh.Mesh`` over the first
        ``mesh`` cards, raising ``RuntimeError`` when fewer are visible, as
        the reference does; with ``--device cpu`` every place is the CPU.
        (The library's ``make_mesh`` wraps places onto fewer cards; the job
        refuses.)"""
        if not self.mesh:
            return None
        import torch

        from skyline_tpu_torch.parallel.mesh import make_mesh

        if self.device == "cuda":
            visible = torch.cuda.device_count()
            if visible < self.mesh:
                raise RuntimeError(
                    f"--mesh {self.mesh} requested but only {visible} "
                    f"device(s) visible"
                )
        return make_mesh(self.mesh, axis="part", device=self.device)


def parse_job_args(argv=None) -> JobConfig:
    """Parse reference-style flags; SKYLINE_* env vars override defaults and
    CLI flags override both."""
    defaults = JobConfig()
    ap = argparse.ArgumentParser(description="skyline job flags (PyTorch port)")
    ap.add_argument("--parallelism", type=int,
                    default=env_int("SKYLINE_PARALLELISM", 4))
    ap.add_argument("--algo", default=env_str("SKYLINE_ALGO", 'mr-angle'))
    ap.add_argument("--input-topic",
                    default=env_str("SKYLINE_INPUT_TOPIC", 'input-tuples'))
    ap.add_argument("--query-topic",
                    default=env_str("SKYLINE_QUERY_TOPIC", 'queries'))
    ap.add_argument("--output-topic",
                    default=env_str("SKYLINE_OUTPUT_TOPIC", 'output-skyline'))
    ap.add_argument("--domain", type=float,
                    default=env_float("SKYLINE_DOMAIN", 1000.0))
    ap.add_argument("--dims", type=int,
                    default=env_int("SKYLINE_DIMS", 2))
    ap.add_argument("--bootstrap",
                    default=env_str("SKYLINE_BOOTSTRAP", 'localhost:9092'))
    ap.add_argument("--buffer-size", type=int,
                    default=env_int("SKYLINE_BUFFER_SIZE", 4096))
    ap.add_argument("--emit-skyline-points", action="store_true",
                    default=env_bool("SKYLINE_EMIT_SKYLINE_POINTS", False))
    ap.add_argument("--query-timeout-ms", type=float,
                    default=env_float("SKYLINE_QUERY_TIMEOUT_MS",
                                      0.0),
                    help="finalize overdue queries as partial results after "
                         "this long (0 = wait forever, reference behavior)")
    ap.add_argument("--grid-prefilter", action="store_true",
                    default=env_bool("SKYLINE_GRID_PREFILTER", False),
                    help="drop tuples dominated by the domain midpoint "
                         "(the reference's disabled GridDominanceFilter, "
                         "implemented barrier-safely)")
    ap.add_argument("--initial-capacity", type=int,
                    default=env_int("SKYLINE_INITIAL_CAPACITY",
                                    0),
                    help="pre-size per-partition skyline buffers")
    ap.add_argument("--flush-policy",
                    choices=("incremental", "lazy", "overlap"),
                    default=env_str("SKYLINE_FLUSH_POLICY",
                                    'incremental'))
    ap.add_argument("--overlap-rows", type=int,
                    default=env_int("SKYLINE_OVERLAP_ROWS",
                                    262144),
                    help="rows between automatic flushes under "
                         "--flush-policy overlap (device work then overlaps "
                         "transport/parse of the next chunk)")
    ap.add_argument("--ingest", choices=("auto", "host", "device"),
                    default=env_str("SKYLINE_INGEST", 'auto'),
                    help="where routing/sort/block assembly runs: auto "
                         "picks device on a single accelerator under "
                         "lazy/overlap")
    ap.add_argument("--mesh", type=int,
                    default=env_int("SKYLINE_MESH", 0),
                    help="shard the partition state over this many devices "
                         "(0 = single device)")
    ap.add_argument("--mesh-chips", type=int,
                    default=env_int("SKYLINE_MESH_CHIPS",
                                    0),
                    help="sharded streaming engine: split partitions into "
                         "this many per-chip groups with a two-level "
                         "tournament merge (0 = single device; mutually "
                         "exclusive with --mesh)")
    ap.add_argument("--cluster-hosts", type=int,
                    default=env_int("SKYLINE_CLUSTER_HOSTS",
                                    0),
                    help="cluster engine: partition ingest across this "
                         "many hosts with a host-level tournament merge "
                         "on top (0 = off; --mesh-chips then means chips "
                         "per host; with --checkpoint-dir the worker also "
                         "runs the lease/fencing write path)")
    ap.add_argument("--stats-port", type=int,
                    default=env_int("SKYLINE_STATS_PORT", 0),
                    help="serve live /stats JSON on this port (0 = off)")
    ap.add_argument("--window", type=int, dest="window_size",
                    default=env_int("SKYLINE_WINDOW", 0),
                    help="sliding-window size in tuples (0 = unbounded, "
                         "the reference's semantics)")
    ap.add_argument("--slide", type=int,
                    default=env_int("SKYLINE_SLIDE", 0),
                    help="slide in tuples (with --window)")
    ap.add_argument("--emit-per-slide", action="store_true",
                    default=env_bool("SKYLINE_EMIT_PER_SLIDE", False),
                    help="emit one result JSON per completed slide in "
                         "addition to trigger-driven results")
    ap.add_argument("--max-drain-polls", type=int,
                    default=env_int("SKYLINE_MAX_DRAIN_POLLS",
                                    256),
                    help="cap on trigger-pending data re-polls per step; "
                         "raise for finite streams larger than "
                         "max_drain_polls * 65536 rows")
    ap.add_argument("--serve", type=int, dest="serve_port",
                    default=env_int("SKYLINE_SERVE", -1),
                    help="start the query-serving plane (snapshot reads, "
                         "forced merges, delta catch-up) on this port "
                         "(-1 = off, 0 = pick a free port)")
    ap.add_argument("--serve-read-rate", type=float,
                    default=env_float("SKYLINE_SERVE_READ_RATE",
                                      0.0),
                    help="snapshot-read token rate per second "
                         "(0 = unlimited); exhaustion sheds with 429")
    ap.add_argument("--serve-read-burst", type=int,
                    default=env_int("SKYLINE_SERVE_READ_BURST",
                                    256),
                    help="snapshot-read token bucket capacity")
    ap.add_argument("--serve-max-queries", type=int,
                    default=env_int("SKYLINE_SERVE_MAX_QUERIES",
                                    2),
                    help="concurrent forced merges (POST /query)")
    ap.add_argument("--serve-query-queue", type=int,
                    default=env_int("SKYLINE_SERVE_QUERY_QUEUE",
                                    8),
                    help="queued forced merges beyond the concurrent cap; "
                         "beyond that POST /query sheds with 429")
    ap.add_argument("--serve-query-deadline-ms", type=float,
                    default=env_float("SKYLINE_SERVE_QUERY_DEADLINE_MS",
                                      10000.0),
                    help="deadline for an admitted forced merge")
    ap.add_argument("--serve-delta-ring", type=int,
                    default=env_int("SKYLINE_SERVE_DELTA_RING",
                                    128),
                    help="snapshot transitions kept for /deltas catch-up")
    ap.add_argument("--serve-history", type=int,
                    default=env_int("SKYLINE_SERVE_HISTORY",
                                    64),
                    help="snapshot versions retained in the store")
    ap.add_argument("--serve-read-cache", type=int,
                    default=env_int("SKYLINE_SERVE_READ_CACHE",
                                    64),
                    help="serialized-response LRU entries (0 disables)")
    ap.add_argument("--serve-tenant-rate", type=float,
                    default=env_float("SKYLINE_SERVE_TENANT_RATE",
                                      0.0),
                    help="per-tenant snapshot-read token rate per second "
                         "(X-Tenant header; 0 disables the tenant plane)")
    ap.add_argument("--serve-tenant-burst", type=int,
                    default=env_int("SKYLINE_SERVE_TENANT_BURST",
                                    64),
                    help="per-tenant token bucket capacity")
    ap.add_argument("--replicas", type=int,
                    default=env_int("SKYLINE_REPLICAS", 0),
                    help="spawn this many in-process WAL-tailing read "
                         "replicas beside the engine (requires "
                         "--checkpoint-dir and --serve)")
    ap.add_argument("--replica-of",
                    default=env_str("SKYLINE_REPLICA_OF",
                                    ''),
                    help="run as a standalone read replica tailing this "
                         "WAL directory instead of an engine worker")
    ap.add_argument("--trace-out",
                    default=env_str("SKYLINE_TRACE_OUT",
                                    ''),
                    help="write the per-query span ring as Chrome "
                         "trace-event JSON to this path on shutdown "
                         "(load at https://ui.perfetto.dev)")
    ap.add_argument("--trace-ring", type=int,
                    default=env_int("SKYLINE_TRACE_RING",
                                    4096),
                    help="span ring capacity (most recent spans kept)")
    ap.add_argument("--jax-profile-dir",
                    default=env_str("SKYLINE_JAX_PROFILE_DIR",
                                    ''),
                    help="opt-in: wrap each forced-query injection "
                         "(POST /query) in torch.profiler and write its "
                         "Chrome trace to this directory (the flag keeps "
                         "the reference's name)")
    ap.add_argument("--checkpoint-dir",
                    default=env_str("SKYLINE_CHECKPOINT_DIR",
                                    ''),
                    help="enable crash safety: WAL + periodic checkpoints "
                         "under this directory (empty = off)")
    ap.add_argument("--checkpoint-interval-s", type=float,
                    default=env_float("SKYLINE_CHECKPOINT_INTERVAL_S",
                                      30.0),
                    help="seconds between automatic checkpoints "
                         "(0 = only on clean shutdown / manual)")
    ap.add_argument("--checkpoint-retain", type=int,
                    default=env_int("SKYLINE_CHECKPOINT_RETAIN",
                                    3),
                    help="checkpoints kept on disk (older ones pruned)")
    ap.add_argument("--wal-fsync", choices=("always", "batch", "off"),
                    default=env_str("SKYLINE_WAL_FSYNC",
                                    'batch'),
                    help="WAL durability: always (per append), batch (per "
                         "worker step), off (OS page cache only)")
    ap.add_argument("--wal-segment-bytes", type=int,
                    default=env_int("SKYLINE_WAL_SEGMENT_BYTES",
                                    4194304),
                    help="WAL segment rotation size")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=defaults.device,
                    help="where the engine runs: cuda (default; raises "
                         "without a card) or cpu")
    a = ap.parse_args(argv)
    return JobConfig(
        parallelism=a.parallelism,
        algo=a.algo,
        input_topic=a.input_topic,
        query_topic=a.query_topic,
        output_topic=a.output_topic,
        domain=a.domain,
        dims=a.dims,
        bootstrap=a.bootstrap,
        buffer_size=a.buffer_size,
        emit_skyline_points=a.emit_skyline_points,
        query_timeout_ms=a.query_timeout_ms,
        grid_prefilter=a.grid_prefilter,
        initial_capacity=a.initial_capacity,
        flush_policy=a.flush_policy,
        overlap_rows=a.overlap_rows,
        ingest=a.ingest,
        mesh=a.mesh,
        mesh_chips=a.mesh_chips,
        cluster_hosts=a.cluster_hosts,
        stats_port=a.stats_port,
        window_size=a.window_size,
        slide=a.slide,
        emit_per_slide=a.emit_per_slide,
        max_drain_polls=a.max_drain_polls,
        serve_port=a.serve_port,
        serve_read_rate=a.serve_read_rate,
        serve_read_burst=a.serve_read_burst,
        serve_max_queries=a.serve_max_queries,
        serve_query_queue=a.serve_query_queue,
        serve_query_deadline_ms=a.serve_query_deadline_ms,
        serve_delta_ring=a.serve_delta_ring,
        serve_history=a.serve_history,
        serve_read_cache=a.serve_read_cache,
        serve_tenant_rate=a.serve_tenant_rate,
        serve_tenant_burst=a.serve_tenant_burst,
        replicas=a.replicas,
        replica_of=a.replica_of,
        trace_out=a.trace_out,
        trace_ring=a.trace_ring,
        jax_profile_dir=a.jax_profile_dir,
        checkpoint_dir=a.checkpoint_dir,
        checkpoint_interval_s=a.checkpoint_interval_s,
        checkpoint_retain=a.checkpoint_retain,
        wal_fsync=a.wal_fsync,
        wal_segment_bytes=a.wal_segment_bytes,
        device=a.device,
    )

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``skyline_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                      # everything, as CI runs it
    python3 chip_smoke.py --only kernels       # build + kernel checks only
    python3 chip_smoke.py --out chiprun_out    # also write details as JSON

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build ``skyline_tpu_torch/csrc/dominance.cu``, ``dominance_rank.cu`` and
   ``cascade.cu`` for sm_90a, one nvcc each, started together, timed, and beside them the
   native host helper (``skyline_tpu_torch/native/fastcsv.cpp``, g++, the
   CSV parse and format, RecordBatch walks and CRC32C of the transport) into
   ``skyline_tpu_torch/_build/``; the run fails if it does not build;
3. kernels against their plain PyTorch versions on the card, exact
   equality: K1 (``dominated_by_any``), K2 (``dominated_by_rect``), K3
   (``skyline_mask_kernel``), K5 (``dominated_by_any_rank``), K6
   (``dominated_by_rank_rect``) — K1, K2, K5 and K6 with and without a
   partition dimension — and K7 (``skyline_mask_rank_kernel``); K4
   (``rank_transform``) on the card against K4 on the CPU. Cases: d in
   {3, 4, 8, 16}, ragged N up to 8192, duplicate rows, integer ties, +inf
   padding, invalid rows with finite coordinates; NaN/-inf rows and a
   dominator whose f32 sum ties its victim's (value kernels); K3 under
   other sort keys; int32 rank sums that differ by 1 at ~2^24 and ~2^25;
   cases aimed at the value kernel's tile and box skips (K1, K2 with
   P = 1 and P = 3, K3; N ragged against the tile and the victim block):
   exact copies of the victims plus one row lower in one dimension, +0.0
   and -0.0 mixed, a tile of NaN rows, victims with NaN and +inf rows,
   equal rows across a tile border; and cases aimed at the rank kernel's
   tile skip (K5, K6 with P = 1 and P = 3, K7): copies plus one row lower
   in one dimension, equal rank sums across a tile border, sums one apart
   near 2^25, sum rows that are not the sum of their ranks, invalid
   dominators and invalid tail victims; the incremental merge step's K2
   core (``_merge_step_kernel_core``) against its plain core on P = 8
   unsorted 8,192-row batches with ragged widths against the running sky
   prefix, a growth round among them; the d <= 2 sweep on the card against
   the CPU; the tree merge's functions on the card against the CPU —
   ``tree_pair_merge`` (two K2 launches) on signed zeros, NaN and +inf
   rows, rows equal across its two sides, an empty side, a capacity of
   exactly both counts and a north-star-like pair, ``compact_tagged`` and
   ``partition_summaries_device``; K1–K3 with ``mp`` (the f32 kernel
   counted under ``_mp``) against their plain versions and their own f32
   launch, and the bf16 row pre-drop's mask entry against its plain
   version (mask and count), for d in {3, 8, 16} on those cases and on rows
   aimed at the bf16 margin (one bf16 ulp and the 2^-7/2^-6 bands either
   side, ties, signed zeros, NaN, infinities, subnormals, values that round
   to bf16 infinity, the north-star's zero rows); both pre-drop entries on
   ``_predrop_cases`` (a zero block against zero dominators, -0.0,
   subnormals, rows one bf16 ulp apart, a north-star-like batch, 1 to
   4,096 dominators at P = 1, 3 and 8): the mask, the fused drop (block
   bytes, validity and per-block counts against ``mp_predrop_plain``, the
   dominators read in place from a prefix of a wider buffer) and the
   kernel's own skip decisions, read from its summaries, against
   ``predrop_skip_plain`` (the skipped share printed per case; the zero
   blocks skipped whole); the merge step with ``mp`` too; the device
   sorted dominance cascade (``device_cascade_mask``: one window pass,
   ``cascade_windows``, over every block's full square and band, and one
   scan on a thread-block cluster, ``cascade_scan``, for the pre-drop and
   the survivor buffer, both in ``csrc/cascade.cu``) against its CPU
   version and K3, ``mp`` off and on, on those cases at d in {3, 8, 16},
   signed-zero duplicates, NaN and mixed +/-inf rows and a north-star
   block, on uniform rows at d = 3, 8 (a buffer of many tiles, so the
   cluster's CTAs split them) and 16, the north-star block and the 8-D
   uniform rows again at blocks of 1,024 and 4,096
   (``SKYLINE_DEVICE_CASCADE_BLOCK``), and its core at block 8 on the 2^24
   equal-key band; each call launching each of the two once, the same at
   4,096 and 65,536 rows (2 and 32 blocks); the window pass's device
   worklist against ``cascade_worklist_plain``; the scan alone
   ``SCAN_REPEATS`` times on the north-star block's and the 8-D uniform
   rows' inputs at blocks of 1,024 and 2,048, each call against
   ``cascade_scan_plain`` on the CPU;
   ``skyline_large`` on the ``--n``-row north-star window against K3's
   survivors in sum order, timed; K3 over a partition batch (the sliding
   slide step's form: one launch over (P, N, d)) against its plain version
   and against K3 on each partition alone, P in {1, 3, 8}, d in {3, 4, 8,
   16}, N ragged, with duplicates, signed zeros, NaN and +inf rows,
   invalid rows with finite coordinates, a partition with no valid rows,
   one whose first half is invalid, the north-star's zero block and an
   empty batch; every compare and pre-drop entry refusing, by name, an
   operand on a second card (or the CPU when one card is visible)
   (``check_one_device``);
4. parity, each on CUDA and with ``device="cpu"`` (plain versions): device
   routing of values outside the domain (``check_routing``: the three
   partitioners at P in {1, 4, 8} on ±inf, NaN, ±1e30, -0.0 and mr-dim
   quotients past 2^31, strict; the mr-dim fault's input through the
   device-ingest engine, lazy and overlap, published bytes strict); the
   host-ingest engine over two 65,536-row 8-D anti-correlated windows
   (same sizes, optimality and point bytes) plus a small window against
   the numpy oracle; then device ingest over two 32,768-row windows with
   the rank cascade on and off (same sizes and sorted point bytes; where
   the card routes every row as the CPU does, also the same local sizes,
   optimality and published order — otherwise the first differing row is
   printed); then the other policies: incremental with host ingest at d = 3
   and d = 8 and at d = 2 (the sweep), and overlap with device ingest, rank
   cascade on and off, and at d = 2 — local sizes, optimality and point
   bytes, strict as above; the merge plane: on the card, the reference's
   defaults (tree, prune, cache, query overlap) against the flat plane
   (``PLANE_OFF``) at the north-star and the 3-D grid cell, and an
   interleaved run (repeated triggers, chunks routed to half the
   partitions, ingest while a merge is in flight) CUDA against the CPU,
   answers and plane counters; the flush cascade (``CASCADE_PARITY``): the
   card under its defaults (mp on, the grid prefilter on at d >= 3) against
   the CPU with ``SKYLINE_MIXED_PRECISION=1`` — answers and
   ``flush_cascade_stats()`` — for the incremental policy and both ingests
   of the lazy and overlap policies at d = 3 and 8, and the card's cascade
   on against off (``CASCADE_OFF``), answers — the lazy flush pinned to
   the SFS rounds (``ROUNDS_ONLY``); the lazy flush race
   (``RACE_PARITY``): the lazy engine with host ingest at d = 3 and 8 over
   three windows, the card with the device cascade forced and under the
   defaults (the SFS rounds raced against the device cascade) against the
   CPU with the host sorted cascade forced, strict; the sliding windows
   (``SLIDING_PARITY``): ``SlidingEngine`` at d in {2, 3, 4, 8} under
   mr-angle, mr-grid and mr-dim, windows 4,096/1,024, 2,048/256 and
   8,192/2,048 or 1,024, two streams that grow the ring (one across the K3
   gate), per-slide emission, mid-slide triggers, a barrier trigger and a
   timeout under an injected clock — every result's fields and point bytes,
   strict; the card must take each leg's branch (sweep, scan, K3 with two
   launches a slide step) — and ``SlidingSkyline`` every slide and
   ``current_skyline`` with rows pending, d = 3 and 8; the observability
   plane (``OBS_PARITY``): a (b)-like lazy device-ingest engine and a
   (d)-like incremental host-ingest one with the midpoint grid prefilter,
   two windows of 32,768 rows, each with a ``Telemetry()`` hub on the card
   and on the CPU (``SKYLINE_MIXED_PRECISION=1`` on both, the tuner's
   cadence out of reach) and on the card without one — the bytes with the
   hub are the bytes without it; ``prefiltered`` and every partition's
   ``max_seen_id`` are the CPU's; where the card routes every row as the CPU
   does, ``stats()`` (``untimed``: the timing fields and the backend aside)
   and every EXPLAIN plan's merge path, tree, cascade and kernel call
   counts are the CPU's; the worker (``WORKER_PARITY``, leg ``worker``):
   the port's ``SkylineWorker`` on the card and on the CPU over their own
   ``MemoryBus`` fed the same 65,536 lines, crash safety on, the event
   clock pinned, for the north-star lazy configuration with device ingest
   (d = 8) and the job CLI's default incremental policy (d = 3): the
   output-topic line with the timing fields aside (point bytes and order
   included, where the card routes every row as the CPU does) and every
   WAL record are the CPU's; then on the card the incremental
   configuration under ``crash@flush.pre_merge:2``, restarted by the
   ``Supervisor``: its answer is the uninterrupted one, bytes and order;
   the sharded engine (``SHARDED_PARITY``, leg ``sharded``):
   ``ShardedEngine`` at chips 1, 2, 4 and 8 (P = 8) on the card against the
   flat engine on the card (results, point bytes and order), and at chips
   4 on the CPU (results and ``sharded_stats()`` with the chip prune's
   counts), the lazy policy at d = 8 (uniform rows) and the incremental at
   d = 3 (anti-correlated), two 65,536-row windows, strict; the chips'
   devices (round-robin over the visible cards, or one line saying they
   share ``cuda:0``); then ``benchmarks/failover.py``'s drill on the card
   (``slow@sharded.chip_merge#1:1`` under a 500 ms deadline: a marked
   degraded answer, quarantine, failover, the healthy run's bytes after;
   ``time_to_healed_ms``); the cluster plane (``CLUSTER_PARITY``, leg
   ``cluster``): ``ClusterEngine`` at (hosts, chips_per_host) in {(1, 1),
   (2, 1), (2, 2), (4, 2), (8, 1)} under the lazy (d = 8, uniform rows),
   incremental (d = 3, anti-correlated) and overlap (d = 8, uniform, a flush
   every 32,768 rows) policies, P = 8, over two 65,536-row windows on the
   card against the flat engine on the card and over two 16,384-row windows
   on the card against the same configuration on the CPU (results, counts,
   survivors, sizes, the points' sha1 — rows and order — and
   ``cluster_stats()`` with the host prune's counts; the CPU side in eight
   child processes beside the card side), strict; then on
   the card the skewed host prune (pruned hosts ship zero rows, the answer
   equals the flat set's and the unpruned set's, fewer ladder pairs), a
   live migration of a host to 2 chips and back and a slice checkpoint
   restored on another facade's host, each with the flat answer after; the
   members' devices (flat members on the engine's card, a sharded member's
   chip c on ``cuda:c % n``) and the host roots copied onto the root card;
   the read replicas (``REPLICA_PARITY``, leg ``replica``): a worker on the
   card with the serving plane, crash safety, two in-process replicas and
   the cluster engine over 2 hosts (the write lease and fenced frames), two
   65,536-row 3-D windows: each replica's points, digest and meta at every
   version it shares with the primary, and its ``/skyline`` CSV bytes and
   digest, are the primary's (``--out`` keeps the WAL as
   ``replica_wal/`` for ``tests/fold_wal_jax.py``, the JAX replica's
   fold); then the promotion drill (the lease expires,
   ``ClusterSupervisor.tick()`` raises the fence and promotes the most
   caught-up replica at the primary's head, the time to promote printed;
   the deposed writer's next append raises ``WalFencedError``, counted);
   the device mesh (``MESH_PARITY``, leg ``mesh``): on the card the
   sharded two-phase (``skyline_keep_np_sharded``) at 1, 2, 4 and 8 places
   and the window pipeline on a 1,048,576-row north-star window against the
   flat ``skyline_keep_np``, the hierarchical step at 2x2 and 2x4 exact and
   with an overflowing ``host_cap`` (a superset, the overflow counted); the
   two-phase, the pipeline and the hierarchical step on an 8,192-row window
   on the card against the CPU (a child process), every output bit for
   bit; ``SkylineEngine(mesh=)`` under the lazy, incremental and overlap
   policies at d = 8 (two 65,536-row windows, P = 8) at 2 and 4 places
   against the flat engine on the card, and at 4 places over two
   4,096-row windows against the CPU (child processes beside the card
   side; results, partition skylines, answer sha1, ``stats()``); the
   sliding engine at 2 and 4 places against
   its flat form on the card and the CPU; a checkpoint across topologies
   (4 places, flat, 2 places); with two cards or more, two NCCL ranks, one
   host each, against the one-process step (with fewer, a line says it did
   not run);
5. main paths at 1,000,000 rows, each one warm window and ``--windows``
   measured ones, driven in 65,536-row chunks with the trigger "0,0", under
   the reference's merge defaults (the pruned tree merge at d > 2, the
   merge cache, the query overlap). The north-star configuration (8-D
   anti-correlated, domain 0-10000, parallelism 4, mr-angle, buffer 8192,
   initial capacity 65536): (a) lazy, device ingest with the rank cascade
   on (K5, K6 rounds; K2 tree pairs), (b) lazy, device ingest with it off
   (K1, K2), (c) lazy, host ingest with it off (K1, K2), (e) overlap
   (automatic sync-free flushes every 262,144 rows), device ingest, rank
   cascade off (K1, K2); (g) is (b) and (h) is (a) with
   ``SKYLINE_MERGE_TREE=0``, the flat merge (K3; K4 and K7). The reference
   grid cell ``grid_mr-angle_3d`` (``benchmarks/reference_grid.py``: 3-D
   anti-correlated, parallelism 4, mr-angle, buffer 8192, the engine's
   default incremental policy, host ingest): (d) at d = 3 (K2 merge steps
   and tree pairs), (f) at d = 2 (every flush and the merge through the
   sweep: no dominance kernel may launch). Under the defaults on a card the
   value flush rounds are mixed-precision (the pre-drop kernel, K1/K2 mp)
   and (g)'s K3 too; (i) is (b) and (k) is (g) with
   ``SKYLINE_MIXED_PRECISION=0`` (K1/K2 and K3 in f32), (j) is (d) with the
   flush cascade off (no grid prefilter, no bf16 pass); (l) is (c) and (m)
   is (g) with ``SKYLINE_DEVICE_CASCADE=on``: every lazy flush of (l) is a
   survivor mask of old ∪ new through the device cascade, (m)'s flat merge
   masks its union through it (neither may launch K3); (p) is (b) with a
   ``Telemetry()`` hub that every window's engine records into (each window
   prints the spans, flight entries and EXPLAIN records it added, the spans
   dropped and its tuner's epochs and moves; the tuner's pins and overrides
   are cleared after (p)), (q) is (d) with ``grid_prefilter=True`` (each
   window prints the rows the midpoint prefilter dropped); both are printed
   beside (b) and (d) after the paths, followed by each plane's host cost
   (``plane_costs``: every plane operation timed alone on this machine, and
   its sum over a window of (p)'s counts). ``--paths`` runs only the named
   paths; ``--ablate-planes R`` runs (p) with each observability gate off
   alone, all off, and (b), one process a setting, R rounds. Each window's
   engine takes over the lazy flush race's profiler of the window before,
   as one long-lived engine keeps it, and each window prints the path its
   flush took and the race's EMAs. Each prints each
   window's ``flush_cascade_stats()`` and the host ms of the grid
   prefilter, tuples/s (all
   measured rows over the summed window walls), p50 window latency, flush
   and merge walls (the engine synchronises the card between them),
   launches (each of its kernels > 0) and the last window's tree; its warm
   answer is checked on the card against samples of input and output. (a)
   also counts the rows the card routes differently from
   ``partition_ids_np`` and from the CPU. On (b), (d) and (f) the last
   engine measures the merge plane (``measure_plane``): a repeated trigger
   (an exact hit, no launch), a delta trigger after a chunk routed to half
   the partitions, and that answer against a fresh set's recompute. Two
   sliding paths: (n) the sliding north-star
   (``benchmarks/sliding_northstar.py``: 8-D anti-correlated, window
   1,048,576, K = 8, parallelism 4, mr-angle, a trigger at every slide
   close; K warm slides, then max(8, 4 x ``--windows``) measured), its
   first full window's answer checked against samples of input and output;
   (o) ``sliding_4d_anticorrelated`` (``benchmarks/run_configs.py``: 4-D,
   window 200,000, slide 50,000, 800,000 rows in 65,536-row chunks,
   per-slide emission). Each prints slide p50/p90, slides/s, tuples/s
   (slide / p50), the skyline size p50, the host ms of routing, the slide
   step's device ms (CUDA events), the answer's ms, K3 launches per slide
   (must be 2), the rings' capacity and the bytes moved to the host per
   answer. Two worker paths: (t) the worker over the wire at full size
   (``README.md:127-134``, ``benchmarks/e2e_transport.py``): a kafkalite
   broker (the port's CLI, 127.0.0.1, port 0), per window fresh topics, the
   collector CLI, the worker built from the job flags (``--algo mr-angle
   --dims 8 --domain 10000 --parallelism 4 --buffer-size 8192
   --flush-policy lazy --device cuda``) and the producer CLI writing one
   1,000,000-row 8-D anti-correlated window over TCP; one warm window and
   ``--windows`` measured: the wall from the producer's start to the
   collector's row, tuples/s over it, the result's TotalTime, the worker's
   poll, parse, ingest and query ms, the latched poll plane (the native
   arrays plane, or the run fails), the launches of K1 mp, K2 mp and the
   pre-drop (each > 0), under ``--profile`` the device's idle share; the
   answer's rows equal the engine alone on the card over the same rows in
   65,536-row chunks (a sorted set) and pass the sampled checks; (t) is
   printed beside (b). (u) the crash drill on the card
   (``tests/test_resilience.py:464-469``): the north-star lazy
   configuration at 262,144 rows over a ``MemoryBus``, the worker restarted
   by the ``Supervisor`` under ``crash@kafka.poll:5``,
   ``crash@wal.pre_fsync:3`` and, with periodic checkpoints,
   ``crash@checkpoint.pre_replace:2,crash@kafka.poll:9``: each restarts at
   least once, ingests every row once, recovers through the WAL (or a
   checkpoint) and gives the uninterrupted answer, bytes and order; each
   plan's recovery wall is printed. Two sharded paths: (v) is (c) and (w)
   is (d) through ``ShardedEngine(chips=4)`` over the visible cards, one
   fresh engine a window (each chip keeping its flush race's profiler):
   tuples/s, p50 window, flush and merge walls, the level-1 ms (the chips'
   merges) and level-2 ms (the rest of the merge: the gather, the
   cross-chip pairs, the harvest), the chips pruned a merge, launches
   (K1 mp, K2 mp and the pre-drop on (v); each > 0) and the cross-chip K2
   launches (> 0); the last answer equals the flat engine's on the same
   rows (a sorted set) and the warm answer passes the sampled checks; each
   printed beside (c) and (d) when they ran in the call. Two cluster paths:
   (x) is (c) through ``ClusterEngine(hosts=4)`` (one flat member a host)
   and (y) is (d) through ``ClusterEngine(hosts=2, chips_per_host=2)`` (the
   three-level tournament), one fresh engine a window: tuples/s, p50
   window, flush and merge walls, the host-level ms (the ``host_merge``
   spans) and the cross-host ms (``cross_host_merge``), the hosts pruned,
   the rows shipped and saved, launches (each > 0) and the host ladder's K2
   launches (> 0 on (x)); the last answer equals the flat engine's, the
   warm answer passes the sampled checks; each printed beside (c) and (d).
   Two mesh paths: (z) is (c) and (z2) is (d) through
   ``SkylineEngine(mesh=make_mesh(4))`` (places ``cuda:i % n``), one fresh
   engine a window: tuples/s, p50 window, the two-phase merge's wall and
   the rest, launches (each > 0), K3 and K2 launched inside the two phases
   on the mesh's places, and each meshed flush step's CUDA-event ms and
   launches; the last answer equals the flat engine's, the warm answer
   passes the sampled checks; each printed beside (c) and (d);
6. timings: each kernel at its main path's shapes (K1–K3 from (c), K4–K7
   from (a), rebuilt from the last window's state; K2 also on the heaviest
   incremental round of (d), its three calls, on the heaviest tree
   pair of a north-star window, its two calls, each recorded from one more
   window, on the heaviest cross-chip pair of (v) and on the heaviest
   host-ladder pair of (x), each its two calls; K3 on the largest shard
   of (z)'s two-phase local phase and K2 on that shard against every
   place's gathered rows),
   CUDA-event ms beside
   the plain version's ms (timed once per input) and the bound: needed
   pairs x d compares at the FP32 peak (K1–K3) or x (d + 1) at the INT32
   compare rate (K5–K7), or bytes at the HBM rate (K4, and whichever is
   larger). Needed pairs: one per dominated victim; per undominated victim
   the dominators whose sum could let them dominate it (values: sum no
   larger, less the rows equal to it in every coordinate; ranks: a smaller
   rank sum). Both peaks are loose lower bounds on time (the predicates
   spend more than one instruction per compare); the plain version must
   agree, and no kernel may read under its bound. K1–K3 and K5–K7 are also
   timed on the north-star shapes filled with uniform rows (ranked by K4
   over their union for K5/K6) and on 65,536 distinct rows: of one sum for
   K1–K3 and K7 (``value_inputs``, ``plane_rows``), of rank sums in a band
   of 16 for K5/K6 (``rank_plane``); each with the share of (victim block,
   dominator tile) pairs ``tile_skip_plain`` or ``rank_tile_skip_plain``
   skips. The mp launches of K1–K3 are timed right after their f32 launch
   on the same inputs (and K2 mp on (d)'s heaviest round), both pre-drop
   entries at the north-star round's shape (P = 8, 512 x 65,536, d = 8;
   the dominators read in place from the skyline buffer; bound: bytes, or
   one f32 compare per needed pair and dimension and four more operations
   a dimension on each certifying pair, the pairs counted as for K1–K3 on
   the bf16-rounded rows; the skipped share and the certified count).
   With ``--parent`` (a checkout of the parent commit) the parent's value
   kernel is built too and each K1–K3 timing and the pre-drop's mask are
   repeated on it in the same call; ``--ab-paths`` then runs the named main
   paths in both trees in turns (parent, change, change, parent). The
   device cascade at the north-star flat-merge union (K3's input), ``mp``
   on and off: its wall beside K3's and the CPU cascade's, its launches,
   and each of its two sites' (the window pass, the scan)
   device ms, plain ms and bound (``cascade_sites``); then the same sites
   over one more window of (l), with the launches a window on (l) and (m);
   the scan's cluster barriers; the window pass split into
   its summary and compare kernels by ``torch.profiler``, with the groups
   that hold a candidate, the items of its worklist and the windows'
   lengths (``cascade_breakdown``); with ``--parent`` the parent's two
   cascade kernels on the same inputs, the windowed K2 split the same way. K3 over a partition batch at
   (n)'s and (o)'s two slide-step shapes (the bucket and window passes of
   the last slide): the wrapper's and its launch's ms, the plain
   version's, the bound and the skipped share. ``--profile`` also profiles
   one more slide of (n) and (o), and gives each profiled path's device
   time by kernel name;
7. analysis (``check_analysis``): the backend probe in a child process
   (``utils/backend_probe.py``; the verdict must be ``cuda`` with a
   device), the knob and lock lints over the port's tree (zero errors),
   ``--check-doc`` (``docs/KNOBS_TORCH.md`` against the registry), the
   graph audit of the flush hot ops on the card (``analysis/graph_audit.py``:
   22 configurations, each under ``torch.cuda.set_sync_debug_mode("error")``
   too, zero errors and zero warnings (no port fault is excused; a host read
   in the cascade's core is an error); every kernel it launched printed
   with its count, each of
   ``AUDIT_WANTED`` at least once), and the trajectory sentinel on a
   healthy (exit 0) and a drifting (exit 1) fixture trajectory.

Each phase's, parity leg's and path's seconds are logged as it ends and
kept under ``seconds`` in the details JSON.

The line before the last is the kernel table as JSON, a row for each
kernel a main path launched (an ``OFF_PATH`` kernel, checked and timed but
launched on no main path, goes under ``off_path_kernels`` in the details
JSON instead); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
# INT32 compares: 64 results per clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) x 132 SMs x
# 1,980 MHz boost (NVIDIA H100 SXM data sheet) — half the FP32 issue rate
INT32_OPS = 64 * 132 * 1.98e9

# entry point -> (short name, route, source, the TPU kernel it replaces)
_VALUE_CU = "skyline_tpu_torch/csrc/dominance.cu"
_RANK_CU = "skyline_tpu_torch/csrc/dominance_rank.cu"
_SCAN_CU = "skyline_tpu_torch/csrc/cascade.cu"
_PALLAS = "skyline_tpu/ops/pallas_dominance.py"
KERNELS = {
    "dominated_by_any": ("K1", "cuda", _VALUE_CU, f"{_PALLAS}:380"),
    "dominated_by_rect": ("K2", "cuda", _VALUE_CU, f"{_PALLAS}:418"),
    "skyline_mask_kernel": ("K3", "cuda", _VALUE_CU, f"{_PALLAS}:467"),
    "rank_transform": (
        "K4", "torch", "skyline_tpu_torch/ops/dominance_kernels.py", f"{_PALLAS}:257",
    ),
    "dominated_by_any_rank": ("K5", "cuda", _RANK_CU, f"{_PALLAS}:301"),
    "dominated_by_rank_rect": ("K6", "cuda", _RANK_CU, f"{_PALLAS}:335"),
    "skyline_mask_rank_kernel": ("K7", "cuda", _RANK_CU, f"{_PALLAS}:512"),
    # the mixed-precision launches of K1-K3 (the TPU kernels' mp,
    # _dom_tile_mp at pallas_dominance.py:85; on the card the f32 kernel) and
    # the bf16 row pre-drop's two entries, the mask and the flush's fused
    # drop (XLA in the reference: ops/dominance.py strictly_dominated_bf16)
    "dominated_by_any_mp": ("K1 mp", "cuda", _VALUE_CU, f"{_PALLAS}:380"),
    "dominated_by_rect_mp": ("K2 mp", "cuda", _VALUE_CU, f"{_PALLAS}:418"),
    "skyline_mask_kernel_mp": ("K3 mp", "cuda", _VALUE_CU, f"{_PALLAS}:467"),
    "strictly_dominated_bf16_kernel": (
        "pre-drop", "cuda", _VALUE_CU, "skyline_tpu/ops/dominance.py:87",
    ),
    "mp_predrop_kernel": (
        "pre-drop fused", "cuda", _VALUE_CU, "skyline_tpu/ops/dominance.py:87",
    ),
    # the device cascade's window pass, its self and band pass for every
    # block in one call (the reference's dominated_by_any_pallas on each
    # block and dominated_by_pallas per band block in its lax.scan,
    # skyline_tpu/ops/device_cascade.py:196-226), and its
    # scan: the pre-drop and the buffer pass of the reference's scan body
    # (device_cascade.py:164-232: strictly_dominated_bf16 and
    # dominated_by_pallas per buffer chunk) on one thread-block cluster. The
    # main paths run both with mp; their f32 launches are timed at the union
    "cascade_windows_mp": ("windows mp", "cuda", _SCAN_CU, f"{_PALLAS}:418"),
    "cascade_scan_mp": ("scan mp", "cuda", _SCAN_CU, f"{_PALLAS}:418"),
}
VALUE_PATH = ("dominated_by_any", "dominated_by_rect", "skyline_mask_kernel")
MP_PATH = ("dominated_by_any_mp", "dominated_by_rect_mp", "skyline_mask_kernel_mp")
PREDROP = "strictly_dominated_bf16_kernel"
PREDROP_FUSED = "mp_predrop_kernel"
# kernels the phases check and time that no main path launches: the
# pre-drop's mask entry (the device cascade runs its test inside its scan;
# skyline_mask_scan and dominated_by_blocked reach it with mp). Their rows
# go beside the kernel line, not in it
OFF_PATH = (PREDROP,)
RANK_PATH = (
    "rank_transform", "dominated_by_any_rank", "dominated_by_rank_rect",
    "skyline_mask_rank_kernel",
)
PHASES = ("kernels", "parity", "main", "timings", "analysis")


def log(msg: str) -> None:
    print(msg, flush=True)


def _kernel_name(mangled: str) -> str:
    """``_ZN<n>_GLOBAL__N_...<n>dominated_kernelILi8ELb1EEEv...`` ->
    ``dominated_kernel<8,1>``: the last component of the nested name, with
    its integer and bool template arguments."""
    if not mangled.startswith("_ZN"):
        return mangled
    pos, name = 3, mangled
    while (m := re.match(r"\d+", mangled[pos:])):
        start = pos + m.end()
        name = mangled[start : start + int(m.group())]
        pos = start + len(name)
    targs = re.match(r"I((?:L[ib]-?\d+E)+)E", mangled[pos:])
    if targs:
        name += "<" + ",".join(re.findall(r"L[ib](-?\d+)E", targs.group(1))) + ">"
    return name


def ptxas_usage(build_log: str):
    """From ``nvcc -Xptxas -v`` output: {kernel: "N registers, M bytes
    smem, ..."} per instantiation, and the lines that report spills."""
    usage, spills, cur = {}, [], None
    for ln in build_log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            cur = _kernel_name(m.group(1))
        elif cur and "Used" in ln and "registers" in ln:
            usage[cur] = ln.split("Used", 1)[1].strip()
        elif cur and "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln:
            spills.append(f"{cur}: {ln.strip()}")
    return usage, spills


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


# -- phase 3: kernels against their plain versions ---------------------------


def _cases(torch, rng, np, dev):
    """(name, x (N, d) f32, valid (N,)) on the card."""
    from skyline_tpu_torch.workload.generators import anti_correlated, uniform

    cases = []
    for d in (3, 4, 8, 16):
        for n in (1000, 4097, 8192):
            # small integer domain: many duplicate rows and tied sums
            x = anti_correlated(rng, n, d, 0, 60) if d <= 8 else uniform(rng, n, d, 0, 20)
            valid = rng.random(n) < 0.9
            x[~valid] = np.inf  # +inf padding on invalid rows, as the engine pads
            dup = rng.integers(0, n, size=n // 10)
            x[rng.integers(0, n, size=n // 10)] = x[dup]
            valid[:: 97] = False  # invalid rows that keep finite coordinates
            cases.append((f"d{d}_n{n}", x, valid))
    # a dominator whose f32 coordinate sum ties its victim's: 1e8 + 1 and
    # 1e8 + 2 both round to 1e8, and the dominator comes after its victim
    x = np.array([[1e8, 2.0, 0.0], [1e8, 1.0, 0.0]] + [[5e7, 5e7, 1.0]] * 3, np.float32)
    cases.append(("sum_tie", x, np.ones(len(x), bool)))
    # NaN and infinities: the plain predicate decides, not a min/max form
    inf, nan = np.inf, np.nan
    x = np.array(
        [[inf, -inf, 1], [inf, 0, 1], [nan, 0, 0], [0, 0, 0], [-inf, -inf, -inf],
         [inf, inf, inf], [0, nan, 5], [1, 1, 1], [-0.0, 0, 0], [0.0, -0.0, 0],
         [1e-45, 0, 0], [0, 0, 1e-45]], np.float32)
    x = np.concatenate([x, x[::-1]])
    cases.append(("nan_inf", x, np.ones(len(x), bool)))
    return [
        (name, torch.from_numpy(x).to(dev), torch.from_numpy(v).to(dev))
        for name, x, v in cases
    ]


def _skip_cases(np, rng, d: int, nx: int, ny: int):
    """Cases aimed at the value kernel's tile and box skips: (name,
    dominators (nx, d), validity (nx,), victims (ny, d)). nx and ny are
    ragged against the 256-row tile and the 256/512-victim block."""
    inf, nan = np.inf, np.nan
    y = rng.integers(0, 4, size=(ny, d)).astype(np.float32)
    cases = []
    # exact copies of the victims, and one row lower in a single dimension
    x = y[rng.integers(0, ny, size=nx)]
    lower = y[ny // 2].copy()
    lower[d // 2] -= 1.0
    x[rng.integers(0, nx)] = lower
    cases.append(("copies_plus_one_lower", x, np.ones(nx, bool), y))
    # +0.0 and -0.0 mixed in both roles
    signed = np.array([0.0, -0.0, 1.0], np.float32)
    x = signed[rng.integers(0, 3, size=(nx, d))]
    cases.append(("signed_zeros", x, np.ones(nx, bool), signed[rng.integers(0, 3, size=(ny, d))]))
    # a first tile made only of NaN rows (some all-NaN, some one NaN), then
    # ordinary rows
    x = rng.integers(0, 4, size=(nx, d)).astype(np.float32)
    x[:256] = nan
    x[1:256:2] = y[rng.integers(0, ny, size=128)]
    x[1:256:2, 0] = nan
    cases.append(("nan_tile", x, np.ones(nx, bool), y))
    # a victim block with NaN rows, +inf rows and rows mixing +inf and NaN
    yb = y.copy()
    yb[::5] = inf
    yb[1::7, d - 1] = nan
    yb[2::11] = nan
    yb[3::13, 0] = inf
    x = rng.integers(0, 4, size=(nx, d)).astype(np.float32)
    valid = rng.random(nx) < 0.8
    x[~valid] = inf
    cases.append(("nan_inf_victims", x, valid, yb))
    # equal rows straddling a tile border, one dominator of them beyond it
    x = rng.integers(2, 6, size=(nx, d)).astype(np.float32)
    x[250:262] = 1.0
    dom = np.ones(d, np.float32)
    dom[0] = 0.0
    x[300] = dom
    yb = y.copy()
    yb[250:262] = 1.0
    cases.append(("equal_rows_across_tile_border", x, np.ones(nx, bool), yb))
    return cases


def _honest_ranks(np, r):
    """(n, d) integer ranks -> (d+1, n) int32 with their sum as the last row."""
    return np.ascontiguousarray(np.column_stack([r, r.sum(1)]).T.astype(np.int32))


def _rank_skip_cases(np, rng, d: int, nx: int, ny: int):
    """Cases aimed at the rank kernel's tile skip: (name, dominators (d+1,
    nx) int32, validity (nx,), victims (d+1, ny)); nx and ny ragged against
    the 256-row tile and the 256-victim block."""
    y = rng.integers(0, 4, size=(ny, d))
    cases = []
    # exact copies of the victims, and one row lower in a single dimension
    x = y[rng.integers(0, ny, size=nx)]
    lower = y[ny // 2].copy()
    lower[d // 2] -= 1
    x[rng.integers(0, nx)] = lower
    cases.append(("copies_plus_one_lower", _honest_ranks(np, x), np.ones(nx, bool),
                  _honest_ranks(np, y)))
    # equal rank sums straddling a tile border, one dominator beyond it
    x = rng.integers(2, 6, size=(nx, d))
    x[250:262] = 1
    x[300] = 1
    x[300, 0] = 0
    yb = y.copy()
    yb[250:262] = 1
    cases.append(("equal_sums_across_tile_border", _honest_ranks(np, x), np.ones(nx, bool),
                  _honest_ranks(np, yb)))
    # sums that differ by 1 where float32 ties them (~2^25)
    cases.append(("sums_near_2p25", _honest_ranks(np, x + 2**25 // d), np.ones(nx, bool),
                  _honest_ranks(np, yb + 2**25 // d)))
    # equal ranks, sum rows one apart: the lower sum row dominates
    xr = _honest_ranks(np, y[rng.integers(0, ny, size=nx)])
    xr[d, ::3] -= 1
    cases.append(("sum_rows_not_their_sums", xr, np.ones(nx, bool), _honest_ranks(np, y)))
    # invalid dominators with finite ranks; invalid tail victims carrying the
    # round's rank U * (d + 1) in every row, sum row included
    yr = _honest_ranks(np, y)
    yr[:, ny - 37 :] = (nx + ny) * (d + 1)
    cases.append(("invalid_tail_victims", _honest_ranks(np, rng.integers(0, 4, size=(nx, d))),
                  rng.random(nx) < 0.8, yr))
    return cases


def check_skip_cases(torch, np, dev) -> int:
    """K1, K2 and K3 on ``_skip_cases``, and K5, K6 and K7 on
    ``_rank_skip_cases``, against their plain versions, with no partition
    dimension and with P = 3 (each partition its own draw); K3 and K7 on
    the first draw's union (K7 reads the rank rows as coordinates)."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    def same(a, b, what):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: kernel and plain version differ in "
                                 f"{int((a != b).sum())} rows")

    rng = np.random.default_rng(17)
    checks = 0
    for d, nx, ny in ((8, 1283, 1799), (3, 777, 1030), (16, 600, 517)):
        draws = [_rank_skip_cases(np, rng, d, nx, ny) for _ in range(3)]
        for c, (name, _, _, _) in enumerate(draws[0]):
            xs, vs, ys = ([torch.from_numpy(dr[c][i]).to(dev) for dr in draws] for i in (1, 2, 3))
            what = f"{name} d={d}"
            for x3, v2, y3, tag in (
                (xs[0], vs[0], ys[0], "P=1"),
                (torch.stack(xs), torch.stack(vs), torch.stack(ys), "P=3"),
            ):
                same(dk.dominated_by_rank_rect(x3, v2, y3),
                     dk.dominated_by_rank_rect_plain(x3, v2, y3), f"K6 {tag} {what}")
                u3 = torch.cat([x3, y3], dim=-1).contiguous()
                uv = torch.cat([v2, torch.ones_like(y3[..., 0, :], dtype=torch.bool)], dim=-1)
                same(dk.dominated_by_any_rank(u3, uv), dk.dominated_by_any_rank_plain(u3, uv),
                     f"K5 {tag} {what}")
                checks += 2
            pts = torch.cat([xs[0], ys[0]], dim=1)[:d].T.float().contiguous()
            uv = torch.cat([vs[0], torch.ones(ny, dtype=torch.bool, device=dev)])
            same(dk.skyline_mask_rank_kernel(pts, uv), dk.skyline_mask_rank_plain(pts, uv),
                 f"K7 {what}")
            checks += 1
    for d, nx, ny in ((8, 1283, 1799), (3, 777, 1030), (16, 600, 517)):
        draws = [_skip_cases(np, rng, d, nx, ny) for _ in range(3)]
        for c, (name, _, _, _) in enumerate(draws[0]):
            xs = [torch.from_numpy(np.ascontiguousarray(dr[c][1].T)).to(dev) for dr in draws]
            vs = [torch.from_numpy(dr[c][2]).to(dev) for dr in draws]
            ys = [torch.from_numpy(np.ascontiguousarray(dr[c][3].T)).to(dev) for dr in draws]
            what = f"{name} d={d}"
            for x3, v2, y3, tag in (
                (xs[0], vs[0], ys[0], "P=1"),
                (torch.stack(xs), torch.stack(vs), torch.stack(ys), "P=3"),
            ):
                same(dk.dominated_by_rect(x3, v2, y3), dk.dominated_by_rect_plain(x3, v2, y3),
                     f"K2 {tag} {what}")
                u3 = torch.cat([x3, y3], dim=-1).contiguous()
                uv = torch.cat([v2, torch.ones_like(y3[..., 0, :], dtype=torch.bool)], dim=-1)
                same(dk.dominated_by_any(u3, uv), dk.dominated_by_any_plain(u3, uv),
                     f"K1 {tag} {what}")
                checks += 2
            u = torch.cat([xs[0], ys[0]], dim=1).T.contiguous()
            uv = torch.cat([vs[0], torch.ones(ny, dtype=torch.bool, device=dev)])
            same(dk.skyline_mask_kernel(u, uv), dk.skyline_mask_plain(u, uv), f"K3 {what}")
            checks += 1
    return checks


def check_kernels(torch, np, dev) -> int:
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.workload.generators import anti_correlated

    def same(a, b, what):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{what}: kernel and plain version differ in {bad} rows")

    rng = np.random.default_rng(7)
    checks = 0
    cases = _cases(torch, rng, np, dev)
    for name, x, valid in cases:
        xt = x.T.contiguous()
        same(dk.dominated_by_any(xt, valid), dk.dominated_by_any_plain(xt, valid), f"K1 {name}")
        # triangular input: sum-sorted, invalid last
        keys = torch.where(valid, x.sum(-1), float("inf"))
        order = torch.argsort(keys, stable=True)
        st, sv = x[order].T.contiguous(), valid[order]
        same(dk.dominated_by_any(st, sv, triangular=True),
             dk.dominated_by_any_plain(st, sv), f"K1 tri {name}")
        same(dk.skyline_mask_kernel(x, valid), dk.skyline_mask_plain(x, valid), f"K3 {name}")
        # K3 under other sort keys (other rounding, other order of ties):
        # the exact in-kernel skip keeps the mask the same
        plain_keep = dk.skyline_mask_plain(x, valid)
        for kname, key in (
            ("f64", x.double().sum(-1)),
            ("reversed", x.flip(-1).sum(-1)),
            ("descending", -x.sum(-1)),
        ):
            o = torch.argsort(torch.where(valid, key, float("inf")), stable=True)
            xs, vs = x[o].T.contiguous(), valid[o]
            keep = torch.empty_like(vs)
            keep[o] = ~dk.dominated_by_any(xs, vs, triangular=True) & vs
            same(keep, plain_keep, f"K3 key={kname} {name}")
        # K2: a ragged split of the same rows into dominators and victims
        n = x.shape[0]
        cut = n // 3 + 1
        xd, vd, yv = x[:cut].T.contiguous(), valid[:cut].contiguous(), x[cut:].T.contiguous()
        same(dk.dominated_by_rect(xd, vd, yv), dk.dominated_by_rect_plain(xd, vd, yv), f"K2 {name}")
        checks += 7
    # the rank cascade (NaN has no rank order: value cases only)
    for name, x, valid in cases:
        if name == "nan_inf":
            continue
        rt = dk.rank_transform(x, valid)
        same(rt, dk.rank_transform(x.cpu(), valid.cpu()).to(dev), f"K4 cuda vs cpu {name}")
        same(dk.dominated_by_any_rank(rt, valid), dk.dominated_by_any_rank_plain(rt, valid),
             f"K5 {name}")
        o = torch.argsort(torch.where(valid, rt[-1].long(), 2**62), stable=True)
        rs, vs = rt[:, o].contiguous(), valid[o]
        same(dk.dominated_by_any_rank(rs, vs, triangular=True),
             dk.dominated_by_any_rank_plain(rs, vs), f"K5 tri {name}")
        keep = dk.skyline_mask_rank_kernel(x, valid)
        same(keep, dk.skyline_mask_rank_plain(x, valid), f"K7 {name}")
        same(keep, dk.skyline_mask_plain(x, valid), f"K7 vs value mask {name}")
        cut = x.shape[0] // 3 + 1
        xr, vr, yr = rt[:, :cut].contiguous(), valid[:cut].contiguous(), rt[:, cut:].contiguous()
        same(dk.dominated_by_rank_rect(xr, vr, yr), dk.dominated_by_rank_rect_plain(xr, vr, yr),
             f"K6 {name}")
        checks += 6
    # rank sums that differ by 1 where float32 ties them (~2^24, ~2^25)
    for base in (2**21, 2**22):
        d, n = 8, 1000
        rt = torch.zeros((d + 1, n), dtype=torch.int32, device=dev)
        rt[:d, :] = base
        rt[0, 1::2] = base + 1  # odd columns: one rank above the even ones
        rt[d] = rt[:d].sum(0, dtype=torch.int32)
        v = torch.ones(n, dtype=torch.bool, device=dev)
        got = dk.dominated_by_any_rank(rt, v)
        same(got, dk.dominated_by_any_rank_plain(rt, v), f"K5 sums near {8 * base}")
        same(dk.dominated_by_rank_rect(rt, v, rt), got, f"K6 sums near {8 * base}")
        want = torch.zeros(n, dtype=torch.bool, device=dev)
        want[1::2] = True
        same(got, want, f"K5 sums near {8 * base} against the known answer")
        checks += 3
    # K1/K2/K5/K6 with a leading partition dimension (the batched SFS round)
    for d, P, nx, ny in ((3, 4, 777, 2049), (8, 8, 4096, 3000), (16, 3, 257, 511)):
        xs = torch.from_numpy(anti_correlated(rng, P * nx, d, 0, 100)).to(dev)
        ys = torch.from_numpy(anti_correlated(rng, P * ny, d, 0, 100)).to(dev)
        x3 = xs.reshape(P, nx, d).transpose(1, 2).contiguous()
        y3 = ys.reshape(P, ny, d).transpose(1, 2).contiguous()
        v2 = torch.from_numpy(rng.random((P, nx)) < 0.8).to(dev)
        same(dk.dominated_by_rect(x3, v2, y3), dk.dominated_by_rect_plain(x3, v2, y3),
             f"K2 P={P} d={d}")
        same(dk.dominated_by_any(x3, v2, triangular=False),
             dk.dominated_by_any_plain(x3, v2), f"K1 P={P} d={d}")
        # one rank universe per partition over its dominators and victims
        ranks = torch.stack([
            dk.rank_transform(
                torch.cat([xs.reshape(P, nx, d)[p], ys.reshape(P, ny, d)[p]]),
                torch.ones(nx + ny, dtype=torch.bool, device=dev),
            ) for p in range(P)
        ])
        xr, yr = ranks[:, :, :nx].contiguous(), ranks[:, :, nx:].contiguous()
        same(dk.dominated_by_rank_rect(xr, v2, yr), dk.dominated_by_rank_rect_plain(xr, v2, yr),
             f"K6 P={P} d={d}")
        same(dk.dominated_by_any_rank(xr, v2), dk.dominated_by_any_rank_plain(xr, v2),
             f"K5 P={P} d={d}")
        checks += 4
    return checks


def _margin_rows(np, rng, d: int):
    """(n, d) f32 rows aimed at the bf16 margin of the mp passes: a base
    block and rows that differ from it, in one dimension or in all, by less
    than, at and just beyond one bf16 ulp and the 2^-7 and 2^-6 bands; exact
    ties and one-f32-ulp neighbours; -0.0/+0.0, NaN, +-inf; subnormals and
    values just above the 1e-30 absolute term; values near the f32 maximum
    (some round to bf16 infinity); and duplicate zero rows."""
    f32 = np.float32
    base = rng.uniform(1.0, 100.0, size=(64, d)).astype(f32)
    parts = [base, base.copy(), np.nextafter(base, f32(np.inf))]
    for scale in (2.0**-9, 2.0**-8, 2.0**-7, 2.0**-6, 2.0**-5):
        for f in (1.0 - 2.0**-12, 1.0, 1.0 + 2.0**-12):
            step = (base * f32(scale * f)).astype(f32)
            one = base.copy()
            one[:, rng.integers(0, d)] += step[:, 0]
            parts += [base + step, base - step, one, np.nextafter(base + step, f32(np.inf))]
    zeros = np.zeros((300, d), f32)
    zeros[::3, 0] = -0.0
    sub = np.full((8, d), f32(2.0**-130))
    sub[::2] *= f32(3.0)
    big = np.full((8, d), f32(3.39e38))
    big[::2] = np.finfo(f32).max
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0], f32)
    parts += [zeros, sub, np.full((8, d), f32(1.5e-30)), np.full((8, d), f32(1e-29)), big,
              special[rng.integers(0, 6, size=(64, d))]]
    x = np.concatenate(parts)
    return x[rng.permutation(x.shape[0])]


def _predrop_cases(np, rng, d: int):
    """(name, victims (P, B, d), dominators (P, L, d), their validity) aimed
    at the pre-drop and its skip rule: a block of zero rows (some -0.0)
    against zero dominators, subnormals, rows one bf16 ulp apart, the
    margin rows of ``_margin_rows``, a north-star-like batch (partition 0
    zeros against zeros, the rest margin rows), and dominator counts of 1,
    511, 513, 777 and 4096 at P = 1, 3 and 8 (ragged victim counts)."""
    f32 = np.float32
    m = _margin_rows(np, rng, d)
    zeros = np.zeros((3, 600, d), f32)
    zeros[:, ::3, 0] = -0.0
    ulp = np.full((1, 512, d), 1.0, f32)
    ulp[0, 1::2] = 1.0078125  # the next bf16 value above 1
    ulp[0, 2::4] = np.nextafter(f32(1.0078125), f32(2.0))
    sub = np.full((1, 64, d), f32(2.0**-130))
    sub[0, ::2] *= f32(3.0)
    ns_y = m[rng.integers(0, m.shape[0], size=(8, 3000))]
    ns_y[0] = 0.0
    ns_x = m[rng.integers(0, m.shape[0], size=(8, 512))]
    ns_x[0] = 0.0
    cases = [
        ("zeros", zeros, np.zeros((3, 512, d), f32)),
        ("ulp", ulp, np.concatenate([ulp[:, :8], np.zeros((1, 1, d), f32)], axis=1)),
        ("subnormal", np.concatenate([sub, np.full((1, 64, d), f32(1e-29))], axis=1), sub),
        ("margin", m[None], m[None, ::3]),
        ("north_star_like", ns_y, ns_x),
    ]
    for nx, P, ny in ((1, 1, 300), (511, 3, 2049), (513, 8, 777), (777, 3, 1000),
                      (4096, 1, 4097)):
        cases.append((f"nx{nx}_P{P}", m[rng.integers(0, m.shape[0], size=(P, ny))],
                      m[rng.integers(0, m.shape[0], size=(P, nx))]))
    return [(name, y, x, rng.random(x.shape[:2]) < 0.85) for name, y, x in cases]


def _kernel_predrop_skips(torch, dk, ys, bv, xs, xv):
    """The fused pre-drop's outputs and its own skip decisions (P, blocks,
    tiles), read from the summaries it leaves in its scratch."""
    P, ny, d = ys.shape
    scratch = dk._scratch(P, d, d, xs.shape[1], ny, ys)
    outs = dk._predrop_call(ys, bv, xs, xv, fused=True, scratch=scratch)
    lo, hi = scratch[1][..., : d + 1], scratch[2][..., : d + 1]
    skip = (lo[:, None, :, d] > hi[:, :, None, d]) | (
        lo[:, None, :, :d] >= hi[:, :, None, :d]).any(-1)
    return outs, skip


def check_mp_kernels(torch, np, dev) -> int:
    """K1, K2 and K3 with ``mp`` (the f32 kernel counted under ``_mp``)
    against their plain versions and against their ``mp=False`` launch,
    exact equality, for d in {3, 8, 16}, on ``_cases`` and the
    margin-adversarial ``_margin_rows`` (alone and appended to the
    north-star's zero rows); K1 and K2 also with P = 3; the pre-drop's mask
    entry against its plain version (``strictly_dominated_bf16``) — mask and
    count — on the same rows, victims against the first 512 rows of the
    sum-sorted set, as an SFS round passes them; and on ``_predrop_cases``
    both entries: the mask, and the fused drop (block bytes, validity and
    per-block counts against ``mp_predrop_plain``) with its dominators read
    in place from a prefix of a wider buffer, and the kernel's own skip
    decisions (from its summaries) equal to ``predrop_skip_plain``'s.
    Returns (checks, {case: skipped share}) for the pre-drop cases."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    def same(a, b, what):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: differ in {int((a != b).sum())} rows")

    rng = np.random.default_rng(23)
    checks = 0
    cases = [(n, x, v) for n, x, v in _cases(torch, rng, np, dev) if x.shape[1] in (3, 8, 16)]
    for d in (3, 8, 16):
        m = _margin_rows(np, rng, d)
        z = np.zeros((2000, d), np.float32)
        for name, rows in (("margin", m), ("zeros_margin", np.concatenate([z, m[:700]]))):
            valid = rng.random(rows.shape[0]) < 0.9
            cases.append((f"{name}_d{d}", torch.from_numpy(rows).to(dev),
                          torch.from_numpy(valid).to(dev)))
    for name, x, valid in cases:
        xt = x.T.contiguous()
        plain = dk.dominated_by_any_plain(xt, valid)
        same(dk.dominated_by_any(xt, valid, mp=True), plain, f"K1 mp vs plain {name}")
        same(dk.dominated_by_any(xt, valid, mp=True), dk.dominated_by_any(xt, valid),
             f"K1 mp vs f32 {name}")
        keys = torch.where(valid, x.sum(-1), float("inf"))
        order = torch.argsort(keys, stable=True)
        st, sv = x[order].T.contiguous(), valid[order]
        same(dk.dominated_by_any(st, sv, triangular=True, mp=True),
             dk.dominated_by_any(st, sv, triangular=True), f"K1 mp tri vs f32 {name}")
        cut = x.shape[0] // 3 + 1
        xd, vd, yv = x[:cut].T.contiguous(), valid[:cut].contiguous(), x[cut:].T.contiguous()
        k2 = dk.dominated_by_rect(xd, vd, yv, mp=True)
        same(k2, dk.dominated_by_rect_plain(xd, vd, yv), f"K2 mp vs plain {name}")
        same(k2, dk.dominated_by_rect(xd, vd, yv), f"K2 mp vs f32 {name}")
        keep = dk.skyline_mask_kernel(x, valid, mp=True)
        same(keep, dk.skyline_mask_plain(x, valid), f"K3 mp vs plain {name}")
        same(keep, dk.skyline_mask_kernel(x, valid), f"K3 mp vs f32 {name}")
        # the pre-drop: victims against the sum-sorted set's first 512 rows
        dom, dv = x[order][:512].contiguous(), valid[order][:512].contiguous()
        pre = dk.strictly_dominated_bf16_kernel(x, dom, dv)
        want = dk.strictly_dominated_bf16_plain(x, dom, dv)
        same(pre, want, f"pre-drop vs plain {name}")
        if int(pre.sum()) != int(want.sum()):
            raise AssertionError(f"pre-drop count {name}")
        checks += 9
    for d, P, nx, ny in ((3, 3, 777, 2049), (8, 3, 4096, 3000), (16, 3, 257, 511)):
        rows = _margin_rows(np, rng, d)
        xs = torch.from_numpy(rows[rng.integers(0, rows.shape[0], P * nx)]).to(dev)
        ys = torch.from_numpy(rows[rng.integers(0, rows.shape[0], P * ny)]).to(dev)
        x3 = xs.reshape(P, nx, d).transpose(1, 2).contiguous()
        y3 = ys.reshape(P, ny, d).transpose(1, 2).contiguous()
        v2 = torch.from_numpy(rng.random((P, nx)) < 0.8).to(dev)
        same(dk.dominated_by_rect(x3, v2, y3, mp=True), dk.dominated_by_rect_plain(x3, v2, y3),
             f"K2 mp P={P} d={d}")
        same(dk.dominated_by_any(x3, v2, mp=True), dk.dominated_by_any_plain(x3, v2),
             f"K1 mp P={P} d={d}")
        checks += 2
    shares = {}
    for d in (3, 8, 16):
        for name, y3, x3, xv3 in _predrop_cases(np, rng, d):
            what = f"pre-drop {name} d={d}"
            ys, xs = torch.from_numpy(y3).to(dev), torch.from_numpy(x3).to(dev)
            xv = torch.from_numpy(xv3).to(dev)
            bv = torch.from_numpy(rng.random(y3.shape[:2]) < 0.9).to(dev)
            same(dk.strictly_dominated_bf16_kernel(ys, xs, xv),
                 dk.strictly_dominated_bf16_plain(ys, xs, xv), f"{what} mask")
            # the dominators and their validity as a prefix of wider buffers
            L = xs.shape[1]
            wide, wide_v = torch.cat([xs, xs], dim=1)[:, :L], torch.cat([xv, xv], dim=1)[:, :L]
            got = dk.mp_predrop_kernel(wide, wide_v, ys, bv)
            want = dk.mp_predrop_plain(xs, xv, ys, bv)
            torch.cuda.synchronize()
            if got[0].cpu().numpy().tobytes() != want[0].cpu().numpy().tobytes():
                raise AssertionError(f"{what} fused: block bytes differ")
            same(got[1], want[1], f"{what} fused validity")
            same(got[2], want[2], f"{what} fused counts")
            outs, skip = _kernel_predrop_skips(torch, dk, ys, bv, wide, wide_v)
            same(outs[2], want[2], f"{what} fused counts (scratch call)")
            plain_skip = dk.predrop_skip_plain(ys, xs, xv, dk.TILE_ROWS, dk.BLOCK_VICTIMS, bv)
            same(skip, plain_skip, f"{what} skip decisions")
            if name in ("zeros", "north_star_like"):
                whole = skip.all() if name == "zeros" else skip[0].all()
                if not bool(whole):
                    raise AssertionError(f"{what}: the zero block is not skipped whole")
            shares[f"{name}_d{d}"] = float(skip.float().mean()) if skip.numel() else 1.0
            checks += 5
    log("kernels: pre-drop skipped share of (block, tile) pairs by case: "
        + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()))
    return checks, shares


def check_merge_step(torch, np, dev, B: int = 8192) -> int:
    """The incremental merge step on the card: ``merge_step_active`` (its K2
    core) against the plain core over the same active prefix, bytes and
    counts, round after round — P = 8, batches of 8,192 rows in arrival
    order (not sum-sorted) with ragged widths, the sky the previous round's
    output; d = 8 on a small integer domain (ties), d = 3 anti-correlated;
    with and without ``mp`` (the pre-drop kernel and K2 mp against the
    plain pre-drop and core: bytes, counts and certified drops). The second
    round outgrows the 8,192-row capacity."""
    from skyline_tpu_torch.stream import window as win
    from skyline_tpu_torch.workload.generators import anti_correlated

    rng = np.random.default_rng(19)
    P = 8
    # ragged widths per round, as shares of B (8,192 rows)
    widths_per_round = [
        [round(B * f) for f in fr] for fr in (
            (1, 0.61, 0, 1, 1 / B, 0.037, 1, 0.5),
            (1, 1, 7 / B, 0, 1, 0.122, 0.305, 1),
            (0.012, 0, 1, 0.366, 1, 1, 1 / B, 0.0078),
        )
    ]
    checks = 0
    for d, domain, mp in ((8, 60, False), (3, 10000, False), (8, 60, True), (3, 10000, True)):
        certified = 0
        cap = B
        sky = torch.full((P, cap, d), float("inf"), device=dev)
        counts = torch.zeros(P, dtype=torch.int64, device=dev)
        grew = False
        for rnd, widths in enumerate(widths_per_round):
            w = np.array(widths)
            batch = np.full((P, B, d), np.inf, np.float32)
            for p in range(P):
                batch[p, : w[p]] = anti_correlated(rng, int(w[p]), d, 0, domain)
            batch = torch.from_numpy(batch).to(dev)
            bvalid = torch.from_numpy(np.arange(B)[None, :] < w[:, None]).to(dev)
            c = counts.cpu().numpy()
            active = min(cap, win._active_bucket(max(int(c.max()), 1)))
            grow = win._next_pow2(max(int((c + w).max()), 1))
            valid = torch.arange(cap, device=dev)[None, :] < counts[:, None]
            vals, _, cnt, res = win.merge_step_active(
                sky, valid, batch, bvalid, active, grow, mp
            )
            pv, _, pc, pres = win._merge_step_core(
                sky[:, :active], valid[:, :active], batch, bvalid, grow, mp
            )
            torch.cuda.synchronize()
            if not torch.equal(cnt, pc) or not torch.equal(vals[:, :grow], pv) \
                    or not torch.equal(res, pres):
                raise AssertionError(
                    f"merge step d={d} mp={mp} round {rnd}: kernel core {cnt.tolist()} rows "
                    f"({res.tolist()} certified), plain {pc.tolist()} ({pres.tolist()}), or "
                    "other bytes"
                )
            grew |= grow > cap
            certified += int(res.sum())
            sky, counts, cap = vals, cnt, max(cap, grow)
            checks += 1
        if not grew:
            raise AssertionError(f"merge step d={d}: no round outgrew the capacity")
        if mp and not certified:
            raise AssertionError(f"merge step d={d} mp: the pre-drop certified nothing")
    return checks


def check_sweep(torch, np, dev) -> int:
    """The d <= 2 sweep's torch ops on the card against the CPU: the
    partitioned sweep (packed state and counts) and the survivor mask, on
    ties, signed zeros, infinities and NaN, with an empty partition."""
    from skyline_tpu_torch.ops import sweep2d

    rng = np.random.default_rng(29)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, 2.0], np.float32)
    checks = 0
    for kind in ("ties", "special", "anti"):
        n, P = 300_000, 8
        if kind == "ties":
            x = rng.integers(0, 50, size=(n, 2)).astype(np.float32)
        elif kind == "special":
            x = special[rng.integers(0, 7, size=(n, 2))]
        else:
            x = rng.random((n, 2)).astype(np.float32)
            x[:, 1] = 1.0 - x[:, 0] + rng.random(n).astype(np.float32) * 0.01
        pids = rng.integers(0, P, n).astype(np.int32)
        pids[pids == 5] = 6
        valid = rng.random(n) < 0.9
        args = [torch.from_numpy(a) for a in (x, pids, valid)]
        cpu = sweep2d.partitioned_sweep2(*args, P, 1 << 16)
        card = sweep2d.partitioned_sweep2(*(a.to(dev) for a in args), P, 1 << 16)
        mask = sweep2d.skyline_mask_sweep(args[0][:, :1].contiguous(), args[2])
        mask_card = sweep2d.skyline_mask_sweep(args[0][:, :1].to(dev), args[2].to(dev))
        if (
            card[0].cpu().numpy().tobytes() != cpu[0].numpy().tobytes()
            or not torch.equal(card[1].cpu(), cpu[1])
            or not torch.equal(
                sweep2d.skyline_mask_sweep(args[0].to(dev), args[2].to(dev)).cpu(),
                sweep2d.skyline_mask_sweep(*args[::2]),
            )
            or not torch.equal(mask_card.cpu(), mask)
        ):
            raise AssertionError(f"sweep on the card differs from the CPU ({kind})")
        checks += 3
    return checks


def _skyline_of(torch, rows):
    """The skyline rows of ``rows`` (n, d) in their order, by the plain mask
    (on the tensor's device)."""
    from skyline_tpu_torch.ops.dominance import skyline_mask

    return rows[skyline_mask(rows)]


def _tree_pair_cases(torch, np, rng, dev):
    """(name, a, a's partition ids, acnt, b, b's ids, bcnt, out_cap) on the
    card: each side a skyline in +inf-padded storage, as the tree feeds its
    leaves. Signed zeros, NaN and +inf rows; rows equal across a and b; an
    empty a or b; out_cap exactly acnt + bcnt; and a north-star-like pair
    (thousands of zero-vector copies against a small anti-correlated
    skyline)."""
    from skyline_tpu_torch.workload.generators import anti_correlated

    special = np.array([0.0, -0.0, np.inf, np.nan, 1.0, 2.0], np.float32)

    def side(rows, width):
        x = torch.full((width, rows.shape[1]), float("inf"), device=dev)
        x[: rows.shape[0]] = rows
        return x, int(rows.shape[0])

    def sky(x):
        return _skyline_of(torch, torch.from_numpy(np.ascontiguousarray(x)).to(dev))

    cases = []
    for name, d, na, nb in (("anti", 3, 3000, 5000), ("anti", 8, 6000, 4000),
                            ("special", 4, 2000, 2000), ("shared", 8, 3000, 3000),
                            ("empty_a", 3, 0, 3000), ("empty_b", 8, 3000, 0)):
        gen = (lambda n: special[rng.integers(0, 6, size=(n, d))]) if name == "special" \
            else (lambda n: anti_correlated(rng, n, d, 0, 60))
        ra = sky(gen(na)) if na else torch.empty((0, d), device=dev)
        rb = sky(gen(nb)) if nb else torch.empty((0, d), device=dev)
        if name == "shared":
            # rows equal across a and b: both copies survive
            rb = _skyline_of(torch, torch.cat([ra[:200], rb]))
        for tight in (False, True):
            wa = max(1024, 1 << max(ra.shape[0] - 1, 0).bit_length())
            wb = max(1024, 1 << max(rb.shape[0] - 1, 0).bit_length())
            a, acnt = side(ra, wa)
            b, bcnt = side(rb, wb)
            out_cap = max(acnt + bcnt, 1) if tight else wa + wb
            cases.append((f"{name} d={d}{' tight' if tight else ''}", a,
                          torch.full((wa,), 1, dtype=torch.int64, device=dev), acnt,
                          b, torch.full((wb,), 5, dtype=torch.int64, device=dev), bcnt,
                          out_cap))
    zeros = torch.zeros((20000, 8), device=dev)
    zeros[::7, 3] = -0.0
    rest = sky(anti_correlated(rng, 20000, 8, 0, 10000))
    a, acnt = side(zeros, 32768)
    b, bcnt = side(rest, 1 << max(rest.shape[0] - 1, 0).bit_length())
    cases.append(("north-star-like d=8", a, torch.zeros(32768, dtype=torch.int64, device=dev),
                  acnt, b, torch.full((b.shape[0],), 3, dtype=torch.int64, device=dev), bcnt,
                  acnt + bcnt))
    return cases


def check_tree(torch, np, dev) -> int:
    """The tree merge's functions on the card against the CPU, bytes and
    counts: ``tree_pair_merge`` (two K2 launches on the card, the plain K2
    on the CPU) on ``_tree_pair_cases``, ``compact_tagged`` and
    ``partition_summaries_device`` (by value: a minimum may keep -0.0 on
    one device and +0.0 on the other, and only comparisons read it)."""
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.ops.dominance import compact_tagged
    from skyline_tpu_torch.stream import window as win

    rng = np.random.default_rng(41)
    checks = 0
    for name, a, ap, acnt, b, bp, bcnt, out_cap in _tree_pair_cases(torch, np, rng, dev):
        before = dk.LAUNCHES["dominated_by_rect"]
        args = (a, ap, torch.tensor(acnt, device=dev), b, bp, torch.tensor(bcnt, device=dev))
        card = win.tree_pair_merge(*args, out_cap)
        torch.cuda.synchronize()
        if dk.LAUNCHES["dominated_by_rect"] - before != 2:
            raise AssertionError(f"tree pair {name}: launched K2 "
                                 f"{dk.LAUNCHES['dominated_by_rect'] - before} times, not 2")
        cpu = win.tree_pair_merge(*(t.cpu() for t in args), out_cap)
        if card[0].cpu().numpy().tobytes() != cpu[0].numpy().tobytes() \
                or not torch.equal(card[1].cpu(), cpu[1]) or int(card[2]) != int(cpu[2]):
            raise AssertionError(f"tree pair {name}: the card ({int(card[2])} rows) differs "
                                 f"from the CPU ({int(cpu[2])} rows)")
        checks += 1
    special = np.array([0.0, -0.0, np.inf, np.nan, 1.0], np.float32)
    for n, cap in ((5000, 4096), (5000, 5000), (3000, 8192)):
        x = torch.from_numpy(special[rng.integers(0, 5, size=(n, 4))])
        tags = torch.from_numpy(rng.integers(0, 8, size=n))
        keep = torch.from_numpy(rng.random(n) < 0.7)
        card = compact_tagged(x.to(dev), tags.to(dev), keep.to(dev), cap)
        cpu = compact_tagged(x, tags, keep, cap)
        if card[0].cpu().numpy().tobytes() != cpu[0].numpy().tobytes() or not all(
            torch.equal(c.cpu(), w) for c, w in zip(card[1:], cpu[1:])
        ):
            raise AssertionError(f"compact_tagged n={n} cap={cap}: the card differs")
        checks += 1
    for d in (3, 8):
        P, cap, active = 8, 4096, 2560
        counts = torch.from_numpy(np.array([0, 1, 2500, 17, 2560, 900, 0, 44]))
        sky = torch.full((P, cap, d), float("inf"))
        for p in range(P):
            rows = special[rng.integers(0, 5, (int(counts[p]), d))]
            sky[p, : counts[p]] = torch.from_numpy(rows)
        sky[4, :1000] = torch.from_numpy(rng.integers(0, 9, (1000, d)).astype(np.float32))
        card = win.partition_summaries_device(sky.to(dev), counts.to(dev), active).cpu().numpy()
        cpu = win.partition_summaries_device(sky, counts, active).numpy()
        np.testing.assert_array_equal(card, cpu, err_msg=f"partition summaries d={d}")
        checks += 1
    return checks


def _cascade_cases(torch, np, rng, dev):
    """(name, x (N, d), valid (N,)) on the card for the device cascade:
    ``_cases`` at d in {3, 8, 16} and its NaN/infinity and sum-tie rows,
    signed-zero duplicates, mixed +/-inf rows (NaN keys: a band to the
    end), all-NaN and partly NaN rows, and a 65,536-row north-star block
    (~44% zero vectors, some of them -0.0)."""
    from skyline_tpu_torch.workload.generators import anti_correlated

    cases = [c for c in _cases(torch, rng, np, dev)
             if c[1].shape[1] in (3, 8, 16) and not c[0].startswith("d4_")]
    inf, nan = np.inf, np.nan
    extra = {
        "signed_zero": np.array([[-0.0, 0, 1], [0, -0.0, 1], [0, 0, 1], [1, 1, 1],
                                 [-0.0, -0.0, 1]] * 40, np.float32),
        "mixed_inf": np.array([[inf, -inf, 0], [-inf, inf, 0], [-inf, -inf, -inf],
                               [0, 0, 0], [inf, -inf, 1], [nan, nan, nan],
                               [2, nan, 0], [inf, inf, inf]] * 300, np.float32),
    }
    ns = anti_correlated(rng, 65536, 8, 0, 10000)
    ns[rng.integers(0, 65536, 64)] = -0.0
    extra["north_star_block"] = ns
    for name, x in extra.items():
        cases.append((name, torch.from_numpy(x).to(dev),
                      torch.from_numpy(rng.random(x.shape[0]) < 0.95).to(dev)))
    return cases


# the 2^24 band: every f32 row sum is 2^24 (fl(2^24 + c) = 2^24 for c < 1),
# the three trailing rows tie the key with different exact sums
BAND_ROWS = [(16777216.0 - j, float(j), 0.0) for j in range(2, 22)] + [
    (16777216.0, 0.5, 0.0), (16777216.0, 1.0, 0.0), (16777216.0, 0.75, 0.0)]


# the device cascade's entries: one launch of each a call, whatever the
# block count
CASCADE_ENTRIES = ("cascade_windows", "cascade_scan")
# two sizes with other block counts (2 and 32 blocks of 2,048 rows)
CASCADE_PLAN_ROWS = (4096, 65536)


def _cascade_launches(dk, fn):
    """``fn()``'s result and the launches it made, by entry (those it made
    none of left out)."""
    before = dict(dk.LAUNCHES)
    out = fn()
    return out, {k: v - before[k] for k, v in dk.LAUNCHES.items() if v > before[k]}


# harder inputs for the device cascade: uniform rows (a buffer of many tiles
# at d = 8, so the cluster's CTAs split its tiles), (name, d, rows)
CASCADE_HARD = (("uniform_d3", 3, 65536), ("uniform_d8", 8, 65536), ("uniform_d16", 16, 16384))
# the scan blocks (SKYLINE_DEVICE_CASCADE_BLOCK) the north-star block and the
# 8-D uniform rows also run at, beside the default 2,048
CASCADE_BLOCKS = ("1024", "4096")


def _cascade_check(torch, dk, tdc, name, x, v, mp, want):
    """One device cascade call on the card against the CPU and K3, exact,
    and its launches against ``want``."""
    card, launched = _cascade_launches(dk, lambda: tdc.device_cascade_mask(x, v))
    if launched != want:
        raise AssertionError(f"cascade {name}: a call launched {launched}, not {want}")
    cpu = tdc.device_cascade_mask(x.cpu(), None if v is None else v.cpu())
    k3 = dk.skyline_mask_kernel(x, v, mp=mp)
    if not (torch.equal(card.cpu(), cpu) and torch.equal(card, k3)):
        raise AssertionError(f"cascade {name} mp={mp}: card {int(card.sum())}, CPU "
                             f"{int(cpu.sum())}, K3 {int(k3.sum())} survivors")


def _core_args(tdc, name, x):
    """The arguments ``device_cascade_mask(x)`` passes to the core's entry
    ``name`` (``cascade_windows`` or ``cascade_scan``) in its one call."""
    seen = []
    real = getattr(tdc, name)

    def spy(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    setattr(tdc, name, spy)
    try:
        tdc.device_cascade_mask(x)
    finally:
        setattr(tdc, name, real)
    (args,) = seen
    return args


def check_worklist(torch, dk, tdc, x) -> int:
    """The window pass's device worklist (its summary kernel's items, read
    from its scratch) on the core's own candidates of ``x`` equals
    ``cascade_worklist_plain`` on the CPU, and its mask the plain
    version's. Returns the items."""
    cand, block, band_end = _core_args(tdc, "cascade_windows", x)[:3]
    scratch = {}
    got = dk.cascade_windows(cand, block, band_end, scratch=scratch)
    count = int(scratch["counters"][0])
    items = sorted(map(tuple, scratch["items"][:count, :3].tolist()))
    want = dk.cascade_worklist_plain(cand.cpu(), block, band_end.cpu())
    if items != want:
        raise AssertionError(f"cascade worklist: {count} items on the card, {len(want)} in "
                             "cascade_worklist_plain, or they differ")
    if not torch.equal(got.cpu(), dk.cascade_windows_plain(cand.cpu(), block, band_end.cpu())):
        raise AssertionError("cascade window pass: the card differs from its plain version")
    return count


# calls of the scan alone on one input, each against the plain version: a
# race between the CTAs or warps of the cluster shows as a call that differs
SCAN_REPEATS = 50
SCAN_REPEAT_BLOCKS = ("1024", "2048")


def check_scan_repeats(torch, dk, tdc, name, x) -> int:
    """The scan alone, ``SCAN_REPEATS`` calls at each of
    ``SCAN_REPEAT_BLOCKS`` with mp off and on, on the inputs the core gives
    it for ``x``; every call's mask equals ``cascade_scan_plain`` on the
    CPU. Returns the calls."""
    calls = 0
    for block in SCAN_REPEAT_BLOCKS:
        for mp in (False, True):
            with knob_env({"SKYLINE_DEVICE_CASCADE_BLOCK": block,
                           "SKYLINE_MIXED_PRECISION": "1" if mp else "0"}):
                cand, alive, blk, _ = _core_args(tdc, "cascade_scan", x)
            want = dk.cascade_scan_plain(cand.cpu(), alive.cpu(), blk, mp)
            for i in range(SCAN_REPEATS):
                got = dk.cascade_scan(cand, alive, blk, mp)
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(
                        f"cascade scan {name} block {blk} mp={mp}: call {i} of {SCAN_REPEATS} "
                        f"differs from the plain version ({int(got.sum())} against "
                        f"{int(want.sum())} survivors)")
                calls += 1
    return calls


def check_cascade(torch, np, dev) -> int:
    """The device sorted dominance cascade (``ops/device_cascade.py``) on the
    card against its CPU version and against K3, exact masks, with
    ``SKYLINE_MIXED_PRECISION`` off and on, on ``_cascade_cases`` (the
    card's sizes: 1,024-row blocks and padding) and ``CASCADE_HARD``, the
    north-star block and the 8-D uniform rows again at ``CASCADE_BLOCKS``;
    and its core at block 8 on the 2^24 equal-key band (``BAND_ROWS``,
    padded to 32 rows), card against CPU and K3. Each card call launches
    each of ``CASCADE_ENTRIES`` exactly once (``_mp`` with mp) and nothing
    else, and north-star rows at ``CASCADE_PLAN_ROWS`` (2 and 32 blocks)
    make the same launches. The window pass's device worklist equals its
    plain mirror on the north-star block and the 8-D uniform rows, and the
    scan alone holds its plain version call after call on both
    (``check_scan_repeats``)."""
    from skyline_tpu_torch.ops import device_cascade as tdc
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.workload.generators import anti_correlated

    rng = np.random.default_rng(61)
    checks = 0
    cases = _cascade_cases(torch, np, rng, dev)
    hard = [(name, torch.from_numpy(rng.random((n, d), dtype=np.float32)).to(dev), None)
            for name, d, n in CASCADE_HARD]
    reblocked = [c for c in cases + hard if c[0] in ("north_star_block", "uniform_d8")]
    band = np.array(BAND_ROWS + [(np.inf,) * 3] * (32 - len(BAND_ROWS)), np.float32)
    band_ok = np.arange(32) < len(BAND_ROWS)
    for mp in (False, True):
        with knob_env({"SKYLINE_MIXED_PRECISION": "1" if mp else "0"}):
            want = {k + ("_mp" if mp else ""): 1 for k in CASCADE_ENTRIES}
            for name, x, v in cases + hard:
                _cascade_check(torch, dk, tdc, name, x, v, mp, want)
                checks += 1
            for block in CASCADE_BLOCKS:
                with knob_env({"SKYLINE_DEVICE_CASCADE_BLOCK": block}):
                    for name, x, v in reblocked:
                        _cascade_check(torch, dk, tdc, f"{name} block {block}", x, v, mp, want)
                        checks += 1
            xb, vb = torch.from_numpy(band), torch.from_numpy(band_ok)
            card = tdc._cascade_core(xb.to(dev), vb.to(dev), 8, mp)
            cpu = tdc._cascade_core(xb, vb, 8, mp)
            k3 = dk.skyline_mask_kernel(xb.to(dev), vb.to(dev), mp=mp)
            if not (torch.equal(card.cpu(), cpu) and torch.equal(card, k3)) \
                    or not card[20] or card[21] or card[22]:
                raise AssertionError(f"cascade 2^24 band mp={mp}: card {card.tolist()}")
            checks += 1
            plans = {}
            for n in CASCADE_PLAN_ROWS:
                x = torch.from_numpy(anti_correlated(rng, n, 8, 0, 10000)).to(dev)
                plans[n] = _cascade_launches(dk, lambda x=x: tdc.device_cascade_mask(x))[1]
            if any(plan != want for plan in plans.values()):
                raise AssertionError(f"cascade mp={mp}: launches at {CASCADE_PLAN_ROWS} rows "
                                     f"{plans}, not {want} each")
            checks += 1
    items = {name: check_worklist(torch, dk, tdc, x) for name, x, _ in reblocked}
    checks += len(items)
    repeats = {name: check_scan_repeats(torch, dk, tdc, name, x) for name, x, _ in reblocked}
    checks += len(repeats)
    log(f"kernels: the device cascade launches {', '.join(CASCADE_ENTRIES)} once a call "
        f"(each case, mp off and on, at blocks of 2,048 and {', '.join(CASCADE_BLOCKS)}, and "
        f"at {CASCADE_PLAN_ROWS} rows: 2 and 32 blocks); the window pass's worklist = its "
        f"plain mirror ({items} items); the scan alone = its plain version on every call "
        f"({repeats} calls); the scan's cluster: {dk.SCAN_CTAS} CTAs")
    return checks


def check_skyline_large(torch, np, n: int, dev) -> dict:
    """``skyline_large`` on an n-row north-star window (8-D anti-correlated,
    0-10000) on the card: its rows and their order equal K3's survivors in
    the host's stable sum order. The second call is timed (host sort, the
    SFS rounds, the final count read and download); its bound is K3's for
    the same function: the window read and the skyline written once at the
    HBM rate, or the needed pairs x d at the FP32 peak."""
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.ops.block_skyline import skyline_large
    from skyline_tpu_torch.workload.generators import anti_correlated

    x = anti_correlated(np.random.default_rng(67), n, 8, 0, 10000)
    got = skyline_large(x, device=dev)
    xd = torch.from_numpy(x).to(dev)
    keep_d = dk.skyline_mask_kernel(xd, mp=True)
    keep = keep_d.cpu().numpy()
    xt = xd.T.contiguous()
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    pairs = _needed_pairs(torch, xt, ones, xt, ~keep_d, ones)
    bound = max((x.nbytes + int(keep.sum()) * x.shape[1] * 4) / HBM_BYTES_S * 1e3,
                pairs * x.shape[1] / FP32_FLOPS * 1e3)
    order = np.argsort(x.sum(axis=1), kind="stable")
    want = x[order][keep[order]]
    if got.shape != want.shape or got.tobytes() != want.tobytes():
        raise AssertionError(f"skyline_large: {got.shape[0]} rows, K3 keeps {want.shape[0]}")
    dk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    skyline_large(x, device=dev)
    wall = (time.perf_counter() - t0) * 1e3
    out = {"rows": n, "skyline_rows": int(got.shape[0]), "wall_ms": wall,
           "bound_ms": bound, "needed_pairs": pairs,
           "launches": {k: v for k, v in dk.LAUNCHES.items() if v}}
    log(f"kernels: skyline_large on the {n}-row north-star window = K3's survivors in sum "
        f"order ({got.shape[0]} rows); a second call {wall:.1f} ms (bound {bound:.4f} ms, "
        f"{pairs} needed pairs), launches {out['launches']}")
    return out


# -- phases 4 and 5: the engine ----------------------------------------------


NORTH_STAR = dict(
    parallelism=4, algo="mr-angle", dims=8, domain_max=10000.0,
    buffer_size=8192, initial_capacity=65536, flush_policy="lazy",
)
# benchmarks/reference_grid.py run_cell("mr-angle", 3, ...): the engine's
# default (incremental) policy
GRID_3D = dict(
    parallelism=4, algo="mr-angle", dims=3, domain_max=10000.0,
    buffer_size=8192, flush_policy="incremental",
)
PARITY_ROWS = 65536
DEVICE_PARITY_ROWS = 32768
# the flat global merge: the tree, the merge cache and the query overlap off
# (the reference's defaults have all three on)
PLANE_OFF = {"SKYLINE_MERGE_TREE": "0", "SKYLINE_MERGE_CACHE": "0",
             "SKYLINE_QUERY_OVERLAP": "0"}
# K2 in the tree merge's pairs
TREE_K2 = ("dominated_by_rect",)
# the mixed-precision SFS rounds: the fused pre-drop, then K1 and K2 with mp
MP_ROUNDS = (PREDROP_FUSED,) + MP_PATH[:2]
# the device cascade's mixed-precision launches: the full square and the
# band (the window pass) and the scan (the pre-drop and the buffer pass)
MP_CASCADE = ("cascade_windows_mp", "cascade_scan_mp")
MP_ANY = MP_ROUNDS + (PREDROP,) + MP_CASCADE + MP_PATH[2:]
# the flush cascade off: the bf16 passes, and the grid prefilter
MP_OFF = {"SKYLINE_MIXED_PRECISION": "0"}
CASCADE_OFF = {"SKYLINE_MIXED_PRECISION": "0", "SKYLINE_FLUSH_PREFILTER": "0"}
# the dispatch race's rows: the device sorted cascade forced, and the SFS
# rounds alone (no race: the legs that compare the rounds' counters)
CASCADE_ON = {"SKYLINE_DEVICE_CASCADE": "on"}
ROUNDS_ONLY = {"SKYLINE_SORTED_SFS": "off", "SKYLINE_DEVICE_CASCADE": "off"}
# the main paths: (engine configuration, rank cascade, the kernels each must
# launch, other knobs). (l) is (c) and (m) is (g) with the device sorted
# cascade forced: (l)'s every lazy flush is a survivor mask of old ∪ new on
# the card (the window pass and the scan, mp), (m)'s flat merge masks its
# union through the cascade instead of K3. Under the reference's defaults the d > 2 merge is
# the pruned tree (K2 pairs, no mp: the reference's tree runs mp=False) —
# (a)–(e) — and the value flush rounds are mixed-precision on a card (the
# pre-drop, K1/K2 mp); (g) and (h) turn the tree off, so K3 (mp) and K7
# (with its K4) merge at full width; (f) must launch no kernel; (i) is (b)
# and (k) is (g) with the bf16 passes off, (j) is (d) with the whole flush
# cascade off
PATHS = {
    "a": (dict(NORTH_STAR, ingest="device"), True, RANK_PATH[1:3] + TREE_K2, {}),
    "b": (dict(NORTH_STAR, ingest="device"), False, MP_ROUNDS + TREE_K2, {}),
    "c": (dict(NORTH_STAR, ingest="host"), False, MP_ROUNDS + TREE_K2, {}),
    "d": (dict(GRID_3D, ingest="host"), False, (PREDROP_FUSED, MP_PATH[1]) + TREE_K2, {}),
    "e": (dict(NORTH_STAR, flush_policy="overlap", ingest="device"), False,
          MP_ROUNDS + TREE_K2, {}),
    "f": (dict(GRID_3D, dims=2, ingest="host"), False, (), {}),
    "g": (dict(NORTH_STAR, ingest="device"), False, MP_ROUNDS + MP_PATH[2:],
          {"SKYLINE_MERGE_TREE": "0"}),
    "h": (dict(NORTH_STAR, ingest="device"), True, RANK_PATH, {"SKYLINE_MERGE_TREE": "0"}),
    "i": (dict(NORTH_STAR, ingest="device"), False, VALUE_PATH[:2], MP_OFF),
    "j": (dict(GRID_3D, ingest="host"), False, TREE_K2, CASCADE_OFF),
    "k": (dict(NORTH_STAR, ingest="device"), False, VALUE_PATH,
          {"SKYLINE_MERGE_TREE": "0", **MP_OFF}),
    "l": (dict(NORTH_STAR, ingest="host"), False, MP_CASCADE + TREE_K2, CASCADE_ON),
    "m": (dict(NORTH_STAR, ingest="device"), False, MP_ROUNDS + MP_CASCADE,
          {"SKYLINE_MERGE_TREE": "0", **CASCADE_ON}),
    "p": (dict(NORTH_STAR, ingest="device"), False, MP_ROUNDS + TREE_K2, {}),
    "q": (dict(GRID_3D, ingest="host", grid_prefilter=True), False,
          (PREDROP_FUSED, MP_PATH[1]) + TREE_K2, {}),
    # (b) and (f) with the serving and audit planes (SERVE_PATHS)
    "r": (dict(NORTH_STAR, ingest="device"), False, MP_ROUNDS + TREE_K2, {}),
    "s": (dict(GRID_3D, dims=2, ingest="host"), False, (), {}),
}
# the paths whose engines record into a telemetry hub, one hub a path shared
# by its windows' engines, as a worker's is: (p) is (b) with the hub
HUB_PATHS = ("p",)
# (path with the observability plane, the path it extends): reported side by
# side after the main paths — (q) is (d) with the midpoint grid prefilter
PLANE_PAIRS = (("p", "b"), ("q", "d"))
# kernels a path must NOT launch (the knobs that turn them off); (l) and
# (m) run the device cascade where K3 could run
K3_ANY = (VALUE_PATH[2], MP_PATH[2])
FORBIDDEN = {"i": MP_ANY, "j": MP_ANY, "k": MP_ANY, "l": K3_ANY, "m": K3_ANY}
# the lazy flush path every window of a path must take
FLUSH_PATH = {"l": "device_cascade"}
# the paths whose last engine measures the merge plane (exact hit, delta)
PLANE_PATHS = ("b", "d", "f")


@contextlib.contextmanager
def knob_env(env: dict):
    """Environment knobs for the duration (the port reads them at flush,
    merge and trigger time)."""
    old = {k: os.environ.get(k) for k in env}  # lint: allow-raw-env
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def rank_gate(on: bool, env: dict | None = None):
    """``SKYLINE_RANK_CASCADE`` (and ``env``) for the duration."""
    return knob_env({"SKYLINE_RANK_CASCADE": "1" if on else "0", **(env or {})})


def run_window(cfg, ids, x, required=0, chunk=65536, flush_prof=None, telemetry=None):
    """One tumbling window through a fresh engine, as ``bench.py`` drives
    the reference: ingest in chunks, one trigger, one result.
    ``flush_prof``: a lazy flush race's profiler from an earlier window's
    engine, handed on as one long-lived engine keeps it. ``telemetry``: a
    hub the engine records into."""
    from skyline_tpu_torch.stream import SkylineEngine

    import torch

    eng = SkylineEngine(cfg, telemetry=telemetry)
    eng.pset._flush_prof = flush_prof
    t0 = time.perf_counter()
    for i in range(0, x.shape[0], chunk):
        eng.process_records(ids[i : i + chunk], x[i : i + chunk])
    eng.process_trigger(f"0,{required}")
    (result,) = eng.poll_results()
    if cfg.device == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0, result, eng


def _drive_windows(cfg, windows, chunk, cascade: list | None = None,
                   engines: list | None = None, telemetry=None):
    """Windows back to back through one engine (recording into
    ``telemetry`` if given), a trigger after each: (results, local sizes
    after each trigger, wall s); the set's ``flush_cascade_stats()`` at the
    end appended to ``cascade`` and the engine to ``engines`` if given."""
    import numpy as np

    from skyline_tpu_torch.stream import SkylineEngine

    eng = SkylineEngine(cfg, telemetry=telemetry)
    t0 = time.perf_counter()
    out, sizes = [], []
    base = 0
    for i, x in enumerate(windows):
        n = x.shape[0]
        ids = np.arange(base, base + n, dtype=np.int64)
        base += n
        for s in range(0, n, chunk):
            eng.process_records(ids[s : s + chunk], x[s : s + chunk])
        eng.process_trigger(f"q{i},0")
        out += eng.poll_results()
        sizes.append(eng.pset.sky_counts().tolist())
    if cascade is not None:
        cascade.append(eng.pset.flush_cascade_stats())
    if engines is not None:
        engines.append(eng)
    return out, sizes, time.perf_counter() - t0


def _points(r):
    import numpy as np

    return np.asarray(r["skyline_points"], np.float32)


def _sorted_bytes(pts):
    import numpy as np

    return pts[np.lexsort(pts.T[::-1])].tobytes()


def check_parity(torch, np, n: int, devices=("cuda", "cpu")) -> dict:
    from skyline_tpu_torch.ops.dominance import skyline_np
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.workload.generators import anti_correlated

    rng = np.random.default_rng(11)
    windows = [anti_correlated(rng, n, 8, 0, 10000) for _ in range(2)]
    answers = {}
    walls = {}
    with rank_gate(False):
        for device in devices:
            cfg = EngineConfig(**NORTH_STAR, emit_skyline_points=True, ingest="host",
                               device=device)
            answers[device], _, walls[device] = _drive_windows(cfg, windows, 16384)
    for a, b in zip(answers[devices[0]], answers[devices[1]]):
        pa, pb = _points(a), _points(b)
        if (a["skyline_size"], a["optimality"]) != (b["skyline_size"], b["optimality"]) \
                or pa.tobytes() != pb.tobytes():
            raise AssertionError(
                f"engine parity: {a['skyline_size']}/{a['optimality']} vs "
                f"{b['skyline_size']}/{b['optimality']}, points equal: "
                f"{pa.tobytes() == pb.tobytes()}"
            )
    # a small window against the numpy oracle
    x = anti_correlated(rng, 4096, 4, 0, 10000)
    cfg = EngineConfig(
        **{**NORTH_STAR, "dims": 4}, emit_skyline_points=True, ingest="host",
        device=devices[0],
    )
    with rank_gate(False):
        _, res, _ = run_window(cfg, np.arange(4096, dtype=np.int64), x)
    want = skyline_np(x)
    got = np.asarray(res["skyline_points"], np.float64)
    if got.shape != want.shape or not np.array_equal(
        got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])]
    ):
        raise AssertionError(f"oracle: {got.shape[0]} points vs {want.shape[0]}")
    return {
        "rows_per_window": n,
        "skyline_sizes": [r["skyline_size"] for r in answers[devices[0]]],
        "optimality": [r["optimality"] for r in answers[devices[0]]],
        "wall_s": walls,
        "oracle_points": int(want.shape[0]),
    }


# values outside the domain: ±inf, NaN, ±1e30, -0.0, first coordinates
# whose mr-dim quotient passes 2^31 (a partition width of 1,250 at P = 8),
# the f32 maximum, and a few values inside
ROUTING_VALUES = (float("inf"), float("-inf"), float("nan"), 1e30, -1e30, -0.0, 0.0, 3e12,
                  2.7e12, 1e13, -1e13, 3.4028234663852886e38, 1.0, 9999.0)
# the smallest input of the mr-dim routing fault (device ingest sent +inf
# and quotients past 2^31 to partition 0 on the CPU, where XLA saturates to
# P - 1), and the order the JAX engine publishes it in
ROUTING_FAULT_ROWS = ((1e30, 0.0, 1.0), (1.0, 1.0, 0.0), (9000.0, 0.5, 0.5))
ROUTING_FAULT_ORDER = (1, 2, 0)


def check_routing(torch, np, dev) -> dict:
    """``partition_ids`` of mr-dim, mr-grid and mr-angle on the card
    against the CPU, strict, on rows drawn from ``ROUTING_VALUES`` at d in
    {1, 2, 3, 8} and P in {1, 4, 8}; then the mr-dim fault's input through
    the device-ingest engine (parallelism 1, lazy and overlap) on the card
    and on the CPU: the published bytes, strict, in the JAX engine's
    order."""
    from skyline_tpu_torch.parallel.partitioners import PARTITIONERS, partition_ids
    from skyline_tpu_torch.stream import EngineConfig, SkylineEngine

    rng = np.random.default_rng(31)
    values = np.array(ROUTING_VALUES, np.float32)
    checks = 0
    for d in (1, 2, 3, 8):
        x = values[rng.integers(0, values.size, size=(4096, d))]
        for algo in PARTITIONERS:
            for P in (1, 4, 8):
                card = partition_ids(torch.from_numpy(x).to(dev), algo, P, 10000.0).cpu()
                cpu = partition_ids(torch.from_numpy(x), algo, P, 10000.0)
                diff = torch.nonzero(card != cpu).flatten()
                if diff.numel():
                    i = int(diff[0])
                    raise AssertionError(
                        f"routing {algo} P={P} d={d}: {diff.numel()} rows differ, first "
                        f"{x[i].tolist()}: card {int(card[i])}, cpu {int(cpu[i])}")
                checks += 1
    rows = np.array(ROUTING_FAULT_ROWS, np.float32)
    for policy in ("lazy", "overlap"):
        got = {}
        for device in (dev, "cpu"):
            eng = SkylineEngine(EngineConfig(
                parallelism=1, algo="mr-dim", dims=3, domain_max=10000.0,
                emit_skyline_points=True, flush_policy=policy, ingest="device",
                device=device))
            eng.process_records(np.arange(rows.shape[0], dtype=np.int64), rows)
            eng.process_trigger("q,0")
            (res,) = eng.poll_results()
            got[device] = _points(res)
        if got[dev].tobytes() != got["cpu"].tobytes():
            raise AssertionError(f"routing fault input ({policy}): card {got[dev].tolist()} "
                                 f"vs cpu {got['cpu'].tolist()}")
        if got["cpu"].tobytes() != rows[list(ROUTING_FAULT_ORDER)].tobytes():
            raise AssertionError(f"routing fault input ({policy}): {got['cpu'].tolist()}")
        checks += 1
    log(f"parity: routing of values outside the domain, card == cpu in {checks} checks "
        "(3 partitioners x P 1/4/8 x d 1/2/3/8, and the mr-dim fault's input through the "
        "device-ingest engine, lazy and overlap)")
    return {"checks": checks}


def routing_mismatch(torch, np, x: np.ndarray, dev) -> dict:
    """Rows the card's ``partition_ids`` routes differently from the CPU's
    and from ``partition_ids_np`` (north-star routing), with the first
    differing row."""
    from skyline_tpu_torch.parallel.partitioners import partition_ids, partition_ids_np

    args = ("mr-angle", 2 * NORTH_STAR["parallelism"], NORTH_STAR["domain_max"])
    card = partition_ids(torch.from_numpy(x).to(dev), *args).cpu().numpy()
    out = {"rows": int(x.shape[0])}
    for name, other in (
        ("vs_cpu", partition_ids(torch.from_numpy(x), *args).numpy()),
        ("vs_numpy", partition_ids_np(x, *args)),
    ):
        diff = np.nonzero(card != other)[0]
        out[name] = int(diff.size)
        if diff.size:
            i = int(diff[0])
            out[f"first_{name}"] = {
                "row": i, "values": x[i].tolist(), "card": int(card[i]), "other": int(other[i]),
            }
    return out


def check_device_parity(torch, np, n: int, devices=("cuda", "cpu")) -> dict:
    """Device ingest, CUDA against the CPU, rank cascade on and off, over
    two windows (the second ranks the old prefixes and runs the cleanup)."""
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.workload.generators import anti_correlated

    rng = np.random.default_rng(13)
    windows = [anti_correlated(rng, n, 8, 0, 10000) for _ in range(2)]
    routing = routing_mismatch(torch, np, np.concatenate(windows), devices[0])
    strict = routing["vs_cpu"] == 0
    out = {"rows_per_window": n, "routing": routing, "strict": strict}
    for gate in (True, False):
        runs = {}
        with rank_gate(gate):
            for device in devices:
                cfg = EngineConfig(**NORTH_STAR, emit_skyline_points=True, ingest="device",
                                   window_capacity=n, device=device)
                runs[device] = _drive_windows(cfg, windows, 16384)
        (ra, sa, wa), (rb, sb, wb) = runs[devices[0]], runs[devices[1]]
        for i, (a, b) in enumerate(zip(ra, rb)):
            pa, pb = _points(a), _points(b)
            if a["skyline_size"] != b["skyline_size"] or _sorted_bytes(pa) != _sorted_bytes(pb):
                raise AssertionError(
                    f"device parity (rank {gate}) window {i}: {a['skyline_size']} vs "
                    f"{b['skyline_size']} points, or another point set"
                )
            if strict and (
                a["optimality"] != b["optimality"] or sa[i] != sb[i]
                or pa.tobytes() != pb.tobytes()
            ):
                raise AssertionError(
                    f"device parity (rank {gate}) window {i}: routing agreed but "
                    f"optimality {a['optimality']} vs {b['optimality']}, local sizes "
                    f"{sa[i]} vs {sb[i]}, published order equal: {pa.tobytes() == pb.tobytes()}"
                )
        out["rank_on" if gate else "rank_off"] = {
            "skyline_sizes": [r["skyline_size"] for r in ra],
            "optimality": [[r["optimality"] for r in ra], [r["optimality"] for r in rb]],
            "local_sizes": [sa, sb], "wall_s": {devices[0]: wa, devices[1]: wb},
        }
    return out


def _same_runs(what, runs, devices, strict: bool) -> None:
    """Hold ``_drive_windows`` runs on two devices to each other: sizes and
    sorted point bytes always; with ``strict`` also optimality, local sizes
    and the published order."""
    (ra, sa, _), (rb, sb, _) = runs[devices[0]], runs[devices[1]]
    for i, (a, b) in enumerate(zip(ra, rb)):
        pa, pb = _points(a), _points(b)
        if a["skyline_size"] != b["skyline_size"] or _sorted_bytes(pa) != _sorted_bytes(pb):
            raise AssertionError(
                f"{what} window {i}: {a['skyline_size']} vs {b['skyline_size']} points, "
                "or another point set"
            )
        if strict and (
            a["optimality"] != b["optimality"] or sa[i] != sb[i] or pa.tobytes() != pb.tobytes()
        ):
            raise AssertionError(
                f"{what} window {i}: optimality {a['optimality']} vs {b['optimality']}, "
                f"local sizes {sa[i]} vs {sb[i]}, published order equal: "
                f"{pa.tobytes() == pb.tobytes()}"
            )


# the other policies' parity legs: (name, engine configuration, rows per
# window, rank cascade); the CPU side's plain dominance sets the sizes
POLICY_PARITY = (
    ("incremental_3d", dict(GRID_3D, buffer_size=2048, ingest="host"), 32768, False),
    ("incremental_8d", dict(NORTH_STAR, flush_policy="incremental", buffer_size=512,
                            initial_capacity=0, ingest="host"), 8192, False),
    ("incremental_2d", dict(GRID_3D, dims=2, ingest="host"), 65536, False),
    ("overlap_device_rank_on", dict(NORTH_STAR, flush_policy="overlap", overlap_rows=4096,
                                    ingest="device"), 16384, True),
    ("overlap_device_rank_off", dict(NORTH_STAR, flush_policy="overlap", overlap_rows=4096,
                                     ingest="device"), 16384, False),
    ("overlap_device_2d", dict(GRID_3D, dims=2, flush_policy="overlap", overlap_rows=16384,
                               ingest="device"), 65536, False),
)


def check_policy_parity(torch, np, devices=("cuda", "cpu")) -> dict:
    """The incremental and overlap policies and d = 2, CUDA against the CPU
    over two windows each (the second merges into, or cleans up against,
    the first's state). Host ingest is strict; device ingest is strict where
    the card routes every row as the CPU does."""
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.workload.generators import anti_correlated

    rng = np.random.default_rng(37)
    out = {}
    for name, cfg, n, gate in POLICY_PARITY:
        windows = [anti_correlated(rng, n, cfg["dims"], 0, 10000) for _ in range(2)]
        strict = True
        if cfg["ingest"] == "device":
            from skyline_tpu_torch.parallel.partitioners import partition_ids

            x = np.concatenate(windows)
            args = (cfg["algo"], 2 * cfg["parallelism"], cfg["domain_max"])
            strict = torch.equal(
                partition_ids(torch.from_numpy(x).to(devices[0]), *args).cpu(),
                partition_ids(torch.from_numpy(x), *args),
            )
        runs = {}
        with rank_gate(gate):
            for device in devices:
                ecfg = EngineConfig(**cfg, emit_skyline_points=True, window_capacity=n,
                                    device=device)
                runs[device] = _drive_windows(ecfg, windows, 4096)
        _same_runs(f"{name} parity", runs, devices, strict)
        ra, sa, wa = runs[devices[0]]
        out[name] = {
            "rows_per_window": n, "strict": bool(strict),
            "skyline_sizes": [r["skyline_size"] for r in ra], "local_sizes": sa,
            "wall_s": {dv: runs[dv][2] for dv in devices},
        }
        log(f"parity: {name}, cuda == cpu over 2 windows of {n} rows: {out[name]}")
    return out


# the flush cascade's parity legs: (name, engine configuration, rows per
# window); both ingests under the lazy and overlap policies, d = 3 and 8
CASCADE_PARITY = tuple(
    (f"{policy}_{ingest}_{d}d",
     dict(GRID_3D if d == 3 else NORTH_STAR, flush_policy=policy, ingest=ingest,
          buffer_size=2048 if d == 3 else 512, overlap_rows=4096, initial_capacity=0),
     16384 if d == 3 else 8192)
    for policy, ingests in (("incremental", ("host",)), ("lazy", ("host", "device")),
                            ("overlap", ("host", "device")))
    for ingest in ingests for d in (3, 8)
)


def check_cascade_parity(torch, np, devices=("cuda", "cpu")) -> dict:
    """The flush cascade over two windows in one engine (the second flushes
    against the first's grid summary): the card under its defaults (mp on,
    the prefilter on at d >= 3) against the CPU with
    ``SKYLINE_MIXED_PRECISION=1`` — answers strict and ``flush_cascade_stats``
    equal (device ingest: where the card routes every row as the CPU does);
    and on the card the cascade on against ``CASCADE_OFF``, answers strict.
    The lazy flush takes the SFS rounds (``ROUNDS_ONLY``) in every leg."""
    from skyline_tpu_torch.parallel.partitioners import partition_ids
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.workload.generators import anti_correlated

    rng = np.random.default_rng(53)
    out = {}
    with rank_gate(False):
        for name, cfg, n in CASCADE_PARITY:
            windows = [anti_correlated(rng, n, cfg["dims"], 0, 10000) for _ in range(2)]
            strict = True
            if cfg["ingest"] == "device":
                x = torch.from_numpy(np.concatenate(windows))
                args = (cfg["algo"], 2 * cfg["parallelism"], cfg["domain_max"])
                strict = torch.equal(partition_ids(x.to(devices[0]), *args).cpu(),
                                     partition_ids(x, *args))
            runs, stats = {}, {}
            for label, device, env in (("card", devices[0], {}),
                                       ("cpu", devices[1], {"SKYLINE_MIXED_PRECISION": "1"}),
                                       ("card off", devices[0], CASCADE_OFF)):
                cascade = []
                # the SFS rounds on both devices: the counters count their
                # pre-drop (the race's other paths are RACE_PARITY's)
                with knob_env({**ROUNDS_ONLY, **env}):
                    ecfg = EngineConfig(**cfg, emit_skyline_points=True, window_capacity=n,
                                        device=device)
                    runs[label] = _drive_windows(ecfg, windows, 4096, cascade)
                stats[label] = cascade[0]
            _same_runs(f"cascade {name} parity", runs, ("card", "cpu"), strict)
            _same_runs(f"cascade {name} on vs off", runs, ("card", "card off"), True)
            if strict and stats["card"] != stats["cpu"]:
                raise AssertionError(f"cascade {name}: counters {stats['card']} on the card, "
                                     f"{stats['cpu']} on the CPU")
            if not stats["card"]["mixed_precision"] or stats["card off"]["bf16_resolved"]:
                raise AssertionError(f"cascade {name}: the defaults {stats['card']}, off "
                                     f"{stats['card off']}")
            out[name] = {"rows_per_window": n, "strict": bool(strict), "counters": stats,
                         "skyline_sizes": [r["skyline_size"] for r in runs["card"][0]],
                         "wall_s": {k: v[2] for k, v in runs.items()}}
            log(f"parity: cascade {name} over 2 windows of {n} rows, card defaults == cpu "
                f"mp=1 (answers{', counters' if strict else ''}) == card cascade off "
                f"(answers): counters {stats['card']}, sizes {out[name]['skyline_sizes']}")
    return out


# the lazy flush race's legs: (name, engine configuration, rows per window);
# three windows through one engine, so the card's race explores both paths
# and then follows its EMAs
RACE_PARITY = tuple(
    (f"lazy_host_{d}d", dict(NORTH_STAR, dims=d, ingest="host", initial_capacity=0), n)
    for d, n in ((3, 32768), (8, 8192))
)


def check_race_parity(torch, np, devices=("cuda", "cpu")) -> dict:
    """The lazy engine with host ingest, strict: the card with the device
    cascade forced (``CASCADE_ON``) and under the defaults (the race of the
    SFS rounds and the device cascade) against the CPU with the host sorted
    cascade forced (``SKYLINE_SORTED_SFS=on``) — answers, local sizes,
    published order."""
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.workload.generators import anti_correlated

    rng = np.random.default_rng(71)
    out = {}
    with rank_gate(False):
        for name, cfg, n in RACE_PARITY:
            windows = [anti_correlated(rng, n, cfg["dims"], 0, 10000) for _ in range(3)]
            runs, paths = {}, {}
            for label, device, env in (
                ("cpu sorted", devices[1], {"SKYLINE_SORTED_SFS": "on"}),
                ("card cascade", devices[0], CASCADE_ON),
                ("card race", devices[0], {"SKYLINE_SORTED_SFS": "auto",
                                           "SKYLINE_DEVICE_CASCADE": "auto"}),
            ):
                engines = []
                with knob_env(env):
                    ecfg = EngineConfig(**cfg, emit_skyline_points=True, device=device)
                    runs[label] = _drive_windows(ecfg, windows, 8192, engines=engines)
                paths[label] = dict(engines[0].pset.flush_paths)
            want = {"cpu sorted": {"sorted_sfs": 3}, "card cascade": {"device_cascade": 3}}
            for label, p in want.items():
                if paths[label] != p:
                    raise AssertionError(f"race {name}: {label} flushed by {paths[label]}")
            if "device_cascade" not in paths["card race"]:
                raise AssertionError(f"race {name}: the card's race never explored the "
                                     f"device cascade: {paths['card race']}")
            _same_runs(f"race {name} cascade", runs, ("cpu sorted", "card cascade"), True)
            _same_runs(f"race {name} defaults", runs, ("cpu sorted", "card race"), True)
            out[name] = {"rows_per_window": n, "flush_paths": paths,
                         "skyline_sizes": [r["skyline_size"] for r in runs["cpu sorted"][0]],
                         "wall_s": {k: v[2] for k, v in runs.items()}}
            log(f"parity: race {name} over 3 windows of {n} rows, cpu sorted cascade == card "
                f"device cascade == card race (answers, sizes, order): {out[name]}")
    return out


# the merge plane's counters, compared between devices
# -- the observability plane: CUDA against the CPU ------------------------------

# every key of stats() and the plans that holds a wall time, a wall-clock
# stamp or a per-process identity: keys ending in _ms or _s, and these
# (tests/test_torch_observability.py holds the same list)
TIMING_KEYS = frozenset({
    "processing_ms", "wall_ms", "ema_ms", "first_call_ms", "last_ms",
    "phase_total_ms", "attributed_share", "t_ms", "trace_id",
    # the freshness lineage's lag histograms
    "stages",
})


def untimed(doc, drop=()):
    """``doc`` (a ``stats()`` dict, a plan, a result) without its timing
    fields and the keys in ``drop``, the kernel profile's rows (sorted by
    wall) in signature order."""
    if isinstance(doc, dict):
        out = {
            k: untimed(v, drop) for k, v in doc.items()
            if k not in TIMING_KEYS and k not in drop and not k.endswith(("_ms", "_s"))
        }
        if isinstance(out.get("kernels"), list):
            out["kernels"] = sorted(out["kernels"], key=lambda r: json.dumps(r, sort_keys=True))
        return out
    if isinstance(doc, list):
        return [untimed(v, drop) for v in doc]
    return doc


def _plan_shape(plan) -> dict:
    """What of an EXPLAIN plan must agree across devices: the merge path,
    the tree, the cascade deltas and each kernel signature's call count
    (the backend aside)."""
    return {"path": plan["merge"]["path"], "tree": plan["tree"], "cascade": plan["cascade"],
            "kernels": sorted((k["variant"], k["d"], k["n_bucket"], k["mp"], k["calls"])
                              for k in plan["kernels"])}


# (name, engine configuration, rows per window): a (b)-like lazy device-ingest
# engine and a (d)-like incremental host-ingest one with the midpoint grid
# prefilter, two windows each through one engine
OBS_PARITY = (
    ("lazy_device_8d", dict(NORTH_STAR, ingest="device"), DEVICE_PARITY_ROWS),
    ("incremental_host_3d_prefilter", dict(GRID_3D, ingest="host", grid_prefilter=True),
     DEVICE_PARITY_ROWS),
)
# both devices run the mixed-precision passes (the card's default), so the
# profiler's mp keys and the bf16 counts compare; the tuner's cadence is out
# of reach, so a slower CPU run cannot tick an epoch the card's never reaches
OBS_ENV = {"SKYLINE_MIXED_PRECISION": "1", "SKYLINE_TUNER_EPOCH_S": "3600"}


def check_observability_parity(torch, np, devices=("cuda", "cpu")) -> dict:
    """The observability plane on the card against the CPU: each
    ``OBS_PARITY`` engine with a ``Telemetry()`` hub on both devices and,
    on the card, without one. The answers with the hub are the bytes
    without it; the card's answers are the CPU's (sorted bytes, and where
    the card routes every row as the CPU does, strict); there also
    ``stats()`` (timings and the backend aside), every EXPLAIN plan's merge
    path, tree, cascade and kernel call counts, ``prefiltered`` and every
    partition's ``max_seen_id`` are equal."""
    from skyline_tpu_torch.parallel.partitioners import partition_ids
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.telemetry import Telemetry
    from skyline_tpu_torch.workload.generators import anti_correlated

    rng = np.random.default_rng(61)
    out = {}
    with rank_gate(False), knob_env(OBS_ENV):
        for name, cfg, n in OBS_PARITY:
            windows = [anti_correlated(rng, n, cfg["dims"], 0, 10000) for _ in range(2)]
            strict = True
            if cfg["ingest"] == "device":
                x = torch.from_numpy(np.concatenate(windows))
                args = (cfg["algo"], 2 * cfg["parallelism"], cfg["domain_max"])
                strict = torch.equal(partition_ids(x.to(devices[0]), *args).cpu(),
                                     partition_ids(x, *args))
            runs, engines, hubs = {}, {}, {}
            for label, device, hub in (("card", devices[0], True), ("card bare", devices[0], False),
                                       ("cpu", devices[1], True)):
                ecfg = EngineConfig(**cfg, emit_skyline_points=True, window_capacity=n,
                                    device=device)
                hubs[label] = Telemetry() if hub else None
                got = []
                runs[label] = _drive_windows(ecfg, windows, 8192, engines=got,
                                             telemetry=hubs[label])
                engines[label] = got[0]
            _same_runs(f"observability {name}: hub vs none", runs, ("card", "card bare"), True)
            _same_runs(f"observability {name}: card vs cpu", runs, ("card", "cpu"), strict)
            card, cpu = engines["card"], engines["cpu"]
            stats = {k: untimed(e.stats(include_skyline_counts=True), ("backend",))
                     for k, e in (("card", card), ("cpu", cpu))}
            plans = {k: [_plan_shape(p) for p in hubs[k].explain.snapshot()]
                     for k in ("card", "cpu")}
            if (card.prefiltered, card.pset.max_seen_id.tolist()) != (
                    cpu.prefiltered, cpu.pset.max_seen_id.tolist()):
                raise AssertionError(f"observability {name}: prefiltered {card.prefiltered} vs "
                                     f"{cpu.prefiltered}, max_seen_id "
                                     f"{card.pset.max_seen_id.tolist()} vs "
                                     f"{cpu.pset.max_seen_id.tolist()}")
            if strict and stats["card"] != stats["cpu"]:
                diff = sorted(k for k in stats["card"] if stats["card"][k] != stats["cpu"].get(k))
                raise AssertionError(f"observability {name}: stats() differ in {diff}: card "
                                     f"{ {k: stats['card'][k] for k in diff} }, cpu "
                                     f"{ {k: stats['cpu'].get(k) for k in diff} }")
            if strict and plans["card"] != plans["cpu"]:
                raise AssertionError(f"observability {name}: plans {plans['card']} on the card, "
                                     f"{plans['cpu']} on the CPU")
            if len(plans["card"]) != 2 or card.stats()["explain"]["recorded_total"] != 2:
                raise AssertionError(f"observability {name}: {len(plans['card'])} plans")
            out[name] = {
                "rows_per_window": n, "strict": bool(strict),
                "skyline_sizes": [r["skyline_size"] for r in runs["card"][0]],
                "prefiltered": card.prefiltered, "plans": plans["card"],
                "counters": hubs["card"].counters.snapshot(),
                "spans": hubs["card"].spans.recorded,
                "wall_s": {k: v[2] for k, v in runs.items()},
            }
            log(f"parity: observability {name} over 2 windows of {n} rows: card with hub == "
                f"card without (bytes) == cpu with hub (answers"
                f"{', stats(), plans' if strict else ''}); prefiltered {card.prefiltered}, "
                f"plans {[p['path'] for p in plans['card']]}, {hubs['card'].spans.recorded} "
                f"spans, wall {out[name]['wall_s']}")
    return out


# -- the serving and audit planes ------------------------------------------------

# (name, engine configuration, rows per window): the OBS_PARITY engines, each
# with a snapshot store, a delta ring, an in-memory body store and a
# Telemetry() hub (so the auditor checks every published snapshot)
SERVE_PARITY = (
    ("lazy_device_8d", dict(NORTH_STAR, ingest="device"), DEVICE_PARITY_ROWS),
    ("incremental_host_3d", dict(GRID_3D, ingest="host"), DEVICE_PARITY_ROWS),
)
# divergence bundles of the audit drill (git-ignored, inside the checkout)
AUDIT_BUNDLES = ROOT / "skyline_tpu_torch" / "_build" / "audit"
DRILL_PLAN = "corrupt@audit.corrupt:1"
# the drill's window, and so the depth of its offline replay
DRILL_ROWS = 8192


@contextlib.contextmanager
def store_clock():
    """The snapshot store's wall clock replaced by a tick of 10 ms from a
    fixed epoch (``serve/snapshot.py`` ``_now_ms``), so the publish stamps,
    and with the batches' event times the whole JSON bodies, compare across
    runs."""
    import itertools

    from skyline_tpu_torch.serve import snapshot

    real, ticks = snapshot._now_ms, itertools.count()
    snapshot._now_ms = lambda: 1.0e12 + 10.0 * next(ticks)
    try:
        yield
    finally:
        snapshot._now_ms = real


def _drive_served(ecfg, windows, chunk=8192, triggers=("q", "r")):
    """Windows through one engine with the serving plane attached (a store,
    a delta ring, an in-memory body store, a hub), event times stamped from
    the row ids, ``triggers`` after each window (a repeat dedupes on the
    device path): (per publish (version, size, watermark, digest, entered,
    left, JSON body, JSON head, CSV body), the points of each publish, the
    audit records without their timings, the hub, the engine)."""
    import numpy as np

    from skyline_tpu_torch.serve import DeltaRing, SnapshotStore
    from skyline_tpu_torch.serve import bodystore as bs
    from skyline_tpu_torch.stream import SkylineEngine
    from skyline_tpu_torch.telemetry import Telemetry, spans

    spans._mint_seq = 0  # the same trace ids in every run
    hub = Telemetry()
    eng = SkylineEngine(ecfg, telemetry=hub)
    store = SnapshotStore()
    ring = DeltaRing(store)
    body = bs.BodyStore(None).attach(store)
    eng.attach_snapshots(store)
    pubs, points = [], []

    def note(prev, snap):
        tail = ring.latest()
        pubs.append((snap.version, snap.size, snap.watermark_id, snap.digest,
                     tail.entered.tobytes(), tail.left.tobytes(),
                     body.get(snap.version, bs.FMT_JSON_POINTS),
                     body.get(snap.version, bs.FMT_JSON_NOPOINTS),
                     body.get(snap.version, bs.FMT_CSV)))
        points.append(snap.points)

    store.on_publish(note)
    base = 0
    with store_clock():
        for i, x in enumerate(windows):
            for s in range(0, x.shape[0], chunk):
                ids = np.arange(base + s, base + min(s + chunk, x.shape[0]), dtype=np.int64)
                eng.process_records(ids, x[s : s + chunk],
                                    event_ms=(5.0e11 + base + s, 5.0e11 + base + s + chunk))
            base += x.shape[0]
            for t in triggers:
                eng.process_trigger(f"{t}{i},0")
                eng.poll_results()
    audits = [untimed(r) for r in hub.audit.snapshot()]
    return pubs, points, audits, hub, eng


def check_serve_parity(torch, np, devices=("cuda", "cpu")) -> dict:
    """The serving and audit planes on the card against the CPU: each
    ``SERVE_PARITY`` engine over two windows, two triggers after each. Every
    publish's version, size, watermark and digest, its delta's entered and
    left bytes, its JSON and CSV bodies and every audit record (timings
    aside) are the CPU's where the card routes every row as the CPU does,
    else the sizes and sorted point bytes; every organic check passes. On
    the card the five canaries pass, each on its named path, and the drill
    (``SKYLINE_FAULT_PLAN=corrupt@audit.corrupt:1``) gives exactly one
    divergence and one bundle, which ``python -m skyline_tpu_torch.audit
    replay`` reproduces and acquits the engine of (exit code 0)."""
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.parallel.partitioners import partition_ids
    from skyline_tpu_torch.resilience import faults
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.workload.generators import anti_correlated

    rng = np.random.default_rng(67)
    out = {}
    with rank_gate(False), knob_env(OBS_ENV):
        for name, cfg, n in SERVE_PARITY:
            windows = [anti_correlated(rng, n, cfg["dims"], 0, 10000) for _ in range(2)]
            strict = True
            if cfg["ingest"] == "device":
                x = torch.from_numpy(np.concatenate(windows))
                args = (cfg["algo"], 2 * cfg["parallelism"], cfg["domain_max"])
                strict = torch.equal(partition_ids(x.to(devices[0]), *args).cpu(),
                                     partition_ids(x, *args))
            runs = {}
            for label, device in (("card", devices[0]), ("cpu", devices[1])):
                ecfg = EngineConfig(**cfg, window_capacity=n, device=device)
                runs[label] = _drive_served(ecfg, windows)
            (pubs, pts, audits, hub, eng), (cpubs, cpts, caudits, _, _) = runs["card"], runs["cpu"]
            if len(pubs) != len(cpubs) or not all(a["ok"] for a in audits + caudits):
                raise AssertionError(f"serve {name}: {len(pubs)} vs {len(cpubs)} publishes, "
                                     f"audits {audits} vs {caudits}")
            if strict:
                for i, (a, b) in enumerate(zip(pubs, cpubs)):
                    if a != b:
                        fields = ("version", "size", "watermark", "digest", "entered", "left",
                                  "json", "head", "csv")
                        raise AssertionError(
                            f"serve {name} publish {i}: "
                            f"{[f for f, u, v in zip(fields, a, b) if u != v]} differ")
                if audits != caudits:
                    raise AssertionError(f"serve {name}: audit records {audits} vs {caudits}")
            elif [p[1] for p in pubs] != [p[1] for p in cpubs] or [
                    _sorted_bytes(p) for p in pts] != [_sorted_bytes(p) for p in cpts]:
                raise AssertionError(f"serve {name}: another point set on the card")
            out[name] = {"rows_per_window": n, "strict": bool(strict),
                         "publishes": [p[:3] for p in pubs], "audits": len(audits),
                         "deduped": eng.snapshots.deduped,
                         "json_bytes": [len(p[6]) for p in pubs]}
            log(f"parity: serve {name} over 2 windows of {n} rows, 2 triggers each: "
                f"{len(pubs)} publishes (versions, sizes, watermarks {out[name]['publishes']}, "
                f"{eng.snapshots.deduped} deduped), card == cpu "
                f"({'digests, deltas, JSON and CSV bodies, audit records' if strict else 'sizes and sorted points'}); "
                f"{len(audits)} organic checks passed")
        # the canaries on the card, through the auditor of a card engine
        before = dict(dk.LAUNCHES)
        records = eng.auditor.run_canaries()
        launched = {k: v - before.get(k, 0) for k, v in dk.LAUNCHES.items()
                    if v != before.get(k, 0)}
        taken = {r["path"]: r["taken"] for r in records}
        if not all(r["ok"] for r in records) or taken != {p: p for p in taken} or len(taken) != 5:
            raise AssertionError(f"serve: canaries {records}")
        if not any(k.startswith("dominated_by_rect") for k in launched):
            raise AssertionError(f"serve: the canaries launched no K2 on the card: {launched}")
        out["canaries"] = {"taken": taken, "launches": launched}
        log(f"parity: serve canaries on the card: 5 of 5 passed, each on its path {taken}; "
            f"launches {launched}")
        # the divergence drill and the offline replay of its bundle
        name, cfg, _ = SERVE_PARITY[0]
        n = DRILL_ROWS
        AUDIT_BUNDLES.mkdir(parents=True, exist_ok=True)
        with knob_env({"SKYLINE_FAULT_PLAN": DRILL_PLAN, "SKYLINE_AUDIT_DIR": str(AUDIT_BUNDLES)}):
            faults.install_from_env()
            try:
                ecfg = EngineConfig(**cfg, window_capacity=n, device=devices[0])
                _, _, audits, hub, _ = _drive_served(
                    ecfg, [anti_correlated(rng, n, 8, 0, 10000)], triggers=("q",))
            finally:
                faults.clear()
        doc = hub.audit.doc()
        if hub.counters.get("audit.divergence") != 1 or len(doc["bundles"]) != 1:
            raise AssertionError(f"serve drill: {hub.counters.get('audit.divergence')} "
                                 f"divergences, bundles {doc['bundles']}")
        bundle = doc["bundles"][0]
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "skyline_tpu_torch.audit", "replay", bundle,
                            "--json", "--device", devices[0]],
                           capture_output=True, text=True, timeout=600, cwd=ROOT)
        verdict = json.loads(r.stdout) if r.returncode == 0 else None
        if verdict is None or not verdict["reproduced"] or verdict["engine_diverges"]:
            raise AssertionError(f"serve drill: replay exit {r.returncode}: {r.stdout[-2000:]} "
                                 f"{r.stderr[-2000:]}")
        out["drill"] = {"plan": DRILL_PLAN, "checks": hub.counters.get("audit.checks"),
                        "divergences": 1, "bundle": bundle, "replay_exit": r.returncode,
                        "replay_s": time.perf_counter() - t0,
                        "first_diff": verdict["recomputed_first_diff"],
                        "replay_path": verdict["replay_plan"]["merge"]["path"]}
        log(f"parity: serve drill {DRILL_PLAN}: {out['drill']['checks']} checks, 1 divergence, "
            f"1 bundle ({bundle}); replay on the card exit 0 in {out['drill']['replay_s']:.1f} s: "
            f"reproduced, the engine acquitted (merge path {out['drill']['replay_path']})")
    return out


PLANE_COUNTERS = (
    "merge_cache_hits", "merge_cache_misses", "merge_delta_merges", "merge_delta_rows",
    "merge_tree_merges", "merge_partitions_pruned", "last_tree_info",
    "last_dirty_fraction",
)
# the plane's parity legs: (name, engine configuration, rows per window)
PLANE_PARITY = (
    ("north_star_8d", dict(NORTH_STAR, ingest="device"), 65536),
    ("grid_3d", dict(GRID_3D, ingest="host"), 65536),
)
INTERLEAVED_PARITY = (
    ("interleaved_grid_3d", dict(GRID_3D, buffer_size=2048, ingest="host"), 16384),
    ("interleaved_north_star_8d", dict(NORTH_STAR, initial_capacity=0, ingest="host"), 8192),
)


def _drive_interleaved(cfg, n: int, seed: int = 43):
    """Four windows through one engine, each trigger repeated (an exact
    hit) and a quarter window more landing while the merge is in flight;
    from the second quarter window and the third window on only the rows
    ``partition_ids_np`` routes to the lower half of the partitions are
    kept, so the last two triggers take delta merges. Returns (results, local sizes
    at each result's poll, the plane's counters, wall s)."""
    import numpy as np

    from skyline_tpu_torch.parallel.partitioners import partition_ids_np
    from skyline_tpu_torch.stream import SkylineEngine
    from skyline_tpu_torch.workload.generators import anti_correlated

    rng = np.random.default_rng(seed)
    eng = SkylineEngine(cfg)
    P = cfg.num_partitions
    t0 = time.perf_counter()
    out, sizes, nid = [], [], 0

    def ingest(x):
        nonlocal nid
        ids = np.arange(nid, nid + x.shape[0], dtype=np.int64)
        nid += x.shape[0]
        for s in range(0, x.shape[0], 4096):
            eng.process_records(ids[s : s + 4096], x[s : s + 4096])

    def lower_half(x):
        return np.ascontiguousarray(x[partition_ids_np(x, cfg.algo, P, cfg.domain_max) < P // 2])

    for rnd in range(4):
        x = anti_correlated(rng, n, cfg.dims, 0, 10000)
        ingest(lower_half(x) if rnd >= 2 else x)
        eng.process_trigger(f"q{rnd},0")
        eng.process_trigger(f"r{rnd},0")
        y = anti_correlated(rng, n // 4, cfg.dims, 0, 10000)
        ingest(lower_half(y) if rnd >= 1 else y)
        res = eng.poll_results()
        out += res
        sizes += [eng.pset.sky_counts().tolist()] * len(res)
    counters = {k: getattr(eng.pset, k) for k in PLANE_COUNTERS}
    return out, sizes, counters, time.perf_counter() - t0


def check_plane_parity(torch, np, devices=("cuda", "cpu")) -> dict:
    """The merge plane, strict (every run routes on the host or on one
    device): (1) on the card, the reference's defaults (tree, prune, cache,
    overlap) against the flat plane (``PLANE_OFF``) over two windows of the
    north-star and of the 3-D grid cell; (2) interleaved windows, repeated
    triggers and half-routed chunks (``_drive_interleaved``), CUDA against
    the CPU: every answer, local size and plane counter."""
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.workload.generators import anti_correlated

    rng = np.random.default_rng(47)
    out = {}
    for name, cfg, n in PLANE_PARITY:
        windows = [anti_correlated(rng, n, cfg["dims"], 0, 10000) for _ in range(2)]
        ecfg = EngineConfig(**cfg, emit_skyline_points=True, window_capacity=n,
                            device=devices[0])
        runs = {"plane on": _drive_windows(ecfg, windows, 16384)}
        with knob_env(PLANE_OFF):
            runs["plane off"] = _drive_windows(ecfg, windows, 16384)
        _same_runs(f"plane parity {name}", runs, ("plane on", "plane off"), True)
        out[name] = {
            "rows_per_window": n,
            "skyline_sizes": [r["skyline_size"] for r in runs["plane on"][0]],
            "wall_s": {k: v[2] for k, v in runs.items()},
        }
        log(f"parity: {name}, plane on == plane off on the card over 2 windows of {n} rows: "
            f"{out[name]}")
    with rank_gate(False):
        for name, cfg, n in INTERLEAVED_PARITY:
            runs = {dv: _drive_interleaved(EngineConfig(**cfg, emit_skyline_points=True,
                                                        device=dv), n) for dv in devices}
            _same_runs(f"{name} parity", {dv: (r[0], r[1], r[3]) for dv, r in runs.items()},
                       devices, True)
            a, b = runs[devices[0]][2], runs[devices[1]][2]
            if a != b:
                raise AssertionError(f"{name} parity: plane counters {a} vs {b}")
            if not (a["merge_cache_hits"] >= 4 and a["merge_delta_merges"] >= 1):
                raise AssertionError(f"{name} parity: no hit or no delta merge: {a}")
            out[name] = {"rows_per_window": n, "answers": len(runs[devices[0]][0]),
                         "counters": a, "wall_s": {dv: r[3] for dv, r in runs.items()}}
            log(f"parity: {name}, cuda == cpu (answers, local sizes, counters): {out[name]}")
    return out


def check_answer(torch, np, x: np.ndarray, pts: np.ndarray, dev) -> None:
    """Sampled soundness of a full-size answer, with plain torch on the card:
    4096 input rows are each dominated by or equal to an output row, and
    4096 output rows are dominated by no output row."""
    from skyline_tpu_torch.ops.dominance import dominated_by

    rng = np.random.default_rng(3)
    if not np.isfinite(pts).all() or pts.ndim != 2 or pts.shape[1] != x.shape[1]:
        raise AssertionError(f"answer of shape {pts.shape} is not finite (g, d)")
    out = torch.from_numpy(pts).to(dev)
    sample_in = torch.from_numpy(x[rng.integers(0, x.shape[0], 4096)]).to(dev)
    covered = dominated_by(sample_in, out)
    for s in range(0, out.shape[0], 4096):
        blk = out[s : s + 4096]
        covered |= (sample_in[:, None, :] == blk[None, :, :]).all(-1).any(-1)
    if not bool(covered.all()):
        raise AssertionError(f"{int((~covered).sum())} sampled input rows not covered")
    sample_out = out[torch.from_numpy(rng.integers(0, out.shape[0], 4096)).to(dev)]
    if bool(dominated_by(sample_out, out).any()):
        raise AssertionError("a sampled output row is dominated by another output row")


def _config(path: str, n: int, **kw):
    from skyline_tpu_torch.stream import EngineConfig

    return EngineConfig(**PATHS[path][0], window_capacity=n, device="cuda", **kw)


def measure_plane(torch, np, path: str, eng, n: int) -> dict:
    """The merge plane on a path's last measured engine: (1) a repeated
    trigger, an exact hit of the merge cache that must launch no kernel;
    (2) one 65,536-row chunk of the same generator, keeping only the rows
    ``partition_ids_np`` routes to the lower half of the partitions, then a
    trigger that must take the delta merge; (3) the same state loaded into
    a fresh set with ``load_state`` and merged with the cache off, whose
    answer must equal the delta's byte for byte. Merge walls, launches, the
    dirty share and the tree's shape."""
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.parallel.partitioners import partition_ids_np
    from skyline_tpu_torch.stream.batched import PartitionSet
    from skyline_tpu_torch.workload.generators import anti_correlated

    cfg, ps = eng.config, eng.pset
    P, d = cfg.num_partitions, cfg.dims
    out = {"tree_info": ps.last_tree_info, "partitions_pruned": ps.merge_partitions_pruned,
           "prune_witness": None if ps.last_prune_witness is None
           else ps.last_prune_witness.tolist()}

    def trigger(qid, rows=None):
        """Launch counts and wall of (ingesting ``rows``, then) a trigger."""
        dk.reset_launches()
        t0 = time.perf_counter()
        if rows is not None:
            eng.process_records(np.arange(n, n + rows.shape[0], dtype=np.int64), rows)
        eng.process_trigger(f"{qid},0")
        (res,) = eng.poll_results()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3, dict(dk.LAUNCHES)

    hits = ps.merge_cache_hits
    res, wall, launches = trigger("hit")
    if ps.merge_cache_hits != hits + 1 or any(launches.values()):
        raise AssertionError(f"plane ({path}): the repeated trigger was no exact hit "
                             f"({ps.merge_cache_hits - hits} hits, launches {launches})")
    out["hit"] = {"trigger_ms": wall, "merge_ms": eng.last_merge_ms,
                  "skyline_size": res["skyline_size"]}
    x = anti_correlated(np.random.default_rng(5), 65536, d, 0, 10000)
    x = np.ascontiguousarray(x[partition_ids_np(x, cfg.algo, P, cfg.domain_max) < P // 2])
    deltas, trees = ps.merge_delta_merges, ps.merge_tree_merges
    res, wall, launches = trigger("delta", x)
    if ps.merge_delta_merges != deltas + 1 or not 0 < ps.last_dirty_fraction <= 0.5:
        raise AssertionError(f"plane ({path}): the chunk's trigger took no delta merge "
                             f"(dirty share {ps.last_dirty_fraction})")
    if (d > 2) != (ps.merge_tree_merges == trees + 1):
        raise AssertionError(f"plane ({path}): the delta merge at d = {d} went "
                             f"{'not ' if d > 2 else ''}through the tree")
    if d <= 2 and any(launches.values()):
        raise AssertionError(f"plane ({path}): the d <= 2 delta launched {launches}")
    out["delta"] = {"rows": int(x.shape[0]), "dirty_share": ps.last_dirty_fraction,
                    "window_ms": wall, "flush_ms": eng.last_flush_ms,
                    "merge_ms": eng.last_merge_ms, "skyline_size": res["skyline_size"],
                    "delta_rows": ps.merge_delta_rows, "tree_info": ps.last_tree_info,
                    "launches": launches}
    got = ps.global_merge_stats(emit_points=True)  # an exact hit on the delta's result
    sky, counts = ps.state_numpy()
    fresh = PartitionSet(P, d, cfg.buffer_size, initial_capacity=cfg.initial_capacity,
                         flush_policy=cfg.flush_policy, device=ps.device)
    fresh.load_state(sky, counts)
    with knob_env({"SKYLINE_MERGE_CACHE": "0"}):
        want = fresh.global_merge_stats(emit_points=True)
    if got[2] != res["skyline_size"] or got[2] != want[2] \
            or not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])) \
            or got[3].tobytes() != want[3].tobytes():
        raise AssertionError(f"plane ({path}): the delta answer ({got[2]} rows) differs from "
                             f"the recompute ({want[2]} rows)")
    log(f"plane ({path}): exact hit {out['hit']['merge_ms']:.3f} ms merge, no launch; delta "
        f"over {x.shape[0]} rows (dirty share {ps.last_dirty_fraction}): window "
        f"{wall:.1f} ms, flush {eng.last_flush_ms:.1f} ms, merge {eng.last_merge_ms:.1f} ms, "
        f"{got[2]} rows = the recompute; tree {out['tree_info']}, "
        f"{out['partitions_pruned']} partitions pruned, witness {out['prune_witness']}")
    return out


@contextlib.contextmanager
def prefilter_timer():
    """Host ms spent in the grid prefilter (``PartitionSet._prefilter_rows``,
    numpy over every pending host row) for the duration: yields a list that
    collects one wall per call."""
    from skyline_tpu_torch.stream.batched import PartitionSet

    real, walls = PartitionSet._prefilter_rows, []

    def timed(self, rows):
        t0 = time.perf_counter()
        try:
            return real(self, rows)
        finally:
            walls.append((time.perf_counter() - t0) * 1e3)

    PartitionSet._prefilter_rows = timed
    try:
        yield walls
    finally:
        PartitionSet._prefilter_rows = real


def flush_race(path: str, window, eng) -> dict | None:
    """The lazy host flush's race in one window's engine: the paths its
    flushes took and, per signature of the race's profiler (handed on from
    window to window), calls and EMA ms. Raises where ``FLUSH_PATH`` fixes
    the path and a flush took another. None where no flush raced or was
    forced."""
    ps = eng.pset
    want = FLUSH_PATH.get(path)
    if want is not None and set(ps.flush_paths) != {want}:
        raise AssertionError(f"main path ({path}) flushed by {ps.flush_paths}, not {want}")
    if ps._flush_prof is None:
        return None
    out = {"paths": dict(ps.flush_paths), "signatures": [
        {"variant": r["variant"], "n_bucket": r["n_bucket"], "calls": r["calls"],
         "ema_ms": r["ema_ms"], "first_call_ms": r["first_call_ms"]}
        for r in ps._flush_prof.doc()["kernels"]]}
    log(f"main ({path}): window {window}: flush race took {out['paths']}; EMAs "
        + ", ".join(f"{r['variant']}@{r['n_bucket']} {r['ema_ms']:.1f} ms ({r['calls']} calls)"
                    for r in out["signatures"]))
    return out


def main_path(torch, np, path: str, n: int, windows: int, dev="cuda"):
    """Path ``path``'s warm window and ``windows`` measured ones, launch
    counts set to 0 just before and read just after; each window's flush
    cascade counters (``flush_cascade_stats``), grid-prefilter host ms and
    rows the midpoint prefilter dropped; on ``PLANE_PATHS`` the merge plane
    measured on the last engine. Each window's engine takes over the lazy
    flush race's profiler of the one before (``flush_race``); on
    ``SERVE_PATHS`` one engine runs every window (``serve_window``), its
    counters read as each window's difference, and the path fails unless
    ``check_serve`` holds. On
    ``HUB_PATHS`` every window's engine records into one ``Telemetry()``
    hub; each window reports the spans, flight entries and EXPLAIN records
    it added, the spans the ring dropped and its tuner's epochs and moves,
    and the cascade table's pins and overrides are cleared after the path,
    so later paths run without the tuner's moves."""
    from skyline_tpu_torch.ops import cascade as table
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.telemetry import Telemetry
    from skyline_tpu_torch.workload.generators import anti_correlated

    cfg, gate, wanted, env = PATHS[path]
    d = cfg["dims"]
    rng = np.random.default_rng(0)
    ids = np.arange(n, dtype=np.int64)
    warm_x = anti_correlated(rng, n, d, 0, 10000)
    hub = Telemetry() if path in HUB_PATHS else None
    serving = ServingPlane(np) if path in SERVE_PATHS else None
    lat, rows = [], []
    with rank_gate(gate, env), prefilter_timer() as pre_ms, contextlib.ExitStack() as stack:
        if serving is not None:
            stack.callback(serving.close)
        dk.reset_launches()
        if serving is None:
            warm_dt, warm_res, eng = run_window(
                _config(path, n, emit_skyline_points=True), ids, warm_x, telemetry=hub
            )
            warm_points = np.asarray(warm_res["skyline_points"], np.float32)
        else:
            eng = serving.engine(_config(path, n))
            warm_dt, warm_res, _ = serve_window(serving, eng, ids, warm_x)
            version = serving.full_reads(d, None)
            warm_points = serving.prev_points  # the answer as the server served it
            # before the first publish a read is a 503 (no snapshot yet)
            serving.warm_codes, serving.codes = serving.codes, {}
        race = [flush_race(path, "warm", eng)]
        for w in range(windows):
            x = anti_correlated(rng, n, d, 0, 10000)
            calls = len(pre_ms)
            mark = _hub_mark(hub)
            served = None
            if serving is None:
                before = None
                dt, res, eng = run_window(_config(path, n), ids, x,
                                          flush_prof=eng.pset._flush_prof, telemetry=hub)
            else:  # one engine: its counters run across windows
                before = (eng.pset.flush_cascade_stats(), eng.prefiltered)
                dt, res, served = serve_window(serving, eng, ids, x)
                version = serving.full_reads(d, version)
            lat.append(dt)
            cascade = _cascade_since(eng.pset.flush_cascade_stats(), before and before[0])
            race.append(flush_race(path, w, eng))
            rows.append({
                "window_ms": dt * 1e3, "flush_ms": eng.last_flush_ms,
                "merge_ms": eng.last_merge_ms, "skyline_size": res["skyline_size"],
                "local_sizes": eng.pset.sky_counts().tolist(), "flush_cascade": cascade,
                "prefilter_ms": sum(pre_ms[calls:]), "prefilter_calls": len(pre_ms) - calls,
                "prefiltered": eng.prefiltered - (before[1] if before else 0),
                "flush_race": race[-1],
                "hub": _hub_window(hub, mark, eng), "serve": served,
            })
            log(f"main ({path}): window {w}: {dt * 1e3:.1f} ms (flush "
                f"{eng.last_flush_ms:.1f} ms, merge {eng.last_merge_ms:.1f} ms, "
                f"flush/prefilter {rows[-1]['prefilter_ms']:.1f} ms host in "
                f"{rows[-1]['prefilter_calls']} flushes), skyline {res['skyline_size']}, "
                f"midpoint prefilter dropped {eng.prefiltered}; flush cascade {cascade}"
                + (f"; hub {rows[-1]['hub']}" if hub is not None else "")
                + (f"; serve {_serve_line(served)}" if served is not None else ""))
        launches = dict(dk.LAUNCHES)
        tree = {"tree_merges": eng.pset.merge_tree_merges,
                "tree_info": eng.pset.last_tree_info,
                "partitions_pruned": eng.pset.merge_partitions_pruned}
        # a fresh engine's one trigger; on a serve path's one engine, the
        # query and the trigger of every window
        tree_want = 1 if d > 2 and env.get("SKYLINE_MERGE_TREE") != "0" else 0
        if serving is not None:
            tree_want *= 2 * (windows + 1)
        if tree["tree_merges"] != tree_want:
            raise AssertionError(f"main path ({path}) ran {tree['tree_merges']} tree merges, "
                                 f"not {tree_want}")
        plane = measure_plane(torch, np, path, eng, n) if path in PLANE_PATHS else None
    if hub is not None:
        pins, overrides = table.pins_doc(), table.overrides_doc()
        table.clear_pins()
        for name in list(overrides):
            table.clear_override(name)
        log(f"main ({path}): cleared the tuner's pins {pins} and overrides {overrides}; "
            f"later paths run without them")
    log(f"main ({path}): warm window {warm_dt * 1e3:.1f} ms, skyline {warm_res['skyline_size']}")
    check_answer(torch, np, warm_x, warm_points, dev)
    missing = [k for k in wanted if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path ({path}) launched no {missing}")
    if not wanted and any(launches.values()):
        raise AssertionError(f"main path ({path}) must launch no dominance kernel: {launches}")
    stray = [k for k in FORBIDDEN.get(path, ()) if launches[k]]
    if stray:
        raise AssertionError(f"main path ({path}) under {env} launched {stray}")
    summary = {
        "ingest": cfg["ingest"], "flush_policy": cfg["flush_policy"], "dims": d,
        "rank_cascade": gate,
        "rows_per_window": n, "windows_measured": windows,
        "tuples_per_s": n * windows / sum(lat),
        "p50_window_ms": float(np.median(lat)) * 1e3,
        "p50_flush_ms": float(np.median([r["flush_ms"] for r in rows])),
        "p50_merge_ms": float(np.median([r["merge_ms"] for r in rows])),
        "p50_prefilter_ms": float(np.median([r["prefilter_ms"] for r in rows])),
        "prefiltered_per_window": [r["prefiltered"] for r in rows],
        "flush_cascade": rows[-1]["flush_cascade"],
        "warm_window_ms": warm_dt * 1e3, "windows": rows,
        "launches": launches, "launches_per_window": {
            k: v / (windows + 1) for k, v in launches.items()
        },
        "merge_env": env, **tree, "plane": plane, "flush_race": race,
    }
    if serving is not None:
        summary["serve"] = serve_summary(np, serving, rows, lat, n, windows)
        check_serve(path, summary["serve"])
    log(f"main ({path}): {summary['tuples_per_s']:.0f} tuples/s, p50 window "
        f"{summary['p50_window_ms']:.1f} ms (flush {summary['p50_flush_ms']:.1f}, merge "
        f"{summary['p50_merge_ms']:.1f}, flush/prefilter {summary['p50_prefilter_ms']:.1f} "
        f"host) over {windows} windows of {n} rows under {env or 'the defaults'}; last "
        f"window's flush cascade {summary['flush_cascade']}")
    log(f"main ({path}): launches over {windows + 1} windows: "
        f"{ {k: launches[k] for k in wanted} if wanted else launches}; last window's "
        f"tree {tree['tree_info']}, {tree['partitions_pruned']} partitions pruned")
    return summary, eng, x


def _hub_mark(hub):
    """The hub's running totals before a window (None without a hub)."""
    if hub is None:
        return None
    return (hub.spans.recorded, hub.flight.doc()["recorded_total"],
            hub.explain.doc()["recorded_total"])


def _hub_window(hub, mark, eng) -> dict | None:
    """What one window added to the hub: spans recorded, flight entries
    and EXPLAIN records; the spans its ring has dropped in all; the
    window's tuner's epochs and moves."""
    if hub is None:
        return None
    spans, flight, plans = mark
    return {
        "spans": hub.spans.recorded - spans,
        "spans_dropped": hub.spans.dropped,
        "flight_entries": hub.flight.doc()["recorded_total"] - flight,
        "explain_records": hub.explain.doc()["recorded_total"] - plans,
        "tuner_epochs": eng.tuner.epochs if eng.tuner is not None else None,
        "tuner_moves": eng.tuner.moves if eng.tuner is not None else None,
    }


# -- main paths with the serving plane ---------------------------------------------

# (path, the main path it extends): (r) is (b) and (s) is (f) with the
# serving and audit planes: one engine, hub, snapshot store, delta ring,
# in-memory body store and SkylineServer (127.0.0.1, port 0) for all the
# path's windows, as a worker keeps them; the auditor at its defaults
# (every answer checked)
SERVE_PATHS = {"r": "b", "s": "f"}
SERVE_READERS = 32
# the header readers: SERVE_READERS threads in a process of their own (a
# client's, not the server's), reading until their stdin closes, then
# printing their latencies and status codes
READER_CLIENT = """
import json, sys, threading, time, urllib.error, urllib.request
url, n = sys.argv[1], int(sys.argv[2])
stop, lock, lat, codes = threading.Event(), threading.Lock(), [], {}
def loop():
    while not stop.is_set():
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(url, timeout=120) as r:
                r.read()
                code = r.status
        except urllib.error.HTTPError as e:
            code = e.code
        ms = (time.perf_counter() - t0) * 1e3
        with lock:
            codes[code] = codes.get(code, 0) + 1
            if code == 200:
                lat.append(ms)
threads = [threading.Thread(target=loop, daemon=True) for _ in range(n)]
for t in threads:
    t.start()
print("ready", flush=True)
sys.stdin.read()
stop.set()
for t in threads:
    t.join(timeout=120)
print(json.dumps({"lat": lat, "codes": codes}), flush=True)
"""


def _pct(np, xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


class ServingPlane:
    """The serving plane of a serve path, with its clients: ``SERVE_READERS``
    threads of a client process (``READER_CLIENT``) issuing ``GET
    /skyline?points=0`` while a window runs, one full
    JSON, one CSV and one ``/deltas`` read after each publish (each full
    read's digest recomputed from its rows), a ``POST /query`` in the middle
    of each window, drained by the window's bridge loop on the engine
    thread and its answer checked there. Per publish: the store's own work
    (copy and digest, its subscribers aside), the body store's and the
    delta ring's ms, and from the window's spans the audit check's ms."""

    def __init__(self, np):
        import threading

        from skyline_tpu_torch.serve import DeltaRing, QueryBridge, SkylineServer, SnapshotStore
        from skyline_tpu_torch.serve.bodystore import BodyStore
        from skyline_tpu_torch.telemetry import Telemetry

        self.np = np
        self.hub = Telemetry()
        self.store = SnapshotStore()
        self.ring = DeltaRing(None)
        self.body = BodyStore(None)
        self.sub_ms = {"delta": [], "body": []}
        self.store.on_publish(self._timed("delta", self.ring.on_publish))
        self.store.on_publish(self._timed("body", lambda prev, snap: self.body.put_snapshot(snap)))
        self.publish_ms = []
        self.published_size = {}  # query id -> rows of the snapshot its answer lives under
        real = self.store.publish

        def publish(points, **kw):
            n_sub = len(self.sub_ms["body"])
            t0 = time.perf_counter()
            snap = real(points, **kw)
            wall = (time.perf_counter() - t0) * 1e3
            subs = sum(v[-1] for v in self.sub_ms.values()) if len(self.sub_ms["body"]) > n_sub else 0.0
            self.publish_ms.append(wall - subs)
            self.published_size[kw.get("query_id")] = int(snap.points.shape[0])
            return snap

        self.store.publish = publish
        self.bridge = QueryBridge()
        self.server = SkylineServer(self.store, deltas=self.ring, bridge=self.bridge, port=0,
                                    telemetry=self.hub, bodystore=self.body)
        self.base = f"http://127.0.0.1:{self.server.port}"
        self.lock = threading.Lock()
        self.reads = {"head": [], "json": [], "csv": [], "deltas": [], "query": []}
        self.codes = {}
        self.warm_codes = {}
        self.torn = {"json": 0, "csv": 0, "deltas": 0}
        self.prev_points = None

    def _timed(self, key, fn):
        def hook(prev, snap):
            t0 = time.perf_counter()
            fn(prev, snap)
            self.sub_ms[key].append((time.perf_counter() - t0) * 1e3)

        return hook

    def _get(self, path, method="GET"):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.base + path, method=method,
                                     data=b"{}" if method == "POST" else None)
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                code, body, hdr = r.status, r.read(), dict(r.headers)
        except urllib.error.HTTPError as e:
            code, body, hdr = e.code, e.read(), dict(e.headers)
        ms = (time.perf_counter() - t0) * 1e3
        with self.lock:
            self.codes[code] = self.codes.get(code, 0) + 1
        return code, body, hdr, ms

    def readers(self):
        """Start the header readers' process; returns once they read."""
        proc = subprocess.Popen(
            [sys.executable, "-c", READER_CLIENT, self.base + "/skyline?points=0",
             str(SERVE_READERS)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        if proc.stdout.readline().strip() != "ready":
            proc.kill()
            raise AssertionError("the reader process did not start")
        return proc

    def stop_readers(self, proc) -> int:
        """Stop the readers' process; fold in its reads, return their count."""
        try:
            out, _ = proc.communicate(input="", timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        got = json.loads(out.strip().splitlines()[-1])
        self.reads["head"] += got["lat"]
        for code, k in got["codes"].items():
            self.codes[int(code)] = self.codes.get(int(code), 0) + k
        return len(got["lat"])

    def engine(self, cfg):
        """The serve path's one engine, as a worker keeps one per store:
        on the plane's hub, publishing into its store; its tracer times the
        points' host copy, unsynchronised."""
        from skyline_tpu_torch.metrics.tracing import Tracer
        from skyline_tpu_torch.stream import SkylineEngine

        eng = SkylineEngine(cfg, tracer=Tracer(sync_device=False), telemetry=self.hub)
        eng.attach_snapshots(self.store)
        return eng

    def post_query(self):
        """Send one ``POST /query`` from a client thread. Returns the thread
        and the dict its outcome lands in (code, body, ms, or the error);
        ``check_query`` judges it on the engine thread."""
        import threading

        out = {}

        def post():
            try:
                out["code"], out["body"], _, out["ms"] = self._get("/query", "POST")
            except Exception as e:  # noqa: BLE001 — raised by check_query
                out["error"] = repr(e)

        t = threading.Thread(target=post, daemon=True)
        t.start()
        return t, out

    def check_query(self, post, out) -> None:
        """The mid-window query's answer: a 200 whose complete answer has
        the size of the snapshot published for it (which the organic audit
        holds against the host oracle)."""
        post.join(timeout=150)
        if post.is_alive():
            raise AssertionError("POST /query did not return in 150 s")
        if "error" in out:
            raise AssertionError(f"POST /query failed: {out['error']}")
        if out["code"] != 200:
            raise AssertionError(f"POST /query answered {out['code']}: {out['body'][:200]!r}")
        doc = json.loads(out["body"])
        size = self.published_size.get(doc.get("query_id"))
        if doc.get("partial") or size is None or doc["skyline_size"] != size:
            raise AssertionError(f"POST /query answered {doc.get('query_id')} with "
                                 f"{doc.get('skyline_size')} rows, partial "
                                 f"{doc.get('partial')}; its snapshot holds {size}")
        self.reads["query"].append(out["ms"])

    def full_reads(self, d: int, since: int | None):
        """One full JSON, one CSV and one ``/deltas?since=`` read of the
        head, each checked: the digest recomputed from the rows, the delta
        applied to the previous read's rows gives this read's row set."""
        np = self.np
        from skyline_tpu_torch.serve.snapshot import points_digest

        code, body, _, ms = self._get("/skyline")
        if code != 200:
            raise AssertionError(f"GET /skyline answered {code}: {body[:200]!r}")
        doc = json.loads(body)
        pts = np.asarray(doc["points"], np.float32).reshape(-1, d)
        self.reads["json"].append(ms)
        log(f"serve: read v{doc['version']}: {pts.shape[0]} rows, "
            f"{np.unique(pts.view(np.uint32), axis=0).shape[0]} distinct by bytes, "
            f"{np.unique(pts + np.float32(0.0), axis=0).shape[0]} by value")
        self._torn("json", points_digest(pts) != doc["digest"],
                   f"{pts.shape} rows, digest {points_digest(pts)} vs {doc['digest']}")
        code, body, hdr, ms = self._get("/skyline?format=csv")
        if code != 200:
            raise AssertionError(f"GET /skyline?format=csv answered {code}: {body[:200]!r}")
        self.reads["csv"].append(ms)
        vals = np.array(body.replace(b"\n", b",").split(b","), dtype=np.float64)
        csv_pts = vals.reshape(-1, d + 1)[:, 1:].astype(np.float32) if vals.size else pts[:0]
        self._torn("csv", points_digest(csv_pts) != hdr["X-Skyline-Digest"]
                   or int(hdr["X-Skyline-Version"]) != doc["version"],
                   f"{csv_pts.shape} rows, digest {points_digest(csv_pts)} vs "
                   f"{hdr['X-Skyline-Digest']}, version {hdr['X-Skyline-Version']} vs "
                   f"{doc['version']}")
        if since is not None:
            code, body, _, ms = self._get(f"/deltas?since={since}")
            delta = json.loads(body)
            self.reads["deltas"].append(ms)
            if code != 200 or delta["to_version"] != doc["version"]:
                raise AssertionError(f"/deltas?since={since}: {code} {body[:200]!r}")
            # as value sets (-0.0 as +0.0): the ring keys rows by their bytes
            # but collapses each delta by value, as the reference's does
            old, new, entered, left = (
                {r.tobytes() for r in np.unique(a + np.float32(0.0), axis=0)}
                for a in (self.prev_points, pts,
                          np.asarray(delta["entered"], np.float32).reshape(-1, d),
                          np.asarray(delta["left"], np.float32).reshape(-1, d)))
            self._torn("deltas", not (entered <= new and left <= old
                                      and new <= old | entered and old - new <= left),
                       f"since {since}: {len(old)} values before, {len(new)} after, "
                       f"{len(entered)} entered, {len(left)} left")
        self.prev_points = pts
        return doc["version"]

    def _torn(self, kind: str, bad: bool, what: str) -> None:
        if bad:
            self.torn[kind] += 1
            log(f"serve: a {kind} read does not hold: {what}")

    def close(self):
        self.server.close()


def serve_window(plane, eng, ids, x, chunk=65536):
    """One tumbling window of a serve path through the path's one engine
    (``plane.engine``): its state emptied first through the public
    checkpoint restore (``pset.restore_all`` of empty partitions, which
    advances every epoch, so the store never takes the new window's
    answer for a repeat of the last), then, with the readers running, the
    chunks ingested with the bridge loop (``bridge.inject(engine)``,
    ``engine.poll_results()``, ``bridge.fulfill(results)``) after each, a
    ``POST /query`` sent at the middle chunk, the trigger, the loop until
    the query answered; the query's answer checked on this thread.
    Returns (wall s, the trigger's result, the window's serve numbers)."""
    import numpy as np
    import torch

    if eng.records_in:
        empty = [np.empty((0, eng.config.dims), np.float32)] * eng.config.num_partitions
        eng.pset.restore_all(empty, empty)
    eng.tracer.reset()
    mark = (len(plane.publish_ms), plane.store.published, time.perf_counter_ns(),
            len(plane.sub_ms["body"]))
    readers = plane.readers()
    try:
        mine, post = [], None
        t0 = time.perf_counter()
        chunks = list(range(0, x.shape[0], chunk))
        for k, i in enumerate(chunks):
            eng.process_records(ids[i : i + chunk], x[i : i + chunk])
            if k == len(chunks) // 2:
                post, answer = plane.post_query()
                # the query runs here, mid-window: wait for its submission
                deadline = time.perf_counter() + 60.0
                while not plane.bridge.pending_injections and time.perf_counter() < deadline:
                    post.join(timeout=0.0005)
            plane.bridge.inject(eng)
            mine += plane.bridge.fulfill(eng.poll_results())
        eng.process_trigger("0,0")
        deadline = time.perf_counter() + 300.0
        while not mine or post.is_alive():
            if time.perf_counter() > deadline:
                raise AssertionError("the window's trigger or query did not answer in 300 s")
            plane.bridge.inject(eng)
            mine += plane.bridge.fulfill(eng.poll_results())
            post.join(timeout=0.001)
        if eng.config.device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        head_reads = plane.stop_readers(readers)
    plane.check_query(post, answer)
    (result,) = mine
    new_pub, new_sub = slice(mark[0], None), slice(mark[3], None)
    spans = [s for s in plane.hub.spans.snapshot() if s["start_ns"] >= mark[2]]
    d2h = eng.tracer.report().get("query/points_transfer", {})
    numbers = {
        "publishes": plane.store.published - mark[1],
        "publish_ms": plane.publish_ms[new_pub],
        "points_to_host_ms": d2h.get("total_ms", 0.0), "points_to_host_calls": d2h.get("count", 0),
        "body_ms": plane.sub_ms["body"][new_sub], "delta_ms": plane.sub_ms["delta"][new_sub],
        "audit_ms": [s["dur_ns"] / 1e6 for s in spans if s["name"].startswith("audit/")],
        "head_reads": head_reads,
    }
    return wall, result, numbers


def _serve_line(s) -> str:
    """One window's serve numbers, rounded for the log."""
    r = lambda v: [round(u, 2) for u in v]  # noqa: E731
    return (f"{s['publishes']} publishes, publish {r(s['publish_ms'])} ms + points to host "
            f"{s['points_to_host_ms']:.2f} ms ({s['points_to_host_calls']} copies), body "
            f"{r(s['body_ms'])} ms, delta {r(s['delta_ms'])} ms, audit {r(s['audit_ms'])} ms, "
            f"{s['head_reads']} header reads")


def report_serve(runs: dict) -> None:
    """Each serve path's numbers beside the main path it extends (both run
    in this call)."""
    for path, base in SERVE_PATHS.items():
        if path not in runs:
            continue
        a, s = runs[path][0], runs[path][0]["serve"]
        beside = ""
        if base in runs:
            b = runs[base][0]
            beside = (f" vs ({base}) {b['p50_window_ms']:.1f} ms "
                      f"({a['p50_window_ms'] / b['p50_window_ms']:.3f}x), "
                      f"{a['tuples_per_s']:.0f} vs {b['tuples_per_s']:.0f} tuples/s")
        rd = s["reads"]
        log(f"main ({path}) = ({base}) + serving: p50 window {a['p50_window_ms']:.1f} ms"
            f"{beside}; per trigger p50: publish {s['p50_publish_ms']:.2f} ms + points to "
            f"host {s['p50_points_to_host_ms']:.2f} ms a window, body {s['p50_body_ms']:.2f} ms, "
            f"delta {s['p50_delta_ms']:.2f} ms, audit {s['p50_audit_ms']:.2f} ms; reads p50/p99 "
            + ", ".join(f"{k} {v['p50_ms'] or 0:.2f}/{v['p99_ms'] or 0:.2f} ms (n {v['n']})"
                        for k, v in rd.items())
            + f"; 429s {s['shed_429']}; versions {s['versions_published']}; torn reads "
            f"{s['torn_reads']}; audit {s['audit']}")


def _cascade_since(now: dict, before: dict | None) -> dict:
    """A window's flush cascade counters: ``now`` less ``before`` (the
    engine's counters when the window began), where the engine runs more
    windows than one."""
    if before is None:
        return now
    out = dict(now)
    for k in ("prefilter_seen", "prefilter_dropped", "bf16_resolved"):
        out[k] = now[k] - before[k]
    seen = out["prefilter_seen"]
    out["prefilter_drop_fraction"] = out["prefilter_dropped"] / seen if seen else 0.0
    return out


def check_serve(path: str, s: dict) -> None:
    """A serve path holds: no torn read, every response of the measured
    windows a 200 or a 429 (and of the warm window, before whose first
    publish the store has no snapshot, a 503 besides), every published
    version checked by the organic audit against the host oracle with no
    divergence, no audit error and no skipped check."""
    bad = []
    if s["torn_reads"]:
        bad.append(f"{s['torn_reads']} torn reads {s['torn_by_kind']}")
    if set(s["codes"]) - {200, 429} or set(s["warm_codes"]) - {200, 429, 503}:
        bad.append(f"response codes {s['codes']}, warm window's {s['warm_codes']}")
    a = s["audit"]
    if a["divergence_total"] or a["errors"] or a["skips"]:
        bad.append(f"audit {a}")
    if a["checks_total"] != s["versions_published"]:
        bad.append(f"{a['checks_total']} audit checks of {s['versions_published']} versions")
    if bad:
        raise AssertionError(f"main path ({path}): " + "; ".join(bad))


def serve_summary(np, plane, rows, lat, n, windows) -> dict:
    """A serve path's numbers over its measured windows."""
    per = lambda key: [v for r in rows for v in r["serve"][key]]  # noqa: E731
    reads = {k: {"n": len(v), "p50_ms": _pct(np, v, 50), "p99_ms": _pct(np, v, 99)}
             for k, v in plane.reads.items()}
    return {
        "p50_publish_ms": _pct(np, per("publish_ms"), 50),
        "p50_points_to_host_ms": float(np.median([r["serve"]["points_to_host_ms"] for r in rows])),
        "p50_body_ms": _pct(np, per("body_ms"), 50), "p50_delta_ms": _pct(np, per("delta_ms"), 50),
        "p50_audit_ms": _pct(np, per("audit_ms"), 50), "reads": reads,
        "codes": plane.codes, "warm_codes": plane.warm_codes,
        "shed_429": plane.codes.get(429, 0),
        "versions_published": plane.store.published, "deduped": plane.store.deduped,
        "torn_reads": sum(plane.torn.values()) + plane.body.stats()["torn_reads"],
        "torn_by_kind": dict(plane.torn),
        "audit": {**{k: plane.hub.audit.doc()[k] for k in ("checks_total", "divergence_total")},
                  "errors": plane.hub.counters.get("audit.errors"),
                  "skips": plane.hub.counters.get("audit.skips")},
        "bodystore": plane.body.stats(),
    }


def profile_window(torch, np, path: str, n: int) -> dict:
    """One more window of ``path`` under ``torch.profiler``: device time by
    kernel name and the device's busy share of the window wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from skyline_tpu_torch.workload.generators import anti_correlated

    from skyline_tpu_torch.telemetry import Telemetry

    x = anti_correlated(np.random.default_rng(1), n, PATHS[path][0]["dims"], 0, 10000)
    ids = np.arange(n, dtype=np.int64)
    hub = Telemetry() if path in HUB_PATHS else None
    with rank_gate(PATHS[path][1], PATHS[path][3]):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dt, _, eng = run_window(_config(path, n), ids, x, telemetry=hub)
    kernels = [
        (ev.self_device_time_total / 1e3, ev.count, ev.key)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    by_kernel: dict[str, list] = {}
    for ms, c, name in kernels:
        slot = by_kernel.setdefault(_short_kernel(name), [0.0, 0])
        slot[0] += ms
        slot[1] += c
    out = {
        "path": path, "window_ms": dt * 1e3, "flush_ms": eng.last_flush_ms,
        "merge_ms": eng.last_merge_ms,
        "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / (dt * 1e3),
        "top_kernels": [
            {"ms": ms, "calls": c, "name": name[:120]} for ms, c, name in kernels[:15]
        ],
        "by_kernel": {k: {"ms": v[0], "calls": v[1]} for k, v in
                      sorted(by_kernel.items(), key=lambda kv: -kv[1][0])},
    }
    log(f"profile ({path}): window {dt * 1e3:.1f} ms under the profiler, device busy "
        f"{busy_ms:.1f} ms (idle share {out['device_idle_share']:.3f})")
    for k in out["top_kernels"]:
        log(f"profile:   {k['ms']:9.2f} ms  {k['calls']:6d} calls  {k['name']}")
    log(f"profile ({path}): device ms by kernel name: " + ", ".join(
        f"{k} {v['ms']:.2f} ({v['calls']})" for k, v in out["by_kernel"].items()))
    return out


def _short_kernel(name: str) -> str:
    """A device kernel's name without its namespace, template arguments and
    parameters: ``void (anonymous namespace)::predrop_kernel<8, true>(...)``
    -> ``predrop_kernel``; copies and sets keep their own names."""
    name = name.replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return base.rsplit("::", 1)[-1].removeprefix("void ").strip() or name


# -- the parent tree, for A/B measurements in one call -----------------------


def parent_library(torch, parent: Path):
    """The parent tree's ``skyline_tpu_torch/ops/dominance_kernels.py``,
    loaded as a module of its own: its sources, its C signatures and its
    build directory are the parent's, so its kernels are built (with its
    own flags, at its first launch) and called exactly as the parent calls
    them; the modules it imports are this tree's."""
    import importlib.util

    src = parent / "skyline_tpu_torch" / "ops" / "dominance_kernels.py"
    spec = importlib.util.spec_from_file_location("parent_dominance_kernels", src)
    lib = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lib)
    t0 = time.perf_counter()
    lib.build()
    log(f"parent: built {', '.join(lib.SOURCES)} from {parent} in "
        f"{time.perf_counter() - t0:.1f} s")
    return lib


@contextlib.contextmanager
def on_parent(torch, lib):
    """Within the block, every value-kernel launch of the wrappers (K1-K3,
    ``mp`` passed on) goes to the parent tree's ``_launch``: the same Python
    path around the parent's kernel."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    real = dk._launch

    def launch(name, x3, v2, y3, mp=False):
        if name not in lib._LIBRARY_OF:
            return real(name, x3, v2, y3, mp)
        return lib._launch(name, x3, v2, y3, mp)

    dk._launch = launch
    try:
        yield
    finally:
        dk._launch = real


def parent_predrop(torch, lib, y, x, xv):
    """The parent tree's pre-drop mask entry: y (P, B, d), x (P, L, d) and
    xv (P, L) on the card -> (P, B) bool."""
    return lib.strictly_dominated_bf16_kernel(y, x, xv)


# one A/B turn: a tree's own chip_smoke functions over the paths — main_path
# for (a)-(m), sliding_northstar for (n), sliding_4d for (o) — in a process
# of its own (each tree builds its own kernels)
AB_RUNNER = """
import json, sys
import numpy as np, torch
import chip_smoke as cs
out = {}
for p in sys.argv[1].split(","):
    if p == "n":
        s = cs.sliding_northstar(torch, np, int(sys.argv[3]))[0]
    elif p == "o":
        s = cs.sliding_4d(torch, np)[0]
    else:
        s = cs.main_path(torch, np, p, int(sys.argv[2]), int(sys.argv[3]))[0]
    out[p] = {"p50_ms": s["p50_slide_ms" if p in ("n", "o") else "p50_window_ms"],
              "tuples_per_s": s["tuples_per_s"]}
print("AB " + json.dumps(out))
"""


def ab_paths(np, parent: Path, paths: list, n: int, windows: int, rounds: int = 1) -> dict:
    """Paths ``paths`` in the parent tree and in this one, ``rounds`` times
    in turns parent, change, change, parent: each turn's p50 window (slide)
    ms and tuples/s, and per path the change's median p50 over the
    parent's and the share of (parent, change) pairs the change wins."""
    turns = []
    order = (("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent))
    for label, root in order * rounds:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", AB_RUNNER, ",".join(paths), str(n), str(windows)],
            cwd=root, capture_output=True, text=True, timeout=1200,
        )
        if proc.returncode:
            raise AssertionError(f"A/B turn ({label}) failed:\n{proc.stderr[-3000:]}")
        res = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")][-1][3:])
        turns.append({"tree": label, "wall_s": time.perf_counter() - t0, "paths": res})
        log(f"ab: turn {len(turns)} ({label}): " + ", ".join(
            f"({p}) p50 {r['p50_ms']:.1f} ms, {r['tuples_per_s']:.0f} tuples/s"
            for p, r in res.items()))
    summary = {}
    for p in paths:
        par = [t["paths"][p]["p50_ms"] for t in turns if t["tree"] == "parent"]
        chg = [t["paths"][p]["p50_ms"] for t in turns if t["tree"] == "change"]
        wins = sum(c < q for c, q in zip(chg, par))
        summary[p] = {"parent_p50_ms": par, "change_p50_ms": chg,
                      "ratio": float(np.median(chg) / np.median(par)),
                      "change_wins": wins, "pairs": len(par)}
        log(f"ab: ({p}) p50 window (slide) parent {[round(v, 1) for v in par]} ms, change "
            f"{[round(v, 1) for v in chg]} ms: change / parent {summary[p]['ratio']:.3f}, "
            f"the change faster in {wins} of {len(par)} pairs")
    return {"turns": turns, "paths": summary}


# the observability plane's gates, on by default; --ablate-planes turns each
# off alone on (p)
PLANE_FLAGS = ("SKYLINE_FRESHNESS", "SKYLINE_KERNEL_PROFILE", "SKYLINE_WORKLOAD",
               "SKYLINE_EXPLAIN", "SKYLINE_AUDIT", "SKYLINE_TUNER")


def _op_us(fn, reps: int) -> float:
    """Median over 5 timings of µs per call of ``fn`` (``reps`` calls each)."""
    import statistics

    times = []
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter_ns() - t0) / 1e3 / reps)
    return statistics.median(times)


def plane_costs(np, hub_window: dict, chunks: int, rows: int, d: int) -> dict:
    """The host cost of each plane's operations on this machine, each timed
    alone (``_op_us``), and what they add to one window of a path with
    ``chunks`` ingest chunks of ``rows`` rows at ``d`` dimensions and
    (p)'s per-window hub counts (``hub_window``: its spans are the
    dispatches' ``kernel/*`` spans, one ``ingest`` a chunk and the query's
    ``local``, ``merge``, ``query`` and ``explain`` spans). The default
    planes (no hub) are the workload sample and the freshness stamps a chunk
    and the profiler's record a dispatch; a hub adds a span a record, the
    ingest wrapper a chunk, the flight notes and the query's plan
    (``_finalize_plan`` on a CPU engine, its cascade read included)."""
    from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
    from skyline_tpu_torch.telemetry import (
        FreshnessTracker, KernelProfiler, Telemetry, WorkloadCharacterizer,
    )
    from skyline_tpu_torch.telemetry.explain import QueryPlan
    from skyline_tpu_torch.workload.generators import anti_correlated

    chunk = anti_correlated(np.random.default_rng(3), rows, d, 0, 10000)
    tel = Telemetry()
    wl, fr = WorkloadCharacterizer(d), FreshnessTracker()
    bare, spanned = KernelProfiler(backend="cuda"), tel.profiler

    def record(prof):
        with prof.record("sfs_sequential", d, 8192, mp=True, backend="cuda"):
            pass

    def stamp():
        fr.on_ingest(1.0, 2.0)
        fr.on_flush()

    def ingest_wrapper():
        t0 = time.perf_counter_ns()
        tel.histogram("ingest_batch_ms").observe(0.5)
        tel.spans.record("ingest", t0, time.perf_counter_ns(), args={"rows": rows})

    eng = SkylineEngine(EngineConfig(dims=d, flush_policy="lazy", device="cpu"), telemetry=tel)
    eng.process_records(np.arange(4096), chunk[:4096])
    eng.process_trigger("warm,0")
    eng.poll_results()
    q = eng._inflight.get("warm,0") or type("Q", (), {})()

    def finalize():
        q.plan, q.span_t0_ns, q.trace_id = QueryPlan("t", "q"), time.perf_counter_ns(), "t"
        q.plan.merge = {"path": "tree"}
        eng._finalize_plan(q, skyline_size=1, local_ms=1.0, global_ms=1.0, total_ms=2.0,
                           latency_ms=2.0)

    us = {
        "workload.observe (a chunk)": _op_us(lambda: wl.observe(chunk), 20),
        "freshness stamps (a chunk)": _op_us(stamp, 2000),
        "profiler record (a dispatch)": _op_us(lambda: record(bare), 2000),
        "profiler record + span (a dispatch, hub)": _op_us(lambda: record(spanned), 2000),
        "ingest wrapper (a chunk, hub)": _op_us(ingest_wrapper, 2000),
        "flight note (hub)": _op_us(lambda: tel.flight.note("merge.launch", path="tree"), 2000),
        "query plan, tuner tick (a query, hub)": _op_us(finalize, 200),
    }
    dispatches = hub_window["spans"] - chunks - 4
    default_ms = (chunks * (us["workload.observe (a chunk)"] + us["freshness stamps (a chunk)"])
                  + dispatches * us["profiler record (a dispatch)"]) / 1e3
    hub_ms = (dispatches * (us["profiler record + span (a dispatch, hub)"]
                            - us["profiler record (a dispatch)"])
              + chunks * us["ingest wrapper (a chunk, hub)"]
              + hub_window["flight_entries"] * us["flight note (hub)"]
              + us["query plan, tuner tick (a query, hub)"]) / 1e3
    out = {"us": us, "dispatches_per_window": dispatches, "chunks": chunks,
           "default_planes_ms_per_window": default_ms, "hub_ms_per_window": hub_ms}
    log("plane costs (host µs, each op alone): " + ", ".join(
        f"{k} {v:.2f}" for k, v in us.items()))
    log(f"plane costs: a window of {chunks} chunks and {dispatches} dispatches pays "
        f"{default_ms:.3f} ms for the default planes and {hub_ms:.3f} ms more with a hub")
    return out


def ablate_planes(np, n: int, windows: int, rounds: int) -> dict:
    """What each plane costs: (p) with every gate on, with each of
    ``PLANE_FLAGS`` off alone, with all of them off, and (b) (no hub), one
    process a setting, ``rounds`` times, the order reversed every other
    round. Per setting its p50 window ms and the ratio of its median to
    (p)'s with every gate on."""
    settings = [("p", "all on", {})] + [("p", f"{f}=0", {f: "0"}) for f in PLANE_FLAGS] + [
        ("p", "all off", {f: "0" for f in PLANE_FLAGS}), ("b", "no hub", {})]
    p50 = {label: [] for _, label, _ in settings}
    for r in range(rounds):
        for path, label, env in (settings if r % 2 == 0 else settings[::-1]):
            proc = subprocess.run(
                [sys.executable, "-c", AB_RUNNER, path, str(n), str(windows)],
                cwd=ROOT, env={**os.environ, **env}, capture_output=True, text=True,
                timeout=1200,
            )
            if proc.returncode:
                raise AssertionError(f"ablation ({label}) failed:\n{proc.stderr[-3000:]}")
            res = json.loads([ln for ln in proc.stdout.splitlines()
                              if ln.startswith("AB ")][-1][3:])
            p50[label].append(res[path]["p50_ms"])
            log(f"ablate: round {r}: ({path}) {label}: p50 {res[path]['p50_ms']:.1f} ms")
    base = float(np.median(p50["all on"]))
    out = {label: {"p50_ms": v, "ratio_to_all_on": float(np.median(v)) / base}
           for label, v in p50.items()}
    log("ablate: median p50 / (p)'s with every gate on: " + ", ".join(
        f"{k} {v['ratio_to_all_on']:.3f}" for k, v in out.items()))
    return out


# -- phase 6: kernel timings at the main path's shapes -----------------------


def _event_ms(torch, fn, reps: int) -> float:
    """Mean ms of ``reps`` runs of ``fn`` after one warm run, by CUDA
    events; a mean under 1 ms is taken again over ten times the runs, so
    launch jitter does not decide it."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for runs in (reps, 10 * reps):
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / runs
        if ms >= 1.0:
            break
    return ms


def _equal_dominators(torch, xt, x_valid, yt):
    """(Ny,) count of valid dominator columns of ``xt`` equal to each
    victim column of ``yt`` in every coordinate under float comparison
    (-0.0 equals 0.0; a row with a NaN equals nothing)."""
    x = xt.T[x_valid] + 0.0  # adding +0.0 turns -0.0 into 0.0
    x = x[~torch.isnan(x).any(-1)]
    y = yt.T + 0.0
    rows, inv = torch.unique(torch.cat([x, y]), dim=0, return_inverse=True)
    per_row = torch.bincount(inv[: x.shape[0]], minlength=rows.shape[0])
    eq = per_row[inv[x.shape[0]:]]
    return torch.where(torch.isnan(y).any(-1), 0, eq)


def _needed_pairs(
    torch, xt, x_valid, yt, dominated, wanted, rank_d: int | None = None
) -> int:
    """Pairs this data needs at least, over the ``wanted`` victims: one for
    each dominated victim; for each undominated victim, every valid
    dominator whose sum could let it dominate. Values (``rank_d`` None):
    a sum no larger than the victim's, less the dominators equal to it in
    every coordinate (the victim itself among them), which cannot dominate
    it. Ranks: a strictly smaller rank sum (row ``rank_d``), which equal
    rows never have."""
    if rank_d is None:
        x_sums, y_sums = xt.T.sum(-1), yt.T.sum(-1)
    else:
        x_sums, y_sums = xt[rank_d].long(), yt[rank_d].long()
    xs = torch.sort(x_sums[x_valid]).values
    cand = torch.searchsorted(xs, y_sums.contiguous(), right=rank_d is None)
    if rank_d is None:
        cand = cand - _equal_dominators(torch, xt, x_valid, yt)
    undominated = cand.clamp(min=0)[wanted & ~dominated].sum()
    return int(undominated) + int((wanted & dominated).sum())


def _row(name, launches, windows, err, ms, plain_ms, bound, shape, pairs=None, extra=None):
    short, route, source, replaces = KERNELS[name]
    bytes_ms, ops_ms = bound
    row = {
        "name": name, "route": route, "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": float(err), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
        "shape": shape,
    }
    if pairs is not None:
        row["needed_pairs"] = pairs
    row.update(extra or {})
    log(f"timings: {short} {name} {shape}: {ms:.3f} ms (plain {plain_ms:.1f} ms, bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']}"
        + (f", {pairs} pairs" if pairs is not None else "")
        + (f", {row['skipped_share']:.6f} of (block, tile) pairs skipped"
           if "skipped_share" in row else "")
        + f"), {launches[name] / windows:.1f} launches per window; library_ms n/a: "
        "no single PyTorch call computes it")
    if row["ms"] < row["bound_ms"]:
        raise AssertionError(f"{short} reads under its bound: {row['ms']} < {row['bound_ms']} ms")
    return row


def _time_pair(torch, kern, plain, what, memo: dict | None = None, key=None):
    """(kernel output, its ms over 10 launches, plain ms, max abs err);
    raises when the two disagree. ``memo`` keeps the plain run (output,
    ms) under ``key``: one plain run on an input serves every launch of a
    kernel on it (the f32 launch and the mp one compute the same mask)."""
    out_k = kern()
    if memo is not None and key in memo:
        out_p, plain_ms = memo[key]
    else:
        t0 = time.perf_counter()
        out_p = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if memo is not None:
            memo[key] = (out_p, plain_ms)
    err = int((out_k.long() - out_p.long()).abs().max()) if out_k.numel() else 0
    if err:
        raise AssertionError(f"{what} at its main-path shape disagrees with its plain version")
    return out_k, _event_ms(torch, kern, reps=10), plain_ms, err


def _heavy_block(np, pset, x_last):
    """A late SFS round of the partition with the largest skyline: its
    sum-sorted rows' second big block (or first, if it has only one)."""
    from skyline_tpu_torch.parallel.partitioners import partition_ids_np

    counts = pset.sky_counts()
    heavy = int(counts.argmax())
    pids = partition_ids_np(x_last, "mr-angle", pset.num_partitions, NORTH_STAR["domain_max"])
    rows = x_last[pids == heavy]
    rows = rows[np.argsort(rows.sum(axis=1), kind="stable")]
    B = pset._seq_block_size(rows.shape[0])
    blk = rows[B : 2 * B] if rows.shape[0] >= 2 * B else rows[:B]
    return heavy, int(counts[heavy]), np.ascontiguousarray(blk)


PLANE_ROWS = 65536


def plane_rows(np, rng, n: int, d: int = 8, top: int = 1000):
    """``n`` distinct integer rows on the plane sum(x) = (d - 1) * top, in
    random order: every f32 row sum is exactly equal, so no row dominates
    another and no skip of any kind applies."""
    head = rng.integers(0, top + 1, size=(2 * n, d - 1))
    rows = np.unique(np.column_stack([head, (d - 1) * top - head.sum(1)]), axis=0)
    return rows[rng.permutation(rows.shape[0])[:n]].astype(np.float32)


def _sorted_t(torch, np, rows, dev):
    """(n, d) numpy rows sorted by sum (stable) -> (d, n) on the card."""
    rows = rows[np.argsort(rows.sum(axis=1), kind="stable")]
    return torch.from_numpy(np.ascontiguousarray(rows.T)).to(dev)


def value_inputs(torch, np, eng, x_last, dev="cuda") -> dict:
    """The three inputs K1–K3 are timed on: label -> (K1 block (d, B), its
    validity, K2 dominators (d, S), their validity, K3 union (U, d), its
    validity).

    - north_star: path (c)'s shapes — a big block of the heaviest
      partition's last SFS rounds against its skyline prefix, and the global
      merge's union, as the engine builds them;
    - uniform: the same shapes filled from a seed with ``uniform(rng, n, 8,
      0, 10000)``, blocks and dominators sum-sorted as the rounds see them;
    - plane: ``PLANE_ROWS`` distinct rows of equal sum for all three.
    """
    from skyline_tpu_torch.stream.window import _active_bucket, gather_union
    from skyline_tpu_torch.workload.generators import uniform

    pset = eng.pset
    counts = pset.sky_counts()
    active = min(pset._cap, _active_bucket(max(int(counts.max()), 1)))
    union_cap = _active_bucket(max(int(counts.sum()), 1))
    u, _, uv = gather_union(pset.sky, pset._count_dev, active, union_cap)
    heavy, c, blk = _heavy_block(np, pset, x_last)
    block_t = torch.from_numpy(np.ascontiguousarray(blk.T)).to(dev)
    sky_act = min(pset._cap, _active_bucket(max(c, 1)))
    sky_t = pset.sky[heavy, :sky_act].T.contiguous()
    sky_ok = torch.arange(sky_act, device=dev) < c

    def ones(n):
        return torch.ones(n, dtype=torch.bool, device=dev)

    rng = np.random.default_rng(21)
    d, B, S, U = pset.dims, block_t.shape[1], sky_t.shape[1], u.shape[0]
    plane = plane_rows(np, rng, PLANE_ROWS, d)
    plane_t = torch.from_numpy(np.ascontiguousarray(plane.T)).to(dev)
    return {
        "north_star": (block_t, ones(B), sky_t, sky_ok, u, uv),
        "uniform": (
            _sorted_t(torch, np, uniform(rng, B, d, 0, 10000), dev), ones(B),
            _sorted_t(torch, np, uniform(rng, S, d, 0, 10000), dev), ones(S),
            torch.from_numpy(uniform(rng, U, d, 0, 10000)).to(dev), ones(U),
        ),
        "plane": (plane_t, ones(PLANE_ROWS), plane_t.clone(), ones(PLANE_ROWS),
                  torch.from_numpy(plane).to(dev), ones(PLANE_ROWS)),
    }


def _time_value_kernel(torch, dk, name, block_t, bvalid, sky_t, sky_ok, u, uv,
                       parent=None, memo=None, label=None) -> dict:
    """One of K1–K3 (``name`` ending in ``_mp``: its mixed-precision
    launch) on one input: its ms against the plain version's (which must
    agree; the plain run on input ``label`` kept in ``memo`` for the other
    launch of the same kernel), needed pairs, the bound's two terms, and
    the share of (victim block, dominator tile) pairs ``tile_skip_plain``
    skips; with ``parent`` also the same wrapper's ms on the parent tree's
    kernel (``on_parent``), whose output must agree."""
    mp = name.endswith("_mp")
    base = name.removesuffix("_mp")
    if base == "dominated_by_any":
        kern = lambda: dk.dominated_by_any(block_t, bvalid, triangular=True, mp=mp)  # noqa: E731
        plain = lambda: dk.dominated_by_any_plain(block_t, bvalid)  # noqa: E731
        xt, xv, yt = block_t, bvalid, block_t
    elif base == "dominated_by_rect":
        kern = lambda: dk.dominated_by_rect(sky_t, sky_ok, block_t, mp=mp)  # noqa: E731
        plain = lambda: dk.dominated_by_rect_plain(sky_t, sky_ok, block_t)  # noqa: E731
        xt, xv, yt = sky_t, sky_ok, block_t
    else:  # K3 runs its kernel over the union in sum order
        kern = lambda: dk.skyline_mask_kernel(u, uv, mp=mp)  # noqa: E731
        plain = lambda: dk.skyline_mask_plain(u, uv)  # noqa: E731
        order, xv = dk._sum_sorted(u, uv)
        xt = yt = u[order].T.contiguous()
    out_k, ms, plain_ms, err = _time_pair(torch, kern, plain, KERNELS[name][0], memo,
                                          (base, label))
    parent_ms = None
    if parent is not None:
        with on_parent(torch, parent):
            if not torch.equal(kern(), out_k):
                raise AssertionError(f"{name}: the parent tree's kernel disagrees")
            parent_ms = _event_ms(torch, kern, reps=10)
    if base == "skyline_mask_kernel":  # survivors; only valid rows are wanted
        dominated, wanted = ~out_k[order], xv
    else:
        dominated, wanted = out_k, torch.ones_like(out_k)
    d, nx = xt.shape
    ny = yt.shape[1]
    pairs = _needed_pairs(torch, xt, xv, yt, dominated, wanted)
    in_bytes = d * nx * 4 + nx + (0 if yt is xt else d * ny * 4)
    skip = dk.tile_skip_plain(xt[None], xv[None], yt[None], dk.TILE_ROWS, dk.BLOCK_VICTIMS)
    return {
        "ms": ms, "plain_ms": plain_ms, "err": err, "pairs": pairs,
        "bound": ((in_bytes + ny) / HBM_BYTES_S * 1e3, pairs * d / FP32_FLOPS * 1e3),
        "shape": {"nx": nx, "ny": ny, "d": d},
        "skipped_share": float(skip.float().mean()) if skip.numel() else 1.0,
        "parent_ms": parent_ms,
    }


def _input_rows(name, got: dict) -> dict:
    """Log each input's numbers for kernel ``name``, check none reads under
    its bound, and return those of every input but north-star, for the
    table row's ``inputs``."""
    others = {}
    for label, r in got.items():
        bound_ms = max(r["bound"])
        log(f"timings: {KERNELS[name][0]} on {label} {r['shape']}: {r['ms']:.3f} ms "
            f"(plain {r['plain_ms']:.1f} ms, bound {bound_ms:.4f} ms, {r['pairs']} "
            f"needed pairs, {r['skipped_share']:.6f} of (block, tile) pairs skipped)"
            + (f"; the parent tree's kernel {r['parent_ms']:.3f} ms"
               if r.get("parent_ms") is not None else ""))
        if r["ms"] < bound_ms:
            raise AssertionError(f"{name} on {label} reads under its bound")
        if label != "north_star":
            others[label] = {
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                "bound_by": "operations" if r["bound"][1] >= r["bound"][0] else "bytes",
                "needed_pairs": r["pairs"], "skipped_share": r["skipped_share"],
                "shape": r["shape"], "parent_ms": r.get("parent_ms"),
            }
    return others


def value_timings(torch, np, eng, x_last, launches: dict, windows: int, dev="cuda",
                  parent=None) -> list:
    """K1–K3 and their mp launches, in turns (f32, mp) on each kernel, on
    the three inputs of ``value_inputs`` (with ``parent``, each also on the
    parent tree's kernel right after); the table's rows are the north-star
    ones, each with the other inputs' numbers under ``inputs``."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    inputs = value_inputs(torch, np, eng, x_last, dev)
    table = []
    memo = {}  # the plain runs, one an input and kernel, read by both launches
    for name in (n for pair in zip(VALUE_PATH, MP_PATH) for n in pair):
        got = {
            label: _time_value_kernel(torch, dk, name, *args, parent=parent, memo=memo,
                                      label=label)
            for label, args in inputs.items()
        }
        ns = got["north_star"]
        table.append(_row(
            name, launches, windows, ns["err"], ns["ms"], ns["plain_ms"], ns["bound"],
            ns["shape"], ns["pairs"],
            {"skipped_share": ns["skipped_share"], "parent_ms": ns["parent_ms"],
             "inputs": _input_rows(name, got)},
        ))
    return table


def heaviest_incremental_round(torch, n: int):
    """One more window of path (d) with ``merge_step_active`` watched: the
    inputs of its heaviest round, cloned — the most compare work, valid
    batch rows x (batch rows + twice the active sky prefix), the last of
    equals."""
    import numpy as np

    from skyline_tpu_torch.stream import batched
    from skyline_tpu_torch.workload.generators import anti_correlated

    real = batched.merge_step_active
    best = {"work": -1}

    def watch(sky, sky_valid, batch, bvalid, active, out_active, mp=False):
        work = int(bvalid.sum()) * (batch.shape[1] + 2 * active)
        if work >= best["work"]:
            best.update(
                work=work, active=active, sky=sky[:, :active].clone(),
                sky_valid=sky_valid[:, :active].clone(), batch=batch.clone(),
                bvalid=bvalid.clone(),
            )
        return real(sky, sky_valid, batch, bvalid, active, out_active, mp)

    x = anti_correlated(np.random.default_rng(2), n, PATHS["d"][0]["dims"], 0, 10000)
    batched.merge_step_active = watch
    try:
        with rank_gate(False):
            run_window(_config("d", n), np.arange(n, dtype=np.int64), x)
    finally:
        batched.merge_step_active = real
    return best


def incremental_k2(torch, np, n: int, launches: dict, windows: int, parent=None,
                   r=None, path: str = "d") -> dict:
    """K2 on the incremental input: the heaviest round of path (d) (or the
    round ``r`` captured on ``path``), its three calls — the batch against
    itself, the sky prefix against the batch, the kept batch against the
    sky — neither side sum-sorted. Each with ms, the plain version's ms,
    needed pairs (summed over the partitions), the bound's two terms and
    the skipped share; plus K2's launches per window on the path."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    if r is None:
        r = heaviest_incremental_round(torch, n)
    sky_t = r["sky"].transpose(1, 2).contiguous()
    batch_t = r["batch"].transpose(1, 2).contiguous()
    sv, bv = r["sky_valid"], r["bvalid"]
    self_dom = dk.dominated_by_rect(batch_t, bv, batch_t)
    keep_batch = bv & ~self_dom & ~dk.dominated_by_rect(sky_t, sv, batch_t)
    calls = {
        "batch_vs_itself": (batch_t, bv, batch_t),
        "sky_vs_batch": (sky_t, sv, batch_t),
        "kept_batch_vs_sky": (batch_t, keep_batch, sky_t),
    }
    out = {"launches_per_window": launches["dominated_by_rect"] / windows,
           "active": r["active"], "valid_batch_rows": int(bv.sum()),
           "valid_sky_rows": int(sv.sum()), "calls": {}}
    total_ms = 0.0
    for label, (xt, xv, yt) in calls.items():
        out_k, ms, plain_ms, err = _time_pair(
            torch, lambda: dk.dominated_by_rect(xt, xv, yt),  # noqa: B023
            lambda: dk.dominated_by_rect_plain(xt, xv, yt), f"K2 {label}",  # noqa: B023
        )
        P, d, nx = xt.shape
        ny = yt.shape[2]
        pairs = sum(
            _needed_pairs(torch, xt[p], xv[p], yt[p], out_k[p], torch.ones_like(out_k[p]))
            for p in range(P)
        )
        in_bytes = P * (d * nx * 4 + nx + (0 if yt is xt else d * ny * 4))
        bound = ((in_bytes + P * ny) / HBM_BYTES_S * 1e3, pairs * d / FP32_FLOPS * 1e3)
        skip = dk.tile_skip_plain(xt, xv, yt, dk.TILE_ROWS, dk.BLOCK_VICTIMS)
        # the mp variant on the same call, right after
        mp_out = dk.dominated_by_rect(xt, xv, yt, mp=True)
        if not torch.equal(mp_out, out_k):
            raise AssertionError(f"K2 mp incremental {label} differs from K2")
        mp_ms = _event_ms(torch, lambda: dk.dominated_by_rect(xt, xv, yt, mp=True), 10)  # noqa: B023
        parent_mp_ms = None
        if parent is not None:
            with on_parent(torch, parent):
                if not torch.equal(dk.dominated_by_rect(xt, xv, yt, mp=True), out_k):
                    raise AssertionError(f"K2 mp incremental {label}: the parent disagrees")
                parent_mp_ms = _event_ms(
                    torch, lambda: dk.dominated_by_rect(xt, xv, yt, mp=True), 10)  # noqa: B023
        row = {
            "ms": ms, "mp_ms": mp_ms, "parent_mp_ms": parent_mp_ms, "plain_ms": plain_ms,
            "max_abs_err": err,
            "needed_pairs": pairs, "bound_ms": max(bound),
            "bound_by": "operations" if bound[1] >= bound[0] else "bytes",
            "skipped_share": float(skip.float().mean()),
            "shape": {"P": P, "nx": nx, "ny": ny, "d": d},
        }
        log(f"timings: K2 incremental {label} {row['shape']}: {ms:.3f} ms, mp {mp_ms:.3f} ms"
            + (f" (the parent's mp loop {parent_mp_ms:.3f} ms) " if parent_mp_ms else " ")
            + f"(plain {plain_ms:.1f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
            f"{pairs} needed pairs, {row['skipped_share']:.6f} of (block, tile) pairs skipped)")
        if min(ms, mp_ms) < row["bound_ms"]:
            raise AssertionError(f"K2 incremental {label} reads under its bound")
        out["calls"][label] = row
        total_ms += ms
        out["round_mp_ms"] = out.get("round_mp_ms", 0.0) + mp_ms
    out["round_ms"] = total_ms
    out["launches_mp_per_window"] = launches["dominated_by_rect_mp"] / windows
    log(f"timings: K2 incremental round (three calls; {out['valid_batch_rows']} batch rows, "
        f"{out['valid_sky_rows']} sky rows) {total_ms:.3f} ms, mp {out['round_mp_ms']:.3f} ms; "
        f"{out['launches_per_window']:.1f} K2 and {out['launches_mp_per_window']:.1f} K2 mp "
        f"launches per window on ({path})")
    return out


def _predrop_pairs(torch, y, x, xv, certified, wanted) -> int:
    """Pairs the pre-drop needs at least on this data, whatever implements
    it: the ``_needed_pairs`` convention on the values rounded to bf16 — one
    pair per certified victim; for each other wanted victim, every valid
    dominator whose rounded sum is no larger, less the rows equal to it in
    every rounded coordinate (no such pair can certify). Callers leave out
    victims with a non-finite coordinate, which no pair certifies. y (P, B,
    d), x (P, L, d), xv, certified and wanted (P, ·) bool."""
    from skyline_tpu_torch.ops.dominance import bf16_round

    total = 0
    for p in range(y.shape[0]):
        # only the wanted victims reach _needed_pairs: a NaN row would upset
        # its sort and unique on the card
        w = wanted[p]
        cert = certified[p][w]
        total += _needed_pairs(torch, bf16_round(x[p]).T, xv[p], bf16_round(y[p][w]).T,
                               cert, torch.ones_like(cert))
    return total


def _predrop_bound(P, B, L, d, pairs, certified, fused: bool):
    """(bytes ms, operations ms) of a pre-drop call: inputs read once and
    outputs written once; one f32 compare per needed pair and dimension (as
    K1-K3 count theirs), and the margin's four further operations a
    dimension on each certified victim's certifying pair."""
    in_bytes = P * (B * d * 4 + L * d * 4 + L + (B if fused else 0))
    out_bytes = P * (B * d * 4 + B + 4 * -(-B // 256)) if fused else P * B
    ops = pairs * d + certified * d * 4
    return (in_bytes + out_bytes) / HBM_BYTES_S * 1e3, ops / FP32_FLOPS * 1e3


def predrop_timing(torch, np, eng, x_last, launches: dict, windows: int, dev="cuda",
                   parent=None) -> list:
    """Both pre-drop entries at the north-star round's shape: P = 8
    partitions of 65,536 victims (each partition's second 65,536-row block
    of its sum-sorted rows of the last window, +inf padded as the rounds
    pad) against the first 512 rows of its skyline (path (c)'s state), read
    in place from the skyline buffer as the flush passes them. The mask
    entry answers for every victim; the fused entry (the flush's) for the
    rows the partition has. Each: ms against the plain version's (which
    must agree), the bound (``_predrop_bound`` over ``_predrop_pairs``), the
    share of (block, tile) pairs ``predrop_skip_plain`` skips and the
    certified count; with ``parent``, the parent tree's pre-drop kernel on
    the same inputs (the mask entry, in the same call)."""
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.parallel.partitioners import partition_ids_np

    pset = eng.pset
    P, d, B, L = pset.num_partitions, pset.dims, 65536, 512
    pids = partition_ids_np(x_last, "mr-angle", P, NORTH_STAR["domain_max"])
    y = np.full((P, B, d), np.inf, np.float32)
    real = np.zeros((P, B), bool)
    for p in range(P):
        rows = x_last[pids == p]
        rows = rows[np.argsort(rows.sum(axis=1), kind="stable")]
        blk = rows[B : 2 * B] if rows.shape[0] >= 2 * B else rows[:B]
        y[p, : blk.shape[0]] = blk
        real[p, : blk.shape[0]] = True
    yt, bv = torch.from_numpy(y).to(dev), torch.from_numpy(real).to(dev)
    x = pset.sky[:, :L]
    xv = torch.arange(pset.sky.shape[1], device=dev)[None, :] < pset._count_dev[:, None]
    xv = xv[:, :L]
    shape = {"P": P, "nx": L, "ny": B, "d": d}
    out_k, ms, plain_ms, err = _time_pair(
        torch, lambda: dk.strictly_dominated_bf16_kernel(yt, x, xv),
        lambda: dk.strictly_dominated_bf16_plain(yt, x, xv), "pre-drop",
    )
    # a victim with a non-finite coordinate (the +inf padding) cannot certify
    finite = torch.isfinite(yt).all(-1)
    pairs = _predrop_pairs(torch, yt, x, xv, out_k, finite)
    cert = int(out_k.sum())
    skip = dk.predrop_skip_plain(yt, x, xv, dk.TILE_ROWS, dk.BLOCK_VICTIMS)
    extra = {"certified": cert, "skipped_share": float(skip.float().mean())}
    if parent is not None:
        xc, xvc = x.contiguous(), xv.contiguous()
        old = lambda: parent_predrop(torch, parent, yt, xc, xvc)  # noqa: E731
        if not torch.equal(old(), out_k):
            raise AssertionError("the parent's pre-drop disagrees at the north-star shape")
        extra["parent_ms"] = _event_ms(torch, old, reps=10)
        log(f"timings: pre-drop mask, the parent tree's kernel on the same inputs: "
            f"{extra['parent_ms']:.3f} ms")
    log(f"timings: pre-drop mask: {cert} victims certified")
    table = [_row(PREDROP, launches, windows, err, ms, plain_ms,
                  _predrop_bound(P, B, L, d, pairs, cert, False), shape, pairs, extra)]

    kern = lambda: dk.mp_predrop_kernel(x, xv, yt, bv)  # noqa: E731
    got = kern()
    t0 = time.perf_counter()
    want = dk.mp_predrop_plain(x, xv, yt, bv)
    torch.cuda.synchronize()
    fused_plain_ms = (time.perf_counter() - t0) * 1e3
    if got[0].cpu().numpy().tobytes() != want[0].cpu().numpy().tobytes() or not (
        torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    ):
        raise AssertionError("the fused pre-drop at its main-path shape disagrees with its "
                             "plain version")
    fused_ms = _event_ms(torch, kern, reps=10)
    certified = bv & ~got[1]
    fcert = int(certified.sum())
    fpairs = _predrop_pairs(torch, yt, x, xv, certified, bv & finite)
    fskip = dk.predrop_skip_plain(yt, x, xv, dk.TILE_ROWS, dk.BLOCK_VICTIMS, bv)
    log(f"timings: pre-drop fused: {fcert} victims certified, the same as the sum of its "
        f"counts: {int(got[2].sum()) == fcert}")
    table.append(_row(PREDROP_FUSED, launches, windows, 0, fused_ms, fused_plain_ms,
                      _predrop_bound(P, B, L, d, fpairs, fcert, True), shape, fpairs,
                      {"certified": fcert, "skipped_share": float(fskip.float().mean())}))
    return table


def heaviest_tree_pair(torch, n: int):
    """One more window of path (b) with ``tree_pair_merge`` watched: the
    inputs of its heaviest pair (the largest product of the two leaves'
    widths), cloned."""
    import numpy as np

    from skyline_tpu_torch.stream import batched
    from skyline_tpu_torch.workload.generators import anti_correlated

    real = batched.tree_pair_merge
    best = {"work": -1, "pairs": 0}

    def watch(a, apids, acnt, b, bpids, bcnt, out_cap):
        best["pairs"] += 1
        work = a.shape[0] * b.shape[0]
        if work >= best["work"]:
            best.update(work=work, a=a.clone(), acnt=acnt.clone(), b=b.clone(),
                        bcnt=bcnt.clone())
        return real(a, apids, acnt, b, bpids, bcnt, out_cap)

    x = anti_correlated(np.random.default_rng(2), n, PATHS["b"][0]["dims"], 0, 10000)
    batched.tree_pair_merge = watch
    try:
        with rank_gate(False):
            _, _, eng = run_window(_config("b", n), np.arange(n, dtype=np.int64), x)
    finally:
        batched.tree_pair_merge = real
    best["tree_info"] = eng.pset.last_tree_info
    return best


def _time_tree_pair(torch, a, acnt, b, bcnt, what: str) -> dict:
    """K2 on one tree pair, its two calls — the b leaf's rows against the
    a leaf's, then the a leaf's against the kept b rows — each with ms, the
    plain version's ms, needed pairs, the bound's two terms and the skipped
    share; and the pair's total ms."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    dev = a.device
    av = torch.arange(a.shape[0], device=dev) < acnt
    bv = torch.arange(b.shape[0], device=dev) < bcnt
    at, bt = a.T.contiguous(), b.T.contiguous()
    keep_b = bv & ~dk.dominated_by_rect(at, av, bt)
    calls = {"b_vs_a": (at, av, bt, bv), "a_vs_kept_b": (bt, keep_b, at, av)}
    out = {"valid_a_rows": int(av.sum()), "valid_b_rows": int(bv.sum()), "calls": {}}
    total_ms = 0.0
    for label, (xt, xv, yt, wanted) in calls.items():
        out_k, ms, plain_ms, err = _time_pair(
            torch, lambda: dk.dominated_by_rect(xt, xv, yt),  # noqa: B023
            lambda: dk.dominated_by_rect_plain(xt, xv, yt), f"{what} {label}",  # noqa: B023
        )
        d, nx = xt.shape
        ny = yt.shape[1]
        pairs = _needed_pairs(torch, xt, xv, yt, out_k, wanted)
        in_bytes = d * nx * 4 + nx + d * ny * 4
        bound = ((in_bytes + ny) / HBM_BYTES_S * 1e3, pairs * d / FP32_FLOPS * 1e3)
        skip = dk.tile_skip_plain(xt[None], xv[None], yt[None], dk.TILE_ROWS, dk.BLOCK_VICTIMS)
        row = {
            "ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "needed_pairs": pairs,
            "bound_ms": max(bound),
            "bound_by": "operations" if bound[1] >= bound[0] else "bytes",
            "skipped_share": float(skip.float().mean()),
            "shape": {"nx": nx, "ny": ny, "d": d},
        }
        log(f"timings: {what} {label} {row['shape']}: {ms:.3f} ms (plain "
            f"{plain_ms:.1f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']}, {pairs} "
            f"needed pairs, {row['skipped_share']:.6f} of (block, tile) pairs skipped)")
        if ms < row["bound_ms"]:
            raise AssertionError(f"{what} {label} reads under its bound")
        out["calls"][label] = row
        total_ms += ms
    out["pair_ms"] = total_ms
    return out


def tree_pair_k2(torch, np, n: int, launches: dict, windows: int) -> dict:
    """K2 on the tree input: the heaviest pair of one north-star window,
    its two calls (``_time_tree_pair``), each side a partition skyline in
    storage order; plus K2's launches per window on (b)."""
    r = heaviest_tree_pair(torch, n)
    if not r["pairs"]:
        raise AssertionError(f"the tree merged no pair on (b): {r['tree_info']}")
    out = {"launches_per_window": launches["dominated_by_rect"] / windows,
           "pairs_per_window": r["pairs"], "tree_info": r["tree_info"],
           **_time_tree_pair(torch, r["a"], r["acnt"], r["b"], r["bcnt"], "K2 tree pair")}
    log(f"timings: K2 tree pair ({out['valid_a_rows']} a rows, {out['valid_b_rows']} b rows) "
        f"{out['pair_ms']:.3f} ms, {out['pairs_per_window']} pairs and "
        f"{out['launches_per_window']:.1f} K2 launches per window on (b); tree "
        f"{out['tree_info']}")
    return out


# the device cascade's launch sites, one call each a mask: the full square
# and the band (the window pass) and the scan (the pre-drop with mp, the
# buffer pass and the appends: one thread-block cluster)
CASCADE_SITES = {"windows": "cascade_windows", "scan": "cascade_scan"}


@contextlib.contextmanager
def cascade_sites(torch):
    """For the duration, every launch of ``ops/device_cascade.py`` is
    bracketed by CUDA events and kept with its wrapper, inputs and output,
    by site, with the host wall of the call. Yields the dict of site ->
    [(start, end, wrapper, args, kwargs, out, host ms)]."""
    from skyline_tpu_torch.ops import device_cascade as tdc

    real = {site: getattr(tdc, name) for site, name in CASCADE_SITES.items()}
    sites = {k: [] for k in CASCADE_SITES}

    def watched(site):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            out = real[site](*args, **kw)
            host_ms = (time.perf_counter() - t0) * 1e3
            end.record()
            sites[site].append((start, end, real[site], args, kw, out, host_ms))
            return out
        return call

    for site, name in CASCADE_SITES.items():
        setattr(tdc, name, watched(site))
    try:
        yield sites
    finally:
        for site, name in CASCADE_SITES.items():
            setattr(tdc, name, real[site])


def _scan_pairs(torch, cand, alive, out, block: int) -> int:
    """Pairs the scan needs at least: one for each row it kills; for each
    survivor v of block b, the rows of the buffer tiles (the survivors of
    the blocks before b, ``TILE_ROWS`` rows a tile in append order) whose
    summary over the rows below b's count — the coordinate minima and the
    least row sum, a NaN sum -inf — does not rule v out by the kernel's
    exact skip (``csrc/dominance_common.cuh`` ``skip_tile``: rule (a) a
    larger least sum, (b) a larger minimum in some coordinate, (c) minima no
    smaller in every coordinate)."""
    from skyline_tpu_torch.ops.dominance_kernels import TILE_ROWS, row_sums

    d = cand.shape[1]
    pairs = int((alive & ~out).sum())
    buf = cand[out]
    sums = torch.nan_to_num(row_sums(buf), nan=float("-inf"))
    kept = out.reshape(-1, block).sum(1)
    before = (torch.cumsum(kept, 0) - kept).tolist()
    for b in kept.nonzero().squeeze(1).tolist():
        count = before[b]
        if count == 0:
            continue
        tiles = -(-count // TILE_ROWS)
        pad = tiles * TILE_ROWS - count
        lo = torch.cat([buf[:count], buf.new_full((pad, d), float("inf"))])
        lo = lo.reshape(tiles, TILE_ROWS, d).amin(1)
        lo_sum = torch.cat([sums[:count], sums.new_full((pad,), float("inf"))])
        lo_sum = lo_sum.reshape(tiles, TILE_ROWS).amin(1)
        size = torch.full((tiles,), TILE_ROWS, device=cand.device)
        size[-1] = count - (tiles - 1) * TILE_ROWS
        rows = cand[b * block:(b + 1) * block][out[b * block:(b + 1) * block]]
        for v in rows.split(256):
            skip = ((lo_sum[None] > row_sums(v)[:, None]) | (lo[None] > v[:, None]).any(-1)
                    | (lo[None] >= v[:, None]).all(-1))
            pairs += int((size[None] * ~skip).sum())
    return pairs


def _window_spans(cand, block, band_end):
    """Per block with a candidate (a row free of NaN) and a window: (block,
    first row, end row) of its window, ``[b * block, min(band_end[b] *
    block, N))``."""
    n = cand.shape[0]
    live = (~cand.isnan().any(1)).reshape(-1, block).any(1).tolist()
    spans = [(b, b * block, min(e * block, n)) for b, e in enumerate(band_end.tolist())]
    return [(b, s, e) for b, s, e in spans if live[b] and e > s]


def _site_bound(torch, site, args, out):
    """(bytes, needed pairs, d) of one cascade call. Bytes: the rows'
    coordinates the function needs, each read once — the scan's its alive
    rows (no other row is compared, and the buffer holds alive rows), the
    window pass's the candidates of the blocks with a window (victims and
    window rows are the same rows of ``cand``: counted once) — plus the
    flags, ends and outputs; the buffer, the summaries and the worklist are
    the kernels' scratch. Pairs: the scan's as ``_scan_pairs`` counts them;
    the window pass's as ``_needed_pairs`` counts them over each window
    (NaN rows, the non-candidates, need none)."""
    if site == "scan":
        cand, alive, block = args[:3]
        n, d = cand.shape
        nbytes = 2 * n + int(alive.sum()) * d * 4
        return nbytes, _scan_pairs(torch, cand, alive, out, block), d
    cand, block, band_end = args[:3]
    n, d = cand.shape
    real = ~torch.isnan(cand).any(1)
    edges = torch.zeros(n + 1, dtype=torch.int64, device=cand.device)
    spans = _window_spans(cand, block, band_end)
    for _, s, e in spans:
        edges[s] += 1
        edges[e] -= 1
    in_window = torch.cumsum(edges, 0)[:n] > 0
    nbytes = 4 * band_end.numel() + out.numel() + int((in_window & real).sum()) * d * 4
    pairs = 0
    for b, s, e in spans:
        rows = real[b * block:(b + 1) * block].nonzero().squeeze(1) + b * block
        wanted = torch.ones(rows.shape[0], dtype=torch.bool, device=cand.device)
        pairs += _needed_pairs(torch, cand[s:e].T.contiguous(), real[s:e],
                               cand[rows].T.contiguous(), out[rows], wanted)
    return nbytes, pairs, d


def site_numbers(torch, sites) -> dict:
    """Per site: launches; ``ms``, each launch timed again alone on its
    inputs (``_event_ms``, 3 runs, the mean), summed; ``in_flow_ms``, the
    CUDA events that bracketed each launch where the caller made it,
    summed — host gaps before the kernel included; ``plain_ms``, the plain
    version once on the same inputs (it must agree); and the summed
    per-launch bound — max(bytes at the HBM rate, needed pairs x d at the
    FP32 peak), ``_site_bound``."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    plain = {"windows": lambda *a, **kw: dk.cascade_windows_plain(*a[:3]),
             "scan": lambda *a, **kw: dk.cascade_scan_plain(*a)}
    torch.cuda.synchronize()
    out = {}
    for site, calls in sites.items():
        ms = in_flow = plain_ms = bytes_ms = ops_ms = bound_ms = 0.0
        pairs = 0
        flows, hosts = [], []
        for start, end, fn, args, kw, got, host_ms in calls:
            flows.append(start.elapsed_time(end))
            hosts.append(host_ms)
            in_flow += flows[-1]
            ms += _event_ms(torch, lambda: fn(*args, **kw), reps=3)  # noqa: B023
            t0 = time.perf_counter()
            want = plain[site](*args, **kw)
            torch.cuda.synchronize()
            plain_ms += (time.perf_counter() - t0) * 1e3
            if not torch.equal(want, got):
                raise AssertionError(f"cascade site {site}: the kernel and its plain version "
                                     "disagree")
            nbytes, p, d = _site_bound(torch, site, args, got)
            pairs += p
            b, o = nbytes / HBM_BYTES_S * 1e3, p * d / FP32_FLOPS * 1e3
            bytes_ms += b
            ops_ms += o
            bound_ms += max(b, o)
        out[site] = {"launches": len(calls), "ms": ms, "in_flow_ms": in_flow,
                     "in_flow_ms_calls": flows, "host_ms_calls": hosts,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bytes_ms": bytes_ms,
                     "ops_ms": ops_ms, "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes", "pairs": pairs}
        if site == "scan" and calls:
            # the scan's cluster barriers: one at the start, then per block
            # with a live row the append's, and once the buffer has rows
            # (after the first such block) the buffer pass's (the pre-drop
            # shares its phase); the time a barrier at most (the work of the
            # phases included)
            barriers = 0
            for _, _, _, (_, alive, block, _), _, _, _ in calls:
                live = int(alive.reshape(-1, block).any(1).sum())
                barriers += 1 + live + max(live - 1, 0)
            out[site]["cluster_barriers"] = barriers
            out[site]["cluster_ctas"] = dk.SCAN_CTAS
            out[site]["us_per_barrier_at_most"] = ms * 1e3 / max(barriers, 1)
        if ms < bound_ms:
            raise AssertionError(f"cascade site {site} reads under its bound: {out[site]}")
    return out


def _wall_ms(torch, fn, reps: int = 3) -> float:
    """Mean host wall of ``fn`` over ``reps`` calls, each ended by a
    synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _sites_line(sites: dict) -> str:
    return "; ".join(f"{k} {v['launches']} x, {v['ms']:.3f} ms ({v['in_flow_ms']:.3f} ms in "
                     f"the flow, the longest call {max(v['in_flow_ms_calls'], default=0):.3f} "
                     f"ms, host {max(v['host_ms_calls'], default=0):.3f} ms at most; plain "
                     f"{v['plain_ms']:.1f} ms), bound {v['bound_ms']:.6f} ms by {v['bound_by']}"
                     + (f", a cluster of {v['cluster_ctas']} CTAs, {v['cluster_barriers']} "
                        f"cluster barriers, at most {v['us_per_barrier_at_most']:.2f} us each"
                        if "cluster_barriers" in v else "")
                     for k, v in sites.items())


def _kernel_ms(torch, fn, reps: int = 5) -> dict:
    """Device ms a call of ``fn`` by kernel name (``_short_kernel``), from
    ``torch.profiler`` over ``reps`` calls after a warm one; empty when the
    profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            name = _short_kernel(ev.key)
            out[name] = out.get(name, 0.0) + ev.self_device_time_total / 1e3 / reps
    return out


def _parent_call(torch, parent, site, args, kw):
    """The parent tree's kernel for a cascade site's recorded call: its
    windowed K2 (``dominated_by_rect_windows``, with the two transposes of
    the candidates its caller made) for the window pass, its cooperative
    ``cascade_scan`` for the scan; a function of no arguments returning
    the (N,) mask."""
    if site == "scan":
        return lambda: parent.cascade_scan(*args, **kw)
    cand, block, band_end = args[:3]
    n, d = cand.shape
    ok = ~torch.isnan(cand).any(1)
    first = torch.arange(n // block, dtype=torch.int32, device=cand.device) * block
    ends = (band_end.long() * block).to(torch.int32)
    return lambda: parent.dominated_by_rect_windows(
        cand.T.contiguous(), ok, cand.reshape(-1, block, d).transpose(1, 2).contiguous(), first,
        ends, mp=kw.get("mp", False)).reshape(n)


def cascade_breakdown(torch, sites, parent=None) -> dict:
    """The cascade's calls recorded by ``cascade_sites``, run again: each
    site's device ms by kernel, summed over its calls (``_kernel_ms``: the
    window pass's summary and compare kernels, the scan's summaries and
    cluster kernel); for the window pass the inputs counted — groups of
    ``BLOCK_VICTIMS`` rows and those holding a candidate (the windowed K2's
    compare grid had one CTA a group, and only these had an open victim),
    the worklist's items, the tiles the longest window walks, and the
    windows' lengths in blocks (least, median, largest, over the blocks
    with a candidate). With ``parent`` (the parent tree's
    ``dominance_kernels``) its kernels on the same inputs (``_parent_call``),
    their masks checked against this tree's, timed by CUDA events
    (``parent_ms``, summed) beside this tree's (``ms``) and split the same
    way."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    out = {}
    for site, calls in sites.items():
        entry = {"calls": len(calls), "ms": 0.0, "kernel_ms": {}}
        if parent is not None:
            entry.update(parent_ms=0.0, parent_kernel_ms={})
        lengths, longest, groups, with_cand, items = [], 0, 0, 0, 0
        for _, _, fn, args, kw, got, _ in calls:
            call = lambda fn=fn, args=args, kw=kw: fn(*args, **kw)  # noqa: E731
            entry["ms"] += _event_ms(torch, call, reps=3)
            for k, v in _kernel_ms(torch, call).items():
                entry["kernel_ms"][k] = entry["kernel_ms"].get(k, 0.0) + v
            if parent is not None:
                old = _parent_call(torch, parent, site, args, kw)
                if not torch.equal(old(), got):
                    raise AssertionError(f"cascade site {site}: the parent's kernel disagrees")
                entry["parent_ms"] += _event_ms(torch, old, reps=3)
                for k, v in _kernel_ms(torch, old).items():
                    entry["parent_kernel_ms"][k] = entry["parent_kernel_ms"].get(k, 0.0) + v
            if site != "windows":
                continue
            cand, block, band_end = args[:3]
            real = ~torch.isnan(cand).any(1)
            size = min(block, dk.BLOCK_VICTIMS)
            groups += cand.shape[0] // size
            with_cand += int(real.reshape(-1, size).any(1).sum())
            scratch = {}
            dk.cascade_windows(cand, block, band_end, scratch=scratch)
            items += int(scratch["counters"][0])
            for _, s, e in _window_spans(cand, block, band_end):
                lengths.append((e - s) / block)
                longest = max(longest, -(-e // dk.TILE_ROWS) - s // dk.TILE_ROWS)
        if site == "windows" and calls:
            lengths.sort()
            entry.update(groups=groups, groups_with_candidate=with_cand, items=items,
                         longest_window_tiles=longest,
                         window_blocks={"min": lengths[0], "median": lengths[len(lengths) // 2],
                                        "max": lengths[-1]} if lengths else None)
        out[site] = entry
    log("timings: the cascade's kernels split: " + "; ".join(
        f"{site} {v['calls']} calls {v['ms']:.3f} ms ("
        + ", ".join(f"{k} {m:.3f}" for k, m in sorted(v["kernel_ms"].items())) + ")"
        + (f", parent {v['parent_ms']:.3f} ms ("
           + ", ".join(f"{k} {m:.3f}" for k, m in sorted(v["parent_kernel_ms"].items())) + ")"
           if "parent_ms" in v else "")
        + (f"; {v['groups_with_candidate']} of {v['groups']} groups hold a candidate, "
           f"{v['items']} items, the longest window {v['longest_window_tiles']} tiles, "
           f"window blocks {v['window_blocks']}" if "items" in v else "")
        for site, v in out.items()))
    return out


def cascade_timings(torch, np, eng, x_last, windows: int, launches_l: dict,
                    launches_m: dict, dev="cuda", parent=None) -> dict:
    """The device cascade at the north-star flat-merge union (path (c)'s
    last engine, the union K3's north-star row masks; 524,288 rows after
    padding), with ``SKYLINE_MIXED_PRECISION`` on and off: the whole call's
    host wall beside K3's on the same input (CUDA events) and the CPU
    cascade's; its launches; each site's device ms, plain ms and bound
    (``cascade_sites``). Then one more window of path (l) with its sites
    watched: the cascade as the flush runs it. Launches per window of (l)
    and (m) from their main-path runs. ``breakdown``: ``cascade_breakdown``
    of the union's mp calls and of the (l) window's (with ``parent``, the
    parent tree's kernels beside them). ``rows``: the kernel table's rows
    of the window pass and the scan (their main paths' mp launches), at
    (l)'s shapes, per call, the union's numbers under ``inputs``."""
    from skyline_tpu_torch.ops import device_cascade as tdc
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.stream.window import _active_bucket, gather_union
    from skyline_tpu_torch.workload.generators import anti_correlated

    pset = eng.pset
    counts = pset.sky_counts()
    active = min(pset._cap, _active_bucket(max(int(counts.max()), 1)))
    union_cap = _active_bucket(max(int(counts.sum()), 1))
    u, _, uv = gather_union(pset.sky, pset._count_dev, active, union_cap)
    out = {"union_rows": int(u.shape[0]), "valid_rows": int(uv.sum())}
    t0 = time.perf_counter()
    cpu_keep = tdc.device_cascade_mask(u.cpu(), uv.cpu())
    out["plain_ms"] = (time.perf_counter() - t0) * 1e3
    # the bound of the function itself, K3's on this input
    ut = u.T.contiguous()
    pairs = _needed_pairs(torch, ut, uv, ut, ~cpu_keep.to(dev), uv)
    out["bound_ms"] = max((u.numel() * 4 + 2 * u.shape[0]) / HBM_BYTES_S * 1e3,
                          pairs * u.shape[1] / FP32_FLOPS * 1e3)
    for mp in (True, False):
        key = "mp" if mp else "f32"
        with knob_env({"SKYLINE_MIXED_PRECISION": "1" if mp else "0"}):
            keep = tdc.device_cascade_mask(u, uv)
            k3 = dk.skyline_mask_kernel(u, uv, mp=mp)
            if not (torch.equal(keep, k3) and torch.equal(keep.cpu(), cpu_keep)):
                raise AssertionError(f"cascade ({key}) at the north-star union differs from K3")
            ms = _wall_ms(torch, lambda: tdc.device_cascade_mask(u, uv))
            k3_ms = _event_ms(torch, lambda: dk.skyline_mask_kernel(u, uv, mp=mp), reps=10)
            dk.reset_launches()
            with cascade_sites(torch) as sites:
                tdc.device_cascade_mask(u, uv)
            launches = {k: v for k, v in dk.LAUNCHES.items() if v}
            out[key] = {"ms": ms, "k3_ms": k3_ms, "sites": site_numbers(torch, sites),
                        "launches": launches}
            if mp:
                union_sites = sites
        log(f"timings: device cascade ({key}) at the north-star union ({out['union_rows']} "
            f"rows, {out['valid_rows']} valid): {ms:.3f} ms wall against K3 {k3_ms:.3f} ms "
            f"and the CPU cascade {out['plain_ms']:.1f} ms (bound {out['bound_ms']:.4f} ms); "
            f"launches {launches}; sites " + _sites_line(out[key]["sites"]))
    # one more window of (l), its flush's cascade watched
    x = anti_correlated(np.random.default_rng(2), x_last.shape[0], 8, 0, 10000)
    cfg, gate, _, env = PATHS["l"]
    with rank_gate(gate, env), cascade_sites(torch) as sites:
        t0 = time.perf_counter()
        run_window(_config("l", x.shape[0]), np.arange(x.shape[0], dtype=np.int64), x)
        window_ms = (time.perf_counter() - t0) * 1e3
        shapes = {site: [tuple(a.shape) for a in calls[0][3] if hasattr(a, "shape")]
                  for site, calls in sites.items() if calls}
    out["flush_l"] = site_numbers(torch, sites)
    out["flush_l_window_ms"] = window_ms
    out["breakdown"] = {"north_star_union": cascade_breakdown(torch, union_sites, parent),
                        "flush_l_window": cascade_breakdown(torch, sites, parent)}
    for p, launches in (("l", launches_l), ("m", launches_m)):
        out[f"launches_per_window_{p}"] = {
            k: v / windows for k, v in launches.items() if v}
    log(f"timings: device cascade in one more window of (l) ({window_ms:.1f} ms host wall): "
        + _sites_line(out["flush_l"])
        + f"; launches per window (l) {out['launches_per_window_l']}, (m) "
        f"{out['launches_per_window_m']}")
    out["rows"] = []
    for site, name in (("windows", "cascade_windows_mp"), ("scan", "cascade_scan_mp")):
        got = out["flush_l"][site]
        n = max(got["launches"], 1)
        extra = {"inputs": {"north_star_union": {k: out[k]["sites"][site] for k in ("mp", "f32")},
                            "flush_l_window": got},
                 "launches_per_window_m": launches_m.get(name, 0) / windows}
        out["rows"].append(_row(name, launches_l, windows, 0, got["ms"] / n, got["plain_ms"] / n,
                                (got["bytes_ms"] / n, got["ops_ms"] / n),
                                {"flush_l": shapes.get(site)}, got["pairs"], extra))
    return out


RANK_PLANE_BAND = 16


def rank_plane(np, rng, n: int, d: int = 8, top: int = 1000, band: int = RANK_PLANE_BAND):
    """``n`` distinct rank rows built in rank space, in random order: (d+1,
    n) int32, d ranks and their sum, the sums ``band`` consecutive values.
    One exact sum would let the rank kernel's sum rule skip every pair
    (domination needs a strictly smaller sum); over a narrow band no (block,
    tile) pair is skipped, half the pairs have a smaller dominator sum, and
    a row dominates another only if it is lower in every rank by less than
    ``band`` in all, which random rows spread over 0..``top`` are not. So
    every victim walks every tile: it times the compare loop."""
    head = rng.integers(0, top + 1, size=(2 * n, d - 1))
    last = (d - 1) * top - head.sum(1) + rng.integers(0, band, size=2 * n)
    rows = np.unique(np.column_stack([head, last]), axis=0)
    rows = rows[rng.permutation(rows.shape[0])[:n]]
    return _honest_ranks(np, rows)


def rank_inputs(torch, np, eng, x_last, dev="cuda"):
    """K4's window universe (rows, validity) at path (a)'s shapes, and the
    three inputs K5–K7 are timed on: label -> (K5 block (d+1, B), its
    validity, K6 dominators (d+1, S), their validity, K7 union (U, d)
    values, its validity).

    - north_star: path (a)'s shapes, the last window's universe rebuilt from
      the engine's (consumed but intact) device window: the heaviest
      partition's second big block (as the sequential rounds slice it)
      against its skyline prefix, in rank space, and the global merge's
      union;
    - uniform: the same shapes filled from a seed with ``uniform(rng, n, 8,
      0, 10000)``, block and dominators sum-sorted as the rounds see them
      and ranked by K4 over their union (the round's universe);
    - plane: ``PLANE_ROWS`` rows of ``rank_plane`` for K5 and K6 (victims
      and dominators the same rows), ``plane_rows`` for K7.
    """
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.stream import device_window as dw
    from skyline_tpu_torch.stream.window import _active_bucket, _next_pow2, gather_union
    from skyline_tpu_torch.workload.generators import uniform

    pset = eng.pset
    counts = pset.sky_counts()
    d, P = pset.dims, pset.num_partitions
    n = x_last.shape[0]
    nb = _next_pow2(n)
    ws, bounds = dw.sort_window(pset._dev_window, pset._dev_pids, n, nb, P, dw.SORT_TAIL)
    sorted_dims, wr = dw.rank_window(ws, pset.sky, pset._count_dev, nb, 0, nb)
    bounds = bounds.cpu().numpy()
    heavy = int(counts.argmax())
    c = int(counts[heavy])
    lo, hi = int(bounds[heavy]), int(bounds[heavy + 1])
    B = min(pset._seq_block_size(hi - lo), dw.SORT_TAIL)
    off = lo + B if hi - lo >= 2 * B else lo
    width = min(B, hi - off)
    bvalid = torch.arange(B, device=dev) < width
    block_rt = torch.where(bvalid[:, None], wr[off : off + B],
                           sorted_dims.shape[0] * (d + 1)).T.contiguous()
    sky_act = min(pset._cap, _active_bucket(max(c, 1)))
    sky_rt = dw._rank_rows(sorted_dims, pset.sky[heavy, :sky_act]).T.contiguous()
    sky_ok = torch.arange(sky_act, device=dev) < c
    active = min(pset._cap, _active_bucket(max(int(counts.max()), 1)))
    union_cap = _active_bucket(max(int(counts.sum()), 1))
    u, _, uv = gather_union(pset.sky, pset._count_dev, active, union_cap)

    def ones(k):
        return torch.ones(k, dtype=torch.bool, device=dev)

    rng = np.random.default_rng(23)
    S, U = sky_rt.shape[1], u.shape[0]
    rows = [uniform(rng, k, d, 0, 10000) for k in (B, S)]
    rows = np.concatenate([r[np.argsort(r.sum(axis=1), kind="stable")] for r in rows])
    uni = dk.rank_transform(torch.from_numpy(rows).to(dev), ones(B + S))
    plane = torch.from_numpy(rank_plane(np, rng, PLANE_ROWS, d)).to(dev)
    vplane = torch.from_numpy(plane_rows(np, rng, PLANE_ROWS, d)).to(dev)
    return (ws[:nb].contiguous(), torch.arange(nb, device=dev) < n), {
        "north_star": (block_rt, bvalid, sky_rt, sky_ok, u, uv),
        "uniform": (
            uni[:, :B].contiguous(), ones(B), uni[:, B:].contiguous(), ones(S),
            torch.from_numpy(uniform(rng, U, d, 0, 10000)).to(dev), ones(U),
        ),
        "plane": (plane, ones(PLANE_ROWS), plane.clone(), ones(PLANE_ROWS), vplane,
                  ones(PLANE_ROWS)),
    }


def _time_rank_kernel(torch, dk, name, block_rt, bvalid, sky_rt, sky_ok, u, uv) -> dict:
    """One of K5–K7 on one input: its ms against the plain version's (which
    must agree), needed pairs, the bound's two terms, and the share of
    (victim block, dominator tile) pairs ``rank_tile_skip_plain`` skips."""
    if name == "dominated_by_any_rank":
        kern = lambda: dk.dominated_by_any_rank(block_rt, bvalid, triangular=True)  # noqa: E731
        plain = lambda: dk.dominated_by_any_rank_plain(block_rt, bvalid)  # noqa: E731
        xt, xv, yt = block_rt, bvalid, block_rt
    elif name == "dominated_by_rank_rect":
        kern = lambda: dk.dominated_by_rank_rect(sky_rt, sky_ok, block_rt)  # noqa: E731
        plain = lambda: dk.dominated_by_rank_rect_plain(sky_rt, sky_ok, block_rt)  # noqa: E731
        xt, xv, yt = sky_rt, sky_ok, block_rt
    else:  # K7 runs its kernel over the union's ranks in sum order
        kern = lambda: dk.skyline_mask_rank_kernel(u, uv)  # noqa: E731
        plain = lambda: dk.skyline_mask_rank_plain(u, uv)  # noqa: E731
        order, xv = dk._sum_sorted(u, uv)
        xt = yt = dk.rank_transform(u[order], xv)
    out_k, ms, plain_ms, err = _time_pair(torch, kern, plain, KERNELS[name][0])
    if name == "skyline_mask_rank_kernel":  # survivors; only valid rows are wanted
        dominated, wanted = ~out_k[order], xv
    else:
        dominated, wanted = out_k, torch.ones_like(out_k)
    d = xt.shape[0] - 1
    nx, ny = xt.shape[1], yt.shape[1]
    pairs = _needed_pairs(torch, xt, xv, yt, dominated, wanted, rank_d=d)
    if name == "skyline_mask_rank_kernel":  # K7 reads the values, not ranks
        in_bytes = d * nx * 4 + nx
    else:
        in_bytes = (d + 1) * nx * 4 + nx + (0 if yt is xt else (d + 1) * ny * 4)
    skip = dk.rank_tile_skip_plain(xt[None], xv[None], yt[None], dk.TILE_ROWS, dk.BLOCK_VICTIMS)
    return {
        "ms": ms, "plain_ms": plain_ms, "err": err, "pairs": pairs,
        "bound": ((in_bytes + ny) / HBM_BYTES_S * 1e3, pairs * (d + 1) / INT32_OPS * 1e3),
        "shape": {"nx": nx, "ny": ny, "d": d},
        "skipped_share": float(skip.float().mean()) if skip.numel() else 1.0,
    }


def rank_timings(torch, np, eng, x_last, launches: dict, windows: int, dev="cuda") -> list:
    """K4 at path (a)'s window universe, and K5–K7 on the three inputs of
    ``rank_inputs``; the table's rows are the north-star ones, each with the
    other inputs' numbers under ``inputs``."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    (w_univ, w_valid), inputs = rank_inputs(torch, np, eng, x_last, dev)
    d, nb = w_univ.shape[1], w_univ.shape[0]
    # K4 is torch ops: bytes-bound (read the rows once, write the ranks once)
    _, ms, plain_ms, err = _time_pair(
        torch, lambda: dk.rank_transform(w_univ, w_valid),
        lambda: dk.rank_transform(w_univ.cpu(), w_valid.cpu()).to(dev), "K4",
    )
    bound = ((nb * d * 4 + nb + nb * (d + 1) * 4) / HBM_BYTES_S * 1e3, 0.0)
    table = [_row("rank_transform", launches, windows, err, ms, plain_ms, bound,
                  {"n": nb, "d": d})]
    for name in RANK_PATH[1:]:
        got = {
            label: _time_rank_kernel(torch, dk, name, *args) for label, args in inputs.items()
        }
        ns = got["north_star"]
        table.append(_row(
            name, launches, windows, ns["err"], ns["ms"], ns["plain_ms"], ns["bound"],
            ns["shape"], ns["pairs"],
            {"skipped_share": ns["skipped_share"], "inputs": _input_rows(name, got)},
        ))
    return table


# -- the sliding windows: K3 over a partition batch, parity, (n), (o) --------


def _batch_k3_cases(torch, np, rng, dev):
    """(name, x (P, N, d) f32, valid (P, N)) on the card: P in {1, 3, 8},
    d in {3, 4, 8, 16}, N ragged against the 256-row tile and victim block;
    duplicate rows, +0.0 and -0.0 mixed, NaN and +inf rows, invalid rows
    with finite coordinates, a partition with no valid rows and one whose
    first half is invalid; the north-star's zero block; an empty batch."""
    from skyline_tpu_torch.workload.generators import anti_correlated, uniform

    cases = []
    for P, n in ((1, 4097), (3, 3001), (8, 1000)):
        for d in (3, 4, 8, 16):
            flat = (anti_correlated(rng, P * n, d, 0, 40) if d <= 8
                    else uniform(rng, P * n, d, 0, 20))
            x = flat.reshape(P, n, d).copy()
            valid = rng.random((P, n)) < 0.9
            x[:, 10:60] = x[:, :50]
            x[:, 100:140] = 0.0
            x[:, 140:160] = -0.0
            x[:, 150:160, 1:] = 0.0
            x[:, 160:170, 0] = np.nan
            x[:, 170:180] = np.inf
            x[:, 180:190, 1] = np.inf
            x[:, 200:260] = rng.integers(0, 5, size=(P, 60, d))
            valid[:, 200:260] = False
            if P > 1:
                valid[1] = False
            if P > 2:
                valid[2, : n // 2] = False
            cases.append((f"P={P} d={d} N={n}", x, valid))
    x = anti_correlated(rng, 8 * 8192, 8, 0, 10000).reshape(8, 8192, 8).copy()
    x[0, :5000] = 0.0
    x[0, 5000:5020, :4] = -0.0
    valid = np.ones((8, 8192), bool)
    valid[:, 7000:] = False
    cases.append(("north-star zero block P=8 d=8 N=8192", x, valid))
    cases.append(("empty P=3 N=0 d=8", np.zeros((3, 0, 8), np.float32), np.zeros((3, 0), bool)))
    return [
        (name, torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev),
         torch.from_numpy(v).to(dev))
        for name, x, v in cases
    ]


def check_batched_k3(torch, np, dev) -> int:
    """K3 over a partition batch (one K1 launch) against its plain version
    and against K3 run on each partition alone, exact equality."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    checks = 0
    for name, x, v in _batch_k3_cases(torch, np, np.random.default_rng(71), dev):
        before = dk.LAUNCHES["skyline_mask_kernel"]
        got = dk.skyline_mask_kernel(x, v)
        torch.cuda.synchronize()
        if dk.LAUNCHES["skyline_mask_kernel"] - before != (1 if x.shape[1] else 0):
            raise AssertionError(f"K3 batch {name}: not one launch")
        if not torch.equal(got, dk.skyline_mask_plain(x, v)):
            raise AssertionError(f"K3 batch {name}: kernel and plain version differ in "
                                 f"{int((got != dk.skyline_mask_plain(x, v)).sum())} rows")
        for p in range(x.shape[0]):
            alone = dk.skyline_mask_kernel(x[p].contiguous(), v[p].contiguous())
            if not torch.equal(got[p], alone):
                raise AssertionError(f"K3 batch {name}: partition {p} differs from K3 alone")
        checks += 1 + x.shape[0]
    return checks


@contextlib.contextmanager
def slide_step_probe(torch):
    """Wrap the sliding engine's slide step: per call the branch, the K3
    launches it made, its device ms between CUDA events (card engines) and
    its inputs (the last call's are kept for the timings)."""
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.stream import sliding_engine as se

    orig = se._slide_step_batched
    calls = []

    def step(rings, ring_valids, slot, rows, rows_valid, use_k3=False):
        cuda = rings.device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        before = dk.LAUNCHES["skyline_mask_kernel"]
        out = orig(rings, ring_valids, slot, rows, rows_valid, use_k3=use_k3)
        rec = {"use_k3": use_k3, "k3_launches": dk.LAUNCHES["skyline_mask_kernel"] - before,
               "rows": rows, "rows_valid": rows_valid, "events": None}
        if cuda:
            ev[1].record()
            rec["events"] = ev
        calls.append(rec)
        return out

    se._slide_step_batched = step
    try:
        yield calls
    finally:
        se._slide_step_batched = orig


def _step_ms(rec) -> float | None:
    if rec["events"] is None:
        return None
    rec["events"][1].synchronize()
    return rec["events"][0].elapsed_time(rec["events"][1])


# the sliding parity legs: (name, engine configuration, window, slide, rows,
# the branch the card must take, skewed tail). Skewed tails route 60% of
# their rows to one partition (mr-dim: dim 0 below domain / P; mr-grid: the
# lowest cell) and grow its ring mid-stream; the 4-D growth leg crosses the
# K3 gate (k * cap 2,048 -> 8,192) when it grows
SLIDING_PARITY = (
    ("8d_angle_4096_1024", dict(parallelism=4, algo="mr-angle", dims=8), 4096, 1024, 12288,
     "scan", False),
    ("3d_grid_2048_256_growth", dict(parallelism=4, algo="mr-grid", dims=3), 2048, 256, 6144,
     "scan", True),
    ("8d_dim_8192_2048", dict(parallelism=1, algo="mr-dim", dims=8), 8192, 2048, 14336,
     "k3", False),
    ("4d_dim_8192_1024_growth", dict(parallelism=4, algo="mr-dim", dims=4), 8192, 1024, 12288,
     "k3", True),
    ("2d_angle_4096_1024", dict(parallelism=4, algo="mr-angle", dims=2), 4096, 1024, 12288,
     "sweep", False),
)
SLIDING_FIELDS = ("query_id", "record_count", "skyline_size", "optimality", "window_size",
                  "slide", "slides_closed", "window_filled", "partial")


def _sliding_stream(np, rng, cfg, n: int, skew: bool):
    from skyline_tpu_torch.workload.generators import anti_correlated

    x = anti_correlated(rng, n, cfg["dims"], 0, 10000)
    if skew:
        tail = np.arange(n // 4, n)
        hot = tail[rng.random(tail.size) < 0.6]
        x[hot] *= 0.2 / (2 * cfg["parallelism"]) if cfg["algo"] == "mr-dim" else 0.05
    return x


def _drive_sliding(cfg, window: int, slide: int, x, device: str):
    """One sliding engine over ``x`` in 700-row chunks under an injected
    clock (one second a chunk), per-slide emission on: a mid-slide trigger
    every third chunk, a barrier trigger cleared by later rows, one that
    never clears and times out (``query_timeout_ms`` 2,500), a watchdog
    sweep after every chunk. Returns (results, stats, ring capacities)."""
    import numpy as np

    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.stream.sliding_engine import SlidingEngine

    eng = SlidingEngine(
        EngineConfig(**cfg, domain_max=10000.0, emit_skyline_points=True,
                     query_timeout_ms=2500.0, device=device),
        window_size=window, slide=slide, emit_per_slide=True,
    )
    ids = np.arange(x.shape[0], dtype=np.int64)
    caps = []
    for j, i in enumerate(range(0, x.shape[0], 700)):
        t = 1000.0 * (j + 1)
        eng.process_records(ids[i : i + 700], x[i : i + 700], now_ms=t)
        if j % 3 == 1:
            eng.process_trigger(f"mid{j},0", now_ms=t)
        if j == 2:
            eng.process_trigger(f"late,{i + 1400}", now_ms=t)
        if j == 4:
            eng.process_trigger(f"never,{10**12}", now_ms=t)
        eng.check_timeouts(now_ms=t)
        caps.append(eng._cap)
    return eng.poll_results(), eng.stats(include_skyline_counts=True), caps


def _sliding_skyline_run(x, window: int, slide: int, device: str):
    """``SlidingSkyline`` over ``x`` in 37 ragged batches: every slide's
    (window end, fill flag, skyline bytes), and ``current_skyline`` with
    rows pending every fifth batch."""
    import numpy as np

    from skyline_tpu_torch.stream.sliding import SlidingSkyline

    sw = SlidingSkyline(window, slide, x.shape[1], device=device)
    out = []
    for j, chunk in enumerate(np.array_split(x, 37)):
        out += [(r["window_end"], r["window_filled"], r["skyline"].tobytes())
                for r in sw.push(chunk)]
        if j % 5 == 2:
            out.append(("current", sw._pending_rows, sw.current_skyline.tobytes()))
    return out


def check_sliding_parity(torch, np, devices=("cuda", "cpu")) -> dict:
    """``SlidingEngine`` and ``SlidingSkyline``, CUDA against the CPU,
    strict (routing is the host's on both): every result's fields and
    point bytes, the final per-partition counts and the ring capacities.
    On the card each leg must take its branch; on the K3 legs every slide
    step whose gate is on launches K3 exactly twice."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    rng = np.random.default_rng(83)
    out = {}
    for name, cfg, window, slide, n, branch, skew in SLIDING_PARITY:
        x = _sliding_stream(np, rng, cfg, n, skew)
        runs, walls = [], []
        for device in devices:
            dk.reset_launches()
            t0 = time.perf_counter()
            with slide_step_probe(torch) as calls:
                runs.append(_drive_sliding(cfg, window, slide, x, device))
            walls.append(time.perf_counter() - t0)
            if len(runs) == 1:  # the card's side
                k3_steps = [c for c in calls if c["use_k3"]]
                if any(c["k3_launches"] != 2 for c in k3_steps) or any(
                        c["k3_launches"] for c in calls if not c["use_k3"]):
                    raise AssertionError(f"sliding parity {name}: K3 launches per step "
                                         f"{[c['k3_launches'] for c in calls]}")
                card = {"branch": runs[0][1]["mask_kernel"], "k3_steps": len(k3_steps),
                        "steps": len(calls)}
        (ra, sa, ca), (rb, sb, cb) = runs
        if devices[0] == "cuda" and (
                card["branch"] != branch or (branch == "k3" and not card["k3_steps"])):
            raise AssertionError(f"sliding parity {name}: the card took {card}, not {branch}")
        if skew and ca[-1] <= ca[0]:
            raise AssertionError(f"sliding parity {name}: the ring never grew ({ca})")
        if len(ra) != len(rb) or ca != cb or sa["partitions"] != sb["partitions"]:
            raise AssertionError(f"sliding parity {name}: {len(ra)} vs {len(rb)} results, "
                                 f"capacities {ca[-1]} vs {cb[-1]}")
        for a, b in zip(ra, rb):
            bad = [f for f in SLIDING_FIELDS if a.get(f) != b.get(f)]
            if bad or _points(a).tobytes() != _points(b).tobytes():
                raise AssertionError(f"sliding parity {name}, result {a['query_id']}: "
                                     f"fields {bad} or the point bytes differ")
        kinds = {"partial": sum(bool(r.get("partial")) for r in ra),
                 "per_slide": sum(r["query_id"].startswith("slide-") for r in ra),
                 "late": sum(r["query_id"] == "late" for r in ra)}
        if not (kinds["partial"] and kinds["per_slide"] and kinds["late"]):
            raise AssertionError(f"sliding parity {name}: missing result kinds {kinds}")
        out[name] = {**card, "wall_s": walls, "results": len(ra), **kinds,
                     "capacity": ca[-1],
                     "skyline_sizes": [r["skyline_size"] for r in ra if r["window_filled"]][-3:]}
        log(f"parity: sliding {name}, cuda == cpu: {out[name]}")
    for d in (3, 8):
        x = _sliding_stream(np, rng, {"dims": d, "algo": "mr-angle", "parallelism": 4},
                            12288, False)
        a, b = (_sliding_skyline_run(x, 4096, 1024, dv) for dv in devices)
        if a != b:
            raise AssertionError(f"SlidingSkyline d={d}: cuda and cpu differ")
        out[f"sliding_skyline_{d}d"] = {"outputs": len(a)}
        log(f"parity: SlidingSkyline d={d} 4096/1024, cuda == cpu over {len(a)} slides and "
            "current_skyline reads")
    return out


class _LastAnswer:
    """A snapshot store that keeps the last published points."""

    points = None

    def note_ingest(self, max_id):
        pass

    def publish(self, points, **meta):
        self.points = points


# (n): benchmarks/sliding_northstar.py:35-67 — 8-D anti-correlated in
# 0-10000, window 1,048,576, K = 8 (slide 131,072), parallelism 4, mr-angle,
# a trigger "<s>,0" at every slide close
SLIDING_NS = dict(parallelism=4, algo="mr-angle", dims=8, domain_max=10000.0)
SLIDING_NS_WINDOW, SLIDING_NS_K = 1_048_576, 8
# (o): benchmarks/run_configs.py:42 SLIDING_CONFIG and :74-119 — 4-D
# anti-correlated, window 200,000, slide 50,000, 800,000 rows in 65,536-row
# chunks, per-slide emission
SLIDING_4D = dict(parallelism=4, algo="mr-angle", dims=4, domain_max=10000.0)
SLIDING_4D_WINDOW, SLIDING_4D_SLIDE, SLIDING_4D_ROWS = 200_000, 50_000, 800_000
SLIDING_CHUNK = 65536


def _timed_answers(eng, walls: list):
    """Record each answer's host wall (ms) of ``eng``."""
    orig = eng._answer_window

    def answer(q, now_ms):
        t0 = time.perf_counter()
        try:
            return orig(q, now_ms)
        finally:
            walls.append((time.perf_counter() - t0) * 1e3)

    eng._answer_window = answer


def _sliding_summary(np, path, lat_s, slide, steps, answers_ms, route_ms, host_bytes, sizes,
                     eng, launches, extra):
    """The path's numbers over its measured slides; raises unless every
    slide step ran the K3 branch with two launches."""
    k3 = [c["k3_launches"] for c in steps]
    p50 = float(np.median(lat_s))
    out = {
        "slides_measured": len(lat_s),
        "p50_slide_ms": p50 * 1e3, "p90_slide_ms": float(np.quantile(lat_s, 0.9)) * 1e3,
        "slides_per_s": 1.0 / p50, "tuples_per_s": slide / p50,
        "skyline_size_p50": float(np.median(sizes)),
        "p50_route_ms": float(np.median(route_ms)),
        "p50_step_device_ms": float(np.median([_step_ms(c) for c in steps])),
        "p50_answer_ms": float(np.median(answers_ms)),
        "k3_launches_per_slide": float(np.mean(k3)),
        "ring_capacity": eng._cap, "ring_shape": list(eng._rings.shape),
        "ring_bytes": eng._rings.numel() * 4 + eng._ring_valids.numel(),
        "host_bytes_per_answer": float(np.median(host_bytes)),
        "mask_kernel": eng.stats()["mask_kernel"], "launches": launches, **extra,
    }
    log(f"main ({path}): slide p50 {out['p50_slide_ms']:.1f} ms, p90 "
        f"{out['p90_slide_ms']:.1f} ms over {len(lat_s)} slides, {out['slides_per_s']:.2f} "
        f"slides/s, {out['tuples_per_s']:.0f} tuples/s (slide / p50), skyline p50 "
        f"{out['skyline_size_p50']:.0f}; route {out['p50_route_ms']:.1f} ms host, slide step "
        f"{out['p50_step_device_ms']:.2f} ms device, answer {out['p50_answer_ms']:.1f} ms; "
        f"K3 launches per slide {out['k3_launches_per_slide']:.2f} ({out['mask_kernel']}); "
        f"rings {out['ring_shape']} ({out['ring_bytes'] / 2**20:.1f} MiB), "
        f"{out['host_bytes_per_answer'] / 2**20:.2f} MiB to the host per answer")
    if out["mask_kernel"] != "k3" or any(c != 2 for c in k3):
        raise AssertionError(f"main ({path}): K3 launches per slide {k3}, branch "
                             f"{out['mask_kernel']}: want 2 on the K3 branch")
    if not launches.get("skyline_mask_kernel"):
        raise AssertionError(f"main ({path}) launched no skyline_mask_kernel: {launches}")
    return out


def _route_ms(tracer) -> float:
    return tracer.report().get("route", {}).get("total_ms", 0.0)


def sliding_northstar(torch, np, windows: int, dev="cuda"):
    """(n): K warm slides fill the window, then max(8, 4 x ``windows``)
    measured ones, each a slide of rows through ``process_records``, the
    trigger "<s>,0" and ``poll_results`` (the benchmark's slide latency).
    The first full window's answer is checked against samples of its input
    and output. Launch counts set to 0 just before, read just after."""
    from collections import deque

    from skyline_tpu_torch.metrics.tracing import Tracer
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.stream.sliding_engine import SlidingEngine
    from skyline_tpu_torch.workload.generators import anti_correlated

    K, slide = SLIDING_NS_K, SLIDING_NS_WINDOW // SLIDING_NS_K
    measured = max(8, 4 * windows)
    tracer = Tracer(sync_device=False)
    eng = SlidingEngine(EngineConfig(**SLIDING_NS, device=dev), window_size=SLIDING_NS_WINDOW,
                        slide=slide, tracer=tracer)
    store = _LastAnswer()
    eng.attach_snapshots(store)
    answers = []
    _timed_answers(eng, answers)
    rng = np.random.default_rng(0)
    recent = deque(maxlen=K)
    lat, sizes, route, host, warm_ms = [], [], [], [], []
    with slide_step_probe(torch) as calls:
        dk.reset_launches()
        for s in range(K + measured):
            x = anti_correlated(rng, slide, SLIDING_NS["dims"], 0, 10000)
            ids = np.arange(s * slide, (s + 1) * slide, dtype=np.int64)
            recent.append(x)
            r0, h0 = _route_ms(tracer), eng.answer_host_bytes
            t0 = time.perf_counter()
            eng.process_records(ids, x)
            eng.process_trigger(f"{s},0")
            (res,) = eng.poll_results()
            dt = time.perf_counter() - t0
            if s < K:
                warm_ms.append(dt * 1e3)
            else:
                lat.append(dt)
                sizes.append(res["skyline_size"])
                route.append(_route_ms(tracer) - r0)
                host.append(eng.answer_host_bytes - h0)
            if s == K - 1:
                if not res["window_filled"]:
                    raise AssertionError("(n): the window is not full after K slides")
                check_answer(torch, np, np.concatenate(list(recent)),
                             np.asarray(store.points, np.float32), dev)
                log(f"main (n): first full window's answer ({res['skyline_size']} points) "
                    "checked against samples of input and output")
        launches = dict(dk.LAUNCHES)
    out = _sliding_summary(
        np, "n", lat, slide, calls[K:], answers[K:], route, host, sizes, eng, launches,
        {"warm_slide_ms": warm_ms, "window": SLIDING_NS_WINDOW, "slide": slide, "k": K},
    )
    return out, eng, calls[-1]


def sliding_4d(torch, np, dev="cuda"):
    """(o): the reference's sliding config through a fresh engine in
    65,536-row chunks with per-slide emission, as ``run_configs.py`` drives
    it; a slide's latency is its close (slide step and its answer), its
    routing the route wall since the close before; the stream's tuples/s
    is all rows over the stream wall. The first K slides fill the window
    and are not measured."""
    from skyline_tpu_torch.metrics.tracing import Tracer
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.stream.sliding_engine import SlidingEngine
    from skyline_tpu_torch.workload.generators import generate

    K = SLIDING_4D_WINDOW // SLIDING_4D_SLIDE
    x = generate("anti_correlated", np.random.default_rng(0), SLIDING_4D_ROWS,
                 SLIDING_4D["dims"], 0, 10000)
    ids = np.arange(SLIDING_4D_ROWS, dtype=np.int64)
    tracer = Tracer(sync_device=False)
    eng = SlidingEngine(EngineConfig(**SLIDING_4D, device=dev), window_size=SLIDING_4D_WINDOW,
                        slide=SLIDING_4D_SLIDE, emit_per_slide=True, tracer=tracer)
    answers, closes, route_marks, host = [], [], [0.0], []
    _timed_answers(eng, answers)
    orig_close = eng._close_slide

    def close(now_ms):
        route_marks.append(_route_ms(tracer))
        t0, h0 = time.perf_counter(), eng.answer_host_bytes
        try:
            return orig_close(now_ms)
        finally:
            closes.append(time.perf_counter() - t0)
            host.append(eng.answer_host_bytes - h0)

    eng._close_slide = close
    results = []
    with slide_step_probe(torch) as calls:
        dk.reset_launches()
        t0 = time.perf_counter()
        for i in range(0, SLIDING_4D_ROWS, SLIDING_CHUNK):
            eng.process_records(ids[i : i + SLIDING_CHUNK], x[i : i + SLIDING_CHUNK])
            results += eng.poll_results()
        stream_s = time.perf_counter() - t0
        launches = dict(dk.LAUNCHES)
    if len(results) != SLIDING_4D_ROWS // SLIDING_4D_SLIDE or not results[-1]["window_filled"]:
        raise AssertionError(f"(o): {len(results)} per-slide results")
    route = np.diff(route_marks)
    out = _sliding_summary(
        np, "o", closes[K:], SLIDING_4D_SLIDE, calls[K:], answers[K:], route[K:], host[K:],
        [r["skyline_size"] for r in results[K:]], eng, launches,
        {"stream_tuples_per_s": SLIDING_4D_ROWS / stream_s, "stream_s": stream_s,
         "window": SLIDING_4D_WINDOW, "slide": SLIDING_4D_SLIDE, "k": K,
         "rows": SLIDING_4D_ROWS},
    )
    log(f"main (o): {SLIDING_4D_ROWS} rows in {stream_s:.2f} s, "
        f"{out['stream_tuples_per_s']:.0f} tuples/s over the stream")
    return out, eng, calls[-1]


def profile_slide(torch, np, path: str, eng) -> dict:
    """One more slide of (n) or (o) through its engine under
    ``torch.profiler``: device time by kernel and the busy share of the
    slide's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from skyline_tpu_torch.workload.generators import anti_correlated

    slide = eng.slide
    x = anti_correlated(np.random.default_rng(1), slide, eng.config.dims, 0, 10000)
    ids = np.arange(eng.records_in, eng.records_in + slide, dtype=np.int64)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.process_records(ids, x)
        if path == "n":
            eng.process_trigger(f"{eng.records_in},0")
        eng.poll_results()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    kernels = sorted(
        ((ev.self_device_time_total / 1e3, ev.count, ev.key) for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
        reverse=True,
    )
    busy_ms = sum(k[0] for k in kernels)
    out = {"path": path, "slide_ms": dt * 1e3, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / (dt * 1e3),
           "top_kernels": [{"ms": ms, "calls": c, "name": n[:120]} for ms, c, n in kernels[:15]]}
    log(f"profile ({path}): slide {dt * 1e3:.1f} ms under the profiler, device busy "
        f"{busy_ms:.1f} ms (idle share {out['device_idle_share']:.3f})")
    for k in out["top_kernels"]:
        log(f"profile:   {k['ms']:9.2f} ms  {k['calls']:6d} calls  {k['name']}")
    return out


def sliding_k3_timings(torch, np, path: str, eng, last, per_slide: float) -> dict:
    """K3 over a partition batch at the path's two slide-step shapes,
    rebuilt from its last slide: the bucket pass (that slide's padded rows)
    and the window pass (the flat rings after it). For each: the wrapper's
    CUDA-event ms (sort, gather, one launch, scatter) and its launch's
    alone, the plain version's ms (which must agree), the bound (bytes at
    the HBM rate, or needed pairs x d at the FP32 peak), the share of
    (victim block, dominator tile) pairs ``tile_skip_plain`` skips."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    P, k, c, d = eng._rings.shape
    inputs = {
        "bucket": (last["rows"], last["rows_valid"]),
        "window": (eng._rings.reshape(P, k * c, d), eng._ring_valids.reshape(P, k * c)),
    }
    out = {}
    for label, (x, v) in inputs.items():
        x, v = x.contiguous(), v.contiguous()
        got = dk.skyline_mask_kernel(x, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = dk.skyline_mask_plain(x, v)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int((got != want).sum())
        if err:
            raise AssertionError(f"K3 batch ({path} {label}) differs from its plain version")
        ms = _event_ms(torch, lambda: dk.skyline_mask_kernel(x, v), reps=5)
        order, vs = dk._sum_sorted(x, v)
        xs_t = torch.gather(x, 1, order[..., None].expand_as(x)).transpose(1, 2).contiguous()
        launch_ms = _event_ms(torch, lambda: dk._launch("skyline_mask_kernel", xs_t, vs, xs_t),
                              reps=5)
        pairs = sum(
            _needed_pairs(torch, x[p].T.contiguous(), v[p], x[p].T.contiguous(),
                          v[p] & ~got[p], v[p])
            for p in range(P)
        )
        skip = dk.tile_skip_plain(xs_t, vs, xs_t, dk.TILE_ROWS, dk.BLOCK_VICTIMS)
        n = x.shape[1]
        bound = ((P * n * d * 4 + 2 * P * n) / HBM_BYTES_S * 1e3, pairs * d / FP32_FLOPS * 1e3)
        r = {"ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms, "max_abs_err": err,
             "bound_ms": max(bound), "bound_by": "operations" if bound[1] >= bound[0] else "bytes",
             "needed_pairs": pairs, "valid_rows": int(v.sum()),
             "skipped_share": float(skip.float().mean()) if skip.numel() else 1.0,
             "shape": {"P": P, "N": n, "d": d}, "launches_per_slide": per_slide / 2}
        log(f"timings: K3 batch ({path} {label}) {r['shape']}, {r['valid_rows']} valid rows: "
            f"{ms:.3f} ms ({launch_ms:.3f} ms the launch alone; plain {plain_ms:.1f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, {pairs} needed pairs, "
            f"{r['skipped_share']:.6f} of (block, tile) pairs skipped), "
            f"{r['launches_per_slide']:.1f} launches per slide")
        if ms < r["bound_ms"]:
            raise AssertionError(f"K3 batch ({path} {label}) reads under its bound")
        out[f"sliding_{path}_{label}"] = r
    return out


# the parity phase's legs: name -> (details key, the leg)
# -- the worker: parity on the card, over the wire (t), the crash drill (u) --------

# the worker's parity configurations at WORKER_PARITY_ROWS rows: the
# north-star lazy with device ingest, and the job CLI's default
# (incremental) policy at d = 3
WORKER_PARITY = (
    ("lazy_device_8d", dict(NORTH_STAR, ingest="device")),
    ("incremental_3d", dict(GRID_3D, ingest="auto")),
)
WORKER_PARITY_ROWS = 65536
# the crash of the parity leg (on the incremental configuration, where the
# second flush lands mid-stream) and the three plans of the reference's chaos
# grid (tests/test_resilience.py:464-469) that path (u) drives
WORKER_CRASH_PLAN = "crash@flush.pre_merge:2"
CRASH_PLANS = (
    ("crash@kafka.poll:5", 0.0),
    ("crash@wal.pre_fsync:3", 0.0),
    ("crash@checkpoint.pre_replace:2,crash@kafka.poll:9", 1e-6),
)
CRASH_ROWS = 262144
# path (t): one north-star window over the wire (README.md:127-134,
# benchmarks/e2e_transport.py), the worker's flags as a user gives them
WIRE_ROWS = 1_000_000
WIRE_SEED = 7
WIRE_WORKER_FLAGS = ["--algo", "mr-angle", "--dims", "8", "--domain", "10000",
                     "--parallelism", "4", "--buffer-size", "8192",
                     "--flush-policy", "lazy"]
# the wire path's processes' logs and CSVs (git-ignored, inside the checkout)
WORKER_RUNS = ROOT / "skyline_tpu_torch" / "_build" / "worker_runs"


class _PinnedClock:
    """The ``time`` module the worker module sees: ``time()`` a fixed
    sequence (the event stamp of each ingested batch), every other clock
    real."""

    def __init__(self):
        self.t = 1.7e9

    def time(self):
        self.t += 0.001
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@contextlib.contextmanager
def pinned_worker_clock():
    import skyline_tpu_torch.bridge.worker as wmod

    old = wmod.time
    wmod.time = _PinnedClock()
    try:
        yield
    finally:
        wmod.time = old


def _untimed_line(line: str) -> dict:
    return {k: v for k, v in json.loads(line).items()
            if not k.endswith("_ms") and k != "trace_id"}


def _worker_feed(cfg: dict, device: str, lines: list, ckpt_dir: Path, plan=None,
                 chunk: int = 8192, interval: float = 0.0):
    """``lines`` into the port's worker on ``device`` over a fresh
    ``MemoryBus`` with crash safety on (``ckpt_dir``), one trigger after the
    data; under ``plan`` the ``Supervisor`` restarts crashed incarnations.
    Returns (output lines, the WAL's records, the last worker, restarts,
    recovery wall s summed over restarts); the WAL's append and fsync ms
    and counts of the last incarnation are on the worker as ``wal_timing``."""
    import shutil

    from skyline_tpu_torch.bridge import MemoryBus, SkylineWorker
    from skyline_tpu_torch.resilience import WAL_SUBDIR, ResilienceConfig
    from skyline_tpu_torch.resilience import faults
    from skyline_tpu_torch.resilience.supervisor import Supervisor
    from skyline_tpu_torch.resilience.wal import read_records
    from skyline_tpu_torch.stream import EngineConfig

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    bus = MemoryBus()
    bus.produce_many("input-tuples", lines)
    out = bus.consumer("output-skyline")
    shared = {"sent": False, "lines": [], "recovery_s": 0.0}
    holder = {}
    res = ResilienceConfig(checkpoint_dir=str(ckpt_dir), checkpoint_interval_s=interval)
    ecfg = EngineConfig(**cfg, emit_skyline_points=True, device=device)

    def incarnation(attempt):
        t0 = time.perf_counter()
        w = SkylineWorker(bus, ecfg, resilience=res)
        if attempt:
            shared["recovery_s"] += time.perf_counter() - t0
        holder["w"] = w
        w.wal_timing = _time_wal(w._wal)
        while True:
            if w.step(max_records=chunk):
                continue
            if not shared["sent"]:
                bus.produce("queries", "q,0")
                shared["sent"] = True
                continue
            shared["lines"] += out.poll()
            if shared["lines"]:
                return shared["lines"]

    if plan:
        faults.install_plan(faults.FaultPlan.parse(plan))
    sup = Supervisor(incarnation, max_restarts=8, backoff_base_s=0.0, backoff_cap_s=0.0,
                     sleep=lambda s: None)
    try:
        got = sup.run()
    finally:
        faults.clear()
        if holder.get("w") is not None:
            holder["w"].close()
    records, torn = read_records(str(ckpt_dir / WAL_SUBDIR))
    if torn and not plan:
        raise AssertionError(f"worker on {device}: {torn} torn WAL segment(s) without a crash")
    return got, records, holder["w"], sup.restarts, shared["recovery_s"]


def _time_wal(wal) -> dict:
    """Host ms and counts of ``wal``'s appends and fsyncs from now on (the
    writer's own methods, wrapped on this instance)."""
    acc = {"append_ms": 0.0, "appends": 0, "fsync_ms": 0.0, "fsyncs": 0}

    def timed(name, key):
        fn = getattr(wal, name)

        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key + "_ms"] += (time.perf_counter() - t0) * 1e3
                acc[key + "s"] += 1

        setattr(wal, name, run)

    timed("append", "append")
    timed("_fsync", "fsync")
    return acc


def check_worker_parity(torch, np, devices=("cuda", "cpu")) -> dict:
    """The port's worker on the card against the CPU: each ``WORKER_PARITY``
    configuration at ``WORKER_PARITY_ROWS`` rows (8-D lazy with device
    ingest; the CLI's default incremental policy at d = 3) fed the same
    lines over its own ``MemoryBus``, crash safety on, the event clock
    pinned, ``SKYLINE_MIXED_PRECISION=1`` on both: every output-topic line
    equals the CPU's with the timing fields aside (point bytes and order
    included) where the card routes every row as the CPU does, else the
    sizes and sorted point bytes; the WAL records equal the CPU's (batch
    spans and their digests, commits). Then, on the card, the incremental
    configuration under ``WORKER_CRASH_PLAN``: the supervised worker's
    answer equals its uninterrupted one, bytes and order."""
    from skyline_tpu_torch.parallel.partitioners import partition_ids
    from skyline_tpu_torch.workload.generators import anti_correlated

    rng = np.random.default_rng(71)
    out = {}
    WORKER_RUNS.mkdir(parents=True, exist_ok=True)
    with rank_gate(False), knob_env(OBS_ENV), pinned_worker_clock():
        for name, cfg in WORKER_PARITY:
            x = anti_correlated(rng, WORKER_PARITY_ROWS, cfg["dims"], 0, 10000)
            lines = [f"{i}," + ",".join(str(int(v)) for v in row) for i, row in enumerate(x)]
            xt = torch.from_numpy(x)
            args = (cfg["algo"], 2 * cfg["parallelism"], cfg["domain_max"])
            strict = torch.equal(partition_ids(xt.to(devices[0]), *args).cpu(),
                                 partition_ids(xt, *args))
            runs = {}
            for label, device in (("card", devices[0]), ("cpu", devices[1])):
                t0 = time.perf_counter()
                got, recs, w, _, _ = _worker_feed(cfg, device, lines,
                                                  WORKER_RUNS / f"parity_{name}_{label}")
                runs[label] = (got, recs, w, time.perf_counter() - t0)
            (a, recs, w, wall), (b, crecs, cw, cwall) = runs["card"], runs["cpu"]
            if len(a) != 1 or len(b) != 1:
                raise AssertionError(f"worker {name}: {len(a)} vs {len(b)} results")
            if w.engine.records_in != WORKER_PARITY_ROWS or cw.engine.records_in != WORKER_PARITY_ROWS:
                raise AssertionError(f"worker {name}: records_in {w.engine.records_in}, "
                                     f"{cw.engine.records_in}")
            ua, ub = _untimed_line(a[0]), _untimed_line(b[0])
            if strict and ua != ub:
                raise AssertionError(f"worker {name}: the card's line differs from the CPU's "
                                     f"in {[k for k in ua if ua[k] != ub.get(k)]}")
            pa, pb = _points(ua), _points(ub)
            if not strict and (ua["skyline_size"] != ub["skyline_size"]
                               or _sorted_bytes(pa) != _sorted_bytes(pb)):
                raise AssertionError(f"worker {name}: another point set on the card")
            # no record of a flat worker without the serving plane carries a
            # wall clock (start, batch, commit): all of it compares
            if recs != crecs:
                raise AssertionError(f"worker {name}: WAL records differ from the CPU's")
            out[name] = {"rows": WORKER_PARITY_ROWS, "strict": bool(strict),
                         "skyline_size": ua["skyline_size"], "wal_records": len(recs),
                         "wal_batches": sum(r["type"] == "batch" for r in recs),
                         "card_s": wall, "cpu_s": cwall, "arrays_plane": w._arrays_plane}
            log(f"parity: worker {name}, {WORKER_PARITY_ROWS} rows over a MemoryBus: skyline "
                f"{ua['skyline_size']}, card == cpu "
                f"({'output line, point bytes and order' if strict else 'size and sorted points'}"
                f"), WAL records equal ({len(recs)}: {out[name]['wal_batches']} batch spans); "
                f"card {wall:.1f} s, cpu {cwall:.1f} s")
        name, cfg = WORKER_PARITY[1]
        x = anti_correlated(rng, WORKER_PARITY_ROWS, cfg["dims"], 0, 10000)
        lines = [f"{i}," + ",".join(str(int(v)) for v in row) for i, row in enumerate(x)]
        base, _, _, _, _ = _worker_feed(cfg, devices[0], lines, WORKER_RUNS / "crash_base")
        got, _, w, restarts, rec_s = _worker_feed(cfg, devices[0], lines,
                                                  WORKER_RUNS / "crash", plan=WORKER_CRASH_PLAN)
        if restarts < 1 or w.engine.records_in != WORKER_PARITY_ROWS:
            raise AssertionError(f"worker crash: {restarts} restarts, records_in "
                                 f"{w.engine.records_in}")
        ua, ub = _untimed_line(got[-1]), _untimed_line(base[-1])
        if ua != ub:
            raise AssertionError("worker crash: the recovered answer differs from the "
                                 "uninterrupted one")
        out["crash"] = {"plan": WORKER_CRASH_PLAN, "config": name, "restarts": restarts,
                        "recovery_s": rec_s, "skyline_size": ua["skyline_size"]}
        log(f"parity: worker crash drill on the card ({name}, {WORKER_CRASH_PLAN}): "
            f"{restarts} restart(s), recovery {rec_s * 1e3:.1f} ms, the recovered answer "
            f"equals the uninterrupted one (skyline {ua['skyline_size']}, bytes and order)")
    return out


def _spawn(args: list, log_path: Path, **kw):
    """A ``python -m`` process of the port from the checkout's root, its
    output to ``log_path``."""
    env = {k: v for k, v in os.environ.items() if k != "SKYLINE_FAULT_PLAN"}
    f = open(log_path, "w")
    try:
        return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                                stdout=f, stderr=subprocess.STDOUT, **kw)
    finally:
        f.close()


def _wait_line(proc, log_path: Path, needle: str, timeout_s: float = 60.0) -> str:
    """The first line of ``log_path`` that holds ``needle``; fails when the
    process ends or ``timeout_s`` passes first."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for line in log_path.read_text().splitlines():
            if needle in line:
                return line
        if proc.poll() is not None:
            raise AssertionError(f"{log_path.name}: exited {proc.returncode} before "
                                 f"{needle!r}:\n{log_path.read_text()[-2000:]}")
        time.sleep(0.02)
    raise AssertionError(f"{log_path.name}: no {needle!r} in {timeout_s} s")


def _stop(*procs) -> None:
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait(timeout=30)


def _wire_rows(np, n: int, seed: int, batch: int = 8192):
    """The rows the producer CLI sends for ``--count n --seed seed``: its
    generator in its batches, as the integers it prints."""
    from skyline_tpu_torch.workload.generators import generate

    rng = np.random.default_rng(seed)
    parts = [generate("anti_correlated", rng, min(batch, n - s), 8, 0.0, 10000.0)
             for s in range(0, n, batch)]
    return np.concatenate(parts).astype(np.int64).astype(np.float32)


def wire_path(torch, np, windows: int, profile: bool = False, n: int = WIRE_ROWS,
              dev: str = "cuda") -> dict:
    """Path (t): the worker over the wire at full size. A kafkalite broker
    (the port's broker CLI, 127.0.0.1, port 0); per window fresh topics, the
    collector CLI (``--count 1``) listening on the output topic, the
    worker built from ``WIRE_WORKER_FLAGS`` by the port's ``parse_job_args``
    and ``build_worker`` (as ``python -m skyline_tpu_torch.bridge.worker``
    builds it), stepped here as ``run_forever`` steps it, and the producer
    CLI sending one ``n``-row 8-D anti-correlated window (``--seed``,
    ``--query-threshold 0 --final-trigger``). One warm window, then
    ``windows`` measured. Each window's wall runs from the producer's start
    to the collector's exit with the row; the worker's phase ms come from
    its tracer. The answer's rows are read from a snapshot store attached to
    the worker's engine (``--emit-skyline-points`` would put ~19 MB of JSON
    on the output topic, past the 10 MB request cap the reference's sink
    keeps, FlinkSkyline.java:177-183; the store's copy and the points' trip
    to the host cost a few tens of ms, its audit sample is 0) and held, as a sorted set, against the engine alone on the card over
    the same rows in 65,536-row chunks, and checked by samples. The path
    fails unless the worker latched the native arrays plane and launched K1
    mp, K2 mp and the pre-drop."""
    import csv as csvmod

    from skyline_tpu_torch.bridge.worker import build_worker
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.serve import SnapshotStore
    from skyline_tpu_torch.utils.config import parse_job_args

    csvmod.field_size_limit(1 << 30)
    WORKER_RUNS.mkdir(parents=True, exist_ok=True)
    broker = None
    rows = []
    prof_out = None
    try:
        broker_log = WORKER_RUNS / "broker.log"
        broker = _spawn(["skyline_tpu_torch.bridge.kafkalite.broker", "--host", "127.0.0.1",
                         "--port", "0"], broker_log)
        addr = _wait_line(broker, broker_log, "listening on").rsplit(" ", 1)[1]
        dk.reset_launches()
        for win in range(windows + 1):
            topics = [f"in-{win}", f"q-{win}", f"out-{win}"]
            csv_path = WORKER_RUNS / f"wire_{win}.csv"
            csv_path.unlink(missing_ok=True)
            col_log, prod_log = WORKER_RUNS / f"collector_{win}.log", WORKER_RUNS / f"producer_{win}.log"
            collector = producer = None
            try:
                collector = _spawn(["skyline_tpu_torch.metrics.collector", str(csv_path),
                                    "--topic", topics[2], "--bootstrap", addr, "--count", "1"],
                                   col_log)
                _wait_line(collector, col_log, "Listening on topic")
                cfg = parse_job_args(WIRE_WORKER_FLAGS + [
                    "--device", dev, "--bootstrap", addr, "--input-topic", topics[0], "--query-topic", topics[1],
                    "--output-topic", topics[2]])
                # the audit sample 0: a worker without --serve has no store,
                # so no organic check; the store here only reads the answer
                with knob_env({"SKYLINE_AUDIT_SAMPLE": "0"}):
                    w = build_worker(cfg)
                store = SnapshotStore()
                w.engine.attach_snapshots(store)
                measured_profile = profile and win == windows
                stack = contextlib.ExitStack()
                if measured_profile:
                    from torch.profiler import ProfilerActivity
                    from torch.profiler import profile as tprofile

                    prof = stack.enter_context(tprofile(
                        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
                with stack:
                    t0 = time.perf_counter()
                    producer = _spawn(["skyline_tpu_torch.workload.producer", topics[0],
                                       "anti_correlated", "8", "0", "10000", topics[1],
                                       "--count", str(n), "--seed", str(WIRE_SEED),
                                       "--query-threshold", "0", "--final-trigger",
                                       "--bootstrap", addr], prod_log)
                    t_first = t_prod = None
                    deadline = time.monotonic() + 600
                    while collector.poll() is None:
                        if time.monotonic() > deadline:
                            raise AssertionError("wire path: no result row in 600 s")
                        w.step()
                        now = time.perf_counter()
                        if t_first is None and w._data_pos:
                            t_first = now
                        if t_prod is None and producer.poll() is not None:
                            t_prod = now
                            if producer.returncode:
                                raise AssertionError(f"producer exited {producer.returncode}:"
                                                     f"\n{prod_log.read_text()[-2000:]}")
                    t_end = time.perf_counter()
                    if dev == "cuda":
                        torch.cuda.synchronize()
                if collector.returncode:
                    raise AssertionError(f"collector exited {collector.returncode}")
                producer.wait(timeout=60)
                t_prod = t_prod if t_prod is not None else t_end
                with open(csv_path, newline="") as f:
                    header, row = list(csvmod.reader(f))[:2]
                doc = dict(zip(header, row))
                snap = store.latest()
                phases = {k: v["total_ms"] for k, v in w.tracer.report().items()}
                rec = {
                    "window": "warm" if win == 0 else win - 1,
                    "wall_ms": (t_end - t0) * 1e3,
                    "first_data_ms": (t_first - t0) * 1e3 if t_first else None,
                    "producer_ms": (t_prod - t0) * 1e3,
                    "total_processing_time_ms": float(doc["TotalTime(ms)"]),
                    "skyline_size": int(doc["SkylineSize"]),
                    "records_in": w.engine.records_in, "dropped": w.engine.dropped,
                    "arrays_plane": w._arrays_plane,
                    "phase_ms": {k: phases.get(k, 0.0) for k in
                                 ("worker/poll", "worker/parse", "worker/ingest", "worker/query")},
                    "engine_phase_ms": {k: v for k, v in phases.items()
                                        if not k.startswith("worker/")},
                }
                rec["tuples_per_s"] = n / (rec["wall_ms"] / 1e3)
                if measured_profile:
                    rec["profile"] = _profile_busy(prof, rec["wall_ms"])
                    prof_out = rec["profile"]
                rows.append(rec)
                log(f"main (t): window {rec['window']}: wall {rec['wall_ms']:.1f} ms (producer "
                    f"start to the collector's row; first data polled at "
                    f"{rec['first_data_ms']:.1f} ms, producer done at {rec['producer_ms']:.1f} ms), "
                    f"{rec['tuples_per_s']:.0f} tuples/s, result TotalTime "
                    f"{rec['total_processing_time_ms']:.1f} ms, skyline {rec['skyline_size']}, "
                    f"worker phases {({k: round(v, 1) for k, v in rec['phase_ms'].items()})}"
                    + (f", device busy {prof_out['device_busy_ms']:.1f} ms (idle share "
                       f"{prof_out['device_idle_share']:.3f})" if measured_profile else ""))
                if not w._arrays_plane:
                    raise AssertionError("wire path: the worker did not latch the native "
                                         "arrays plane")
                if w.engine.records_in != n or snap is None or snap.size != rec["skyline_size"]:
                    raise AssertionError(f"wire path: records_in {w.engine.records_in}, "
                                         f"published {snap and snap.size}, row {doc['SkylineSize']}")
                last_points = np.asarray(snap.points, np.float32)
                w.close()
            finally:
                _stop(producer, collector)
        launches = dict(dk.LAUNCHES)
    finally:
        _stop(broker)
    wanted = ("dominated_by_any_mp", "dominated_by_rect_mp", PREDROP_FUSED)
    missing = [k for k in wanted if launches[k] == 0]
    if missing:
        raise AssertionError(f"wire path launched no {missing}: {launches}")
    # the same rows through the engine alone on the card
    from skyline_tpu_torch.stream import SkylineEngine

    x = _wire_rows(np, n, WIRE_SEED)
    eng = SkylineEngine(parse_job_args(
        WIRE_WORKER_FLAGS + ["--emit-skyline-points", "--device", dev]).engine_config())
    ids = np.arange(n, dtype=np.int64)
    for s in range(0, n, 65536):
        eng.process_records(ids[s : s + 65536], x[s : s + 65536])
    eng.process_trigger("0,0")
    (res,) = eng.poll_results()
    want = _points(res)
    if want.shape != last_points.shape or _sorted_bytes(want) != _sorted_bytes(last_points):
        raise AssertionError(f"wire path: the answer ({last_points.shape}) is not the engine's "
                             f"on the same rows ({want.shape})")
    check_answer(torch, np, x, last_points, dev)
    meas = rows[1:]
    summary = {
        "rows_per_window": n, "windows_measured": windows, "windows": rows,
        "p50_wall_ms": float(np.median([r["wall_ms"] for r in meas])),
        "tuples_per_s": n * len(meas) / (sum(r["wall_ms"] for r in meas) / 1e3),
        "p50_total_processing_time_ms": float(np.median(
            [r["total_processing_time_ms"] for r in meas])),
        "p50_phase_ms": {k: float(np.median([r["phase_ms"][k] for r in meas]))
                         for k in meas[0]["phase_ms"]},
        "launches": launches, "arrays_plane": True, "profile": prof_out,
        "engine_only_skyline": int(want.shape[0]),
    }
    log(f"main (t): {summary['tuples_per_s']:.0f} tuples/s over {windows} windows of {n} rows "
        f"(p50 wall {summary['p50_wall_ms']:.1f} ms, p50 TotalTime "
        f"{summary['p50_total_processing_time_ms']:.1f} ms, p50 phases "
        f"{({k: round(v, 1) for k, v in summary['p50_phase_ms'].items()})}); arrays plane "
        f"latched; the answer equals the engine alone on the same rows "
        f"({want.shape[0]} rows, sorted set) and passes the sampled checks; launches over "
        f"{windows + 1} windows: { {k: launches[k] for k in wanted} }")
    return summary


def _profile_busy(prof, wall_ms: float) -> dict:
    from torch.autograd import DeviceType

    kernels = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    busy = sum(k[0] for k in kernels)
    by_kernel: dict = {}
    for ms, c, name in kernels:
        slot = by_kernel.setdefault(_short_kernel(name), [0.0, 0])
        slot[0] += ms
        slot[1] += c
    return {"device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms,
            "by_kernel": {k: {"ms": v[0], "calls": v[1]} for k, v in
                          sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]}}


def crash_path(torch, np, n: int = CRASH_ROWS, dev: str = "cuda", chunk: int = 65536) -> dict:
    """Path (u): the crash drill on the card. The north-star lazy
    configuration (device ingest) at ``n`` rows over a ``MemoryBus``, the
    port's worker restarted by the ``Supervisor`` under each of
    ``CRASH_PLANS`` (periodic checkpoints with the last): each run must
    restart at least once, ingest every row exactly once, recover through
    the WAL replay (or a checkpoint restore) and give the uninterrupted
    run's answer, bytes and order. Prints each plan's recovery wall (the
    restarted incarnations' construction: restore and replay)."""
    from skyline_tpu_torch.workload.generators import anti_correlated

    cfg = dict(NORTH_STAR, ingest="device")
    x = anti_correlated(np.random.default_rng(73), n, 8, 0, 10000)
    lines = [f"{i}," + ",".join(str(int(v)) for v in row) for i, row in enumerate(x)]
    WORKER_RUNS.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    base, _, w, _, _ = _worker_feed(cfg, dev, lines, WORKER_RUNS / "drill_base",
                                    chunk=chunk)
    base_s = time.perf_counter() - t0
    want = _untimed_line(base[-1])
    check_answer(torch, np, x, _points(want), dev)
    out = {"rows": n, "uninterrupted_s": base_s, "skyline_size": want["skyline_size"],
           "wal": w.wal_timing, "plans": {}}
    log(f"main (u): uninterrupted {base_s * 1e3:.1f} ms, skyline {want['skyline_size']}; "
        f"WAL (fsync per step): {w.wal_timing['appends']} appends in "
        f"{w.wal_timing['append_ms']:.2f} ms, {w.wal_timing['fsyncs']} fsyncs in "
        f"{w.wal_timing['fsync_ms']:.2f} ms")
    for plan, interval in CRASH_PLANS:
        t0 = time.perf_counter()
        got, recs, w, restarts, rec_s = _worker_feed(
            cfg, dev, lines, WORKER_RUNS / "drill", plan=plan, chunk=chunk,
            interval=interval)
        wall = time.perf_counter() - t0
        counters = w.telemetry.counters.snapshot()
        rec = w._recovered or {}
        replayed = rec.get("replayed_batches", 0)
        restored = rec.get("checkpoint") is not None
        ok = (restarts >= 1 and w.engine.records_in == n
              and (replayed >= 1 or (interval and restored))
              and _untimed_line(got[-1]) == want)
        out["plans"][plan] = {"restarts": restarts, "recovery_ms": rec_s * 1e3,
                              "run_s": wall, "replayed_batches": replayed,
                              "checkpoint_restored": restored, "counters": counters}
        log(f"main (u): {plan}: {restarts} restart(s), recovery wall {rec_s * 1e3:.1f} ms "
            f"(run {wall:.1f} s, uninterrupted {base_s:.1f} s), replayed {replayed} WAL "
            f"batch(es), checkpoint restored {restored}, records_in {w.engine.records_in}; "
            f"the answer {'equals' if ok else 'DIFFERS FROM'} the uninterrupted run's "
            f"(skyline {want['skyline_size']}, bytes and order)")
        if not ok:
            raise AssertionError(f"crash drill {plan}: {out['plans'][plan]}")
    return out


def compare_wire(wire: dict, b: dict) -> None:
    """(t)'s window beside (b)'s, both measured in this call: the same
    north-star shapes, (b) fed in process, (t) over the wire."""
    ratio = wire["p50_wall_ms"] / b["p50_window_ms"]
    wire["beside_b"] = {"b_p50_window_ms": b["p50_window_ms"],
                        "b_tuples_per_s": b["tuples_per_s"], "wall_over_b": ratio}
    log(f"main (t) beside (b): p50 wall {wire['p50_wall_ms']:.1f} ms vs p50 window "
        f"{b['p50_window_ms']:.1f} ms ({ratio:.1f}x), {wire['tuples_per_s']:.0f} vs "
        f"{b['tuples_per_s']:.0f} tuples/s")


# -- the sharded engine (distributed/sharded.py) --------------------------------------


def check_one_device(torch, dev) -> int:
    """Every compare and pre-drop entry raises ``ValueError``, naming
    itself, when an operand lies on another device than the rest — a
    second card when one is visible, else the CPU — before any launch."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    other = "cuda:1" if torch.cuda.device_count() > 1 else (
        "cpu" if str(dev).startswith("cuda") else "meta")
    x3 = torch.zeros((1, 3, 64), device=dev)
    ok = torch.ones((1, 64), dtype=torch.bool, device=dev)
    y3 = torch.zeros((1, 64, 3), device=dev)
    w = torch.zeros((1,), dtype=torch.int32, device=dev)
    cases = [
        ("dominated_by_rect", lambda: dk._launch("dominated_by_rect", x3, ok, x3.to(other))),
        ("dominated_by_any", lambda: dk._launch("dominated_by_any", x3, ok.to(other), x3)),
        ("strictly_dominated_bf16_kernel",
         lambda: dk._predrop_call(y3, None, y3.to(other), ok, fused=False)),
        ("mp_predrop_kernel", lambda: dk._predrop_call(y3, ok, y3, ok.to(other), fused=True)),
        ("cascade_windows", lambda: dk.cascade_windows(y3[0], 64, w.to(other))),
        ("cascade_scan", lambda: dk.cascade_scan(y3[0], ok[0].to(other), 64)),
    ]
    before = dict(dk.LAUNCHES)
    for name, call in cases:
        try:
            call()
        except ValueError as e:
            if name not in str(e) or "different devices" not in str(e):
                raise AssertionError(f"{name}: the device check says {e}") from e
        else:
            raise AssertionError(f"{name} launched with an operand on {other}")
    if dict(dk.LAUNCHES) != before:
        raise AssertionError("a refused launch was counted")
    log(f"kernels: {len(cases)} entries refuse operands on {other} beside {dev}, each naming "
        "itself")
    return len(cases)


# the sharded parity legs: (name, engine configuration, generator); P = 8
# (parallelism 4), two windows of SHARDED_PARITY_ROWS through one engine, the
# lazy flush pinned to the SFS rounds. The lazy leg runs uniform rows: the
# north-star generator's 8-D window is ~44% all-zero rows, whose skyline
# costs the CPU side minutes.
SHARDED_PARITY = (
    ("lazy d=8", dict(NORTH_STAR, ingest="host"), "uniform"),
    ("incremental d=3", dict(GRID_3D, ingest="host"), "anti_correlated"),
)
SHARDED_CHIPS = (1, 2, 4, 8)
# the chip count the CPU side runs (answers do not depend on the chip count;
# sharded_stats() and the prune counts are compared at this one)
SHARDED_CPU_CHIPS = 4
SHARDED_PARITY_ROWS = 65536
# benchmarks/failover.py's drill: 20,000 4-D anti-correlated rows, 2 chips
FAILOVER_PLAN = "slow@sharded.chip_merge#1:1"
FAILOVER_ROWS = 20000


def _sharded_stats(eng) -> dict:
    doc = untimed(eng.stats()["sharded"])
    doc.pop("devices")
    return doc


def _drive_sharded(cfg, windows, chips, chunk=8192):
    """Windows back to back through one engine (sharded over ``chips``, or
    the flat engine when None), a trigger after each: (results, the
    ``sharded`` block or None, engine)."""
    import numpy as np

    from skyline_tpu_torch.distributed import ShardedEngine
    from skyline_tpu_torch.stream import SkylineEngine

    eng = SkylineEngine(cfg) if chips is None else ShardedEngine(cfg, chips=chips)
    out, base = [], 0
    for i, x in enumerate(windows):
        ids = np.arange(base, base + x.shape[0], dtype=np.int64)
        base += x.shape[0]
        for s in range(0, x.shape[0], chunk):
            eng.process_records(ids[s : s + chunk], x[s : s + chunk])
        eng.process_trigger(f"q{i},0")
        out += eng.poll_results()
    return out, (None if chips is None else _sharded_stats(eng)), eng


def _spread(torch, eng, chips: int) -> str:
    """The chips' devices: spread round-robin over the visible cards, and
    whether a surviving chip root crossed to chip 0's card."""
    n = torch.cuda.device_count()
    devs = [str(d) for d in eng.pset.devices]
    want = [f"cuda:{c % n}" for c in range(chips)] if n else ["cpu"] * chips
    if devs != want:
        raise AssertionError(f"{chips} chips placed on {devs}, not {want}")
    last = eng.pset.last_chip_info or {}
    crossed = [c for c in last.get("survivors", []) if devs[c] != devs[0]]
    return f"devices {devs}, survivors {last.get('survivors')}, cross-card roots {crossed}"


def check_sharded_parity(torch, np, devices=("cuda", "cpu")) -> dict:
    """The sharded engine on the card at every chip count of
    ``SHARDED_CHIPS`` against the flat engine on the card (results: point
    bytes and order, sizes, counts) and, at ``SHARDED_CPU_CHIPS``, against
    itself on the CPU (results and ``sharded_stats()`` with the chip prune's
    counts, timings and device names aside), strict; then the failover
    drill (``failover_drill``)."""
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.workload import generators

    card, cpu = devices
    n_cards = torch.cuda.device_count()
    log(f"sharded: torch.cuda.device_count() = {n_cards}")
    if n_cards == 1:
        log("sharded: one card visible: every chip group shares cuda:0 and no cross-card "
            "copy is exercised")
    else:
        check_one_device(torch, card)  # an operand on cuda:1 beside cuda:0
    out = {"cards": n_cards, "legs": {}}
    t_leg = time.perf_counter()
    with knob_env(ROUNDS_ONLY):
        for name, cfg, gen in SHARDED_PARITY:
            rng = np.random.default_rng(17)
            windows = [getattr(generators, gen)(rng, SHARDED_PARITY_ROWS, cfg["dims"], 0, 10000)
                       for _ in range(2)]
            ecfg = {dev: EngineConfig(**cfg, window_capacity=SHARDED_PARITY_ROWS, device=dev)
                    for dev in devices}
            t0 = time.perf_counter()
            flat, _, _ = _drive_sharded(ecfg[card], windows, None)
            want = [untimed(r) for r in flat]
            got = {}
            for chips in SHARDED_CHIPS:
                res, stats, eng = _drive_sharded(ecfg[card], windows, chips)
                if [untimed(r) for r in res] != want:
                    raise AssertionError(f"sharded {name}: {chips} chips on the card differ "
                                         "from the flat engine on the card")
                got[chips] = stats
                log(f"sharded {name}: {chips} chips = the flat engine, bytes and order; "
                    f"{stats['merges']} merges, {stats['chips_pruned']} of "
                    f"{stats['chips_considered']} chips pruned; {_spread(torch, eng, chips)}")
            t1 = time.perf_counter()
            res, stats, _ = _drive_sharded(ecfg[cpu], windows, SHARDED_CPU_CHIPS)
            if [untimed(r) for r in res] != want:
                raise AssertionError(f"sharded {name}: the CPU's answers differ from the card's")
            if stats != got[SHARDED_CPU_CHIPS]:
                raise AssertionError(f"sharded {name}: sharded_stats() on the CPU "
                                     f"{stats} != the card's {got[SHARDED_CPU_CHIPS]}")
            cpu_s = time.perf_counter() - t1
            out["legs"][name] = {
                "rows_per_window": SHARDED_PARITY_ROWS, "windows": 2,
                "skyline_sizes": [r["skyline_size"] for r in flat],
                "chips": {c: {"chips_pruned": s["chips_pruned"],
                              "chips_considered": s["chips_considered"],
                              "merges": s["merges"], "last": s["last"]}
                          for c, s in got.items()},
                "card_s": t1 - t0, "cpu_s": cpu_s,
            }
            log(f"sharded {name}: {SHARDED_CPU_CHIPS} chips on the CPU = the card, answers and "
                f"sharded_stats(); card {t1 - t0:.1f} s, CPU side {cpu_s:.1f} s")
    out["failover"] = failover_drill(torch, np, card)
    out["worker"] = sharded_worker(torch, np, card)
    log(f"sharded: parity leg done in {time.perf_counter() - t_leg:.1f} s")
    return out


SHARDED_WORKER_ROWS = 65536
SHARDED_WORKER_TAIL = 16384


def sharded_worker(torch, np, dev) -> dict:
    """The worker with ``mesh_chips=4`` (``--mesh-chips 4``) on the card
    over a ``MemoryBus``, crash safety on, (d)'s configuration: its answer
    equals the flat worker's (bytes and order, timings aside); its chip
    journals verify; a checkpoint taken then restores onto the flat engine
    and onto 2 chips, and each gives the sharded worker's next answer over
    a tail of rows, bytes and order; a restarted worker restores it."""
    import shutil

    from skyline_tpu_torch.bridge import MemoryBus, SkylineWorker
    from skyline_tpu_torch.bridge.wire import format_tuple_line
    from skyline_tpu_torch.resilience import WAL_SUBDIR, ResilienceConfig
    from skyline_tpu_torch.resilience.chip_wal import verify_chip_barriers
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.utils.checkpoint import load_engine
    from skyline_tpu_torch.workload.generators import anti_correlated

    n, tail = SHARDED_WORKER_ROWS, SHARDED_WORKER_TAIL
    rows = anti_correlated(np.random.default_rng(5), n + tail, 3, 0, 10000)
    lines = [format_tuple_line(i, r) for i, r in enumerate(rows)]
    ecfg = EngineConfig(**dict(GRID_3D, ingest="host"), emit_skyline_points=True, device=dev)

    def run(chips, ckpt):
        shutil.rmtree(ckpt, ignore_errors=True)
        bus = MemoryBus()
        out = bus.consumer("output-skyline")
        w = SkylineWorker(bus, ecfg, mesh_chips=chips, resilience=ResilienceConfig(
            checkpoint_dir=str(ckpt), checkpoint_interval_s=0.0))
        got = []
        for lo, hi, q in ((0, n, "q,0"), (n, n + tail, "r,0")):
            bus.produce_many("input-tuples", lines[lo:hi])
            while w.step(max_records=8192):
                pass
            bus.produce("queries", q)
            while not (polled := out.poll()):
                w.step(max_records=8192)
            got += polled
            if q == "q,0":
                path = w.checkpoint_now()
        return got, w, path, bus

    ckpt = WORKER_RUNS / "sharded"
    t0 = time.perf_counter()
    got, w, path, bus = run(4, ckpt)
    flat, fw, _, _ = run(0, WORKER_RUNS / "sharded_flat")
    fw.close()
    if [_untimed_line(x) for x in got] != [_untimed_line(x) for x in flat]:
        raise AssertionError("sharded worker: its answers differ from the flat worker's")
    verdict = verify_chip_barriers(str(ckpt / WAL_SUBDIR), 4)
    if not verdict["agree"] or verdict["common_seq"] is None:
        raise AssertionError(f"sharded worker: chip journals {verdict}")
    devices = w.engine.stats()["sharded"]["devices"]
    w.close()
    want = json.loads(got[-1])["skyline_points"]
    ids = np.arange(n, n + tail, dtype=np.int64)
    for chips in (0, 2):
        eng = load_engine(path, mesh_chips=chips, device=dev)
        for i in range(0, tail, 8192):
            eng.process_records(ids[i : i + 8192], rows[n + i : n + i + 8192])
        eng.process_trigger("r,0")
        (res,) = eng.poll_results()
        if res["skyline_points"] != want:
            raise AssertionError(f"sharded worker: its checkpoint restored onto {chips or 'no'} "
                                 "chips gives another next answer")
    again = SkylineWorker(bus, ecfg, mesh_chips=4, resilience=ResilienceConfig(
        checkpoint_dir=str(ckpt), checkpoint_interval_s=0.0))
    restored = again._recovered
    again.close()
    if not restored or not restored.get("checkpoint"):
        raise AssertionError(f"sharded worker: a restart restored {restored}")
    out = {"rows": n, "tail": tail, "chips": 4, "devices": devices, "chip_barriers": verdict,
           "answers": [json.loads(x)["skyline_size"] for x in got],
           "wall_s": time.perf_counter() - t0}
    log(f"sharded: worker with --mesh-chips 4 on {devices}: answers {out['answers']} = the flat "
        f"worker's; chip journals {verdict}; its checkpoint restored flat and on 2 chips gives "
        f"its next answer, bytes and order; a restart restored {restored['checkpoint']}; "
        f"{out['wall_s']:.1f} s")
    return out


def failover_drill(torch, np, dev) -> dict:
    """``benchmarks/failover.py``'s drill on the card: a 2-chip engine with
    a hub, ``slow@sharded.chip_merge#1:1`` under a 500 ms deadline. The
    degraded answer arrives marked within 2 s (chip 1 excluded, a
    completeness bound), chip 1 quarantines, the next trigger fails its
    group over, and the first post-heal answer is the healthy run's, bytes
    and order. ``time_to_healed_ms`` is the failover's own wall."""
    import threading

    from skyline_tpu_torch.distributed import ShardedEngine
    from skyline_tpu_torch.resilience.faults import FaultPlan, clear, install_plan
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.telemetry import Telemetry
    from skyline_tpu_torch.workload.generators import anti_correlated

    d, n = 4, FAILOVER_ROWS
    rows = anti_correlated(np.random.default_rng(0), n, d, 0, 10000)
    cfg = EngineConfig(parallelism=2, dims=d, domain_max=10000.0, buffer_size=4096,
                       emit_skyline_points=True, device=dev)

    def answer(eng, trigger):
        eng.process_trigger(trigger)
        (r,) = eng.poll_results()
        return r, np.asarray(r["skyline_points"], np.float32).tobytes()

    def fed():
        eng = ShardedEngine(cfg, chips=2, telemetry=Telemetry())
        ids = np.arange(n, dtype=np.int64)
        for i in range(0, n, 1024):
            eng.process_records(ids[i : i + 1024], rows[i : i + 1024])
        return eng

    _, truth = answer(fed(), "truth,0")
    eng = fed()
    _, warm = answer(eng, "warm,0")
    if warm != truth:
        raise AssertionError("failover drill: the warm answer is not the healthy run's")
    env = {"SKYLINE_CHIP_MERGE_DEADLINE_MS": "500", "SKYLINE_CHIP_MERGE_RETRIES": "0",
           "SKYLINE_FAULT_SLOW_MS": "2000"}
    with knob_env(env):
        install_plan(FaultPlan.parse(FAILOVER_PLAN))
        eng.pset._gm_cache = None  # same epoch: force the level-1 rerun
        t_fault = time.perf_counter()
        degraded, _ = answer(eng, "fault,0")
        t_degraded = time.perf_counter()
        clear()
    for t in threading.enumerate():  # drain the abandoned slow attempt
        if t.name.startswith("chip1-merge"):
            t.join(timeout=30)
    wall_ms = (t_degraded - t_fault) * 1e3
    if degraded.get("partial") is not True or degraded.get("excluded_chips") != [1]:
        raise AssertionError(f"failover drill: the answer is not marked degraded: {degraded}")
    if eng.health.quarantined() != [1]:
        raise AssertionError(f"failover drill: quarantined {eng.health.quarantined()}")
    if wall_ms >= 2000.0:
        raise AssertionError(f"failover drill: the degraded answer took {wall_ms:.0f} ms")
    eng.pset._gm_cache = None
    healed, healed_bytes = answer(eng, "healed,0")  # the launch fails chip 1 over
    t_healed = time.perf_counter()
    lf = eng.pset.last_failover
    if "partial" in healed or eng.pset.failovers != 1 or healed_bytes != truth:
        raise AssertionError(f"failover drill: post-heal {healed.get('partial')}, "
                             f"{eng.pset.failovers} failovers, same bytes {healed_bytes == truth}")
    out = {
        "fault": FAILOVER_PLAN, "deadline_ms": 500.0, "rows": n, "d": d, "chips": 2,
        "degraded_answer_wall_ms": wall_ms, "completeness_bound": degraded["completeness_bound"],
        "time_to_healed_ms": float(lf["wall_ms"]), "failover_owner": int(lf["owner"]),
        "degraded_window_ms": (t_healed - t_degraded) * 1e3,
        "devices": [str(x) for x in eng.pset.devices],
    }
    log(f"sharded: failover drill ({FAILOVER_PLAN}, 500 ms deadline): degraded answer in "
        f"{wall_ms:.1f} ms excluding chip 1 (bound {degraded['completeness_bound']}), "
        f"quarantined, failed over to chip {lf['owner']}; time_to_healed_ms "
        f"{lf['wall_ms']:.3f}; the post-heal answer is the healthy run's, bytes and order")
    return out


# the sharded main paths: path -> (the flat path whose configuration it runs,
# chips). (v) is (c) through ShardedEngine(chips=4), (w) is (d).
SHARDED_PATHS = {"v": ("c", 4), "w": ("d", 4)}
# the kernels each must launch: (v) the lazy rounds' mp kernels and K2 (the
# chip trees and the cross-chip level), (w) the incremental rounds and K2
SHARDED_WANTED = {"v": MP_ROUNDS + TREE_K2, "w": (PREDROP_FUSED, MP_PATH[1]) + TREE_K2}


@contextlib.contextmanager
def cross_chip_watch(torch):
    """For the duration, every cross-chip ``tree_pair_merge`` (the level-2
    pairs on chip 0's card) is counted with the K2 launches it made, and
    the heaviest pair's inputs kept (cloned). Yields the record."""
    from skyline_tpu_torch.distributed import sharded
    from skyline_tpu_torch.ops import dominance_kernels as dk

    real = sharded.tree_pair_merge
    rec = {"pairs": 0, "k2_launches": 0, "work": -1}

    def watch(a, apids, acnt, b, bpids, bcnt, out_cap):
        rec["pairs"] += 1
        work = a.shape[0] * b.shape[0]
        if work >= rec["work"]:
            rec.update(work=work, a=a.clone(), acnt=acnt.clone(), b=b.clone(),
                       bcnt=bcnt.clone())
        k0 = dk.LAUNCHES["dominated_by_rect"]
        out = real(a, apids, acnt, b, bpids, bcnt, out_cap)
        rec["k2_launches"] += dk.LAUNCHES["dominated_by_rect"] - k0
        return out

    sharded.tree_pair_merge = watch
    try:
        yield rec
    finally:
        sharded.tree_pair_merge = real


def _sync_all(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def sharded_path(torch, np, path: str, n: int, windows: int, base_runs=None,
                 dev="cuda") -> tuple:
    """Path (v) or (w): its flat path's configuration and rows (the same
    seed) through a fresh ``ShardedEngine(chips=4)`` a window, one warm
    window and ``windows`` measured, launch counts set to 0 before and read
    after. Each window prints its wall, the flush and merge walls, the
    level-1 ms (the chips' merges, summed) and level-2 ms (the merge wall
    less level 1: the gather, the cross-chip pairs and the harvest), the
    chips pruned and the cross-chip pairs; the last window's answer equals
    the flat engine's on the same rows (a sorted set; the order is the
    parity leg's) and the warm answer passes the sampled checks. With the
    flat path's run in ``base_runs``, printed beside it."""
    from skyline_tpu_torch.distributed import ShardedEngine
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.telemetry.spans import SpanRecorder
    from skyline_tpu_torch.workload.generators import anti_correlated

    base, chips = SHARDED_PATHS[path]
    cfg, _, _, env = PATHS[base]
    d = cfg["dims"]
    rng = np.random.default_rng(0)
    ids = np.arange(n, dtype=np.int64)
    xs = [anti_correlated(rng, n, d, 0, 10000) for _ in range(windows + 1)]
    lat, rows = [], []
    with rank_gate(False, env), cross_chip_watch(torch) as cross:
        dk.reset_launches()
        prev = None
        for w, x in enumerate(xs):
            eng = ShardedEngine(_config(base, n, emit_skyline_points=w == 0), chips=chips)
            if prev is not None:
                # each chip takes over its lazy flush race's profiler, as one
                # long-lived engine keeps it (main_path's flush_race)
                for chip, old in zip(eng.pset._chips, prev.pset._chips):
                    chip._flush_prof = old._flush_prof
            prev = eng
            spans = SpanRecorder(256)
            eng.pset._spans = spans
            pairs0 = cross["pairs"]
            t0 = time.perf_counter()
            for i in range(0, n, 65536):
                eng.process_records(ids[i : i + 65536], x[i : i + 65536])
            eng.process_trigger("0,0")
            (res,) = eng.poll_results()
            _sync_all(torch)
            dt = time.perf_counter() - t0
            level1 = sum(s["dur_ns"] for s in spans.snapshot() if s["name"] == "chip_merge") / 1e6
            info = eng.pset.last_chip_info
            row = {"window_ms": dt * 1e3, "flush_ms": eng.last_flush_ms,
                   "merge_ms": eng.last_merge_ms, "level1_ms": level1,
                   "level2_ms": eng.last_merge_ms - level1,
                   "skyline_size": res["skyline_size"], "chips_pruned": len(info["pruned"]),
                   "survivors": info["survivors"], "cross_chip_pairs": cross["pairs"] - pairs0,
                   "per_chip_skyline": [c["skyline"] for c in info["per_chip"]],
                   "flush_paths": [dict(c.flush_paths) for c in eng.pset._chips],
                   "local_sizes": eng.pset.sky_counts().tolist(),
                   "records_seen": eng.pset.records_seen.tolist()}
            if w == 0:
                warm = (dt, res, x)
                log(f"main ({path}): warm window {dt * 1e3:.1f} ms, skyline "
                    f"{res['skyline_size']}; {_spread(torch, eng, chips)}")
                continue
            lat.append(dt)
            rows.append(row)
            log(f"main ({path}): window {w - 1}: {dt * 1e3:.1f} ms (flush "
                f"{row['flush_ms']:.1f} ms, merge {row['merge_ms']:.1f} ms: level 1 "
                f"{level1:.1f} ms, level 2 {row['level2_ms']:.1f} ms), skyline "
                f"{res['skyline_size']}, chips' skylines {row['per_chip_skyline']}, "
                f"{row['chips_pruned']} of {chips} chips pruned, survivors {row['survivors']}, "
                f"{row['cross_chip_pairs']} cross-chip pairs; chips' flush paths "
                f"{row['flush_paths']}; partitions' skylines {row['local_sizes']} of records "
                f"{row['records_seen']}")
        launches = dict(dk.LAUNCHES)
        cross_k2 = cross["k2_launches"]
        heavy = {k: cross.get(k) for k in ("a", "acnt", "b", "bcnt")}
        stats = eng.stats()["sharded"]
    want_k = SHARDED_WANTED[path]
    missing = [k for k in want_k if launches[k] == 0]
    if missing or cross_k2 == 0:
        raise AssertionError(f"main path ({path}) launched no {missing or 'cross-chip K2'}")
    # the last window's answer against the flat engine on the same rows
    from skyline_tpu_torch.stream import SkylineEngine

    def points(engine):
        return engine.pset.global_merge_stats(emit_points=True)[3]

    flat = SkylineEngine(_config(base, n))
    with rank_gate(False, env):
        for i in range(0, n, 65536):
            flat.process_records(ids[i : i + 65536], xs[-1][i : i + 65536])
        flat.process_trigger("0,0")
        flat.poll_results()
        if _sorted_bytes(points(flat)) != _sorted_bytes(points(eng)):
            raise AssertionError(f"main path ({path}): the answer differs from the flat engine's")
    check_answer(torch, np, warm[2], np.asarray(warm[1]["skyline_points"], np.float32), dev)
    summary = {
        "base": base, "chips": chips, "rows_per_window": n, "windows_measured": windows,
        "tuples_per_s": n * windows / sum(lat),
        "p50_window_ms": float(np.median(lat)) * 1e3,
        "p50_flush_ms": float(np.median([r["flush_ms"] for r in rows])),
        "p50_merge_ms": float(np.median([r["merge_ms"] for r in rows])),
        "p50_level1_ms": float(np.median([r["level1_ms"] for r in rows])),
        "p50_level2_ms": float(np.median([r["level2_ms"] for r in rows])),
        "chips_pruned_per_merge": [r["chips_pruned"] for r in rows],
        "warm_window_ms": warm[0] * 1e3, "windows": rows, "launches": launches,
        "launches_per_window": {k: v / (windows + 1) for k, v in launches.items()},
        "cross_chip_k2_launches": cross_k2, "devices": stats["devices"],
        "merge_env": env,
    }
    log(f"main ({path}): {summary['tuples_per_s']:.0f} tuples/s, p50 window "
        f"{summary['p50_window_ms']:.1f} ms (flush {summary['p50_flush_ms']:.1f}, merge "
        f"{summary['p50_merge_ms']:.1f}: level 1 {summary['p50_level1_ms']:.1f}, level 2 "
        f"{summary['p50_level2_ms']:.1f}) over {windows} windows of {n} rows, {chips} chips on "
        f"{stats['devices']}; chips pruned per merge {summary['chips_pruned_per_merge']}; "
        f"launches over {windows + 1} windows {({k: launches[k] for k in want_k})}, cross-chip "
        f"K2 {cross_k2}; the last answer = the flat engine's (a sorted set)")
    if base_runs and base in base_runs:
        b = base_runs[base][0]
        summary["beside_" + base] = {"p50_window_ms": b["p50_window_ms"],
                                     "tuples_per_s": b["tuples_per_s"],
                                     "ratio": summary["p50_window_ms"] / b["p50_window_ms"]}
        log(f"main ({path}) beside ({base}): p50 {summary['p50_window_ms']:.1f} ms vs "
            f"{b['p50_window_ms']:.1f} ms ({summary['p50_window_ms'] / b['p50_window_ms']:.3f}x), "
            f"{summary['tuples_per_s']:.0f} vs {b['tuples_per_s']:.0f} tuples/s")
    return summary, heavy


def cross_chip_k2(torch, np, heavy: dict, summary: dict) -> dict:
    """K2 at the cross-chip level: the heaviest level-2 pair over (v)'s
    windows (chip roots on chip 0's card), its two calls as
    ``tree_pair_k2`` times them, with (v)'s cross-chip K2 launches a
    window."""
    if heavy.get("a") is None:
        raise AssertionError("(v) merged no cross-chip pair")
    out = _time_tree_pair(torch, heavy["a"], heavy["acnt"], heavy["b"], heavy["bcnt"],
                          "K2 cross-chip pair")
    out["launches"] = summary["cross_chip_k2_launches"]
    out["launches_per_window"] = out["launches"] / (summary["windows_measured"] + 1)
    out["devices"] = summary["devices"]
    log(f"timings: K2 cross-chip pair ({out['valid_a_rows']} a rows, {out['valid_b_rows']} b "
        f"rows) {out['pair_ms']:.3f} ms, {out['launches_per_window']:.1f} cross-chip K2 "
        "launches per window on (v)")
    return out


# -- the cluster plane: CLUSTER_PARITY, REPLICA_PARITY and the paths (x), (y) --

# two 65,536-row windows, P = 8, under each policy (lazy d = 8 on uniform
# rows, as SHARDED_PARITY: the north-star generator's zero rows cost the
# CPU side minutes; overlap flushing every 32,768 rows so its automatic
# flushes land mid-window)
CLUSTER_PARITY = (
    ("lazy d=8", dict(NORTH_STAR, ingest="host"), "uniform"),
    ("incremental d=3", dict(GRID_3D, ingest="host"), "anti_correlated"),
    ("overlap d=8", dict(NORTH_STAR, ingest="host", flush_policy="overlap",
                         overlap_rows=32768), "uniform"),
)
# (hosts, chips_per_host): the grid of tests/test_cluster.py:484-502
CLUSTER_GRID = ((1, 1), (2, 1), (2, 2), (4, 2), (8, 1))
CLUSTER_PARITY_ROWS = 65536
# the rows a window of the card-against-CPU comparison: the CPU side's
# depth, cut from CLUSTER_PARITY_ROWS to keep the run under its limit (the
# card's grid against the flat engine keeps CLUSTER_PARITY_ROWS)
CLUSTER_CPU_ROWS = 16384
# the CPU side's configurations run in this many child processes beside the
# card side, one thread each (the card side takes seconds, the CPU side
# minutes of the CPU's plain dominance)
CLUSTER_CPU_WORKERS = 8
CLUSTER_RUNS = ROOT / "skyline_tpu_torch" / "_build" / "cluster_runs"


def _points_sha1(pts) -> str:
    import hashlib

    return hashlib.sha1(pts.tobytes()).hexdigest()


def _cluster_stats(eng) -> dict:
    doc = untimed(eng.stats()["cluster"])
    doc.pop("health", None)  # the host scorer's wall EMAs and heartbeat ages
    return doc


def _drive_cluster(cfg, windows, hosts, chips, chunk=8192):
    """Windows back to back through one engine (``ClusterEngine`` over
    ``hosts`` x ``chips``, or the flat engine when ``hosts`` is None), a
    trigger after each. Per window: the results (timings aside) and the
    merge state — counts, survivors, size and the points' sha1 (rows and
    order). Returns (windows, ``cluster_stats()`` or None, engine)."""
    import numpy as np

    from skyline_tpu_torch.cluster import ClusterEngine
    from skyline_tpu_torch.stream import SkylineEngine

    eng = (SkylineEngine(cfg) if hosts is None
           else ClusterEngine(cfg, hosts=hosts, chips_per_host=chips))
    out, base = [], 0
    for i, x in enumerate(windows):
        ids = np.arange(base, base + x.shape[0], dtype=np.int64)
        base += x.shape[0]
        for s in range(0, x.shape[0], chunk):
            eng.process_records(ids[s : s + chunk], x[s : s + chunk])
        eng.process_trigger(f"q{i},0")
        res = [untimed(r) for r in eng.poll_results()]
        counts, surv, g, pts = eng.pset.global_merge_stats(emit_points=True)
        out.append({"results": res, "counts": counts.tolist(), "surv": surv.tolist(),
                    "g": int(g), "points_sha1": _points_sha1(pts)})
    return out, (None if hosts is None else _cluster_stats(eng)), eng


def _cluster_windows(gen: str, d: int, rows: int):
    import numpy as np

    from skyline_tpu_torch.workload import generators

    rng = np.random.default_rng(17)
    return [getattr(generators, gen)(rng, rows, d, 0, 10000) for _ in range(2)]


def _cluster_cpu_side(job):
    """One ``CLUSTER_PARITY`` configuration on the CPU, in a child process:
    (leg, hosts, chips, windows, stats, seconds)."""
    name, cfg, gen, hosts, chips, rows, env = job
    import torch

    torch.set_num_threads(1)
    os.environ.update(env)
    from skyline_tpu_torch.stream import EngineConfig

    t0 = time.perf_counter()
    ecfg = EngineConfig(**cfg, window_capacity=rows, device="cpu")
    out, stats, _ = _drive_cluster(ecfg, _cluster_windows(gen, cfg["dims"], rows), hosts, chips)
    return name, hosts, chips, out, stats, time.perf_counter() - t0


def _member_devices(m) -> list:
    return [str(dv) for dv in (m.devices if hasattr(m, "devices") else [m.device])]


def _cluster_spread(eng) -> str:
    """The members' devices and where each surviving host root lived before
    the host ladder put it on the root device."""
    from skyline_tpu_torch.cluster.merge import member_device

    ps = eng.pset
    roots = [str(member_device(m)) for m in ps._members]
    last = ps.last_host_info or {}
    crossed = [h for h in last.get("survivors", []) if roots[h] != str(ps.root_device)]
    return (f"members on {[_member_devices(m) for m in ps._members]}, host roots on {roots}, "
            f"root {ps.root_device}, survivors {last.get('survivors')}, roots copied across "
            f"cards {crossed}")


def check_cluster_parity(torch, np, devices=("cuda", "cpu")) -> dict:
    """``ClusterEngine`` at every (hosts, chips_per_host) of ``CLUSTER_GRID``
    under each ``CLUSTER_PARITY`` policy, P = 8: two 65,536-row windows on
    the card against the flat engine on the card, and two
    ``CLUSTER_CPU_ROWS``-row windows on the card against the same
    configuration on the CPU (results, counts, survivors, sizes, the points'
    sha1 — rows and order — and ``cluster_stats()`` with the host prune's
    counts, timings aside), strict. The CPU side runs in child processes
    beside the card side. Then, on the card: the skewed host prune, a live
    migration to another chip count and a slice checkpoint restored on
    another facade's host (``cluster_rebalance``)."""
    import concurrent.futures
    import multiprocessing

    from skyline_tpu_torch.stream import EngineConfig

    card, cpu = devices
    n_cards = torch.cuda.device_count() if card != "cpu" else 0
    if n_cards == 1:
        log("cluster: one card visible: every host member and every chip of a sharded "
            "member share cuda:0")
    out = {"cards": n_cards, "legs": {}}
    t_leg = time.perf_counter()
    # the lazy flush races on both sides (the CPU's host sorted cascade is
    # ~3x faster than its plain SFS rounds); nothing compared here depends on
    # the path the race takes
    jobs = [(name, cfg, gen, h, c, CLUSTER_CPU_ROWS, {})
            for name, cfg, gen in CLUSTER_PARITY for h, c in CLUSTER_GRID]
    card_small = {}
    with concurrent.futures.ProcessPoolExecutor(
            CLUSTER_CPU_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_cluster_cpu_side, job) for job in jobs]
        try:
            for name, cfg, gen in CLUSTER_PARITY:
                windows = _cluster_windows(gen, cfg["dims"], CLUSTER_PARITY_ROWS)
                ecfg = EngineConfig(**cfg, window_capacity=CLUSTER_PARITY_ROWS, device=card)
                t0 = time.perf_counter()
                want, _, _ = _drive_cluster(ecfg, windows, None, None)
                got = {}
                for hosts, chips in CLUSTER_GRID:
                    res, stats, eng = _drive_cluster(ecfg, windows, hosts, chips)
                    if res != want:
                        raise AssertionError(f"cluster {name}: {hosts} hosts x {chips} chips on "
                                             "the card differ from the flat engine on the card")
                    got[(hosts, chips)] = stats
                    log(f"cluster {name}: {hosts} hosts x {chips} chips = the flat engine, rows, "
                        f"order, counts and sha1 {[w['points_sha1'][:12] for w in res]}; "
                        f"{stats['merges']} merges, {stats['hosts_pruned']} of "
                        f"{stats['hosts_considered']} hosts pruned, rows shipped "
                        f"{stats['rows_shipped']} saved {stats['rows_saved']}, levels "
                        f"{stats['last']['levels']}; {_cluster_spread(eng)}")
                # the same grid on the card at the CPU side's depth
                small_windows = _cluster_windows(gen, cfg["dims"], CLUSTER_CPU_ROWS)
                small_cfg = EngineConfig(**cfg, window_capacity=CLUSTER_CPU_ROWS, device=card)
                for hosts, chips in CLUSTER_GRID:
                    res, stats, _ = _drive_cluster(small_cfg, small_windows, hosts, chips)
                    card_small[(name, hosts, chips)] = (res, stats)
                out["legs"][name] = {
                    "rows_per_window": CLUSTER_PARITY_ROWS, "windows": 2,
                    "cpu_rows_per_window": CLUSTER_CPU_ROWS,
                    "skyline_sizes": [w["g"] for w in want],
                    "points_sha1": [w["points_sha1"] for w in want],
                    "grid": {f"{h}x{c}": {k: s[k] for k in ("merges", "hosts_pruned",
                                                           "hosts_considered", "rows_shipped",
                                                           "rows_saved", "last")}
                             for (h, c), s in got.items()},
                    "card_s": time.perf_counter() - t0, "cpu_s": {},
                }
            t1 = time.perf_counter()
            for f in concurrent.futures.as_completed(futures):
                name, hosts, chips, res, stats, secs = f.result()
                card_res, card_stats = card_small[(name, hosts, chips)]
                if res != card_res:
                    raise AssertionError(f"cluster {name}: {hosts} x {chips} on the CPU differs "
                                         "from the card")
                if stats != card_stats:
                    raise AssertionError(f"cluster {name}: {hosts} x {chips}: cluster_stats() on "
                                         f"the CPU {stats} != the card's {card_stats}")
                out["legs"][name]["cpu_s"][f"{hosts}x{chips}"] = secs
            wait_s = time.perf_counter() - t1
        except BaseException:
            # a failed card side stops the CPU side too
            pool.shutdown(wait=True, cancel_futures=True)
            raise
    for name, leg in out["legs"].items():
        log(f"cluster {name}: every configuration on the CPU = the card over two "
            f"{CLUSTER_CPU_ROWS}-row windows, answers and "
            f"cluster_stats(); card {leg['card_s']:.1f} s, CPU side "
            f"{sum(leg['cpu_s'].values()):.1f} s in {CLUSTER_CPU_WORKERS} processes of one "
            "thread")
    log(f"cluster: waited {wait_s:.1f} s for the CPU side after the card side")
    out["cpu_wait_s"] = wait_s
    out["rebalance"] = cluster_rebalance(torch, np, card)
    out["wall_s"] = time.perf_counter() - t_leg
    log(f"cluster: parity leg done in {out['wall_s']:.1f} s")
    return out


def _feed_round_robin(pset, x, P: int, chunk: int = 8192) -> None:
    """Rows to partitions round-robin, the set's own flush cadence after
    every chunk (tests/test_cluster.py's feed, at full size)."""
    import numpy as np

    n = x.shape[0]
    pids = np.arange(n) % P
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        for p in range(P):
            rows = np.ascontiguousarray(x[lo:hi][pids[lo:hi] == p])
            if rows.shape[0]:
                pset.add_batch(p, rows, max_id=hi, now_ms=0.0)
        pset.maybe_flush()
    pset.flush_all()


def _merge_state(pset):
    counts, surv, g, pts = pset.global_merge_stats(emit_points=True)
    return counts.tolist(), surv.tolist(), int(g), _points_sha1(pts)


@contextlib.contextmanager
def host_ladder_watch(torch):
    """For the duration, every host-ladder ``tree_pair_merge`` (the cluster
    merge's pairs on the root device) is counted with the K2 launches it
    made, and the heaviest pair's inputs kept (cloned). Yields the
    record."""
    from skyline_tpu_torch.cluster import merge as cmerge
    from skyline_tpu_torch.ops import dominance_kernels as dk

    real = cmerge.tree_pair_merge
    rec = {"pairs": 0, "k2_launches": 0, "work": -1}

    def watch(a, apids, acnt, b, bpids, bcnt, out_cap):
        rec["pairs"] += 1
        work = a.shape[0] * b.shape[0]
        if work >= rec["work"]:
            rec.update(work=work, a=a.clone(), acnt=acnt.clone(), b=b.clone(),
                       bcnt=bcnt.clone())
        k0 = dk.LAUNCHES["dominated_by_rect"]
        out = real(a, apids, acnt, b, bpids, bcnt, out_cap)
        rec["k2_launches"] += dk.LAUNCHES["dominated_by_rect"] - k0
        return out

    cmerge.tree_pair_merge = watch
    try:
        yield rec
    finally:
        cmerge.tree_pair_merge = real


def cluster_rebalance(torch, np, dev) -> dict:
    """On the card, ``ClusterPartitionSet`` over P = 8 with round-robin
    routing: (1) the skewed host prune — a near-origin cluster on partition
    0 whose witness dominates every other host's least corner: pruned hosts
    ship zero rows, the answer equals the flat set's and the set's with
    ``SKYLINE_CLUSTER_HOST_PRUNE=0``, and the ladder merges fewer pairs; (2)
    ``migrate`` of host 1 to 2 chips and back, the next answers the flat
    set's after more rows; (3) ``checkpoint_slice`` of host 1 restored into
    another facade's host 1 at another chip count, the flat answer."""
    from skyline_tpu_torch.cluster import ClusterPartitionSet
    from skyline_tpu_torch.stream.batched import PartitionSet
    from skyline_tpu_torch.workload.generators import uniform

    P, n = 8, CLUSTER_PARITY_ROWS
    rng = np.random.default_rng(29)
    out = {}

    def flat(d):
        return PartitionSet(P, d, 8192, device=dev)

    def cluster(d, hosts, chips):
        return ClusterPartitionSet(P, d, 8192, hosts=hosts, chips_per_host=chips, device=dev)

    # (1) the skewed prune
    d = 3
    x = (rng.random((n, d)) * 4000 + 6000).astype(np.float32)
    x[::P] = (rng.random((n // P, d)) * 50).astype(np.float32)
    ref = flat(d)
    _feed_round_robin(ref, x, P)
    want = _merge_state(ref)
    runs = {}
    for prune in ("1", "0"):
        with knob_env({"SKYLINE_CLUSTER_HOST_PRUNE": prune}), host_ladder_watch(torch) as lad:
            cp = cluster(d, 4, 2)
            _feed_round_robin(cp, x, P)
            got = _merge_state(cp)
        if got != want:
            raise AssertionError(f"cluster prune={prune}: the skewed answer differs from the "
                                 "flat set's")
        runs[prune] = (cp.cluster_stats(), lad["pairs"], lad["k2_launches"])
    stats, pairs, k2 = runs["1"]
    info = stats["last"]
    pruned = {e["host"] for e in info["pruned"]}
    if not pruned or pruned & set(info["survivors"]) or info["rows_saved"] <= 0:
        raise AssertionError(f"cluster: the skewed host prune did not fire cleanly: {info}")
    if pairs >= runs["0"][1] or runs["0"][0]["hosts_pruned"]:
        raise AssertionError(f"cluster: pruning {sorted(pruned)} merged {pairs} ladder pairs, "
                             f"unpruned {runs['0'][1]}")
    out["prune"] = {"hosts_pruned": sorted(pruned), "survivors": info["survivors"],
                    "rows_shipped": info["rows_shipped"], "rows_saved": info["rows_saved"],
                    "ladder_pairs": pairs, "ladder_k2": k2,
                    "ladder_pairs_unpruned": runs["0"][1], "ladder_k2_unpruned": runs["0"][2]}
    log(f"cluster: skewed prune on the card: hosts {sorted(pruned)} pruned (ship zero rows; "
        f"rows shipped {info['rows_shipped']}, saved {info['rows_saved']}), the answer = the "
        f"flat set's = unpruned; ladder pairs {pairs} (K2 {k2}) against {runs['0'][1]} "
        f"(K2 {runs['0'][2]}) unpruned")
    # (2) live migration to another chip count and back
    d = 8
    xs = [uniform(rng, n, d, 0, 10000) for _ in range(2)]
    ref = flat(d)
    cp = cluster(d, 2, 1)
    for s in (ref, cp):
        _feed_round_robin(s, xs[0], P)
    want = _merge_state(ref)
    if _merge_state(cp) != want:
        raise AssertionError("cluster: the pre-migration answer differs from the flat set's")
    t0 = time.perf_counter()
    doc = cp.migrate(1, chips=2, reason="drill")
    mig_ms = (time.perf_counter() - t0) * 1e3
    if _merge_state(cp) != want or cp._member_chips != [1, 2]:
        raise AssertionError("cluster: the answer after migrating host 1 to 2 chips differs")
    for s in (ref, cp):
        _feed_round_robin(s, xs[1], P)
    want = _merge_state(ref)
    if _merge_state(cp) != want:
        raise AssertionError("cluster: the answer after more rows on the migrated host differs")
    back = cp.migrate(1, chips=1, reason="drill")
    if _merge_state(cp) != want:
        raise AssertionError("cluster: the answer after migrating host 1 back differs")
    out["migrate"] = {"to_2_chips_ms": mig_ms, "doc": doc, "back": back,
                      "migrations": cp.migrations}
    log(f"cluster: host 1 migrated to 2 chips in {mig_ms:.1f} ms and back "
        f"({back['wall_ms']:.1f} ms): the next answers = the flat set's")
    # (3) a slice checkpoint of host 1, restored on another facade's host 1
    CLUSTER_RUNS.mkdir(parents=True, exist_ok=True)
    path = str(CLUSTER_RUNS / "slice_host1.npz")
    cp.checkpoint_slice(1, path)
    dst = cluster(d, 2, 2)
    skies, pendings = cp.audit_state()
    G = cp.group_size
    empty = [np.empty((0, d), dtype=np.float32)] * G
    dst.restore_all(list(skies[:G]) + empty, list(pendings[:G]) + empty)
    rdoc = dst.restore_slice(1, path, chips=1)
    if _merge_state(dst) != want or dst._member_chips != [2, 1]:
        raise AssertionError("cluster: the slice restored on another facade's host differs")
    out["slice"] = {"bytes": os.path.getsize(path), "doc": rdoc}
    log(f"cluster: host 1's slice ({os.path.getsize(path)} bytes) restored on another "
        "facade's host 1 at 1 chip: the next answer = the flat set's")
    return out


REPLICA_ROWS = 65536
REPLICA_RUNS = ROOT / "skyline_tpu_torch" / "_build" / "replica_runs"


def _http_get(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read(), dict(r.headers)


def check_replica_parity(torch, np, devices=("cuda", "cpu")) -> dict:
    """A worker on the card with the serving plane, crash safety and two
    in-process read replicas, over a ``MemoryBus`` fed two windows of
    ``REPLICA_ROWS`` 3-D anti-correlated rows ((d)'s configuration) through
    the cluster engine over 2 hosts (so the worker holds the write lease and
    stamps every WAL frame with its fencing token). At every version the
    primary and a replica both hold, the replica's points, digest and meta
    are the primary's; after each window the replicas' ``/skyline`` CSV
    bytes and ``X-Skyline-Digest`` are the primary's. The WAL stays in
    ``REPLICA_RUNS`` (``--out`` copies it beside the details, where
    ``tests/fold_wal_jax.py`` folds it with the JAX replica). Then the
    promotion drill: the lease expires, ``ClusterSupervisor.tick()`` raises
    the fence and promotes the most caught-up replica, whose head is the
    primary's; the deposed writer's next append raises ``WalFencedError``
    and is counted."""
    import hashlib
    import shutil

    from skyline_tpu_torch.bridge import MemoryBus, SkylineWorker
    from skyline_tpu_torch.cluster import ClusterSupervisor, WalFencedError
    from skyline_tpu_torch.resilience import ResilienceConfig
    from skyline_tpu_torch.resilience.wal import read_records
    from skyline_tpu_torch.serve import ServeConfig
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.workload.generators import anti_correlated

    card = devices[0]
    t_leg = time.perf_counter()
    shutil.rmtree(REPLICA_RUNS, ignore_errors=True)
    REPLICA_RUNS.mkdir(parents=True)
    rng = np.random.default_rng(23)
    bus = MemoryBus()
    res = ResilienceConfig(checkpoint_dir=str(REPLICA_RUNS), wal_fsync="off")
    versions = {}
    with knob_env({"SKYLINE_CLUSTER_LEASE_TTL_MS": "600000"}):
        w = SkylineWorker(bus, EngineConfig(**GRID_3D, ingest="host", device=card),
                          serve_port=0, serve_config=ServeConfig(), resilience=res,
                          replicas=2, cluster_hosts=2)
        try:
            wal_dir = w._wal_dir
            base = 0
            for window in range(2):
                x = np.rint(anti_correlated(rng, REPLICA_ROWS, 3, 0, 10000))
                bus.produce_many("input-tuples", [
                    f"{base + i}," + ",".join(str(int(v)) for v in row)
                    for i, row in enumerate(x)])
                base += REPLICA_ROWS
                bus.produce("queries", f"q{window},0")
                while w.step() > 0:
                    pass
                t0 = time.perf_counter()
                store = w.serve_server.store
                head = store.latest()
                lag, common = [], 0
                for rep in w.replicas:
                    if not rep.wait_for_version(store.head_version, timeout_s=60.0):
                        raise AssertionError(f"replica {rep.replica_id} stuck at "
                                             f"{rep.store.head_version} < {store.head_version}")
                    lag.append((time.perf_counter() - t0) * 1e3)
                    common = 0
                    for snap in list(store._history):
                        mine = rep.store.get(snap.version)
                        if mine is None:
                            continue
                        common += 1
                        if (mine.points.tobytes() != snap.points.tobytes()
                                or mine.digest != snap.digest or mine.meta != snap.meta):
                            raise AssertionError(f"replica {rep.replica_id} differs from the "
                                                 f"primary at version {snap.version}")
                        versions[snap.version] = snap.digest
                    rb, rh = _http_get(f"http://127.0.0.1:{rep.port}/skyline?format=csv")
                    pb, ph = _http_get(f"http://127.0.0.1:{w.serve_server.port}"
                                       "/skyline?format=csv")
                    if rb != pb or rh["X-Skyline-Digest"] != ph["X-Skyline-Digest"]:
                        raise AssertionError(f"replica {rep.replica_id}'s /skyline bytes differ")
                log(f"replica: window {window}: head version {store.head_version} "
                    f"({head.points.shape[0]} rows, digest {head.digest[:12]}), both replicas "
                    f"equal at every common version ({common}) and over HTTP (CSV sha256 "
                    f"{hashlib.sha256(pb).hexdigest()[:12]}); caught up "
                    f"{[round(v, 1) for v in lag]} ms after the worker's last step")
            tokens = {r.get("fence") for r in read_records(wal_dir)[0]}
            if tokens != {w._lease_keeper.epoch}:
                raise AssertionError(f"WAL frames carry fencing tokens {tokens}")
            # the promotion drill: the primary's lease expires
            head = w.serve_server.store.latest()
            sup = ClusterSupervisor(wal_dir, w.replicas, lease_ttl_ms=1000.0,
                                    telemetry=w.telemetry,
                                    clock=lambda: time.time() * 1000.0 + 1e9)
            doc = sup.tick()
            if doc is None or (doc["head_version"], doc["head_digest"]) != (
                    head.version, head.digest):
                raise AssertionError(f"promotion: {doc} does not carry the primary's head "
                                     f"{head.version} {head.digest}")
            try:
                w._wal.append({"type": "delta", "drill": True})
            except WalFencedError as e:
                fenced_err = str(e)
            else:
                raise AssertionError("the deposed writer's append after the fence went through")
            if w._wal.fenced_writes != 1:
                raise AssertionError(f"fenced writes counted {w._wal.fenced_writes}, not 1")
            promoted = [r.replica_id for r in w.replicas if r.role == "primary"]
            log(f"replica: promotion drill: lease expired, fence raised to epoch "
                f"{doc['epoch']}, {promoted} promoted in {doc['time_to_promote_ms']:.3f} ms "
                f"(time to promote) at head {doc['head_version']} = the primary's digest; the "
                f"deposed writer's next append refused ({fenced_err}), counted "
                f"{w._wal.fenced_writes}")
        finally:
            w.close()
    out = {"rows_per_window": REPLICA_ROWS, "windows": 2, "wal_dir": str(wal_dir),
           "versions": sorted(versions.items()), "promotion": doc,
           "time_to_promote_ms": doc["time_to_promote_ms"], "fenced_writes": 1,
           "wall_s": time.perf_counter() - t_leg}
    log(f"replica: parity leg done in {out['wall_s']:.1f} s")
    return out


# the cluster paths: (x) is (c) through 4 hosts of one flat member each, (y)
# is (d) through 2 hosts of 2 chips each (the three-level tournament)
CLUSTER_PATHS = {"x": ("c", 4, 1), "y": ("d", 2, 2)}
CLUSTER_WANTED = {"x": MP_ROUNDS + TREE_K2, "y": (PREDROP_FUSED, MP_PATH[1]) + TREE_K2}


def _carry_flush_prof(new, old) -> None:
    """Each member (each chip of a sharded member) takes over its lazy
    flush race's profiler from the engine of the window before."""
    for m, o in zip(new._members, old._members):
        for a, b in (zip(m._chips, o._chips) if hasattr(m, "_chips") else [(m, o)]):
            a._flush_prof = b._flush_prof


def cluster_path(torch, np, path: str, n: int, windows: int, base_runs=None,
                 dev="cuda") -> tuple:
    """Path (x) or (y): its flat path's configuration and rows (the same
    seed) through a fresh ``ClusterEngine`` a window, one warm window and
    ``windows`` measured, launch counts set to 0 before and read after. Each
    window prints its wall, the flush and merge walls, the host-level ms
    (the ``host_merge`` spans: each host's own merge) and the cross-host ms
    (the ``cross_host_merge`` span: the ladder's launches), the hosts
    pruned, the rows shipped and saved and the ladder's pairs and K2
    launches; the last window's answer equals the flat engine's on the same
    rows (a sorted set) and the warm answer passes the sampled checks. With
    the flat path's run in ``base_runs``, printed beside it."""
    from skyline_tpu_torch.cluster import ClusterEngine
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.stream import SkylineEngine
    from skyline_tpu_torch.telemetry.spans import SpanRecorder
    from skyline_tpu_torch.workload.generators import anti_correlated

    base, hosts, chips = CLUSTER_PATHS[path]
    cfg, _, _, env = PATHS[base]
    d = cfg["dims"]
    rng = np.random.default_rng(0)
    ids = np.arange(n, dtype=np.int64)
    xs = [anti_correlated(rng, n, d, 0, 10000) for _ in range(windows + 1)]
    lat, rows = [], []
    with rank_gate(False, env), host_ladder_watch(torch) as lad:
        dk.reset_launches()
        prev = None
        for w, x in enumerate(xs):
            eng = ClusterEngine(_config(base, n, emit_skyline_points=w == 0), hosts=hosts,
                                chips_per_host=chips)
            if prev is not None:
                _carry_flush_prof(eng.pset, prev.pset)
            prev = eng
            spans = SpanRecorder(256)
            eng.pset._spans = spans
            pairs0, k0 = lad["pairs"], lad["k2_launches"]
            t0 = time.perf_counter()
            for i in range(0, n, 65536):
                eng.process_records(ids[i : i + 65536], x[i : i + 65536])
            eng.process_trigger("0,0")
            (res,) = eng.poll_results()
            _sync_all(torch)
            dt = time.perf_counter() - t0
            snap = spans.snapshot()
            host_ms = sum(s["dur_ns"] for s in snap if s["name"] == "host_merge") / 1e6
            cross_ms = sum(s["dur_ns"] for s in snap if s["name"] == "cross_host_merge") / 1e6
            info = eng.pset.last_host_info
            row = {"window_ms": dt * 1e3, "flush_ms": eng.last_flush_ms,
                   "merge_ms": eng.last_merge_ms, "host_ms": host_ms, "cross_host_ms": cross_ms,
                   "skyline_size": res["skyline_size"], "hosts_pruned": len(info["pruned"]),
                   "survivors": info["survivors"], "rows_shipped": info["rows_shipped"],
                   "rows_saved": info["rows_saved"], "ladder_pairs": lad["pairs"] - pairs0,
                   "ladder_k2": lad["k2_launches"] - k0,
                   "per_host_skyline": [h["skyline"] for h in info["per_host"]],
                   "local_sizes": eng.pset.sky_counts().tolist(),
                   "records_seen": eng.pset.records_seen.tolist()}
            if w == 0:
                warm = (dt, res, x)
                log(f"main ({path}): warm window {dt * 1e3:.1f} ms, skyline "
                    f"{res['skyline_size']}; {_cluster_spread(eng)}")
                continue
            lat.append(dt)
            rows.append(row)
            log(f"main ({path}): window {w - 1}: {dt * 1e3:.1f} ms (flush "
                f"{row['flush_ms']:.1f} ms, merge {row['merge_ms']:.1f} ms: hosts {host_ms:.1f} "
                f"ms, cross-host {cross_ms:.1f} ms), skyline {res['skyline_size']}, hosts' "
                f"skylines {row['per_host_skyline']}, {row['hosts_pruned']} of {hosts} hosts "
                f"pruned, survivors {row['survivors']}, rows shipped {row['rows_shipped']} "
                f"saved {row['rows_saved']}, {row['ladder_pairs']} ladder pairs "
                f"({row['ladder_k2']} K2); partitions' skylines {row['local_sizes']} of "
                f"records {row['records_seen']}")
        launches = dict(dk.LAUNCHES)
        ladder_k2, ladder_pairs = lad["k2_launches"], lad["pairs"]
        heavy = {k: lad.get(k) for k in ("a", "acnt", "b", "bcnt")}
        stats = eng.pset.cluster_stats()
        devices = [str(dv) for dv in eng.pset.devices]
    want_k = CLUSTER_WANTED[path]
    missing = [k for k in want_k if launches[k] == 0]
    if missing or (path == "x" and ladder_k2 == 0):
        raise AssertionError(f"main path ({path}) launched no {missing or 'host-ladder K2'}")

    def points(engine):
        return engine.pset.global_merge_stats(emit_points=True)[3]

    flat = SkylineEngine(_config(base, n))
    with rank_gate(False, env):
        for i in range(0, n, 65536):
            flat.process_records(ids[i : i + 65536], xs[-1][i : i + 65536])
        flat.process_trigger("0,0")
        flat.poll_results()
        if _sorted_bytes(points(flat)) != _sorted_bytes(points(eng)):
            raise AssertionError(f"main path ({path}): the answer differs from the flat engine's")
    check_answer(torch, np, warm[2], np.asarray(warm[1]["skyline_points"], np.float32), dev)
    summary = {
        "base": base, "hosts": hosts, "chips_per_host": chips, "rows_per_window": n,
        "windows_measured": windows, "tuples_per_s": n * windows / sum(lat),
        "p50_window_ms": float(np.median(lat)) * 1e3,
        "p50_flush_ms": float(np.median([r["flush_ms"] for r in rows])),
        "p50_merge_ms": float(np.median([r["merge_ms"] for r in rows])),
        "p50_host_ms": float(np.median([r["host_ms"] for r in rows])),
        "p50_cross_host_ms": float(np.median([r["cross_host_ms"] for r in rows])),
        "hosts_pruned_per_merge": [r["hosts_pruned"] for r in rows],
        "rows_shipped_per_merge": [r["rows_shipped"] for r in rows],
        "rows_saved_per_merge": [r["rows_saved"] for r in rows],
        "warm_window_ms": warm[0] * 1e3, "windows": rows, "launches": launches,
        "launches_per_window": {k: v / (windows + 1) for k, v in launches.items()},
        "ladder_k2_launches": ladder_k2, "ladder_pairs": ladder_pairs,
        "devices": devices, "cluster_stats": untimed(stats), "merge_env": env,
    }
    log(f"main ({path}): {summary['tuples_per_s']:.0f} tuples/s, p50 window "
        f"{summary['p50_window_ms']:.1f} ms (flush {summary['p50_flush_ms']:.1f}, merge "
        f"{summary['p50_merge_ms']:.1f}: hosts {summary['p50_host_ms']:.1f}, cross-host "
        f"{summary['p50_cross_host_ms']:.1f}) over {windows} windows of {n} rows, {hosts} hosts "
        f"x {chips} chips on {devices}; hosts pruned per merge "
        f"{summary['hosts_pruned_per_merge']}, rows shipped {summary['rows_shipped_per_merge']}"
        f" saved {summary['rows_saved_per_merge']}; launches over {windows + 1} windows "
        f"{({k: launches[k] for k in want_k})}, host-ladder K2 {ladder_k2} ({ladder_pairs} "
        "pairs); the last answer = the flat engine's (a sorted set)")
    if base_runs and base in base_runs:
        b = base_runs[base][0]
        summary["beside_" + base] = {"p50_window_ms": b["p50_window_ms"],
                                     "tuples_per_s": b["tuples_per_s"],
                                     "ratio": summary["p50_window_ms"] / b["p50_window_ms"]}
        log(f"main ({path}) beside ({base}): p50 {summary['p50_window_ms']:.1f} ms vs "
            f"{b['p50_window_ms']:.1f} ms ({summary['p50_window_ms'] / b['p50_window_ms']:.3f}x), "
            f"{summary['tuples_per_s']:.0f} vs {b['tuples_per_s']:.0f} tuples/s")
    return summary, heavy


def host_ladder_k2(torch, np, heavy: dict, summary: dict) -> dict:
    """K2 at the host level: the heaviest host-ladder pair over (x)'s
    windows (host roots on the root device), its two calls as
    ``tree_pair_k2`` times them, with (x)'s ladder K2 launches a window."""
    if heavy.get("a") is None:
        raise AssertionError("(x) merged no host-ladder pair")
    out = _time_tree_pair(torch, heavy["a"], heavy["acnt"], heavy["b"], heavy["bcnt"],
                          "K2 host-ladder pair")
    out["launches"] = summary["ladder_k2_launches"]
    out["launches_per_window"] = out["launches"] / (summary["windows_measured"] + 1)
    out["devices"] = summary["devices"]
    log(f"timings: K2 host-ladder pair ({out['valid_a_rows']} a rows, {out['valid_b_rows']} b "
        f"rows) {out['pair_ms']:.3f} ms, {out['launches_per_window']:.1f} host-ladder K2 "
        "launches per window on (x)")
    return out


# the worker's paths: (t) over the wire, (u) the crash drill
# -- the device mesh: MESH_PARITY and the paths (z), (z2) ----------------------

# place counts of the two-phase and the pipeline; the 1,048,576-row
# north-star window they run on the card against the flat mask; the window
# they run on the card and the CPU, bit for bit (the CPU's blocked mask is
# O(N^2) on the north-star's zero rows: minutes at the full window)
MESH_PLACES = (1, 2, 4, 8)
MESH_WINDOW_ROWS = 1 << 20
MESH_CPU_ROWS = 8192
# (hosts, chips) of the hierarchical step; its overflowing host_cap is an
# eighth of a host's rows (65,536 of the 1M window's 524,288)
MESH_HIER = ((2, 2), (2, 4))
# the meshed engine: three policies at d = 8, two 65,536-row windows, P = 8,
# on the card at 2 and 4 places against the flat engine on the card; and two
# 4,096-row windows at 4 places on the card against the CPU (child processes
# beside the card side: a meshed set takes no flush race and no sequential
# rounds, so the CPU's plain batched K1 over every partition lane cost ~60 s
# a configuration at 8,192 rows)
MESH_PARITY = (
    ("lazy d=8", dict(NORTH_STAR, ingest="host"), "uniform"),
    ("incremental d=8", dict(NORTH_STAR, ingest="host", flush_policy="incremental"),
     "uniform"),
    ("overlap d=8", dict(NORTH_STAR, ingest="host", flush_policy="overlap",
                         overlap_rows=32768), "uniform"),
)
MESH_PARITY_ROWS = 65536
MESH_CPU_ENGINE_ROWS = 4096
MESH_ENGINE_PLACES = (2, 4)
MESH_CPU_PLACES = 4
# the sliding engine over a mesh: 8-D, window 16,384, slide 4,096 (K3 on the
# card: K * C >= 8,192), 32,768 rows
MESH_SLIDING = dict(parallelism=4, algo="mr-angle", dims=8, domain_max=10000.0)
MESH_SLIDING_ROWS = 32768
MESH_PATHS = {"z": ("c", 4), "z2": ("d", 4)}
MESH_WANTED = {"z": MP_ROUNDS + ("skyline_mask_kernel", "dominated_by_rect"),
               "z2": (PREDROP_FUSED, MP_PATH[1], "skyline_mask_kernel", "dominated_by_rect")}

NCCL_RANK = """
import sys
import numpy as np
import torch
rank, cards, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
chips = max(1, cards // 2)
torch.cuda.set_device(rank * chips % cards)
from skyline_tpu_torch.parallel.multihost import (
    build_hierarchical_two_phase, init_multihost, make_host_chip_mesh)
init_multihost(device="cuda")
mesh = make_host_chip_mesh(chips_per_host=chips, device="cuda")
x = np.load(sys.argv[4])
res = {"devices": np.array([str(d) for d in mesh.places])}
for tag, cap in (("exact", None), ("capped", 1024)):
    step = build_hierarchical_two_phase(mesh, rows_per_shard=x.shape[0] // mesh.size,
                                        host_cap=cap)
    hk, gk, ov = step(x, np.ones(x.shape[0], dtype=bool))
    res["hk_" + tag], res["gk_" + tag] = hk.cpu().numpy(), gk.cpu().numpy()
    res["ov_" + tag] = int(ov)
np.savez(out, **res)
torch.distributed.destroy_process_group()
"""


def _mesh_window(np, rows: int, seed: int = 23):
    from skyline_tpu_torch.workload.generators import anti_correlated

    return anti_correlated(np.random.default_rng(seed), rows, 8, 0, 10000)


def _mesh_small(torch, np, x, dev: str) -> dict:
    """The two-phase at every place count, the pipeline and the
    hierarchical step (exact and with an overflowing host_cap) on ``x``
    with every place on ``dev``: every output as host arrays."""
    from skyline_tpu_torch.parallel.mesh import build_two_phase, make_mesh
    from skyline_tpu_torch.parallel.multihost import (
        build_hierarchical_two_phase, make_host_chip_mesh)
    from skyline_tpu_torch.parallel.pipeline import build_window_pipeline

    n = x.shape[0]
    valid = np.ones(n, dtype=bool)
    out = {}
    for k in MESH_PLACES:
        lk, gk = build_two_phase(make_mesh(k, device=dev))(x, valid)
        out[f"two_phase_{k}"] = (lk.cpu().numpy(), gk.cpu().numpy())
        g, lc, gc, order = build_window_pipeline(make_mesh(k, device=dev),
                                                 domain_max=10000.0)(
            torch.from_numpy(x).to(dev), torch.from_numpy(valid).to(dev))
        out[f"pipeline_{k}"] = (g.cpu().numpy(), int(lc), int(gc), order.cpu().numpy())
    for hosts, chips in MESH_HIER:
        mesh = make_host_chip_mesh(hosts, chips, places=hosts * chips, device=dev)
        for cap in (None, 1024):
            hk, gk, ov = build_hierarchical_two_phase(
                mesh, rows_per_shard=n // mesh.size, host_cap=cap)(x, valid)
            out[f"hier_{hosts}x{chips}_{cap}"] = (hk.cpu().numpy(), gk.cpu().numpy(), int(ov))
    return out


def _same_outputs(a: dict, b: dict) -> list:
    """Keys whose outputs differ (arrays by bytes, counts by value)."""
    bad = []
    for key in a:
        if len(a[key]) != len(b[key]) or any(
            (u.tobytes() != v.tobytes()) if hasattr(u, "tobytes") else u != v
            for u, v in zip(a[key], b[key])
        ):
            bad.append(key)
    return bad


def _mesh_cpu_side(job):
    """One ``MESH_PARITY`` job on the CPU, in a child process: the small
    window's outputs, or a meshed engine's windows."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    kind = job[0]
    t0 = time.perf_counter()
    if kind == "small":
        return kind, None, _mesh_small(torch, np, _mesh_window(np, MESH_CPU_ROWS), "cpu"), \
            time.perf_counter() - t0
    _, name, cfg, gen, places, rows = job
    # the card's default: the bf16 passes on, so the cascade counters compare
    os.environ["SKYLINE_MIXED_PRECISION"] = "1"
    from skyline_tpu_torch.parallel.mesh import make_mesh
    from skyline_tpu_torch.stream import EngineConfig

    ecfg = EngineConfig(**cfg, window_capacity=rows, emit_skyline_points=True, device="cpu")
    out, stats = _drive_meshed(ecfg, _cluster_windows(gen, cfg["dims"], rows),
                               make_mesh(places, device="cpu"))
    return kind, name, (out, stats), time.perf_counter() - t0


def _drive_meshed(cfg, windows, mesh, chunk=8192):
    """Windows back to back through one engine (over ``mesh``, or flat when
    it is None), a trigger after each: per window the results (timings
    aside), each partition's skyline bytes' sha1 and the answer's points'
    sha1 (rows and order). Returns (windows, ``stats()`` untimed, with the
    backend aside)."""
    import numpy as np

    from skyline_tpu_torch.stream import SkylineEngine

    eng = SkylineEngine(cfg, mesh=mesh)
    out, base = [], 0
    for i, x in enumerate(windows):
        ids = np.arange(base, base + x.shape[0], dtype=np.int64)
        base += x.shape[0]
        for s in range(0, x.shape[0], chunk):
            eng.process_records(ids[s : s + chunk], x[s : s + chunk])
        eng.process_trigger(f"q{i},0")
        res = eng.poll_results()
        pts = np.asarray(res[0].pop("skyline_points", []), np.float32) if res else None
        out.append({
            "results": [untimed(r) for r in res],
            "points_sha1": None if pts is None else _points_sha1(pts),
            "partitions_sha1": [_points_sha1(eng.pset.skyline_host(p))
                                for p in range(eng.config.num_partitions)],
        })
    return out, untimed(eng.stats(include_skyline_counts=True), drop=("backend",))


def _meshed_sliding(torch, np, x, device: str, places):
    from skyline_tpu_torch.parallel.mesh import make_mesh
    from skyline_tpu_torch.stream import EngineConfig
    from skyline_tpu_torch.stream.sliding_engine import SlidingEngine

    mesh = None if places is None else make_mesh(places, device=device)
    eng = SlidingEngine(EngineConfig(**MESH_SLIDING, emit_skyline_points=True, device=device),
                        window_size=16384, slide=4096, mesh=mesh, emit_per_slide=True)
    ids = np.arange(x.shape[0], dtype=np.int64)
    for i in range(0, x.shape[0], 3000):
        eng.process_records(ids[i : i + 3000], x[i : i + 3000], now_ms=1.0)
    eng.process_trigger("end,0", now_ms=2.0)
    res = eng.poll_results()
    return ([(r["skyline_size"], r["window_filled"],
              np.asarray(r["skyline_points"], np.float32).tobytes()) for r in res],
            eng.stats()["mask_kernel"])


def _mesh_checkpoint(torch, np, dev: str, tmp: Path) -> dict:
    """A meshed engine saved on four places, restored flat, saved and
    restored on two places: each step's next answer equals the
    uninterrupted flat engine's (bytes and order)."""
    from skyline_tpu_torch.parallel.mesh import make_mesh
    from skyline_tpu_torch.stream import EngineConfig, SkylineEngine
    from skyline_tpu_torch.utils.checkpoint import load_engine, save_engine

    cfg = EngineConfig(**dict(NORTH_STAR, ingest="host"), emit_skyline_points=True, device=dev)
    xs = _cluster_windows("uniform", 8, 32768)
    whole = SkylineEngine(cfg)
    eng = SkylineEngine(cfg, mesh=make_mesh(4, device=dev))
    tmp.mkdir(parents=True, exist_ok=True)
    steps = []

    def feed(e, x, base, q):
        ids = np.arange(base, base + x.shape[0], dtype=np.int64)
        for s in range(0, x.shape[0], 8192):
            e.process_records(ids[s : s + 8192], x[s : s + 8192])
        e.process_trigger(f"{q},0")
        return np.asarray(e.poll_results()[0]["skyline_points"], np.float32).tobytes()

    feed(eng, xs[0][:16384], 0, "a")
    feed(whole, xs[0][:16384], 0, "a")
    save_engine(eng, str(tmp / "m4.npz"))
    flat = load_engine(str(tmp / "m4.npz"), device=dev)
    steps.append(feed(flat, xs[0][16384:], 16384, "b") == feed(whole, xs[0][16384:], 16384, "b"))
    save_engine(flat, str(tmp / "flat.npz"))
    m2 = load_engine(str(tmp / "flat.npz"), mesh=make_mesh(2, device=dev))
    steps.append(feed(m2, xs[1], 32768, "c") == feed(whole, xs[1], 32768, "c"))
    if not all(steps) or flat.mesh is not None or m2.mesh is None:
        raise AssertionError(f"mesh: the checkpoint across topologies differs: {steps}")
    return {"steps": ["mesh 4 -> flat", "flat -> mesh 2"], "equal": steps}


def _nccl_ranks(torch, np, x, tmp: Path) -> dict:
    """Two ranks over NCCL, one host each (a card per rank): the joined
    masks and the overflow against the one-process step on the card."""
    import socket

    from skyline_tpu_torch.parallel.multihost import (
        build_hierarchical_two_phase, make_host_chip_mesh)

    cards = torch.cuda.device_count()
    chips = max(1, cards // 2)
    tmp.mkdir(parents=True, exist_ok=True)
    np.save(tmp / "x.npy", x)
    (tmp / "rank.py").write_text(NCCL_RANK)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), SKYLINE_COORDINATOR=f"127.0.0.1:{port}",
                   SKYLINE_NUM_PROCESSES="2", SKYLINE_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(tmp / "rank.py"), str(rank), str(cards),
             str(tmp / f"r{rank}.npz"), str(tmp / "x.npy")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=240)[0].decode()[-2000:] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"mesh: an NCCL rank failed: {logs}")
    ranks = [np.load(tmp / f"r{r}.npz") for r in range(2)]
    mesh = make_host_chip_mesh(2, chips, places=2 * chips, device="cuda")
    out = {"chips_per_host": chips, "devices": [str(d) for d in ranks[0]["devices"]]}
    for tag, cap in (("exact", None), ("capped", 1024)):
        hk, gk, ov = build_hierarchical_two_phase(
            mesh, rows_per_shard=x.shape[0] // mesh.size, host_cap=cap)(
            x, np.ones(x.shape[0], dtype=bool))
        joined = (np.concatenate([r["hk_" + tag] for r in ranks]),
                  np.concatenate([r["gk_" + tag] for r in ranks]))
        if (joined[0].tobytes() != hk.cpu().numpy().tobytes()
                or joined[1].tobytes() != gk.cpu().numpy().tobytes()
                or [int(r["ov_" + tag]) for r in ranks] != [int(ov)] * 2):
            raise AssertionError(f"mesh: two NCCL ranks ({tag}) differ from one process")
        out[tag] = {"overflowed": int(ov), "global": int(gk.sum())}
    return out


def check_mesh_parity(torch, np, devices=("cuda", "cpu")) -> dict:
    """``MESH_PARITY`` (leg ``mesh``). On the card: the two-phase
    (``skyline_keep_np_sharded``) at 1, 2, 4 and 8 places and the window
    pipeline (its mask mapped back through ``order``) on a 1,048,576-row
    north-star window against the flat ``skyline_keep_np``; the
    hierarchical step at 2x2 and 2x4 exact (= flat) and with an overflowing
    ``host_cap`` (a superset, the overflow counted). Card against the CPU
    (a child process) on an 8,192-row window: every output of the
    two-phase, the pipeline and the hierarchical step bit for bit. The
    meshed engine (``MESH_PARITY``: lazy, incremental and overlap at d = 8,
    two 65,536-row windows, P = 8) at 2 and 4 places on the card against
    the flat engine on the card (results, partition skylines, answer
    sha1), and at 4 places over two 4,096-row windows against the CPU (and
    ``stats()`` untimed); the
    sliding engine at 2 and 4 places against its flat form on the card and
    the CPU; the checkpoint across topologies (4 places -> flat -> 2
    places). With two or more cards, two NCCL ranks (one host each) against
    the one-process step; with fewer, a line says it did not run."""
    import concurrent.futures
    import multiprocessing

    from skyline_tpu_torch.ops.dispatch import skyline_keep_np
    from skyline_tpu_torch.parallel.mesh import make_mesh, skyline_keep_np_sharded
    from skyline_tpu_torch.parallel.multihost import (
        build_hierarchical_two_phase, make_host_chip_mesh)
    from skyline_tpu_torch.parallel.pipeline import build_window_pipeline
    from skyline_tpu_torch.stream import EngineConfig

    card, cpu = devices
    n_cards = torch.cuda.device_count() if card != "cpu" else 0
    out = {"cards": n_cards, "places": {str(k): [str(d) for d in make_mesh(k, device=card).places]
                                        for k in MESH_PLACES}}
    if n_cards == 1:
        log("mesh: one card visible: every place of every mesh is cuda:0")
    t_leg = time.perf_counter()
    jobs = [("small",)] + [("engine", name, cfg, gen, MESH_CPU_PLACES, MESH_CPU_ENGINE_ROWS)
                           for name, cfg, gen in MESH_PARITY]
    with concurrent.futures.ProcessPoolExecutor(
            len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_mesh_cpu_side, job) for job in jobs]
        try:
            # the full window on the card against the flat mask
            x = _mesh_window(np, MESH_WINDOW_ROWS)
            t0 = time.perf_counter()
            flat = skyline_keep_np(x, card)
            flat_ms = (time.perf_counter() - t0) * 1e3
            full = {"rows": MESH_WINDOW_ROWS, "skyline": int(flat.sum()), "flat_ms": flat_ms}
            for k in MESH_PLACES:
                mesh = make_mesh(k, device=card)
                skyline_keep_np_sharded(mesh, x)  # warm
                _sync_all(torch)
                t0 = time.perf_counter()
                keep = skyline_keep_np_sharded(mesh, x)
                ms = (time.perf_counter() - t0) * 1e3
                if keep.tobytes() != flat.tobytes():
                    raise AssertionError(f"mesh: the two-phase at {k} places differs from the "
                                         "flat mask on the 1M window")
                g, lc, gc, order = build_window_pipeline(mesh, domain_max=10000.0)(
                    torch.from_numpy(x).to(card),
                    torch.ones(x.shape[0], dtype=torch.bool, device=card))
                back = torch.empty_like(g)
                back[order] = g
                if back.cpu().numpy().tobytes() != flat.tobytes() or int(gc) != int(flat.sum()):
                    raise AssertionError(f"mesh: the pipeline at {k} places differs from the "
                                         "flat mask")
                full[f"places_{k}"] = {"keep_np_sharded_ms": ms, "pipeline_local": int(lc),
                                       "pipeline_global": int(gc)}
                log(f"mesh: {k} places on {out['places'][str(k)]}: two-phase = flat "
                    f"skyline_keep_np on {MESH_WINDOW_ROWS} rows ({ms:.1f} ms against flat "
                    f"{flat_ms:.1f} ms); pipeline = flat, local {int(lc)}, global {int(gc)}")
            for hosts, chips in MESH_HIER:
                cap = MESH_WINDOW_ROWS // hosts // 8
                mesh = make_host_chip_mesh(hosts, chips, places=hosts * chips, device=card)
                step = build_hierarchical_two_phase(
                    mesh, rows_per_shard=MESH_WINDOW_ROWS // mesh.size)
                _, gk, ov = step(x, np.ones(x.shape[0], dtype=bool))
                if gk.cpu().numpy().tobytes() != flat.tobytes() or int(ov):
                    raise AssertionError(f"mesh: hierarchical {hosts}x{chips} exact differs")
                capped = build_hierarchical_two_phase(
                    mesh, rows_per_shard=MESH_WINDOW_ROWS // mesh.size, host_cap=cap)
                _, gc_, ovc = capped(x, np.ones(x.shape[0], dtype=bool))
                gc_ = gc_.cpu().numpy()
                if not gc_[flat].all() or int(ovc) == 0:
                    raise AssertionError(f"mesh: hierarchical {hosts}x{chips} capped at {cap} "
                                         f"is no superset or did not overflow ({int(ovc)})")
                full[f"hier_{hosts}x{chips}"] = {"host_cap": cap, "overflowed": int(ovc),
                                                 "capped_global": int(gc_.sum())}
                log(f"mesh: hierarchical {hosts}x{chips}: exact = flat; host_cap {cap}: "
                    f"{int(ovc)} participants overflowed, {int(gc_.sum())} kept against "
                    f"{int(flat.sum())} (a superset)")
            out["full_window"] = full
            # the small window on the card, against the CPU below
            small_card = _mesh_small(torch, np, _mesh_window(np, MESH_CPU_ROWS), card)
            # the meshed engine on the card against the flat engine on the card
            engines = {}
            for name, cfg, gen in MESH_PARITY:
                windows = _cluster_windows(gen, cfg["dims"], MESH_PARITY_ROWS)
                ecfg = EngineConfig(**cfg, window_capacity=MESH_PARITY_ROWS,
                                    emit_skyline_points=True, device=card)
                t0 = time.perf_counter()
                want, _ = _drive_meshed(ecfg, windows, None)
                engines[name] = {}
                for k in MESH_ENGINE_PLACES:
                    got, stats = _drive_meshed(ecfg, windows, make_mesh(k, device=card))
                    if got != want:
                        raise AssertionError(f"mesh {name}: {k} places differ from the flat "
                                             "engine on the card")
                    log(f"mesh {name}: {k} places = the flat engine on the card (results, "
                        f"partition skylines, answer sha1 "
                        f"{[w['points_sha1'][:12] for w in got]})")
                small = EngineConfig(**cfg, window_capacity=MESH_CPU_ENGINE_ROWS,
                                     emit_skyline_points=True, device=card)
                engines[name] = _drive_meshed(
                    small, _cluster_windows(gen, cfg["dims"], MESH_CPU_ENGINE_ROWS),
                    make_mesh(MESH_CPU_PLACES, device=card))
                out.setdefault("engine", {})[name] = {
                    "rows_per_window": MESH_PARITY_ROWS, "windows": 2,
                    "card_s": time.perf_counter() - t0}
            # the sliding engine over a mesh
            xs = _mesh_window(np, MESH_SLIDING_ROWS, seed=31)
            slid_flat, branch = _meshed_sliding(torch, np, xs, card, None)
            for k in (2, 4):
                got, kb = _meshed_sliding(torch, np, xs, card, k)
                if got != slid_flat:
                    raise AssertionError(f"mesh: the sliding engine at {k} places differs")
            slid_cpu, _ = _meshed_sliding(torch, np, xs, cpu, 4)
            if slid_cpu != slid_flat:
                raise AssertionError("mesh: the sliding engine at 4 places on the CPU differs")
            out["sliding"] = {"results": len(slid_flat), "branch": kb}
            log(f"mesh: sliding engine at 2 and 4 places = flat on the card and 4 places on "
                f"the CPU, {len(slid_flat)} results, the slide step's branch {kb!r}")
            out["checkpoint"] = _mesh_checkpoint(torch, np, card, WORKER_RUNS / "mesh_ckpt")
            log("mesh: checkpoint across topologies (4 places -> flat -> 2 places) = the "
                "uninterrupted flat engine")
            t1 = time.perf_counter()
            for f in concurrent.futures.as_completed(futures):
                kind, name, res, secs = f.result()
                if kind == "small":
                    bad = _same_outputs(small_card, res)
                    if bad:
                        raise AssertionError(f"mesh: the CPU differs from the card on {bad}")
                    out["small_cpu_s"] = secs
                    log(f"mesh: {MESH_CPU_ROWS}-row window: two-phase (1, 2, 4, 8 places, "
                        f"local and global masks), pipeline (mask, counts, order) and "
                        f"hierarchical (host and global masks, overflow; exact and host_cap "
                        f"1024) on the CPU = the card ({secs:.1f} s on the CPU)")
                    continue
                got, stats = res
                card_got, card_stats = engines[name]
                if got != card_got:
                    raise AssertionError(f"mesh {name}: {MESH_CPU_PLACES} places on the CPU "
                                         "differ from the card")
                if stats != card_stats:
                    keys = sorted(k for k in set(stats) | set(card_stats)
                                  if stats.get(k) != card_stats.get(k))
                    raise AssertionError(f"mesh {name}: stats() on the CPU differs from the "
                                         f"card's in {keys}")
                out["engine"][name]["cpu_s"] = secs
                log(f"mesh {name}: {MESH_CPU_PLACES} places on the CPU = the card over two "
                    f"{MESH_CPU_ENGINE_ROWS}-row windows (results, partition skylines, answer "
                    f"sha1, stats()) in {secs:.1f} s")
            out["cpu_wait_s"] = time.perf_counter() - t1
        except BaseException:
            pool.shutdown(wait=True, cancel_futures=True)
            raise
    if n_cards >= 2:
        out["nccl"] = _nccl_ranks(torch, np, _mesh_window(np, MESH_CPU_ROWS),
                                  WORKER_RUNS / "mesh_nccl")
        log(f"mesh: two NCCL ranks (one host each) = the one-process step: {out['nccl']}")
    else:
        out["nccl"] = None
        log(f"mesh: the two-process NCCL form did not run: {n_cards} card visible, and NCCL "
            "needs a card of its own per rank")
    out["wall_s"] = time.perf_counter() - t_leg
    log(f"mesh: parity leg done in {out['wall_s']:.1f} s (waited {out['cpu_wait_s']:.1f} s "
        "for the CPU side)")
    return out


@contextlib.contextmanager
def mesh_watch(torch):
    """For the duration, every call of the mesh's two phases
    (``parallel/mesh.py``'s ``skyline_mask_blocked``, the local phase, and
    ``dominated_by_blocked``, the cross prune) is counted with the K3 and
    K2 launches it made and the device it ran on, and each two-phase merge
    timed (synchronised); every meshed flush step (``meshed_sfs_round``,
    ``meshed_merge_step``: all places' partitions) is timed by CUDA events
    on the state's card, with the launches it made by kernel. With
    ``rec["probe"]`` set (a window outside the measured ones), each
    place's inputs to the last two-phase merge are kept (cloned), the
    heaviest meshed merge step's inputs too, and each meshed step is split
    by synchronised host clocks into its cores, its copies between cards
    (``gather_to`` of the step's inputs and outputs, ``Placed.split`` of a
    state read whole since the last step) and the rest (slicing and
    concatenation). Yields the record."""
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.parallel import mesh as mesh_mod
    from skyline_tpu_torch.stream import batched as batched_mod
    from skyline_tpu_torch.stream import window as window_mod

    real_local, real_cross = mesh_mod.skyline_mask_blocked, mesh_mod.dominated_by_blocked
    real_keep = mesh_mod.skyline_keep_np_sharded
    real_steps = {"meshed_sfs_round": batched_mod.meshed_sfs_round,
                  "meshed_merge_step": batched_mod.meshed_merge_step}
    real_cores = {k: getattr(window_mod, k)
                  for k in ("sfs_round", "merge_step_active", "sfs_cleanup")}
    real_gather = window_mod.gather_to
    real_split = mesh_mod.Placed.split.__func__
    rec = {"local_calls": 0, "cross_calls": 0, "k3": 0, "k2": 0, "devices": set(),
           "merge_ms": [], "probe": False, "local": [], "cross": [], "merge_round": None,
           "split": {k: [] for k in real_steps}, "_split": None,
           "steps": {k: {"events": [], "launches": {}} for k in real_steps}}

    def synced(fn, key):
        def run(*a, **kw):
            if rec["_split"] is None:
                return fn(*a, **kw)
            _sync_all(torch)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync_all(torch)
            rec["_split"][key] += (time.perf_counter() - t0) * 1e3
            return out

        return run

    def keep_round(active, ins):
        sky, sky_valid, batch, bvalid = ins
        if isinstance(sky, mesh_mod.Placed):
            sky = sky.gather(sky_valid.device)
        work = int(bvalid.sum()) * (batch.shape[1] + 2 * active)
        best = rec["merge_round"]
        if best is None or work >= best["work"]:
            rec["merge_round"] = dict(
                work=work, active=active, sky=sky[:, :active].clone(),
                sky_valid=sky_valid[:, :active].clone(), batch=batch.clone(),
                bvalid=bvalid.clone())

    def timed(name, factory):
        def make(*a, **kw):
            fn = factory(*a, **kw)

            def run(*ins):
                if rec["probe"]:
                    if name == "meshed_merge_step":
                        keep_round(a[2], ins)
                    rec["_split"] = {"core_ms": 0.0, "copy_ms": 0.0}
                    _sync_all(torch)
                    t0 = time.perf_counter()
                    out = fn(*ins)
                    _sync_all(torch)
                    split, rec["_split"] = rec["_split"], None
                    split["step_ms"] = (time.perf_counter() - t0) * 1e3
                    split["rest_ms"] = split["step_ms"] - split["core_ms"] - split["copy_ms"]
                    rec["split"][name].append(split)
                    return out
                timing = ins[1].device.type == "cuda"
                if timing:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                before = dict(dk.LAUNCHES)
                out = fn(*ins)
                step = rec["steps"][name]
                if timing:
                    end.record()
                    step["events"].append((start, end))
                for k, v in dk.LAUNCHES.items():
                    if v - before[k]:
                        step["launches"][k] = step["launches"].get(k, 0) + v - before[k]
                return out

            return run

        return make

    def local(x, valid=None, block=2048):
        k0 = dk.LAUNCHES["skyline_mask_kernel"]
        out = real_local(x, valid, block=block)
        rec["k3"] += dk.LAUNCHES["skyline_mask_kernel"] - k0
        rec["local_calls"] += 1
        rec["devices"].add(str(x.device))
        if rec["probe"]:
            rec["local"].append((x.clone(), valid.clone()))
        return out

    def cross(y, x, x_valid=None, block=8192, y_valid=None, mp=False):
        k0 = dk.LAUNCHES["dominated_by_rect"]
        out = real_cross(y, x, x_valid=x_valid, block=block, y_valid=y_valid, mp=mp)
        rec["k2"] += dk.LAUNCHES["dominated_by_rect"] - k0
        rec["cross_calls"] += 1
        if rec["probe"]:
            rec["cross"].append((y.clone(), x.clone(), x_valid.clone()))
        return out

    def keep(mesh, x, **kw):
        if rec["probe"]:  # the last merge's inputs, one entry a place
            rec["local"], rec["cross"] = [], []
        _sync_all(torch)
        t0 = time.perf_counter()
        out = real_keep(mesh, x, **kw)
        _sync_all(torch)
        rec["merge_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    from skyline_tpu_torch.stream import engine as engine_mod

    real_engine_keep = engine_mod.skyline_keep_np_sharded
    mesh_mod.skyline_mask_blocked, mesh_mod.dominated_by_blocked = local, cross
    engine_mod.skyline_keep_np_sharded = keep
    for name, factory in real_steps.items():
        setattr(batched_mod, name, timed(name, factory))
    for name, fn in real_cores.items():
        setattr(window_mod, name, synced(fn, "core_ms"))
    window_mod.gather_to = synced(real_gather, "copy_ms")
    mesh_mod.Placed.split = classmethod(synced(real_split, "copy_ms"))
    try:
        yield rec
    finally:
        mesh_mod.skyline_mask_blocked, mesh_mod.dominated_by_blocked = real_local, real_cross
        engine_mod.skyline_keep_np_sharded = real_engine_keep
        for name, factory in real_steps.items():
            setattr(batched_mod, name, factory)
        for name, fn in real_cores.items():
            setattr(window_mod, name, fn)
        window_mod.gather_to = real_gather
        mesh_mod.Placed.split = classmethod(real_split)
        _sync_all(torch)
        for name, step in rec["steps"].items():
            ms = [a.elapsed_time(b) for a, b in step.pop("events")]
            step.update(calls=len(ms), mean_ms=(sum(ms) / len(ms)) if ms else None,
                        max_ms=max(ms) if ms else None)
            parts = rec["split"][name]
            step["probe_split"] = None if not parts else dict(
                {k: sum(p[k] for p in parts)
                 for k in ("step_ms", "core_ms", "copy_ms", "rest_ms")},
                calls=len(parts))


def mesh_path(torch, np, path: str, n: int, windows: int, base_runs=None, dev="cuda"):
    """Path (z) or (z2): its flat path's configuration and rows (the same
    seed) through a fresh ``SkylineEngine(mesh=make_mesh(4))`` a window,
    one warm window, ``windows`` measured and one probe window, launch
    counts set to 0 before and read after the measured ones. Each window
    prints its wall, the two-phase merge's wall (synchronised) and the rest
    (ingest, the meshed flush, the partials to the host), the skyline and
    the K3 and K2 launches of the two phases. The run fails unless the
    path's kernels launched, K3 and K2 among them inside the mesh's two
    phases, on the mesh's places. The last measured window's answer is
    held against the flat engine's on the same rows (``check_mesh_answer``);
    the warm answer passes the sampled checks. The probe window keeps each
    place's two-phase inputs and splits the meshed steps' time
    (``mesh_watch``). With the flat path's run in ``base_runs``, printed
    beside it."""
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.parallel.mesh import make_mesh
    from skyline_tpu_torch.stream import SkylineEngine
    from skyline_tpu_torch.workload.generators import anti_correlated

    base, places = MESH_PATHS[path]
    cfg, _, _, env = PATHS[base]
    d = cfg["dims"]
    rng = np.random.default_rng(0)
    ids = np.arange(n, dtype=np.int64)
    xs = [anti_correlated(rng, n, d, 0, 10000) for _ in range(windows + 2)]
    mesh = make_mesh(places, device=dev)
    lat, rows = [], []
    with rank_gate(False, env), mesh_watch(torch) as watch:
        dk.reset_launches()
        for w, x in enumerate(xs):
            probe = w == windows + 1
            if probe:
                launches = dict(dk.LAUNCHES)
                k3_all, k2_all = watch["k3"], watch["k2"]
                watch["probe"] = True
            eng = SkylineEngine(_config(base, n, emit_skyline_points=w == 0), mesh=mesh)
            k3, k2, m0 = watch["k3"], watch["k2"], len(watch["merge_ms"])
            _sync_all(torch)
            t0 = time.perf_counter()
            for i in range(0, n, 65536):
                eng.process_records(ids[i : i + 65536], x[i : i + 65536])
            eng.process_trigger("0,0")
            (res,) = eng.poll_results()
            _sync_all(torch)
            dt = time.perf_counter() - t0
            merge_ms = sum(watch["merge_ms"][m0:])
            row = {"window_ms": dt * 1e3, "merge_ms": merge_ms,
                   "rest_ms": dt * 1e3 - merge_ms, "skyline_size": res["skyline_size"],
                   "k3": watch["k3"] - k3, "k2": watch["k2"] - k2,
                   "local_sizes": eng.pset.sky_counts().tolist()}
            if w == 0:
                warm = (dt, res, x)
                log(f"main ({path}): warm window {dt * 1e3:.1f} ms, skyline "
                    f"{res['skyline_size']}; places {[str(p) for p in mesh.places]}")
                continue
            if probe:
                log(f"main ({path}): probe window (synchronised clocks, inputs kept) "
                    f"{dt * 1e3:.1f} ms, skyline {res['skyline_size']}")
                continue
            lat.append(dt)
            rows.append(row)
            last = (eng, res, x)
            log(f"main ({path}): window {w - 1}: {dt * 1e3:.1f} ms (two-phase merge "
                f"{merge_ms:.1f} ms, the rest {row['rest_ms']:.1f} ms), skyline "
                f"{res['skyline_size']}, two-phase K3 {row['k3']} and K2 {row['k2']} "
                f"launches; partitions' skylines {row['local_sizes']}")
        heavy = {"local": watch["local"], "cross": watch["cross"],
                 "merge_round": watch["merge_round"], "engine": last[0], "x": last[2]}
        seen = sorted(watch["devices"])
    steps = watch["steps"]
    want_k = MESH_WANTED[path]
    missing = [k for k in want_k if launches[k] == 0]
    if missing or k3_all == 0 or k2_all == 0:
        raise AssertionError(f"main path ({path}) launched no {missing or 'K3/K2 in the mesh'}")
    if seen != sorted({str(p) for p in mesh.places}):
        raise AssertionError(f"main path ({path}): the local phase ran on {seen}, not on the "
                             f"mesh's places {[str(p) for p in mesh.places]}")
    check_mesh_answer(np, path, base, env, n, last)
    check_answer(torch, np, warm[2], np.asarray(warm[1]["skyline_points"], np.float32), dev)
    summary = {
        "base": base, "places": [str(p) for p in mesh.places], "rows_per_window": n,
        "windows_measured": windows, "tuples_per_s": n * windows / sum(lat),
        "p50_window_ms": float(np.median(lat)) * 1e3,
        "p50_merge_ms": float(np.median([r["merge_ms"] for r in rows])),
        "p50_rest_ms": float(np.median([r["rest_ms"] for r in rows])),
        "warm_window_ms": warm[0] * 1e3, "windows": rows, "launches": launches,
        "launches_per_window": {k: v / (windows + 1) for k, v in launches.items()},
        "mesh_k3_launches": k3_all, "mesh_k2_launches": k2_all, "merge_env": env,
        "meshed_steps": steps,
    }
    log(f"main ({path}): {summary['tuples_per_s']:.0f} tuples/s, p50 window "
        f"{summary['p50_window_ms']:.1f} ms (two-phase merge {summary['p50_merge_ms']:.1f}, "
        f"the rest {summary['p50_rest_ms']:.1f}) over {windows} windows of {n} rows, "
        f"{places} places on {summary['places']}; launches over {windows + 1} windows "
        f"{({k: launches[k] for k in want_k})}, of them in the two phases K3 {k3_all} and K2 "
        f"{k2_all}")
    for name, step in steps.items():
        if step["calls"]:
            log(f"main ({path}): {name}: {step['calls']} calls in the warm and measured "
                f"windows, {step['mean_ms']:.3f} ms mean ({step['max_ms']:.3f} max) by CUDA "
                f"events, launches {step['launches']}")
        sp = step["probe_split"]
        if sp:
            log(f"main ({path}): {name} on the probe window, synchronised: {sp['calls']} "
                f"calls, {sp['step_ms']:.3f} ms in all = cores {sp['core_ms']:.3f} + copies "
                f"between cards {sp['copy_ms']:.3f} + the rest {sp['rest_ms']:.3f} ms")
    if base_runs and base in base_runs:
        b = base_runs[base][0]
        summary["beside_" + base] = {"p50_window_ms": b["p50_window_ms"],
                                     "tuples_per_s": b["tuples_per_s"],
                                     "ratio": summary["p50_window_ms"] / b["p50_window_ms"]}
        log(f"main ({path}) beside ({base}): p50 {summary['p50_window_ms']:.1f} ms vs "
            f"{b['p50_window_ms']:.1f} ms ({summary['p50_window_ms'] / b['p50_window_ms']:.3f}x), "
            f"{summary['tuples_per_s']:.0f} vs {b['tuples_per_s']:.0f} tuples/s")
    return summary, heavy


def check_mesh_answer(np, path, base, env, n, last) -> None:
    """The last measured window of (z)/(z2) against a flat engine on the
    same rows: the meshed trigger's size and optimality, each partition's
    skyline size, and the points the meshed engine itself emits on a
    second trigger (its host partials and two-phase merge again, the
    points kept), as a sorted set."""
    from skyline_tpu_torch.stream import SkylineEngine

    eng, res, x = last
    ids = np.arange(n, dtype=np.int64)
    flat = SkylineEngine(_config(base, n, emit_skyline_points=True))
    with rank_gate(False, env):
        for i in range(0, n, 65536):
            flat.process_records(ids[i : i + 65536], x[i : i + 65536])
        flat.process_trigger("0,0")
        (fres,) = flat.poll_results()
        eng.config.emit_skyline_points = True
        eng.process_trigger("1,0")
        (again,) = eng.poll_results()
    got = (res["skyline_size"], res["optimality"], eng.pset.sky_counts().tolist())
    want = (fres["skyline_size"], fres["optimality"], flat.pset.sky_counts().tolist())
    if got != want:
        raise AssertionError(f"main path ({path}): size, optimality and partitions' skylines "
                             f"{got} differ from the flat engine's {want}")
    mesh_pts = _sorted_bytes(np.asarray(again["skyline_points"], np.float32))
    flat_pts = _sorted_bytes(np.asarray(fres["skyline_points"], np.float32))
    if again["skyline_size"] != res["skyline_size"] or mesh_pts != flat_pts:
        raise AssertionError(f"main path ({path}): the emitted answer differs from the flat "
                             "engine's")
    log(f"main ({path}): the last window's answer = the flat engine's: {res['skyline_size']} "
        f"rows, optimality {res['optimality']!r}, partitions' skylines {got[2]}, the emitted "
        f"points as a sorted set (sha1 {_points_sha1(np.frombuffer(mesh_pts, np.uint8))})")


def _costliest(torch, np, rows, fn):
    """Time ``fn(*row)`` on every place's row, each under its own card's
    context: (index of the costliest, the ms of every place)."""
    ms = []
    for r in rows:
        with torch.cuda.device(r[0].device):
            ms.append(_event_ms(torch, lambda: fn(*r), reps=10))  # noqa: B023
    return int(np.argmax(ms)), ms


def mesh_site_timings(torch, np, heavy: dict, summary: dict) -> dict:
    """K3 in the two-phase's local phase (each place's shard of the padded
    union on the probe window: a quarter of it on (z)) and K2 in its cross
    prune (each place's rows against every place's gathered rows, the
    local survivors valid): every place timed by CUDA events on its own
    card; on the costliest place the plain version's ms, needed pairs, the
    bound and the skipped share; and (z)'s launches of each inside the two
    phases over its windows."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    out = {}
    at, place_ms = _costliest(torch, np, heavy["local"], dk.skyline_mask_kernel)
    x, v = heavy["local"][at]
    with torch.cuda.device(x.device):
        keep, ms, plain_ms, err = _time_pair(
            torch, lambda: dk.skyline_mask_kernel(x, v), lambda: dk.skyline_mask_plain(x, v),
            "K3 mesh local phase")
        order = torch.argsort(torch.where(v, x.sum(-1), float("inf")), stable=True)
        xs_t, vs = x[order].T.contiguous(), v[order]
        n, d = x.shape
        pairs = _needed_pairs(torch, xs_t, vs, xs_t, ~keep[order] & vs, vs)
        skip = dk.tile_skip_plain(xs_t[None], vs[None], xs_t[None], dk.TILE_ROWS,
                                  dk.BLOCK_VICTIMS)
    bound = ((n * d * 4 + 2 * n) / HBM_BYTES_S * 1e3, pairs * d / FP32_FLOPS * 1e3)
    out["local"] = {
        "ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "needed_pairs": pairs,
        "bound_ms": max(bound), "bound_by": "operations" if bound[1] >= bound[0] else "bytes",
        "skipped_share": float(skip.float().mean()), "shape": {"n": n, "d": d},
        "valid_rows": int(v.sum()), "launches": summary["mesh_k3_launches"],
        "launches_per_window": summary["mesh_k3_launches"] / (summary["windows_measured"] + 1),
        "place": at, "device": str(x.device), "place_ms": place_ms,
    }
    rect = [(g.T.contiguous(), gv, y.T.contiguous()) for y, g, gv in heavy["cross"]]
    at2, place_ms2 = _costliest(torch, np, rect, dk.dominated_by_rect)
    gt, gv, yt = rect[at2]
    with torch.cuda.device(gt.device):
        dom, ms2, plain2, err2 = _time_pair(
            torch, lambda: dk.dominated_by_rect(gt, gv, yt),
            lambda: dk.dominated_by_rect_plain(gt, gv, yt), "K2 mesh cross prune")
        wanted = torch.ones(yt.shape[1], dtype=torch.bool, device=yt.device)
        pairs2 = _needed_pairs(torch, gt, gv, yt, dom, wanted)
        skip2 = dk.tile_skip_plain(gt[None], gv[None], yt[None], dk.TILE_ROWS,
                                   dk.BLOCK_VICTIMS)
    nx, ny = gt.shape[1], yt.shape[1]
    bound2 = ((d * nx * 4 + nx + d * ny * 4 + ny) / HBM_BYTES_S * 1e3,
              pairs2 * d / FP32_FLOPS * 1e3)
    out["cross"] = {
        "ms": ms2, "plain_ms": plain2, "max_abs_err": err2, "needed_pairs": pairs2,
        "bound_ms": max(bound2), "bound_by": "operations" if bound2[1] >= bound2[0] else "bytes",
        "skipped_share": float(skip2.float().mean()), "shape": {"nx": nx, "ny": ny, "d": d},
        "valid_dominators": int(gv.sum()), "launches": summary["mesh_k2_launches"],
        "launches_per_window": summary["mesh_k2_launches"] / (summary["windows_measured"] + 1),
        "place": at2, "device": str(gt.device), "place_ms": place_ms2,
    }
    for key, what in (("local", "K3 mesh local phase"), ("cross", "K2 mesh cross prune")):
        r = out[key]
        log(f"timings: {what} {r['shape']}, costliest place {r['place']} on {r['device']}: "
            f"{r['ms']:.3f} ms (every place {[round(t, 4) for t in r['place_ms']]} ms; plain "
            f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['needed_pairs']} needed pairs, {r['skipped_share']:.6f} of (block, tile) "
            f"pairs skipped), {r['launches_per_window']:.1f} launches per window on (z)")
        if r["ms"] < r["bound_ms"]:
            raise AssertionError(f"{what} reads under its bound")
    return out


def mesh_flush_timings(torch, np, heavy: dict, summary: dict, path: str) -> dict:
    """The kernels of a meshed flush step on the path's own state: on (z)
    the SFS round's K1 mp and K2 mp (the heaviest partition's big block of
    the last measured window against its skyline prefix, as ``value_inputs``
    builds (c)'s) and its fused pre-drop (``predrop_timing``: P = 8
    partitions of 65,536 victims against 512 prefix rows); on (z2) the
    merge step's three K2 calls on the probe window's heaviest round
    (``incremental_k2``). Each with ms, the plain version's ms, the bound,
    the skipped share and the path's launches over its windows."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    launches, w = summary["launches"], summary["windows_measured"] + 1
    if path == "z2":
        with rank_gate(False):
            return {"merge_step_k2": incremental_k2(
                torch, np, 0, launches, w, r=heavy["merge_round"], path=path)}
    eng, x_last = heavy["engine"], heavy["x"]
    out = {}
    with rank_gate(False):
        ns = value_inputs(torch, np, eng, x_last)["north_star"]
        for name in MP_ROUNDS[1:]:
            got = _time_value_kernel(torch, dk, name, *ns)
            out[name] = _row(name, launches, w, got["err"], got["ms"], got["plain_ms"],
                             got["bound"], got["shape"], got["pairs"],
                             {"skipped_share": got["skipped_share"]})
        for row in predrop_timing(torch, np, eng, x_last, launches, w):
            if row["name"] == PREDROP_FUSED:
                out[PREDROP_FUSED] = row
    return out


# -- phase 7: the analysis gate ------------------------------------------------

# the kernels the graph audit's matrix launches on the card: K1 and K2 (f32
# and mp) in the SFS round and the merge step, the window pass and the scan
# in the device cascade, K3 in the merge-time mask at d > 2,
# the fused pre-drop in the rounds
AUDIT_WANTED = ("dominated_by_any", "dominated_by_any_mp", "dominated_by_rect",
                "dominated_by_rect_mp", "skyline_mask_kernel", PREDROP_FUSED,
                "cascade_windows", "cascade_windows_mp", "cascade_scan", "cascade_scan_mp")
AUDIT_CONFIGS = 22
SENTINEL_RUNS = ROOT / "skyline_tpu_torch" / "_build" / "sentinel"


def _sentinel_trajectory(directory: Path, values) -> None:
    """BENCH_r*.json rounds with ``values`` as their throughput, and one
    healthy MULTICHIP round, as the sentinel reads them."""
    import shutil

    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    for r, v in enumerate(values, start=1):
        doc = {"parsed": {"value": v, "backend": "cuda", "p50_window_latency_ms": 1e6 / v}}
        (directory / f"BENCH_r{r:02d}.json").write_text(json.dumps(doc))
    (directory / "MULTICHIP_r01.json").write_text(json.dumps(
        {"n_devices": 1, "rc": 0, "ok": True, "skipped": False, "tail": ""}))


def check_analysis(torch, np, dev="cuda") -> dict:
    """The port's analysis gate on the card: the backend probe (a child
    process; the verdict must be cuda with a device), the knob and lock
    lints over the port's tree (zero errors), the knob doc against the
    registry, the graph audit of the flush hot ops on ``dev`` (22
    configurations, zero errors; the kernels it launched, counted from 0,
    each of ``AUDIT_WANTED`` at least once) and the trajectory sentinel on a
    healthy (exit 0) and a drifting (exit 1) fixture trajectory."""
    import io

    from skyline_tpu_torch.analysis.__main__ import check_doc, run_passes
    from skyline_tpu_torch.analysis.findings import errors
    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.telemetry import sentinel
    from skyline_tpu_torch.utils import backend_probe

    out = {}
    t0 = time.perf_counter()
    verdict = backend_probe.probe_backend(backend_probe.probe_timeout_s(), use_cache=False)
    out["probe"] = verdict
    log(f"analysis: backend probe {verdict['backend']}, {verdict['n_devices']} device(s), "
        f"{verdict.get('name')} (capability {verdict.get('capability')}) in "
        f"{verdict['probe_total_s']} s; errors {verdict['errors'] or 'none'}")
    if verdict["backend"] != dev or verdict["n_devices"] < 1:
        raise AssertionError(f"analysis: the backend probe's verdict is {verdict}, not {dev} "
                             "with a device")

    lint, summary = run_passes(("knobs", "locks"), str(ROOT))
    for f in lint:
        log(f"analysis: {f.format()}")
    if errors(lint):
        raise AssertionError(f"analysis: the lints found {len(errors(lint))} error(s)")
    out["lints"] = summary
    log(f"analysis: knob lint {summary['knobs']['findings']} finding(s) over "
        f"{summary['knobs']['registry_size']} declared knobs, lock lint "
        f"{summary['locks']['findings']} finding(s)")
    with contextlib.redirect_stdout(io.StringIO()) as doc_out:
        doc_rc = check_doc(str(ROOT))
    if doc_rc:
        raise AssertionError(f"analysis: --check-doc exit {doc_rc}: {doc_out.getvalue()}")
    log(f"analysis: {doc_out.getvalue().strip()}")

    dk.reset_launches()
    t1 = time.perf_counter()
    graph, gsum = run_passes(("graph",), str(ROOT), device=dev)
    launches = {k: v for k, v in dk.LAUNCHES.items() if v}
    out["graph"] = {**gsum["graph"], "findings": [f.format() for f in graph],
                    "launches_counted": launches, "seconds": time.perf_counter() - t1}
    for f in graph:
        log(f"analysis: {f.format()}")
    log(f"analysis: graph audit on {gsum['graph']['card'] or dev}: {gsum['graph']['configs']} "
        f"configurations, {len(errors(graph))} error(s), {len(graph) - len(errors(graph))} "
        f"warning(s) in {out['graph']['seconds']:.1f} s; kernels "
        f"launched: {', '.join(f'{k} {v}' for k, v in launches.items())}")
    if gsum["graph"]["configs"] != AUDIT_CONFIGS:
        raise AssertionError(f"analysis: {gsum['graph']['configs']} configurations audited, "
                             f"not {AUDIT_CONFIGS}")
    if graph:
        raise AssertionError(f"analysis: the graph audit found {len(errors(graph))} error(s) "
                             f"and {len(graph) - len(errors(graph))} warning(s)")
    missing = [k for k in AUDIT_WANTED if not launches.get(k)]
    if missing:
        raise AssertionError(f"analysis: the graph audit launched no {missing}")

    runs = {}
    for name, values, want in (("healthy", (100.0, 110.0, 105.0, 112.0), 0),
                               ("drifting", (100.0, 98.0, 101.0, 99.0, 60.0), 1)):
        directory = SENTINEL_RUNS / name
        _sentinel_trajectory(directory, values)
        with contextlib.redirect_stdout(io.StringIO()) as so, \
                contextlib.redirect_stderr(io.StringIO()):
            rc = sentinel.main(["--dir", str(directory)])
        report = so.getvalue()
        runs[name] = {"exit": rc, "report": report.splitlines()}
        if rc != want or (want == 1) != ("REGRESSION" in report):
            raise AssertionError(f"analysis: the sentinel on the {name} trajectory exited {rc}, "
                                 f"not {want}:\n{report}")
        line = next(ln for ln in report.splitlines() if ln.strip().startswith("value"))
        log(f"analysis: sentinel on the {name} trajectory exit {rc}: {line.strip()}")
    out["sentinel"] = runs
    out["wall_s"] = time.perf_counter() - t0
    log(f"analysis: phase done in {out['wall_s']:.1f} s")
    return out


WORKER_PATHS = {
    "t": lambda torch, np, windows, profile: wire_path(torch, np, windows, profile),
    "u": lambda torch, np, windows, profile: crash_path(torch, np),
}


PARITY_LEGS = {
    "routing": ("routing_parity", lambda torch, np: check_routing(torch, np, "cuda")),
    "host": ("parity", lambda torch, np: check_parity(torch, np, PARITY_ROWS)),
    "device": ("device_parity", lambda torch, np: check_device_parity(torch, np,
                                                                      DEVICE_PARITY_ROWS)),
    "policy": ("policy_parity", check_policy_parity),
    "plane": ("plane_parity", check_plane_parity),
    "cascade": ("cascade_parity", check_cascade_parity),
    "race": ("race_parity", check_race_parity),
    "observability": ("observability_parity", check_observability_parity),
    "serve": ("serve_parity", check_serve_parity),
    "sliding": ("sliding_parity", check_sliding_parity),
    "worker": ("worker_parity", check_worker_parity),
    "sharded": ("sharded_parity", check_sharded_parity),
    "cluster": ("cluster_parity", check_cluster_parity),
    "replica": ("replica_parity", check_replica_parity),
    "mesh": ("mesh_parity", check_mesh_parity),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="main-path window rows")
    ap.add_argument("--windows", type=int, default=3, help="measured windows per path")
    ap.add_argument("--only", nargs="*", choices=PHASES, default=list(PHASES))
    ap.add_argument("--out", type=Path, default=None, help="directory for a details JSON")
    ap.add_argument(
        "--profile", action="store_true",
        help="after the main paths, profile one more window of each path",
    )
    ap.add_argument(
        "--parent", type=Path, default=None,
        help="a checkout of the parent commit: time its value kernel (the mp loop, the "
        "pre-drop) beside this tree's in the timings phase",
    )
    ap.add_argument(
        "--ab-paths", default="",
        help="comma-separated paths to run in the --parent tree and in this one, in "
        "turns (parent, change, change, parent), after the phases",
    )
    ap.add_argument("--ab-rounds", type=int, default=1,
                    help="times to repeat the --ab-paths turns")
    ap.add_argument(
        "--ablate-planes", type=int, default=0, metavar="ROUNDS",
        help="after the phases, run (p) with each observability gate off alone, all off, "
        "and (b), one process a setting, ROUNDS times",
    )
    ap.add_argument(
        "--legs", default="",
        help=f"comma-separated parity legs, in this order (default: all): "
        f"{', '.join(PARITY_LEGS)}",
    )
    ap.add_argument(
        "--paths", default="",
        help="comma-separated paths for the main phase, in this order: the tumbling "
        "paths, the sharded v and w, the cluster x and y, the mesh z and z2, and the "
        "worker's t (over the wire) and u (the crash drill) (default: all, then v, w, x, "
        "y, z and z2, the sliding paths, t and u); not with the timings phase, which reads "
        "them all",
    )
    args = ap.parse_args()
    if args.paths and "timings" in args.only:
        raise SystemExit("--paths selects main paths; the timings phase needs them all")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from skyline_tpu_torch.ops import dominance_kernels as dk
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    import threading

    from skyline_tpu_torch import native

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    # the native host helper (g++) builds beside the nvcc runs
    native_s = {}
    native_build = threading.Thread(
        target=lambda: native_s.setdefault("lib", (native.get_lib(), time.perf_counter() - t0)))
    native_build.start()
    built = dk.build()
    log(f"build: {', '.join(p.name for p, _ in built.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    native_build.join()
    lib, lib_s = native_s["lib"]
    if lib is None:
        print(f"chip_smoke: the native host helper did not build: {native.build_error()}",
              file=sys.stderr)
        return 3
    log(f"build: native {native.library_path().relative_to(ROOT)} in {lib_s:.1f} s")
    details = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    # each phase's, leg's and path's seconds, also logged as each ends
    seconds = details["seconds"] = {"build": time.perf_counter() - t0}
    for name, (_, build_log) in built.items():
        usage, spills = ptxas_usage(build_log)
        for kernel, used in usage.items():
            log(f"build: {name} ptxas {kernel}: {used}")
        log(f"build: {name} spilling: {spills or 'none'}")
        details.setdefault("ptxas", {})[name] = {"usage": usage, "spills": spills}

    if "kernels" in args.only:
        t0 = time.perf_counter()
        n = check_kernels(torch, np, "cuda") + check_skip_cases(torch, np, "cuda")
        mpn, details["predrop_skips"] = check_mp_kernels(torch, np, "cuda")
        m = check_merge_step(torch, np, "cuda")
        sw = check_sweep(torch, np, "cuda")
        tr = check_tree(torch, np, "cuda")
        dc = check_cascade(torch, np, "cuda")
        bk = check_batched_k3(torch, np, "cuda")
        od = check_one_device(torch, "cuda")
        log(f"kernels: {n} checks equal to the plain versions, {mpn} mixed-precision checks "
            f"(K1-K3 mp equal to the plain versions and to their f32 launches, both pre-drop "
            f"entries and the pre-drop's skip decisions equal to their plain versions), {m} merge-step rounds (with and without mp) equal "
            f"to the plain core, {sw} sweep checks and {tr} tree-merge checks (tree pairs "
            f"on K2, compact_tagged, partition summaries) equal to the CPU, {dc} device "
            f"cascade checks (mp off and on) equal to the CPU cascade and to K3, {bk} checks "
            f"of K3 over a partition batch (one launch) equal to its plain version and to K3 "
            f"on each partition alone, {od} entries refusing operands on two devices in "
            f"{time.perf_counter() - t0:.1f} s")
        details["skyline_large"] = check_skyline_large(torch, np, args.n, "cuda")
        seconds["kernels"] = time.perf_counter() - t0
        log(f"kernels: phase done in {seconds['kernels']:.1f} s")
    if "parity" in args.only:
        legs = args.legs.split(",") if args.legs else list(PARITY_LEGS)
        t_parity = time.perf_counter()
        for leg in legs:
            key, run = PARITY_LEGS[leg]
            t0 = time.perf_counter()
            details[key] = run(torch, np)
            if leg in ("host", "device"):
                log(f"parity: {leg} ingest, cuda vs cpu: {details[key]}")
            secs = seconds.setdefault("parity", {})[leg] = time.perf_counter() - t0
            log(f"parity: leg {leg} in {secs:.1f} s")
        if args.out is not None and "replica_parity" in details:
            # the replica leg's WAL, read as files by tests/fold_wal_jax.py
            import shutil

            dst = args.out / "replica_wal"
            shutil.rmtree(dst, ignore_errors=True)
            shutil.copytree(details["replica_parity"]["wal_dir"], dst)
        seconds["parity_all"] = time.perf_counter() - t_parity
        log(f"parity: done at {time.perf_counter() - t_start:.1f} s "
            f"({seconds['parity_all']:.1f} s for the phase)")
    table = []
    parent = None
    if args.parent is not None and "timings" in args.only:
        parent = parent_library(torch, args.parent.resolve())
    if args.paths and "main" in args.only:
        runs = {}
        for path in args.paths.split(","):
            t0 = time.perf_counter()
            if path in WORKER_PATHS:
                details.setdefault("worker", {})[path] = WORKER_PATHS[path](
                    torch, np, args.windows, args.profile)
            elif path in SHARDED_PATHS:
                details.setdefault("sharded", {})[path] = sharded_path(
                    torch, np, path, args.n, args.windows, runs)[0]
            elif path in CLUSTER_PATHS:
                cl = details.setdefault("cluster", {})
                cl[path], heavy = cluster_path(torch, np, path, args.n, args.windows, runs)
                if path == "x":
                    cl["host_ladder_k2"] = host_ladder_k2(torch, np, heavy, cl[path])
            elif path in MESH_PATHS:
                me = details.setdefault("mesh", {})
                me[path], heavy = mesh_path(torch, np, path, args.n, args.windows, runs)
                if path == "z":
                    me["sites"] = mesh_site_timings(torch, np, heavy, me[path])
                me[path]["flush_kernels"] = mesh_flush_timings(torch, np, heavy, me[path], path)
            else:
                runs[path] = main_path(torch, np, path, args.n, args.windows)
            secs = seconds.setdefault("main", {})[path] = time.perf_counter() - t0
            log(f"main ({path}): {secs:.1f} s in all")
        details["main"] = {path: r[0] for path, r in runs.items()}
        if "b" in runs and "t" in details.get("worker", {}):
            compare_wire(details["worker"]["t"], runs["b"][0])
        for path, base in PLANE_PAIRS:
            if path in runs and base in runs:
                a, b = runs[path][0], runs[base][0]
                log(f"main ({path}) beside ({base}): p50 {a['p50_window_ms']:.1f} ms vs "
                    f"{b['p50_window_ms']:.1f} ms, {a['tuples_per_s']:.0f} vs "
                    f"{b['tuples_per_s']:.0f} tuples/s")
        report_serve(runs)
        if "p" in runs:
            details["plane_costs"] = plane_costs(
                np, runs["p"][0]["windows"][-1]["hub"], -(-args.n // 65536), 65536, 8)
        if args.profile:
            details["profile"] = {p: profile_window(torch, np, p, args.n) for p in runs
                                  if p not in SERVE_PATHS}
    elif "main" in args.only or "timings" in args.only:
        runs = {}
        for path in PATHS:
            t0 = time.perf_counter()
            runs[path] = main_path(torch, np, path, args.n, args.windows)
            secs = seconds.setdefault("main", {})[path] = time.perf_counter() - t0
            log(f"main ({path}): {secs:.1f} s in all")
        details["main"] = {path: r[0] for path, r in runs.items()}
        for path, base in PLANE_PAIRS:
            a, b = runs[path][0], runs[base][0]
            log(f"main ({path}) beside ({base}): p50 {a['p50_window_ms']:.1f} ms vs "
                f"{b['p50_window_ms']:.1f} ms ({a['p50_window_ms'] / b['p50_window_ms']:.3f}x), "
                f"{a['tuples_per_s']:.0f} vs {b['tuples_per_s']:.0f} tuples/s")
        report_serve(runs)
        details["plane_costs"] = plane_costs(
            np, runs["p"][0]["windows"][-1]["hub"], -(-args.n // 65536), 65536, 8)
        sharded, heavy = {}, None
        for path in SHARDED_PATHS:
            t0 = time.perf_counter()
            sharded[path], h = sharded_path(torch, np, path, args.n, args.windows, runs)
            heavy = h if path == "v" else heavy
            secs = seconds.setdefault("main", {})[path] = time.perf_counter() - t0
            log(f"main ({path}): {secs:.1f} s in all")
        details["sharded"] = sharded
        cluster, cluster_heavy = {}, None
        for path in CLUSTER_PATHS:
            t0 = time.perf_counter()
            cluster[path], h = cluster_path(torch, np, path, args.n, args.windows, runs)
            cluster_heavy = h if path == "x" else cluster_heavy
            secs = seconds.setdefault("main", {})[path] = time.perf_counter() - t0
            log(f"main ({path}): {secs:.1f} s in all")
        details["cluster"] = cluster
        meshed, mesh_heavy = {}, {}
        for path in MESH_PATHS:
            t0 = time.perf_counter()
            meshed[path], mesh_heavy[path] = mesh_path(torch, np, path, args.n, args.windows,
                                                       runs)
            secs = seconds.setdefault("main", {})[path] = time.perf_counter() - t0
            log(f"main ({path}): {secs:.1f} s in all")
        details["mesh"] = meshed
        t0 = time.perf_counter()
        sliding = {"n": sliding_northstar(torch, np, args.windows), "o": sliding_4d(torch, np)}
        details["sliding"] = {path: r[0] for path, r in sliding.items()}
        secs = seconds.setdefault("main", {})["n,o"] = time.perf_counter() - t0
        log(f"main (n), (o): {secs:.1f} s in all")
        details["worker"] = {}
        for path, run in WORKER_PATHS.items():
            t0 = time.perf_counter()
            details["worker"][path] = run(torch, np, args.windows, args.profile)
            secs = seconds.setdefault("main", {})[path] = time.perf_counter() - t0
            log(f"main ({path}): {secs:.1f} s in all")
        compare_wire(details["worker"]["t"], runs["b"][0])
        t_timings = time.perf_counter()
        details["routing"] = routing_mismatch(torch, np, runs["a"][2], "cuda")
        log(f"routing: the card vs the CPU and vs partition_ids_np on the last "
            f"{args.n}-row window of (a): {details['routing']}")
        summary_a, eng_a, x_a = runs["a"]
        summary_c, eng_c, x_c = runs["c"]
        # each kernel's launches from a path that runs it: the mp variants
        # and the pre-drop from (c) (K3 mp from (g)); K1/K2 f32 from (i),
        # K3 f32 from (k) — the bf16 passes off; K7 with its K4 from (h)
        launches_of = {p: runs[p][0]["launches"] for p in runs}
        g_launches, h_launches = launches_of["g"], launches_of["h"]
        value_launches = dict(
            summary_c["launches"],
            dominated_by_any=launches_of["i"]["dominated_by_any"],
            dominated_by_rect=launches_of["i"]["dominated_by_rect"],
            skyline_mask_kernel=launches_of["k"]["skyline_mask_kernel"],
            skyline_mask_kernel_mp=g_launches["skyline_mask_kernel_mp"],
            # the mask entry's launches on every main path: none since the
            # cascade's pre-drop runs inside its scan (it stays an entry of
            # skyline_mask_scan and dominated_by_blocked with mp)
            strictly_dominated_bf16_kernel=sum(v.get(PREDROP, 0) for v in launches_of.values()),
        )
        rank_launches = dict(
            summary_a["launches"], rank_transform=h_launches["rank_transform"],
            skyline_mask_rank_kernel=h_launches["skyline_mask_rank_kernel"],
        )
        w = args.windows + 1
        log(f"timings: bounds at {FP32_FLOPS / 1e12:.0f} TFLOP/s FP32 (K1-K3), "
            f"{INT32_OPS / 1e12:.1f} TOP/s INT32 compares (K5-K7: 64 per clock per SM, "
            f"CUDA C++ Programming Guide, x 132 SMs x 1.98 GHz) and "
            f"{HBM_BYTES_S / 1e12:.2f} TB/s HBM")
        with rank_gate(False):
            table = value_timings(torch, np, eng_c, x_c, value_launches, w, parent=parent)
            table += predrop_timing(torch, np, eng_c, x_c, value_launches, w, parent=parent)
        with rank_gate(True):
            table += rank_timings(torch, np, eng_a, x_a, rank_launches, w)
        with rank_gate(False):
            inc = incremental_k2(torch, np, args.n, launches_of["d"], w, parent=parent)
            pair = tree_pair_k2(torch, np, args.n, launches_of["b"], w)
        rows = {r["name"]: r for r in table}
        rows["dominated_by_rect"]["inputs"]["incremental"] = inc
        rows["dominated_by_rect"]["inputs"]["tree_pair"] = pair
        rows["dominated_by_rect"]["inputs"]["cross_chip"] = cross_chip_k2(
            torch, np, heavy, sharded["v"])
        rows["dominated_by_rect"]["inputs"]["host_ladder"] = host_ladder_k2(
            torch, np, cluster_heavy, cluster["x"])
        sites = mesh_site_timings(torch, np, mesh_heavy["z"], meshed["z"])
        rows["skyline_mask_kernel"]["inputs"]["mesh_local"] = sites["local"]
        rows["dominated_by_rect"]["inputs"]["mesh_cross"] = sites["cross"]
        # the meshed flush steps: each step timed whole with the launches of
        # each kernel inside, and the kernels on the path's own inputs —
        # the round's K1 mp, K2 mp and fused pre-drop on (z), the merge
        # step's K2 on (z2)
        for path, step_name in (("z", "meshed_sfs_round"), ("z2", "meshed_merge_step")):
            step = meshed[path]["meshed_steps"][step_name]
            flush = mesh_flush_timings(torch, np, mesh_heavy[path], meshed[path], path)
            meshed[path]["flush_kernels"] = flush
            for kname, count in step["launches"].items():
                if kname not in rows:
                    continue
                site = {"calls": step["calls"], "step_mean_ms": step["mean_ms"],
                        "step_max_ms": step["max_ms"], "launches": count,
                        "launches_per_window": count / w,
                        "probe_split": step["probe_split"]}
                if kname in flush:
                    site["kernel"] = {k: flush[kname][k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by", "skipped_share", "shape",
                        "needed_pairs")}
                elif kname.startswith("dominated_by_rect") and "merge_step_k2" in flush:
                    site["kernel"] = flush["merge_step_k2"]
                rows[kname].setdefault("inputs", {})[f"{step_name}_{path}"] = site
        casc = cascade_timings(torch, np, eng_c, x_c, w, launches_of["l"],
                               launches_of["m"], parent=parent)
        details["device_cascade"] = casc
        # the window pass and the scan have rows of their own
        table += casc["rows"]
        rows.update({r["name"]: r for r in casc["rows"]})
        rows["dominated_by_rect_mp"]["inputs"]["incremental"] = {
            "round_ms": inc["round_mp_ms"], "round_f32_ms": inc["round_ms"],
            "launches_per_window": inc["launches_mp_per_window"],
            "calls": {k: {"ms": c["mp_ms"], "f32_ms": c["ms"], "bound_ms": c["bound_ms"],
                          "parent_ms": c["parent_mp_ms"]}
                      for k, c in inc["calls"].items()},
        }
        for path, (summary, eng, last) in sliding.items():
            rows["skyline_mask_kernel"]["inputs"].update(sliding_k3_timings(
                torch, np, path, eng, last, summary["k3_launches_per_slide"]))
        if args.profile:
            details["profile"] = {p: profile_window(torch, np, p, args.n) for p in PATHS
                                  if p not in SERVE_PATHS}
            details["profile"].update(
                {p: profile_slide(torch, np, p, r[1]) for p, r in sliding.items()})
        seconds["timings"] = time.perf_counter() - t_timings
        log(f"timings: phase done in {seconds['timings']:.1f} s")
    if "analysis" in args.only:
        details["analysis"] = check_analysis(torch, np)
        seconds["analysis"] = details["analysis"]["wall_s"]
    if args.ab_paths:
        if args.parent is None:
            raise SystemExit("--ab-paths needs --parent")
        details["ab"] = ab_paths(np, args.parent.resolve(), args.ab_paths.split(","),
                                 args.n, args.windows, args.ab_rounds)
    if args.ablate_planes:
        details["ablate_planes"] = ablate_planes(np, args.n, args.windows, args.ablate_planes)
    off_path = [r for r in table if not r["launches"]]
    stray = [r["name"] for r in off_path if r["name"] not in OFF_PATH]
    if stray:
        raise AssertionError(f"no main path launched {stray}")
    if off_path:
        details["off_path_kernels"] = off_path
        table = [r for r in table if r["launches"]]
        log(f"timings: {', '.join(r['name'] for r in off_path)} checked and timed, launched "
            "on no main path: kept out of the kernel line (details: off_path_kernels)")
    details["wall_s"] = time.perf_counter() - t_start
    log(f"total: {details['wall_s']:.1f} s")
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        details["kernels"] = table
        (args.out / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

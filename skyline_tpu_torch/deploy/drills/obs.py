"""The observability drill: ``scripts/obs_smoke.sh`` on the port.

Legs, in the reference's order:

1. ``worker``: a worker over the in-memory bus with both HTTP surfaces
   (``--stats-port 0 --serve 0``) and ``--trace-out``: the merge cache, the
   read cache and the publish dedupe; ``/metrics`` on both surfaces as
   Prometheus text with every named family; ``/stats`` latency tiles;
   ``/profile``, ``/slo``, ``/ops`` and ``/cluster/overview``; ``/explain``
   (a cache hit, deduped, inlined by ``/skyline?explain=1``); ``/audit``
   after the five canaries; ``/debug/flight``; the freshness lineage;
   ``/trace`` and the ``--trace-out`` file.
2. ``prune``: the merge tree's witness prune on and off, the same bytes.
3. ``flush_cascade``: the grid prefilter and the bf16 pre-drop on and off
   over a two-round flush, the same bytes, rows prefiltered only when on.
4. ``sorted_sfs``: on the CPU the host sorted cascade forced on and off,
   the same bytes, and the sorted path counted and profiled. The knob acts
   on the CPU only: on a card the leg asserts the lazy flush's race
   instead — two equal flushes under ``auto`` explore the SFS rounds and
   the device cascade, and the bytes equal the rounds alone.
5. ``device_cascade``: the reference's "live under jit" witness
   (``cascade_trace_count``) becomes: ``device_cascade_mask`` on a fresh
   1,117 x 5 input equal to the quadratic mask, and on a card its two
   kernels' launch counts (``cascade_windows*``, ``cascade_scan*``) moving;
   then the forced on/off engine digests, the cascade flushes counted
   (``pset.flush_paths``, ``flush.device_cascade``) and profiled.
6. ``tuner``: a uniform -> anti-correlated drift through a live worker
   with the controller at zero cadence (drift counted, controller epochs,
   ``/dispatch`` on both surfaces, tuner decisions in the flight ring), and
   the same stream through an engine with the tuner on and off publishing
   the same bytes per trigger.
7. ``replica``: a WAL-tailing replica: role-marked ``/healthz``, the
   primary's bytes, an SSE delta push on ``/subscribe``, a labeled tenant
   shed, labeled replication families, ``/ops`` and ``/cluster/overview``.
8. ``bodystore``: the shared body store: four wire shapes with the same
   bytes on primary and replica, the store's counter families on
   ``/metrics``.
9. ``sentinel``: the perf-trajectory sentinel trips (exit 1) on a
   self-relative synthetic drift whose every step passes pairwise.
10. ``lint``: the port's analysis gate (``python -m
    skyline_tpu_torch.analysis``: knob lint, graph audit, lock lint) and
    ``--check-doc``.

Not ported: the regression gate over ``scripts/bench_compare.py`` and the
sentinel's check of the checked-in ``BENCH_r*.json`` trajectory (both read
the JAX package's artifacts; the port has no benchmark yet). The
reference's mesh and chaos gates at its end are the ``mesh`` and
``chaos`` drills, which ``all`` runs.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np

from skyline_tpu_torch.deploy.drills.common import (
    env_scope,
    port_engine_config,
    port_job_args,
    say,
    sha256,
    wait_until,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def port_ns(device: str) -> SimpleNamespace:
    import functools

    from skyline_tpu_torch.bridge import MemoryBus, SkylineWorker
    from skyline_tpu_torch.bridge.wire import format_trigger, format_tuple_line
    from skyline_tpu_torch.ops import cascade
    from skyline_tpu_torch.resilience.wal import WalWriter
    from skyline_tpu_torch.serve import (
        ServeConfig,
        SkylineServer,
        SnapshotStore,
        delta_wal_record,
    )
    from skyline_tpu_torch.serve.bodystore import BodyStore
    from skyline_tpu_torch.serve.replica import SkylineReplica
    from skyline_tpu_torch.stream import SkylineEngine
    from skyline_tpu_torch.stream.batched import PartitionSet
    from skyline_tpu_torch.telemetry import Telemetry
    from skyline_tpu_torch.telemetry.clusterview import ClusterView
    from skyline_tpu_torch.telemetry.opslog import OpsLog
    from skyline_tpu_torch.telemetry.sentinel import DEFAULT_RULES
    from skyline_tpu_torch.workload.generators import anti_correlated, uniform

    return SimpleNamespace(
        device=device, parse_job_args=port_job_args(device), MemoryBus=MemoryBus,
        SkylineWorker=SkylineWorker, format_trigger=format_trigger,
        format_tuple_line=format_tuple_line, anti_correlated=anti_correlated,
        uniform=uniform, PartitionSet=functools.partial(PartitionSet, device=device),
        Telemetry=Telemetry, EngineConfig=port_engine_config(device),
        SkylineEngine=SkylineEngine, cascade=cascade, WalWriter=WalWriter,
        SkylineServer=SkylineServer, SnapshotStore=SnapshotStore, ServeConfig=ServeConfig,
        delta_wal_record=delta_wal_record, SkylineReplica=SkylineReplica,
        BodyStore=BodyStore, ClusterView=ClusterView, OpsLog=OpsLog,
        DEFAULT_RULES=DEFAULT_RULES, cascade_witness=functools.partial(
            port_cascade_witness, device), launches=port_launches)


def port_launches() -> dict:
    """The port's kernel launch counts so far (the card's; the CPU's plain
    versions count nothing)."""
    from skyline_tpu_torch.ops import dominance_kernels as dk

    return dict(dk.LAUNCHES)


def port_cascade_witness(device: str) -> dict:
    """The device cascade live on ``device``: ``device_cascade_mask`` on a
    fresh 1,117 x 5 anti-correlated input equals the quadratic mask, and on
    a card it launched each of its two kernels."""
    import torch

    from skyline_tpu_torch.ops import dominance_kernels as dk
    from skyline_tpu_torch.ops.device_cascade import device_cascade_mask
    from skyline_tpu_torch.ops.dominance import skyline_mask
    from skyline_tpu_torch.workload.generators import anti_correlated

    x = torch.as_tensor(anti_correlated(np.random.default_rng(29), 1117, 5, 0, 10000),
                        device=device)
    before = dict(dk.LAUNCHES)
    got = device_cascade_mask(x).cpu().numpy()
    moved = {k: dk.LAUNCHES[k] - before[k] for k in dk.LAUNCHES
             if k.startswith(("cascade_windows", "cascade_scan")) and dk.LAUNCHES[k] > before[k]}
    assert np.array_equal(got, skyline_mask(x).cpu().numpy()), \
        "the device cascade's mask diverges from the quadratic referee"
    if device == "cuda":
        for site in ("cascade_windows", "cascade_scan"):
            assert any(k.startswith(site) for k in moved), \
                f"the device cascade launched no {site} kernel: {moved}"
    return {"survivors": int(got.sum()), "launches": moved}


def parse_prom(text):
    """Minimal Prometheus text parser: {name: [value, ...]}."""
    series = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        assert head and val, f"malformed sample line: {line!r}"
        if "{" in head:
            name, _, rest = head.partition("{")
            assert rest.endswith("}"), f"malformed labels: {line!r}"
        else:
            name = head
        float(val)  # must parse
        series.setdefault(name, []).append(val)
    assert series, "no samples in exposition"
    return series


def _json(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return json.load(r)


def _text(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read().decode()


def _drain(worker):
    while worker.step() > 0:
        pass


# -- 1. the worker's HTTP surfaces ------------------------------------------------


def worker_leg(ns, bounds: bool = True) -> dict:
    out_dir = tempfile.mkdtemp(prefix="skyline-obs-")
    trace_out = os.path.join(out_dir, "obs_smoke_trace.json")
    ev = {}
    try:
        cfg = ns.parse_job_args(["--serve", "0", "--stats-port", "0", "--parallelism", "2",
                                 "--dims", "3", "--trace-out", trace_out])
        bus = ns.MemoryBus()
        worker = ns.SkylineWorker(bus, cfg.engine_config(), stats_port=cfg.stats_port,
                                  serve_port=cfg.serve_port, serve_config=cfg.serve_config(),
                                  trace_out=cfg.trace_out)
        try:
            _worker_surfaces(ns, bus, worker, ev, bounds)
        finally:
            worker.close()
        with open(trace_out) as f:
            doc = json.load(f)
        names = {e["name"] for e in doc["traceEvents"]}
        for want in ("ingest", "local", "merge", "publish"):
            assert want in names, (want, names)
        ev["trace_out_events"] = len(doc["traceEvents"])
        say("obs", f"--trace-out ok: {len(doc['traceEvents'])} events")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    say("obs", "PASS")
    return ev


# the SLOs whose breach is a wall-clock reading
LATENCY_SLOS = frozenset(("read_p99", "freshness_p99", "replication_lag_p99", "promote_p99"))


def _worker_surfaces(ns, bus, worker, ev, bounds: bool) -> None:
    x = ns.anti_correlated(np.random.default_rng(7), 3000, 3, 0, 10000)
    bus.produce_many("input-tuples", [ns.format_tuple_line(i, row) for i, row in enumerate(x)])
    bus.produce("queries", ns.format_trigger(0, 0))
    _drain(worker)
    stats_base = f"http://127.0.0.1:{worker.stats_server.port}"
    serve_base = f"http://127.0.0.1:{worker.serve_server.port}"

    # a read, so serve_read_ms has a sample; the second is the read cache's
    first = _json(f"{serve_base}/skyline")
    assert first["version"] == 1
    doc = _json(f"{serve_base}/skyline")
    assert doc["version"] == 1 and "age_ms" in doc and "stale" in doc
    ev["skyline_size"] = first["skyline_size"]
    ev["digest"] = sha256(json.dumps(first["points"]).encode())

    # a second trigger over unchanged state: a merge-cache hit, the publish
    # deduped (the version stays 1)
    bus.produce("queries", ns.format_trigger(1, 0))
    _drain(worker)
    assert _json(f"{serve_base}/skyline")["version"] == 1, "dedupe minted a version"
    stats = _json(f"{stats_base}/stats")
    mc = stats["merge_cache"]
    assert mc["hits"] >= 1 and mc["misses"] >= 1, mc
    assert stats["serve"]["read_cache_hits"] >= 1, stats["serve"]
    assert stats["snapshot_store"]["deduped"] >= 1, stats["snapshot_store"]
    ev["merge_cache"] = {"hits": mc["hits"], "misses": mc["misses"]}
    say("obs", f"merge cache ok: {mc['hits']} hit(s), {stats['serve']['read_cache_hits']} "
        f"read-cache hit(s), {stats['snapshot_store']['deduped']} publish dedupe(s)")

    for label, base in (("stats", stats_base), ("serve", serve_base)):
        with urllib.request.urlopen(f"{base}/metrics", timeout=5) as r:
            ctype = r.headers.get("Content-Type", "")
            series = parse_prom(r.read().decode())
        assert "version=0.0.4" in ctype, ctype
        assert any(k.startswith("skyline_") for k in series), sorted(series)
        say("obs", f"{label} /metrics ok: {len(series)} series")
    body = _text(f"{stats_base}/metrics")
    for want in ("skyline_ingest_batch_ms_bucket", "skyline_query_latency_ms_count",
                 "skyline_merge_cache_hit_total", "skyline_merge_cache_miss_total",
                 "skyline_merge_tree_levels_total", "skyline_merge_partitions_pruned_total",
                 "skyline_flush_prefilter_dropped_total", "skyline_flush_bf16_resolved_total",
                 "skyline_freshness_lag_ms_bucket", "skyline_telemetry_spans_dropped_total",
                 "skyline_compile_cache_hits_total", "skyline_compile_cache_misses_total",
                 "skyline_explain_records_total", "skyline_audit_checks_total",
                 "skyline_audit_divergence_total"):
        assert want in body, f"{want} missing from exposition"
    for stage in ("ingest", "flush", "merge", "publish", "read"):
        assert f'stage="{stage}"' in body, f"freshness stage {stage!r} missing from exposition"
    assert "skyline_serve_read_cache_hits_total" in _text(f"{serve_base}/metrics"), \
        "read-cache counter missing from serve exposition"

    stats = _json(f"{stats_base}/stats")
    lat = stats["latency_ms"]
    assert lat["query_latency_ms"]["count"] >= 1, lat
    assert "p99" in lat["query_latency_ms"], lat
    say("obs", f"/stats latency tiles ok: {[k for k, v in lat.items() if v['count'] > 0]}")

    for base in (stats_base, serve_base):
        prof = _json(f"{base}/profile")
        assert prof["signatures"] >= 1 and prof["kernels"], prof
        assert prof["dispatches"] >= prof["signatures"], prof
    variants = {k["variant"] for k in prof["kernels"]}
    ev["profile"] = {"variants": sorted(variants),
                     "backends": sorted({k["backend"] for k in prof["kernels"]})}
    say("obs", f"/profile ok: {prof['signatures']} signature(s), {prof['dispatches']} "
        f"dispatch(es), variants={sorted(variants)}")

    slo = _json(f"{stats_base}/slo")
    assert set(slo["slos"]) == {"read_p99", "freshness_p99", "shed_fraction", "restart_rate",
                                "audit_divergence", "degraded_answers",
                                "tenant_shed_fraction", "replication_lag_p99",
                                "promote_p99"}, slo
    for name, s in slo["slos"].items():
        assert {"fast", "slow"} <= set(s["windows"]), (name, s)
        # the latency SLOs are wall-clock bounds: held with bounds on
        if bounds or name not in LATENCY_SLOS:
            assert s["breach"] is False, (name, s)
    if bounds:
        assert slo["ok"] is True, slo
    ev["slo_breaches"] = sorted(n for n, s in slo["slos"].items() if s["breach"])
    say("obs", f"/slo ok: {len(slo['slos'])} SLOs, "
        + ("no breach" if not ev["slo_breaches"] else
           f"latency breach(es) {ev['slo_breaches']} not held (outcomes only)"))

    for base in (stats_base, serve_base):
        doc = _json(f"{base}/ops")
        assert doc == {"ok": True, "enabled": False}, doc
        doc = _json(f"{base}/cluster/overview")
        assert doc["ok"] is True and doc["enabled"] is False, doc
    say("obs", "/ops + /cluster/overview probe-friendly on both surfaces (plane off)")

    for base in (stats_base, serve_base):
        plan = _json(f"{base}/explain")
        for block in ("merge", "cascade", "kernels", "publish", "timing"):
            assert plan.get(block) is not None, (base, block, plan)
        assert plan["merge"]["path"] == "cache_hit", plan["merge"]
        assert plan["publish"]["version"] == 1, plan["publish"]
        assert plan["publish"]["deduped"] is True, plan["publish"]
        assert plan["trace_id"], plan
        assert _json(f"{base}/explain?version=1")["publish"]["version"] == 1
    inline = _json(f"{serve_base}/skyline?explain=1")["explain"]
    assert inline["trace_id"] == plan["trace_id"], inline
    assert stats["explain"]["recorded_total"] >= 2, stats["explain"]
    say("obs", f"/explain ok: {stats['explain']['recorded_total']} plan(s), latest "
        f"path={plan['merge']['path']} (v{plan['publish']['version']}, deduped)")

    worker.engine.auditor.run_canaries()
    for base in (stats_base, serve_base):
        audit = _json(f"{base}/audit")
        assert audit["ok"] is True, audit
        assert audit["checks_total"] >= 2 + 5, audit  # organic + canaries
        assert audit["divergence_total"] == 0, audit
        assert set(audit["canaries"]) == {"flat", "tree", "cache_hit", "tree_delta", "host"}, \
            audit["canaries"]
        assert all(c["last_ok"] for c in audit["canaries"].values()), audit
        organic = [c for c in worker.telemetry.audit.snapshot() if c["kind"] == "organic"]
        assert organic and organic[-1]["trace_id"], organic
        assert _json(f"{base}/audit?trace_id={organic[-1]['trace_id']}")["ok"] is True
    ev["audit"] = {"checks_total": audit["checks_total"],
                   "divergence_total": audit["divergence_total"],
                   "canaries": sorted(audit["canaries"])}
    say("obs", f"/audit ok: {audit['checks_total']} check(s), 0 divergence, canary paths "
        f"{sorted(audit['canaries'])}")

    flight = _json(f"{stats_base}/debug/flight")
    kinds = {e["kind"] for e in flight["entries"]}
    assert "merge.launch" in kinds, sorted(kinds)
    say("obs", f"/debug/flight ok: {flight['recorded_total']} decision(s), "
        f"kinds={sorted(kinds)}")

    fr = _json(f"{stats_base}/stats")["freshness"]
    counts = {s: fr["stages"][s]["count"] for s in fr["stages"]}
    assert all(c >= 1 for c in counts.values()), counts
    assert fr["published_wm_ms"] is not None, fr
    say("obs", f"freshness lineage ok: stage samples {counts}")

    doc = _json(f"{stats_base}/trace")
    names = {e["name"] for e in doc["traceEvents"]}
    for want in ("ingest", "local", "merge", "publish", "query"):
        assert want in names, (want, names)
    for e in doc["traceEvents"]:
        assert e["ph"] == "X" and "ts" in e and "dur" in e, e
    say("obs", f"/trace ok: {len(doc['traceEvents'])} events")


# -- 2.-5. the flush and merge planes, on against off -----------------------------


def _pset_digest(pset) -> tuple[int, str]:
    counts, surv, g, pts = pset.global_merge_stats(emit_points=True)
    h = hashlib.sha256(np.asarray(surv).tobytes())
    h.update(np.asarray(pts).tobytes())
    return int(g), h.hexdigest()


def _fill(ns, pset, x, pids, parts: int, halves: bool = False) -> None:
    spans = ((0, len(x) // 2), (len(x) // 2, len(x))) if halves else ((0, len(x)),)
    for lo, hi in spans:
        for p in range(parts):
            rows = np.ascontiguousarray(x[lo:hi][pids[lo:hi] == p])
            if rows.shape[0]:
                pset.add_batch(p, rows, max_id=len(x), now_ms=0.0)
        pset.flush_all()


def prune_leg(ns, bounds: bool = True) -> dict:
    digests = {}
    for prune in ("1", "0"):
        with env_scope(SKYLINE_MERGE_CACHE="0", SKYLINE_MERGE_TREE="1",
                       SKYLINE_MERGE_PRUNE=prune):
            rng = np.random.default_rng(23)
            pset = ns.PartitionSet(4, 3)
            x = ns.anti_correlated(rng, 4000, 3, 0, 10000).astype(np.float32)
            _fill(ns, pset, x, rng.integers(0, 4, len(x)), 4)
            digests[prune] = _pset_digest(pset)
    assert digests["1"] == digests["0"], \
        "prune on/off merge results diverge (g or point bytes differ)"
    say("obs", f"prune digest ok: g={digests['1'][0]} identical with SKYLINE_MERGE_PRUNE=1 "
        "and =0")
    return {"g": digests["1"][0], "digest": digests["1"][1]}


def flush_cascade_leg(ns, bounds: bool = True) -> dict:
    digests, dropped = {}, {}
    for on in ("1", "0"):
        with env_scope(SKYLINE_MERGE_CACHE="0", SKYLINE_FLUSH_PREFILTER=on,
                       SKYLINE_MIXED_PRECISION=on):
            rng = np.random.default_rng(23)
            pset = ns.PartitionSet(4, 4)
            x = ns.anti_correlated(rng, 4000, 4, 0, 10000).astype(np.float32)
            before = ns.launches()
            _fill(ns, pset, x, rng.integers(0, 4, len(x)), 4, halves=True)
            digests[on] = _pset_digest(pset)
            dropped[on] = pset.flush_cascade_stats()["prefilter_dropped"]
            if on == "1" and ns.device == "cuda":
                moved = {k: v - before[k] for k, v in ns.launches().items() if v > before[k]}
                assert moved.get("mp_predrop_kernel"), f"no fused pre-drop launched: {moved}"
    assert digests["1"] == digests["0"], \
        "cascade on/off merge results diverge (g or point bytes differ)"
    assert dropped["1"] > 0, "prefilter dropped nothing — cascade not live"
    assert dropped["0"] == 0, dropped
    say("obs", f"flush cascade digest ok: g={digests['1'][0]} identical with cascade on "
        f"({dropped['1']} rows prefiltered) and off")
    return {"g": digests["1"][0], "digest": digests["1"][1], "prefilter_dropped": dropped["1"]}


def _lazy_run(ns, halves: bool = False):
    tel = ns.Telemetry()
    rng = np.random.default_rng(23)
    pset = ns.PartitionSet(4, 4, flush_policy="lazy", counters=tel.counters)
    x = ns.anti_correlated(rng, 4000, 4, 0, 10000).astype(np.float32)
    _fill(ns, pset, x, rng.integers(0, 4, len(x)), 4, halves=halves)
    return _pset_digest(pset), dict(tel.counters.snapshot()), pset


def sorted_sfs_leg(ns, bounds: bool = True) -> dict:
    if ns.device == "cuda":
        return _race_leg(ns)
    digests, tels = {}, {}
    for mode in ("on", "off"):
        with env_scope(SKYLINE_MERGE_CACHE="0", SKYLINE_SORTED_SFS=mode):
            digests[mode], counters, pset = _lazy_run(ns)
            tels[mode] = (counters, pset._flush_prof)
    assert digests["on"] == digests["off"], \
        "sorted-SFS on/off merge results diverge (g or point bytes differ)"
    on_counters, on_prof = tels["on"]
    assert on_counters.get("flush.sorted_sfs", 0) > 0, \
        "sorted path never engaged under SKYLINE_SORTED_SFS=on"
    variants = {k["variant"] for k in on_prof.doc()["kernels"]}
    assert "flush_sorted_sfs" in variants, variants
    assert tels["off"][0].get("flush.sorted_sfs", 0) == 0, tels["off"][0]
    say("obs", f"sorted-SFS digest ok: g={digests['on'][0]} identical with cascade on "
        f"({on_counters['flush.sorted_sfs']:.0f} sorted flush(es)) and off")
    return {"g": digests["on"][0], "digest": digests["on"][1],
            "sorted_flushes": on_counters["flush.sorted_sfs"]}


def _race_leg(ns) -> dict:
    """On a card: the lazy flush's race under ``auto`` — two flushes of
    one signature (2,000 rows each; the grid prefilter off in both arms so
    that no drop moves the second into another row bucket) explore the SFS
    rounds, then the device cascade — publishes the bytes of the rounds
    alone."""
    with env_scope(SKYLINE_MERGE_CACHE="0", SKYLINE_FLUSH_PREFILTER="0"):
        raced, counters, pset = _lazy_run(ns, halves=True)
        paths = dict(pset.flush_paths)
    with env_scope(SKYLINE_MERGE_CACHE="0", SKYLINE_FLUSH_PREFILTER="0",
                   SKYLINE_SORTED_SFS="off", SKYLINE_DEVICE_CASCADE="off"):
        rounds, _, _ = _lazy_run(ns, halves=True)
    assert raced == rounds, "the raced lazy flush diverges from the SFS rounds"
    assert paths.get("device_cascade", 0) >= 1, f"the race never ran the device cascade: {paths}"
    assert sum(v for k, v in paths.items() if k != "device_cascade") >= 1, \
        f"the race never ran the SFS rounds: {paths}"
    say("obs", f"flush race ok: g={raced[0]} identical to the SFS rounds alone; paths "
        f"{paths} (SKYLINE_SORTED_SFS acts on the CPU only)")
    return {"g": raced[0], "digest": raced[1], "flush_paths": paths}


def device_cascade_leg(ns, bounds: bool = True) -> dict:
    witness = ns.cascade_witness()
    digests, tels = {}, {}
    for mode in ("on", "off"):
        with env_scope(SKYLINE_MERGE_CACHE="0", SKYLINE_SORTED_SFS="off",
                       SKYLINE_DEVICE_CASCADE=mode):
            before = ns.launches()
            digests[mode], counters, pset = _lazy_run(ns)
            moved = {k: v - before[k] for k, v in ns.launches().items() if v > before[k]}
            tels[mode] = (counters, pset._flush_prof, dict(getattr(pset, "flush_paths", {})),
                          moved)
    assert digests["on"] == digests["off"], \
        "device-cascade on/off merge results diverge (g or point bytes differ)"
    on_counters, on_prof, on_paths, on_moved = tels["on"]
    assert on_counters.get("flush.device_cascade", 0) > 0, \
        "cascade path never engaged under SKYLINE_DEVICE_CASCADE=on"
    if on_paths:
        assert on_paths.get("device_cascade", 0) > 0, on_paths
    variants = {k["variant"] for k in on_prof.doc()["kernels"]}
    assert "flush_device_cascade" in variants, variants
    assert tels["off"][0].get("flush.device_cascade", 0) == 0, tels["off"][0]
    if ns.device == "cuda":
        for site in ("cascade_windows", "cascade_scan"):
            assert any(k.startswith(site) for k in on_moved), \
                f"the forced cascade flush launched no {site} kernel: {on_moved}"
    say("obs", f"device cascade ok: live ({witness}), g={digests['on'][0]} identical with "
        f"cascade on ({on_counters['flush.device_cascade']:.0f} cascade flush(es), paths "
        f"{on_paths}) and off")
    return {"g": digests["on"][0], "digest": digests["on"][1],
            "cascade_flushes": on_counters["flush.device_cascade"], "flush_paths": on_paths,
            "witness": witness, "launches": on_moved}


# -- 6. the dispatch tuner --------------------------------------------------------

TUNER_ENV = dict(SKYLINE_TUNER="1", SKYLINE_TUNER_EPOCH_S="0", SKYLINE_TUNER_HYSTERESIS="1",
                 SKYLINE_WORKLOAD_EPOCH_ROWS="256", SKYLINE_WORKLOAD_SAMPLE_CAP="2000")


def _phases(ns, d):
    rng = np.random.default_rng(11)
    return [ns.uniform(rng, 1500, d, 0, 10000), ns.anti_correlated(rng, 1500, d, 0, 10000)]


def _clear_tuning(ns) -> None:
    ns.cascade.clear_pins()
    for k in ns.cascade.TUNABLE_KNOBS:
        ns.cascade.clear_override(k)


def tuner_leg(ns, bounds: bool = True) -> dict:
    ev = {}
    with env_scope(**TUNER_ENV):
        cfg = ns.parse_job_args(["--serve", "0", "--stats-port", "0", "--parallelism", "2",
                                 "--dims", "4"])
        bus = ns.MemoryBus()
        worker = ns.SkylineWorker(bus, cfg.engine_config(), stats_port=cfg.stats_port,
                                  serve_port=cfg.serve_port, serve_config=cfg.serve_config())
        try:
            rid = 0
            for qid, x in enumerate(_phases(ns, 4)):
                bus.produce_many("input-tuples", [ns.format_tuple_line(rid + i, row)
                                                  for i, row in enumerate(x)])
                rid += len(x)
                bus.produce("queries", ns.format_trigger(qid, 0))
                _drain(worker)
            for _ in range(4):  # idle ticks drive maybe_tune at zero cadence
                worker.step()
            counters = dict(worker.telemetry.counters.snapshot())
            assert counters.get("workload.drift", 0) >= 1, "regime flip never counted as drift"
            assert counters.get("tuner.epochs", 0) >= 1, "controller never ran an epoch"
            stats_base = f"http://127.0.0.1:{worker.stats_server.port}"
            serve_base = f"http://127.0.0.1:{worker.serve_server.port}"
            body = _text(f"{stats_base}/metrics")
            for want in ("skyline_workload_drift_total", "skyline_tuner_epochs_total",
                         "skyline_tuner_moves_total", "skyline_tuner_switches_total"):
                assert want in body, f"{want} missing from exposition"
            for base in (stats_base, serve_base):
                doc = _json(f"{base}/dispatch")
                assert doc["table"]["rows"], "cascade table empty on /dispatch"
                assert doc["tuner"]["enabled"] is True, doc["tuner"]
                assert doc["tuner"]["epochs"] >= 1, doc["tuner"]
            kinds = {e["kind"] for e in _json(f"{stats_base}/debug/flight")["entries"]}
            assert "workload.drift" in kinds, sorted(kinds)
            assert any(k.startswith("tuner.") for k in kinds), sorted(kinds)
            tuner_doc = doc["tuner"]
            ev["live"] = {"drift": counters["workload.drift"], "epochs": tuner_doc["epochs"],
                          "switches": tuner_doc["switches"],
                          "pins": sorted(str(p) for p in tuner_doc.get("pins", []))}
            say("obs", f"tuner live ok: {counters['workload.drift']:.0f} drift(s) counted, "
                f"{tuner_doc['epochs']} controller epoch(s), {tuner_doc['switches']} regime "
                f"switch(es), decision kinds {sorted(k for k in kinds if k.startswith('tuner.'))}"
                " on /debug/flight, /dispatch live on both surfaces")
        finally:
            worker.close()

        # the same drift stream through an engine, the tuner on and off:
        # the same bytes per trigger
        digests = {}
        for mode in ("1", "0"):
            os.environ["SKYLINE_TUNER"] = mode
            _clear_tuning(ns)
            eng = ns.SkylineEngine(
                ns.EngineConfig(parallelism=2, algo="mr-angle", dims=4, domain_max=10000.0,
                                flush_policy="lazy", emit_skyline_points=True),
                telemetry=ns.Telemetry())
            out, ingested = [], 0
            for qid, x in enumerate(_phases(ns, 4)):
                eng.process_records(np.arange(ingested, ingested + len(x), dtype=np.int64), x)
                ingested += len(x)
                eng.process_trigger(f"tuner-smoke-{qid},0")
                res = eng.poll_results()
                assert len(res) == 1, f"trigger {qid} unanswered"
                h = hashlib.sha256(str(res[0]["skyline_size"]).encode())
                pts = res[0].get("skyline_points")
                if pts is not None:
                    h.update(np.ascontiguousarray(np.asarray(pts, dtype=np.float32)).tobytes())
                out.append(h.hexdigest()[:16])
            digests[mode] = out
        _clear_tuning(ns)
    assert digests["1"] == digests["0"], \
        "tuner on/off published skylines diverge (controller moved WHAT)"
    ev["digests"] = digests["1"]
    say("obs", f"tuner digest ok: {len(digests['1'])} trigger(s) byte-identical with the "
        "controller on and off")
    return ev


# -- 7.-8. replicas ---------------------------------------------------------------


def _shadowed(ns, wal_dir):
    writer = ns.WalWriter(wal_dir, fsync="off")

    def shadow(prev, snap):
        writer.append(ns.delta_wal_record(prev, snap))
        writer.flush(force=True)

    store = ns.SnapshotStore()
    store.on_publish(shadow)
    return writer, store


def replica_leg(ns, bounds: bool = True) -> dict:
    assert any(r["label"] == "replica.read_lag_p99_ms" for r in ns.DEFAULT_RULES), \
        "sentinel does not watch replica read lag"
    wal_dir = tempfile.mkdtemp(prefix="skyline-replica-obs-")
    rng = np.random.default_rng(31)
    writer, store = _shadowed(ns, wal_dir)
    primary = ns.SkylineServer(store, port=0)
    rep = ns.SkylineReplica(wal_dir, serve_config=ns.ServeConfig(tenant_rate=0.001,
                                                                 tenant_burst=2),
                            replica_id="obs-rep", poll_interval_s=0.005, start=True)
    ev = {}
    try:
        store.publish(rng.random((64, 3)).astype(np.float32))
        assert rep.wait_for_version(1, timeout_s=10.0)
        assert _json(f"http://127.0.0.1:{rep.port}/healthz")["role"] == "replica"
        bodies = []
        for port in (primary.port, rep.port):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/skyline?format=csv",
                                        timeout=5) as r:
                bodies.append(sha256(r.read()))
        assert bodies[0] == bodies[1], "replica served different bytes"
        ev["csv_sha256"] = bodies[0]

        # SSE: subscribe, publish, the delta is pushed
        sk = socket.create_connection(("127.0.0.1", rep.port), timeout=10)
        sk.sendall(b"GET /subscribe HTTP/1.1\r\nHost: x\r\n\r\n")
        f = sk.makefile("rb")
        while f.readline().strip():  # response headers
            pass
        wait_until(lambda: rep.server._sse_queues, 5.0, "the SSE subscriber's registration",
                   every_s=0.01)
        store.publish(rng.random((64, 3)).astype(np.float32))
        assert rep.wait_for_version(2, timeout_s=10.0)
        event = None
        while event is None:
            line = f.readline()
            if line.startswith(b"event:"):
                event = line.split(b":", 1)[1].strip().decode()
        assert event == "delta", event
        sk.close()

        # the tenant bucket: "t1" past its 2 tokens, the labeled shed family
        shed = 0
        for _ in range(6):
            req = urllib.request.Request(f"http://127.0.0.1:{rep.port}/skyline?points=0",
                                         headers={"X-Tenant": "t1"})
            try:
                urllib.request.urlopen(req, timeout=5).read()
            except urllib.error.HTTPError as e:
                assert e.code == 429, e.code
                shed += 1
        assert shed >= 1, "tenant bucket never shed"
        prom = _text(f"http://127.0.0.1:{rep.port}/metrics")
        assert 'skyline_serve_tenant_reads_shed_total{tenant="t1"}' in prom, \
            "labeled tenant shed family missing from replica exposition"
        assert 'skyline_serve_tenant_reads_admitted_total{tenant="t1"}' in prom
        ev.update(sse_event=event, tenant_shed=shed)
        say("obs", f"replica surface ok: byte-identical read, role-marked healthz, SSE delta "
            f"push, {shed} tenant shed(s) labeled on /metrics, sentinel watches read lag")

        assert any(r["label"] == "cluster.replication_lag_p99_ms" for r in ns.DEFAULT_RULES), \
            "sentinel does not watch replication lag"
        for fam in ('skyline_replica_head_version{replica="obs-rep"}',
                    'skyline_replica_lag_ms{replica="obs-rep"}',
                    'skyline_replica_records_applied_total{replica="obs-rep"}'):
            assert fam in prom, f"{fam} missing from exposition"
        ops = ns.OpsLog(wal_dir, process_id="worker-obs-1", fsync="off")
        ops.record("promoted", epoch=2, holder="obs-rep")
        ops.flush(force=True)
        rep.telemetry.opslog = ops
        rep.telemetry.clusterview = ns.ClusterView(
            [f"http://127.0.0.1:{primary.port}", f"http://127.0.0.1:{rep.port}"])
        opsdoc = _json(f"http://127.0.0.1:{rep.port}/ops?limit=8")
        assert opsdoc["enabled"] and opsdoc["total"] >= 1, opsdoc
        assert any(rec["type"] == "promoted" for rec in opsdoc["records"]), opsdoc
        ov = _json(f"http://127.0.0.1:{rep.port}/cluster/overview")
        assert ov["enabled"] is True and ov["ok"] is True, ov
        assert ov["fleet"]["size"] == 2 and ov["fleet"]["live"] == 2, ov
        assert ov["findings"] == [], ov["findings"]
        ops.close()
        ev.update(ops_total=opsdoc["total"], fleet_live=ov["fleet"]["live"])
        say("obs", f"ops plane ok: labeled replica families on /metrics, {opsdoc['total']} "
            f"journal record(s) on /ops, fleet overview {ov['fleet']['live']}/"
            f"{ov['fleet']['size']} live with zero findings")
    finally:
        rep.close()
        primary.close()
        writer.close()
        shutil.rmtree(wal_dir, ignore_errors=True)
    return ev


def bodystore_leg(ns, bounds: bool = True) -> dict:
    for label in ("serve_load.read_p99_ms", "serve_load.shed_fraction"):
        assert any(r["label"] == label for r in ns.DEFAULT_RULES), \
            f"sentinel does not watch {label}"
    wal_dir = tempfile.mkdtemp(prefix="skyline-bodystore-obs-")
    rng = np.random.default_rng(47)
    writer, store = _shadowed(ns, wal_dir)
    body = ns.BodyStore(os.path.join(wal_dir, "bodystore.dat")).attach(store)
    primary = ns.SkylineServer(store, port=0, read_cache=0, bodystore=body)
    rep = ns.SkylineReplica(wal_dir, replica_id="obs-body-rep", poll_interval_s=0.005,
                            start=True)
    ev = {"shapes": {}}
    try:
        assert rep.bodystore is not None, "replica did not open the shared body store"
        store.publish(rng.random((96, 4)).astype(np.float32), watermark_id=7, partial=True)
        assert rep.wait_for_version(1, timeout_s=10.0)
        # JSON bodies carry a per-request tail after the stored prefix:
        # hash the prefix; csv has no tail and hashes whole
        paths = ("/skyline", "/skyline?points=0", "/skyline?explain=1", "/skyline?format=csv")
        for path in paths:
            digests = []
            for port in (primary.port, rep.port):
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
                    raw = r.read()
                if "csv" not in path:
                    raw = raw.split(b', "age_ms":')[0]
                digests.append(sha256(raw))
            assert digests[0] == digests[1], f"replica served different bytes for {path}"
            ev["shapes"][path] = digests[0]
        stats = rep.bodystore.stats()
        assert stats["hits"] >= 1, stats
        assert body.stats()["bodies_published"] >= 1, body.stats()
        prom = _text(f"http://127.0.0.1:{primary.port}/metrics")
        for fam in ("skyline_serve_bodystore_hits_total", "skyline_serve_bodystore_misses_total",
                    "skyline_serve_bodystore_torn_reads_total",
                    "skyline_serve_bodystore_retries_total",
                    "skyline_serve_read_cache_misses_total"):
            assert fam in prom, f"{fam} missing from exposition"
        urllib.request.urlopen(f"http://127.0.0.1:{rep.port}/skyline?format=csv",
                               timeout=5).read()
        assert "skyline_serve_read_cache_hits_total" in \
            _text(f"http://127.0.0.1:{rep.port}/metrics"), \
            "read_cache_hits family missing from replica exposition"
        sdoc = _json(f"http://127.0.0.1:{primary.port}/stats")
        assert sdoc["bodystore"]["bodies_published"] >= 1, sdoc["bodystore"]
        ev["replica_hits"] = stats["hits"]
        say("obs", f"bodystore ok: {len(paths)} wire shapes sha256-identical primary vs "
            f"replica out of the shared store ({stats['hits']} replica ring hit(s), 0 torn), "
            "counter families live on /metrics, sentinel watches serve_load")
    finally:
        rep.close()
        primary.close()
        body.close()
        writer.close()
        shutil.rmtree(wal_dir, ignore_errors=True)
    return ev


# -- 9.-10. the sentinel and the analysis gate ------------------------------------


def sentinel_leg(ns, bounds: bool = True) -> dict:
    """Four steady rounds then one 40% below their median, each step inside
    the pairwise threshold: the sentinel passes the steady four and trips on
    the fifth (exit 1)."""
    from skyline_tpu_torch.telemetry import sentinel

    base = {"parsed": {"value": 1000.0, "backend": ns.device,
                       "p50_window_latency_ms": 100.0}}
    out = {}
    drifted = tempfile.mkdtemp(prefix="skyline-sentinel-")
    try:
        for name, scales, want in (("steady", (1.00, 0.99, 1.01, 1.00), 0),
                                   ("drifted", (1.00, 0.99, 1.01, 1.00, 0.60), 1)):
            for f in os.listdir(drifted):
                os.remove(os.path.join(drifted, f))
            for r, scale in enumerate(scales, start=1):
                doc = json.loads(json.dumps(base))
                doc["parsed"]["value"] *= scale
                with open(os.path.join(drifted, f"BENCH_r{r:02d}.json"), "w") as f:
                    json.dump(doc, f)
            with contextlib.redirect_stdout(io.StringIO()) as so, \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = sentinel.main(["--dir", drifted])
            assert rc == want, f"sentinel on the {name} trajectory exited {rc}:\n{so.getvalue()}"
            out[name] = rc
    finally:
        shutil.rmtree(drifted, ignore_errors=True)
    say("obs", "sentinel ok (steady trajectory + drift trip)")
    return out


def lint_leg(ns, bounds: bool = True) -> dict:
    out = {}
    for name, flags in (("analysis", ["--device", ns.device]), ("check_doc", ["--check-doc"])):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "skyline_tpu_torch.analysis", *flags],
                           cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, f"analysis {flags} exited {r.returncode}:\n" \
            f"{r.stdout[-3000:]}\n{r.stderr[-2000:]}"
        out[name] = {"exit": r.returncode, "seconds": time.perf_counter() - t0}
    say("obs", "static-analysis gate ok")
    return out


LEGS = (("worker", worker_leg), ("prune", prune_leg), ("flush_cascade", flush_cascade_leg),
        ("sorted_sfs", sorted_sfs_leg), ("device_cascade", device_cascade_leg),
        ("tuner", tuner_leg), ("replica", replica_leg), ("bodystore", bodystore_leg),
        ("sentinel", sentinel_leg), ("lint", lint_leg))


def main(device: str, bounds: bool = True) -> dict:
    from skyline_tpu_torch.deploy.drills.common import reset_process_state

    ns = port_ns(device)
    out = {}
    for name, leg in LEGS:
        reset_process_state()
        out[name] = leg(ns, bounds)
    say("obs", "ALL PASS")
    return out

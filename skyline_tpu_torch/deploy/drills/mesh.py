"""The mesh drill: ``scripts/mesh_smoke.sh`` on the port.

A flat worker and a ``--mesh-chips 4`` worker (the sharded engine; on one
card every chip is ``cuda:0``) over identical streams — anti-correlated,
seed 11, 6,000 rows, d = 4, parallelism 8 — then:

- the sharded worker's published skyline is byte-identical (survivor count
  and point-buffer sha256) to the flat worker's;
- ``/stats`` carries the sharded block and its chip-prune counter is
  non-zero; the flat worker stamps no sharded block;
- ``/explain``'s latest plan carries per-chip attribution;
- ``/fleet`` is live on the sharded worker (per-chip ingest, imbalance,
  chip 0 ships no interconnect rows) and answers ``enabled: false`` on the
  flat one;
- ``/metrics`` carries the labeled ``skyline_chip_*`` families, the drift
  counter, and the degraded-answer counter at 0 with every chip healthy.

The evidence also counts the stream's ``-0.0`` coordinates: a numpy
whose generator gives zero rows a negative sign routes them differently.
"""

from __future__ import annotations

import json
import urllib.request
from types import SimpleNamespace

import numpy as np

from skyline_tpu_torch.deploy.drills.common import points_sha256, port_job_args, say


def port_ns(device: str) -> SimpleNamespace:
    from skyline_tpu_torch.bridge import MemoryBus, SkylineWorker
    from skyline_tpu_torch.bridge.wire import format_trigger, format_tuple_line
    from skyline_tpu_torch.workload.generators import anti_correlated

    return SimpleNamespace(
        parse_job_args=port_job_args(device), MemoryBus=MemoryBus,
        SkylineWorker=SkylineWorker, format_trigger=format_trigger,
        format_tuple_line=format_tuple_line, anti_correlated=anti_correlated)


def stream(ns):
    return ns.anti_correlated(np.random.default_rng(11), 6000, 4, 0, 10000)


def negative_zeros(x) -> int:
    """Coordinates of ``x`` that are ``-0.0``."""
    x = np.asarray(x)
    return int(((x == 0) & np.signbit(x)).sum())


def drive(ns, mesh_chips: int):
    argv = ["--stats-port", "0", "--parallelism", "8", "--dims", "4"]
    if mesh_chips:
        argv += ["--mesh-chips", str(mesh_chips)]
    cfg = ns.parse_job_args(argv)
    bus = ns.MemoryBus()
    w = ns.SkylineWorker(bus, cfg.engine_config(), stats_port=cfg.stats_port,
                         mesh_chips=cfg.mesh_chips)
    try:
        x = stream(ns)
        bus.produce_many("input-tuples", [ns.format_tuple_line(i, r) for i, r in enumerate(x)])
        bus.produce("queries", ns.format_trigger(0, 0))
        while w.step() > 0:
            pass
        # the published answer's exact bytes: survivor count + point buffer
        # (the merge cache serves the same epoch)
        counts, surv, g, pts = w.engine.pset.global_merge_stats(emit_points=True)
        digest = points_sha256(pts)
        base = f"http://127.0.0.1:{w.stats_server.port}"
        docs = {}
        for path in ("stats", "explain", "fleet"):
            with urllib.request.urlopen(f"{base}/{path}", timeout=5) as r:
                docs[path] = json.load(r)
        with urllib.request.urlopen(f"{base}/metrics", timeout=5) as r:
            metrics = r.read().decode()
    finally:
        w.close()
    return int(g), digest, docs["stats"], docs["explain"], docs["fleet"], metrics


def run(ns, bounds: bool = True) -> dict:
    g_flat, d_flat, s_flat, _, fleet_flat, _ = drive(ns, 0)
    assert "sharded" not in s_flat, "flat worker stamped a sharded block"
    assert fleet_flat["enabled"] is False, fleet_flat

    g_sh, d_sh, s_sh, plan, fleet, metrics = drive(ns, 4)
    sh = s_sh["sharded"]
    ev = {"g": g_sh, "digest": d_sh, "flat_g": g_flat, "flat_digest": d_flat,
          "chips_pruned": sh["chips_pruned"], "pruned_chip_fraction": sh["pruned_chip_fraction"],
          "merges": sh["merges"], "negative_zeros": negative_zeros(stream(ns)),
          "stream_sha256": points_sha256(stream(ns))}
    assert sh["chips"] == 4 and sh["group_size"] >= 1, sh
    assert sh["merges"] >= 1, sh
    assert sh["chips_pruned"] >= 1, f"chip-witness prefilter never fired: {sh}"
    assert 0.0 < sh["pruned_chip_fraction"] <= 0.75, sh
    assert (g_flat, d_flat) == (g_sh, d_sh), (
        f"sharded worker diverges from flat: g {g_flat} vs {g_sh}, "
        f"digest {d_flat[:12]} vs {d_sh[:12]}")

    ch = plan["chips"]
    assert ch is not None, "EXPLAIN plan lacks per-chip attribution"
    assert plan["merge"]["path"] == "sharded_tree", plan["merge"]
    assert ch["chips"] == 4, ch
    pruned_ids = {p["chip"] for p in ch["pruned"]}
    assert pruned_ids and pruned_ids.isdisjoint(ch["survivors"]), ch
    assert len(ch["per_chip"]) == 4, ch
    ev.update(explain_path=plan["merge"]["path"], pruned=sorted(pruned_ids),
              survivors=ch["survivors"])

    assert fleet["enabled"] is True and fleet["chips"] == 4, fleet
    per = {pc["chip"]: pc for pc in fleet["per_chip"]}
    assert len(per) == 4 and all(pc["ingest_rows"] > 0 for pc in per.values()), \
        f"per-chip ingest series dead: {fleet}"
    assert fleet["imbalance_index"] >= 1.0, fleet
    assert per[0]["interconnect_rows"] == 0, f"root chip shipped rows to itself: {per[0]}"
    assert 'skyline_chip_ingest_rows_total{chip="0"}' in metrics, \
        "labeled per-chip family missing from /metrics"
    assert "skyline_fleet_imbalance_index" in metrics, metrics[-400:]
    assert "skyline_workload_drift_total" in metrics, "workload drift counter missing from /metrics"
    hdoc = fleet["health"]
    assert hdoc is not None and hdoc["chips"] == 4, hdoc
    assert hdoc["quarantined"] == [], f"clean run quarantined chips: {hdoc['quarantined']}"
    assert all(pc["status"] == "healthy" for pc in hdoc["per_chip"]), hdoc
    assert "skyline_degraded_answers_total 0" in metrics, \
        "degraded-answer counter missing from /metrics on a clean run"
    ev.update(imbalance_index=fleet["imbalance_index"],
              interconnect_rows_total=fleet["interconnect_rows_total"],
              ingest_rows=[per[c]["ingest_rows"] for c in sorted(per)])

    say("mesh", f"identity ok: g={g_sh}, sha256 {d_sh[:16]}… identical flat vs 4 chips "
        f"(stream sha256 {ev['stream_sha256'][:16]}…, {ev['negative_zeros']} -0.0 "
        "coordinates)")
    say("mesh", f"chip prune ok: {sh['chips_pruned']} chip(s) pruned, "
        f"fraction={sh['pruned_chip_fraction']}")
    say("mesh", f"explain ok: path={plan['merge']['path']}, pruned={sorted(pruned_ids)}, "
        f"survivors={ch['survivors']}")
    say("mesh", f"fleet ok: imbalance={fleet['imbalance_index']}, "
        f"interconnect_rows_total={fleet['interconnect_rows_total']}, "
        "labeled chip families on /metrics")
    say("mesh", "PASS")
    return ev


# the evidence a card run must share with the CPU's plain path over the
# same rows (the stream itself may differ from another machine's: a numpy
# whose generator signs some zeros routes those rows elsewhere)
CARD_VS_CPU = ("g", "digest", "chips_pruned", "pruned", "survivors", "ingest_rows",
               "interconnect_rows_total", "stream_sha256", "negative_zeros")


def main(device: str, bounds: bool = True) -> dict:
    ev = run(port_ns(device), bounds)
    if device == "cuda":
        cpu = run(port_ns("cpu"), bounds)
        diff = [k for k in CARD_VS_CPU if ev[k] != cpu[k]]
        assert not diff, "the card and the CPU differ on the same rows: " + ", ".join(
            f"{k} {ev[k]} vs {cpu[k]}" for k in diff)
        ev["cpu"] = {k: cpu[k] for k in CARD_VS_CPU}
        say("mesh", f"card = CPU over the same rows: g={ev['g']}, {ev['chips_pruned']} chip(s) "
            f"pruned, {ev['negative_zeros']} -0.0 coordinates")
    return ev

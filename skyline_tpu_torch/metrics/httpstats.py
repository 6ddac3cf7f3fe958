"""Live observability endpoint — the Flink Web UI role.

Counterpart of ``skyline_tpu/metrics/httpstats.py``, with the same
endpoints and bodies. The reference job's operator watches Flink's Web UI
while a job runs; the engine's equivalent surface is
``SkylineEngine.stats()`` — this module serves it (plus any caller-supplied
counters) as JSON over a stdlib ``http.server`` thread, plus a
self-contained human-facing dashboard, so both ``curl
localhost:<port>/stats`` and a browser on the root URL work.

Endpoints:
  GET /         human dashboard (single self-contained HTML page polling
                /stats — headline counters, serve-plane counters, p50/p99
                latency tiles + per-partition load bars; the Flink-Web-UI
                role for an operator's browser)
  GET /stats    full stats JSON (engine counters, partitions, worker I/O,
                serve counters, latency histogram summaries)
  GET /metrics  Prometheus text exposition (stats flattened to gauges +
                telemetry counters/histograms), for a standard scraper
  GET /trace    Chrome trace-event JSON of the telemetry span ring
                (load at https://ui.perfetto.dev)
  GET /profile  per-compiled-kernel dispatch registry (wall-time EMA,
                compile-time canary, optional AOT cost_analysis figures)
  GET /slo      declarative SLO table with multi-window burn rates
  GET /debug/flight  bounded flight-recorder ring of dispatch decisions
  GET /explain  one per-query EXPLAIN plan from the hub ring
                (?version=N | ?trace_id=... | latest)
  GET /audit    audit-plane verdict: shadow-verification totals, canary
                path coverage, divergence bundles
                (?trace_id=... for one check record)
  GET /fleet    per-chip fleet join: ingest/flush/merge loads per chip,
                imbalance index + skew score, freshness watermark, last
                EXPLAIN chip attribution (sharded workers; a flat worker
                reports {"enabled": false})
  GET /health   chip-health block: {"ok": true, "enabled": false} on the
                port's flat engine (the health plane is not ported)
  GET /cluster  cluster block: {"ok": true, "enabled": false} (the cluster
                plane is not ported)
  GET /ops      the ops journal: {"ok": true, "enabled": false} (the
                journal is not ported; a hub that carries one raises)
  GET /cluster/overview  fleet-wide aggregation: {"ok": true, "enabled":
                false} with no members configured; with members
                ($SKYLINE_CLUSTERVIEW_MEMBERS) a 500 naming the unported
                scrape
  GET /healthz  {"ok": true} once serving — readiness probe for supervisors
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

_DASHBOARD = """<!doctype html>
<html><head><meta charset="utf-8"><title>tpu-skyline worker</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;background:#14171c;color:#e6e6e6}
 h1{font-size:1.2rem;font-weight:600} h2{font-size:.8rem;color:#8a93a3;
 text-transform:uppercase;letter-spacing:.05em;margin:1.2rem 0 .3rem}
 .muted{color:#8a93a3}
 .tiles{display:flex;gap:1rem;flex-wrap:wrap;margin:.4rem 0}
 .tile{background:#1e232b;border-radius:8px;padding:.8rem 1.1rem;min-width:9rem}
 .tile .v{font-size:1.5rem;font-variant-numeric:tabular-nums}
 .tile .s{font-size:.85rem;color:#b9c2d0;font-variant-numeric:tabular-nums}
 .tile .k{font-size:.75rem;color:#8a93a3;text-transform:uppercase;letter-spacing:.05em}
 table{border-collapse:collapse;margin-top:.6rem;font-variant-numeric:tabular-nums}
 td,th{padding:.25rem .7rem;text-align:right;font-size:.85rem}
 th{color:#8a93a3;font-weight:500} td:first-child,th:first-child{text-align:left}
 .bar{height:.55rem;border-radius:3px;background:#3fb68b;min-width:2px;display:inline-block}
 #err{color:#e07676}
</style></head><body>
<h1>tpu-skyline worker <span class="muted" id="ts"></span></h1>
<div class="tiles" id="tiles"></div>
<div id="serveblock" style="display:none"><h2>serving plane</h2>
<div class="tiles" id="servetiles"></div></div>
<div id="latblock" style="display:none"><h2>latency (p50 / p99 ms)</h2>
<div class="tiles" id="lattiles"></div></div>
<table id="parts"></table>
<div id="err"></div>
<script>
const fmt = n => typeof n === "number" ? n.toLocaleString("en-US") : n;
async function tick() {
  try {
    const resp = await fetch("/stats");
    const s = await resp.json();
    if (!resp.ok || s.error) throw new Error(s.error || resp.status);
    document.getElementById("err").textContent = "";
    document.getElementById("ts").textContent = new Date().toLocaleTimeString();
    const tiles = [
      ["records in", s.records_in], ["results", s.results_emitted],
      ["in-flight queries", s.inflight_queries],
      ["pending rows", s.pending_flush_rows],
      ["dropped", s.dropped], ["prefiltered", s.prefiltered],
      ["device ms", s.processing_ms && Math.round(s.processing_ms)],
      ["meshed", s.meshed],
      ["slides closed", s.slides_closed],
      ["merge cache hits", s.merge_cache && s.merge_cache.hits],
      ["merge cache misses", s.merge_cache && s.merge_cache.misses],
      ["delta merges", s.merge_cache && s.merge_cache.delta_merges],
      ["dirty fraction", s.merge_cache && s.merge_cache.last_dirty_fraction],
      ["prefilter dropped", s.flush_cascade && s.flush_cascade.prefilter_dropped],
      ["prefilter drop frac", s.flush_cascade && s.flush_cascade.prefilter_drop_fraction],
      ["bf16 resolved", s.flush_cascade && s.flush_cascade.bf16_resolved],
    ].filter(([, v]) => v !== undefined && v !== null);
    document.getElementById("tiles").innerHTML = tiles.map(
      ([k, v]) => `<div class="tile"><div class="v">${fmt(v)}</div><div class="k">${k}</div></div>`
    ).join("");
    const sv = s.serve, st = s.snapshot_store;
    const serveTiles = sv === undefined ? [] : [
      ["reads served", sv.reads_served || 0],
      ["reads shed (429)", sv.reads_shed || 0],
      ["stale rejected (503)", sv.stale_rejected || 0],
      ["delta re-baselines (410)", sv.deltas_gone || 0],
      ["queries shed (429)", sv.queries_shed || 0],
      ["read-cache hits", sv.read_cache_hits],
      ["snapshot version", st && st.head_version],
      ["version lag", st && st.version_lag],
      ["publishes deduped", st && st.deduped],
    ].filter(([, v]) => v !== undefined);
    document.getElementById("serveblock").style.display =
      serveTiles.length ? "" : "none";
    document.getElementById("servetiles").innerHTML = serveTiles.map(
      ([k, v]) => `<div class="tile"><div class="v">${fmt(v)}</div><div class="k">${k}</div></div>`
    ).join("");
    const lat = s.latency_ms || {};
    const latTiles = Object.entries(lat).filter(([, h]) => h.count > 0).map(
      ([name, h]) =>
        `<div class="tile"><div class="s">${fmt(h.p50)} / ${fmt(h.p99)}</div>` +
        `<div class="k">${name} (n=${fmt(h.count)})</div></div>`
    );
    document.getElementById("latblock").style.display =
      latTiles.length ? "" : "none";
    document.getElementById("lattiles").innerHTML = latTiles.join("");
    const p = s.partitions || {};
    const seen = p.records_seen || [], ids = p.max_seen_id || [],
          sky = p.skyline_counts;
    const mx = Math.max(1, ...seen);
    let rows = `<tr><th>partition</th><th>records</th><th style="text-align:left">load</th><th>max id</th>${sky ? "<th>skyline</th>" : ""}</tr>`;
    for (let i = 0; i < seen.length; i++) {
      rows += `<tr><td>p${i}</td><td>${fmt(seen[i])}</td>` +
        `<td style="text-align:left"><span class="bar" style="width:${Math.round(140 * seen[i] / mx)}px"></span></td>` +
        `<td>${fmt(ids[i])}</td>${sky ? `<td>${fmt(sky[i])}</td>` : ""}</tr>`;
    }
    document.getElementById("parts").innerHTML = rows;
  } catch (e) { document.getElementById("err").textContent = "stats fetch failed: " + e; }
}
tick(); setInterval(tick, 1000);
</script></body></html>"""


class StatsServer:
    """Background stats server: JSON (/stats, /healthz), Prometheus
    (/metrics), Chrome trace JSON (/trace) + dashboard (/).

    ``callback`` is invoked per /stats (and /metrics) request and must
    return a JSON-serializable dict; exceptions become a 500 with the error
    message (the server never takes the worker down). ``telemetry`` is an
    optional ``telemetry.Telemetry`` hub — its counters and histograms join
    the exposition and its span ring backs /trace.
    """

    def __init__(self, callback, port: int, host: str = "127.0.0.1", telemetry=None):
        self._callback = callback
        self.telemetry = telemetry
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(handler):  # noqa: N805 — http.server API
                # handler.path carries the raw query string; split it so
                # parameterized endpoints (/explain?version=) route like
                # their bare forms
                path, _, qs = handler.path.partition("?")
                if path == "/healthz":
                    handler._reply(200, {"ok": True})
                elif path == "/stats":
                    try:
                        handler._reply(200, callback())
                    except Exception as e:
                        handler._reply(500, {"error": str(e)})
                elif path == "/metrics":
                    try:
                        body, ctype = outer._render_metrics()
                        handler._reply_raw(200, body, ctype)
                    except Exception as e:
                        handler._reply(500, {"error": str(e)})
                elif path == "/trace":
                    doc = (
                        outer.telemetry.spans.to_chrome()
                        if outer.telemetry is not None
                        else {"traceEvents": []}
                    )
                    handler._reply(200, doc)
                elif path == "/profile":
                    if outer.telemetry is None:
                        handler._reply(404, {"error": "no telemetry hub"})
                    else:
                        handler._reply(200, outer.telemetry.profiler.doc())
                elif path == "/slo":
                    if outer.telemetry is None:
                        handler._reply(404, {"error": "no telemetry hub"})
                    else:
                        handler._reply(200, outer.telemetry.slo.evaluate())
                elif path == "/debug/flight":
                    if outer.telemetry is None:
                        handler._reply(404, {"error": "no telemetry hub"})
                    else:
                        handler._reply(200, outer.telemetry.flight.doc())
                elif path == "/explain":
                    if outer.telemetry is None:
                        handler._reply(404, {"error": "no telemetry hub"})
                    else:
                        code, doc = outer._explain_doc(qs)
                        handler._reply(code, doc)
                elif path == "/audit":
                    if outer.telemetry is None:
                        handler._reply(404, {"error": "no telemetry hub"})
                    else:
                        code, doc = outer._audit_doc(qs)
                        handler._reply(code, doc)
                elif path == "/dispatch":
                    # the declarative cascade table + live tuner decisions
                    # — works even without a hub: the table is module
                    # state, only the tuner block needs telemetry
                    from skyline_tpu_torch.telemetry.tuner import dispatch_doc

                    handler._reply(200, dispatch_doc(outer.telemetry))
                elif path == "/fleet":
                    if outer.telemetry is None:
                        handler._reply(404, {"error": "no telemetry hub"})
                    else:
                        try:
                            handler._reply(200, outer._fleet_doc())
                        except Exception as e:
                            handler._reply(500, {"error": str(e)})
                elif path == "/health":
                    handler._reply(200, outer._health_doc())
                elif path == "/cluster":
                    try:
                        handler._reply(200, outer._cluster_doc())
                    except Exception as e:
                        handler._reply(500, {"error": str(e)})
                elif path == "/ops":
                    code, doc = outer._ops_doc(qs)
                    handler._reply(code, doc)
                elif path == "/cluster/overview":
                    try:
                        handler._reply(200, outer._overview_doc())
                    except Exception as e:
                        handler._reply(500, {"error": str(e)})
                elif path in ("/", "/ui"):
                    handler._reply_raw(
                        200, _DASHBOARD.encode(), "text/html; charset=utf-8"
                    )
                else:
                    handler._reply(404, {"error": "not found"})

            def _reply(handler, code: int, doc: dict):
                handler._reply_raw(
                    code, json.dumps(doc).encode(), "application/json"
                )

            def _reply_raw(handler, code: int, body: bytes, ctype: str):
                handler.send_response(code)
                handler.send_header("Content-Type", ctype)
                handler.send_header("Content-Length", str(len(body)))
                handler.end_headers()
                handler.wfile.write(body)

            def log_message(handler, *args):  # silence per-request stderr
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]  # resolved when port=0
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def _explain_doc(self, qs: str) -> tuple[int, dict]:
        """Resolve an /explain request against the hub's plan ring:
        ``version=N`` → newest plan published under snapshot version N,
        ``trace_id=...`` → span/flight join, neither → latest plan."""
        params = {k: v[-1] for k, v in parse_qs(qs).items()}
        rec = self.telemetry.explain
        version = params.get("version")
        if version is not None:
            try:
                version = int(version)
            except ValueError:
                return 400, {"error": f"bad version {version!r}"}
            plan = rec.by_version(version)
        elif params.get("trace_id"):
            plan = rec.by_trace(params["trace_id"])
        else:
            plan = rec.latest()
        if plan is None:
            return 404, {"error": "no matching plan", "ring": rec.doc()}
        return 200, plan

    def _audit_doc(self, qs: str) -> tuple[int, dict]:
        """Resolve an /audit request against the hub's verdict ring:
        ``trace_id=...`` → the check record for that snapshot's trace
        (the /explain and /trace join), no params → the full verdict."""
        params = {k: v[-1] for k, v in parse_qs(qs).items()}
        rec = self.telemetry.audit
        if params.get("trace_id"):
            check = rec.by_trace(params["trace_id"])
            if check is None:
                return 404, {"error": "no matching check", "ring": rec.doc()}
            return 200, check
        return 200, rec.doc()

    def _fleet_doc(self) -> dict:
        """The /fleet join: per-chip stats + freshness watermark + last
        EXPLAIN chip attribution (telemetry/fleet.py)."""
        from skyline_tpu_torch.telemetry import fleet_doc

        return fleet_doc(self.telemetry, self._callback())

    def _health_doc(self) -> dict:
        """The /health chip block (RUNBOOK §2p): per-chip health scores +
        quarantine state. Probe-friendly on flat workers — ``enabled`` is
        false and the chip list is absent when no ChipHealth is attached."""
        health = (
            getattr(self.telemetry, "health", None)
            if self.telemetry is not None
            else None
        )
        if health is None:
            return {"ok": True, "enabled": False}
        doc = health.doc()
        doc["ok"] = not doc.get("quarantined")
        doc["enabled"] = True
        return doc

    def _cluster_doc(self) -> dict:
        """The /cluster block (RUNBOOK §2r): lease/role state + per-host
        ingest/merge/prune stats. Probe-friendly on non-cluster workers —
        ``enabled`` is false when no ClusterStatus is attached."""
        status = (
            getattr(self.telemetry, "cluster", None)
            if self.telemetry is not None
            else None
        )
        if status is None:
            return {"ok": True, "enabled": False}
        return status.doc()

    def _ops_doc(self, qs: str) -> tuple[int, dict]:
        """The /ops journal tail. Probe-friendly — ``enabled`` is false
        when this process opened no journal, which the port cannot yet
        (ROADMAP queue 1 item 6): a hub that carries one raises instead
        of answering a doc this server did not compute."""
        params = {k: v[-1] for k, v in parse_qs(qs).items()}
        try:
            int(params["since_seq"]) if "since_seq" in params else None
            int(params["limit"]) if "limit" in params else None
        except ValueError:
            return 400, {"error": "since_seq/limit must be integers"}
        ops = (
            getattr(self.telemetry, "opslog", None)
            if self.telemetry is not None
            else None
        )
        if ops is None:
            return 200, {"ok": True, "enabled": False}
        raise NotImplementedError(
            "the ops journal is not ported yet (ROADMAP queue 1 item 6)"
        )

    def _overview_doc(self) -> dict:
        """The /cluster/overview fleet aggregation (RUNBOOK §2s)."""
        from skyline_tpu_torch.telemetry.clusterview import overview_doc

        return overview_doc(self.telemetry)

    def _render_metrics(self) -> tuple[bytes, str]:
        """Prometheus text: the stats dict flattened to gauges, plus the
        telemetry hub's counters and histograms when attached."""
        from skyline_tpu_torch.telemetry import (
            PROMETHEUS_CONTENT_TYPE,
            flatten_gauges,
            render_prometheus,
        )

        stats = self._callback()
        # latency summaries are already exposed as real histogram series
        # below; don't double-flatten their p50/p99 into gauges
        gauges = flatten_gauges(
            {k: v for k, v in stats.items() if k != "latency_ms"}
        )
        if self.telemetry is not None:
            body = self.telemetry.render_prometheus(gauges=gauges)
        else:
            body = render_prometheus(gauges=gauges)
        return body.encode(), PROMETHEUS_CONTENT_TYPE

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

"""Asyncio HTTP server for the query-serving plane (stdlib only).

Counterpart of ``skyline_tpu/serve/server.py``, with the same endpoints,
codes, headers and bodies. The read-heavy counterpart of ``metrics/httpstats.py``: that module serves
operator observability; this one serves the skyline itself. Endpoints:

  GET  /skyline   snapshot read — latest published version, lock-free.
                  Query params: ``max_age_ms`` / ``max_version_lag``
                  (staleness bound; violating it is a 503 unless
                  ``allow_stale=1``), ``refresh=1`` (a stale read fires a
                  refresh merge through the query bridge instead of
                  blocking on one), ``points=0`` (headers only), ``format=csv`` (the
                  wire.py data-plane line format instead of JSON).
  POST /query     force a fresh consistency merge (reference-parity
                  semantics: an immediate trigger through the engine's
                  query plane) — admission-controlled, deadline-bounded.
  GET  /deltas    ``?since=<version>``: what entered/left the skyline
                  between that version and the head, from the bounded
                  delta ring; 410 Gone + ``"resync": true`` once ``since``
                  fell behind the ring (re-baseline with GET /skyline).
  GET  /subscribe SSE push of published deltas (``event: delta`` per
                  publish; ``event: resync`` when the subscriber must
                  re-baseline — slow consumer or ring overrun).
                  ``?since=V`` replays the net ring catch-up first.
  GET  /healthz   readiness probe.
  GET  /stats     the ``stats_cb`` doc (engine counters) plus serve-plane
                  counters.
  GET  /metrics   Prometheus text exposition (admission counters, snapshot
                  store gauges, latency histograms incl. serve read p50/p99).
  GET  /trace     Chrome trace-event JSON of the telemetry span ring
                  (Perfetto-loadable): ingest → local → merge → publish
                  spans per query when the engine shares its hub here.
  GET  /profile   per-dispatch-signature kernel profile (variant, d,
                  N-bucket, backend, mp → calls / wall / EMA / retrace
                  canary, optional cost_analysis columns).
  GET  /slo       declarative SLO table with multi-window burn rates
                  (read p99, freshness lag p99, shed fraction, restarts,
                  audit divergence).
  GET  /debug/flight  the flight recorder — last N engine decisions
                  (dispatch / cascade / prune / cache), crash black box.
  GET  /audit     audit-plane verdict: shadow-verification totals, canary
                  path coverage, divergence bundles (``?trace_id=`` joins
                  one check back to /explain and /trace).
  GET  /fleet     per-chip fleet join: ingest/flush/merge loads per chip,
                  imbalance index + skew score, freshness watermark, last
                  EXPLAIN chip attribution (sharded workers; flat workers
                  report {"enabled": false}).
  GET  /health    chip-health block: per-chip score/status + quarantine
                  state from the sharded engine's ``ChipHealth`` on the hub
                  (``resilience/health.py``); a flat engine answers
                  ``{"ok": true, "enabled": false}``.
  GET  /cluster   cluster block: lease/role state, fenced-write and
                  promotion counts, per-host stats from the hub's
                  ``ClusterStatus`` (``cluster/lease.py``); ``{"ok": true,
                  "enabled": false}`` outside a cluster.
  GET  /ops       the ops journal's merged timeline (``?since_seq=N``,
                  ``?limit=N``); ``{"ok": true, "enabled": false}`` when no
                  journal is attached.
  GET  /cluster/overview  fleet-wide aggregation: ``{"ok": true,
                  "enabled": false}`` with no members configured; else the
                  ``ClusterView`` scrape of every member
                  (``telemetry/clusterview.py``).

Requests never touch the engine: reads come off the ``SnapshotStore``;
forced queries cross to the engine-owner thread through ``QueryBridge``
(a loop on that thread drains it: ``bridge.inject(engine)``,
``engine.poll_results()``, ``bridge.fulfill(results)``), so the engine
stays single-threaded. Load shedding is explicit: 429 + Retry-After from the
admission controller, never an unbounded queue.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from collections import OrderedDict, deque
from urllib.parse import parse_qs, urlsplit

from skyline_tpu_torch.serve.admission import AdmissionController
from skyline_tpu_torch.telemetry import (
    PROMETHEUS_CONTENT_TYPE,
    Telemetry,
    flatten_gauges,
)

_MAX_HEADER = 16_384
_MAX_BODY = 1_048_576


class ServeConfig:
    """Knob bundle for the serving plane."""

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        read_rate: float = 0.0,  # snapshot-read tokens/s; 0 = unlimited
        read_burst: int = 256,
        max_concurrent_queries: int = 2,
        max_query_queue: int = 8,
        query_deadline_ms: float = 10_000.0,
        delta_ring: int = 128,
        history: int = 64,
        read_cache_entries: int = 64,
        tenant_rate: float = 0.0,  # per-tenant read tokens/s; 0 disables
        tenant_burst: int = 64,
    ):
        self.port = port
        self.host = host
        self.read_rate = read_rate
        self.read_burst = read_burst
        self.max_concurrent_queries = max_concurrent_queries
        self.max_query_queue = max_query_queue
        self.query_deadline_ms = query_deadline_ms
        self.delta_ring = delta_ring
        self.history = history
        self.read_cache_entries = read_cache_entries
        self.tenant_rate = tenant_rate
        self.tenant_burst = tenant_burst

    def admission(self, counters=None) -> AdmissionController:
        return AdmissionController(
            read_rate=self.read_rate,
            read_burst=self.read_burst,
            max_concurrent_queries=self.max_concurrent_queries,
            max_query_queue=self.max_query_queue,
            query_deadline_ms=self.query_deadline_ms,
            counters=counters,
            tenant_rate=self.tenant_rate,
            tenant_burst=self.tenant_burst,
        )


class _PendingQuery:
    __slots__ = ("qid", "event", "result")

    def __init__(self, qid: str):
        self.qid = qid
        self.event = threading.Event()
        self.result = None

    def wait(self, timeout_s: float) -> bool:
        return self.event.wait(timeout_s)


class QueryBridge:
    """Hands forced queries from HTTP threads to the engine-owner thread.

    HTTP side: ``submit()`` returns a pending handle to wait on. Engine
    side (the loop on the engine's thread): ``inject(engine)`` turns
    submissions into immediate triggers, ``fulfill(results)`` routes the
    engine's completed results back to their waiters and returns the
    non-serve leftovers (the loop's own results). Forced-query
    qids are namespaced so they can never collide with bus triggers.
    """

    PREFIX = "__serve-"

    def __init__(self):
        self._lock = threading.Lock()
        self._seq = 0
        self._to_inject: deque[_PendingQuery] = deque()
        self._awaiting: dict[str, _PendingQuery] = {}

    def submit(self) -> _PendingQuery:
        with self._lock:
            self._seq += 1
            p = _PendingQuery(f"{self.PREFIX}{self._seq}")
            self._to_inject.append(p)
            return p

    def inject(self, engine) -> int:
        """Dispatch queued submissions as immediate (required=0) triggers —
        reference-parity consistency-merge semantics. Engine thread only."""
        n = 0
        while True:
            with self._lock:
                if not self._to_inject:
                    return n
                p = self._to_inject.popleft()
                self._awaiting[p.qid] = p
            engine.process_trigger(f"{p.qid},0")
            n += 1

    def fulfill(self, results: list[dict]) -> list[dict]:
        """Route completed serve queries to their waiters; return the rest."""
        out = []
        for r in results:
            qid = str(r.get("query_id", ""))
            if qid.startswith(self.PREFIX):
                with self._lock:
                    p = self._awaiting.pop(qid, None)
                if p is not None:
                    p.result = r
                    p.event.set()
            else:
                out.append(r)
        return out

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._to_inject) + len(self._awaiting)

    @property
    def pending_injections(self) -> int:
        """Submissions not yet dispatched to the engine (the slice of
        ``depth`` the next ``inject`` call will actually run)."""
        with self._lock:
            return len(self._to_inject)


class SkylineServer:
    """The serving-plane HTTP front end (asyncio loop on a daemon thread)."""

    def __init__(
        self,
        store,
        deltas=None,
        admission: AdmissionController | None = None,
        stats_cb=None,
        bridge: QueryBridge | None = None,
        port: int = 0,
        host: str = "127.0.0.1",
        telemetry=None,
        read_cache: int = 64,
        max_stale_ms: float | None = None,
        role: str = "primary",
        bodystore=None,
    ):
        """``max_stale_ms``: the staleness fence — any ``/skyline`` read
        whose snapshot is older than this (event-time watermark when
        available, publish age otherwise) is refused with 503 +
        Retry-After, regardless of ``allow_stale``. The replica plane's
        honesty contract; None (primary default) disables. ``role`` rides
        ``/healthz`` and fence rejections so probes can tell a replica
        from the primary. ``bodystore``: a ``serve/bodystore.py``
        BodyStore (primary, publish-time serialized bodies) or
        BodyStoreReader (replica, the PRIMARY's exact bytes via the shared
        mmap) consulted between the LRU and the serialize-on-miss path."""
        self.store = store
        self.deltas = deltas
        self.bodystore = bodystore
        self.admission = admission if admission is not None else AdmissionController()
        self.stats_cb = stats_cb
        self.bridge = bridge
        self.max_stale_ms = max_stale_ms
        self.role = role
        # read-side result cache: serialized response bodies keyed by
        # (snapshot version, format/projection) — snapshots are immutable,
        # so repeated reads of the same version skip re-serialization (the
        # points tolist + json.dumps dominate big-skyline reads). Every
        # handler runs on the single asyncio loop thread, so the
        # OrderedDict LRU needs no lock. ``read_cache`` bounds entries;
        # 0 disables.
        self._read_cache: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._read_cache_cap = max(0, int(read_cache))
        # the engine shares its hub so engine spans/histograms surface on
        # /metrics and /trace here; a standalone server gets its own (the
        # read-latency histogram still works)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        # the SLO engine samples shed/served counts from this plane's
        # admission controller (they live on it, not the hub)
        self.telemetry.slo.attach_admission(self.admission)
        from skyline_tpu_torch.utils.knobs import env_float

        self._ready_timeout_s = env_float("SKYLINE_SERVE_READY_TIMEOUT_S", 10.0)
        self._shutdown_timeout_s = env_float(
            "SKYLINE_SERVE_SHUTDOWN_TIMEOUT_S", 10.0
        )
        self._header_timeout_s = env_float(
            "SKYLINE_SERVE_HEADER_TIMEOUT_S", 10.0
        )
        from skyline_tpu_torch.utils.knobs import env_int

        # SSE push (GET /subscribe): per-subscriber bounded queues fed from
        # the store's publish hook. Overflow (a slow consumer) clears the
        # queue and enqueues a resync marker — the stream never silently
        # drops a delta without telling the subscriber to re-baseline.
        self._sse_queue_cap = max(1, env_int("SKYLINE_SERVE_SSE_QUEUE", 64))
        self._sse_queues: set = set()  # mutated on the loop thread only
        self._sse_events = 0
        self._loop = asyncio.new_event_loop()
        self._server = None
        self._startup_error: BaseException | None = None
        self.port = None
        ready = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(host, port, ready), daemon=True
        )
        self._thread.start()
        ready.wait(timeout=self._ready_timeout_s)
        if self._startup_error is not None:
            raise self._startup_error
        # subscribe only once the loop is live (never on a failed startup):
        # the hook bounces publish events onto the loop thread for SSE fanout
        store.on_publish(self._sse_on_publish)

    def _run(self, host, port, ready):
        asyncio.set_event_loop(self._loop)
        try:
            self._server = self._loop.run_until_complete(
                asyncio.start_server(self._handle, host, port)
            )
            self.port = self._server.sockets[0].getsockname()[1]
        except BaseException as e:  # surfaced to __init__
            self._startup_error = e
            ready.set()
            return
        ready.set()
        try:
            self._loop.run_forever()
        finally:
            self._server.close()
            self._loop.run_until_complete(self._server.wait_closed())
            # long-lived /subscribe streams outlive run_forever: cancel and
            # reap them so loop.close() never destroys a pending task
            pending = [
                t for t in asyncio.all_tasks(self._loop) if not t.done()
            ]
            for t in pending:
                t.cancel()
            if pending:
                self._loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
            self._loop.close()

    def close(self) -> None:
        if self._startup_error is not None:
            return
        self._loop.call_soon_threadsafe(self._sse_shutdown)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=self._shutdown_timeout_s)

    # -- SSE push (/subscribe) ---------------------------------------------

    def _sse_on_publish(self, prev, snap) -> None:
        """Store publish hook (engine thread): shape one SSE event and hand
        it to the loop thread. The ring subscribed before this server, so
        its tail delta is the one for ``snap``."""
        if self._startup_error is not None or not self._sse_queues:
            return
        tail = self.deltas.latest() if self.deltas is not None else None
        if tail is not None and tail.to_version == snap.version:
            # preserialize the payload ONCE here (publish time) via the
            # Delta's memoized row fragments — every subscriber then gets
            # the same bytes with no per-connection serialization. The
            # splice is byte-identical to json.dumps of the equivalent
            # doc (test-asserted).
            payload = (
                b'{"from_version": ' + str(tail.from_version).encode()
                + b', "to_version": ' + str(tail.to_version).encode()
                + b', "watermark_id": ' + str(snap.watermark_id).encode()
                + b', "entered": ' + tail.entered_json()
                + b', "left": ' + tail.left_json()
                + b', "meta": ' + json.dumps(snap.meta).encode()
                + b"}"
            )
            event = ("delta", payload)
        else:  # no ring: announce the version; subscribers re-read
            event = ("resync", {"head_version": snap.version})
        try:
            self._loop.call_soon_threadsafe(self._sse_fanout, event)
        except RuntimeError:  # loop already closed (shutdown race)
            pass

    def _sse_fanout(self, event) -> None:
        """Loop thread: enqueue to every subscriber; a full queue (slow
        consumer) is cleared and handed an explicit resync marker instead
        of silently dropping deltas."""
        self._sse_events += 1
        for q in list(self._sse_queues):
            if q.full():
                while not q.empty():
                    q.get_nowait()
                q.put_nowait(
                    (
                        "resync",
                        {
                            "head_version": self.store.head_version,
                            "reason": "subscriber fell behind",
                        },
                    )
                )
            else:
                q.put_nowait(event)

    def _sse_shutdown(self) -> None:
        for q in list(self._sse_queues):
            if q.full():
                while not q.empty():
                    q.get_nowait()
            q.put_nowait(None)  # sentinel: stream handlers exit cleanly

    async def _subscribe(self, writer, params):
        """SSE stream of published deltas. ``?since=V`` replays the net
        catch-up from the ring first; a ``since`` behind the ring (or no
        ring) opens with an explicit ``resync`` event — same contract as
        the 410 on ``/deltas``."""
        try:
            since = _int_param(params, "since")
        except ValueError as e:
            await self._reply(writer, 400, {"error": str(e)})
            return
        head = [
            "HTTP/1.1 200 OK",
            "Content-Type: text/event-stream",
            "Cache-Control: no-cache",
            "Connection: close",
        ]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
        q: asyncio.Queue = asyncio.Queue(maxsize=self._sse_queue_cap)
        self._sse_queues.add(q)
        try:
            if since is not None:
                res = self.deltas.since(since) if self.deltas is not None else None
                if res is None:
                    await self._sse_write(
                        writer,
                        "resync",
                        {
                            "since": since,
                            "head_version": self.store.head_version,
                            "hint": "re-baseline with GET /skyline",
                        },
                    )
                else:
                    entered, left, hv = res
                    from skyline_tpu_torch.serve.bodystore import points_json

                    await self._sse_write(
                        writer,
                        "delta",
                        b'{"from_version": ' + str(since).encode()
                        + b', "to_version": ' + str(hv).encode()
                        + b', "entered": ' + points_json(entered)
                        + b', "left": ' + points_json(left)
                        + b"}",
                    )
            while True:
                try:
                    item = await asyncio.wait_for(q.get(), timeout=15.0)
                except asyncio.TimeoutError:
                    writer.write(b": keepalive\n\n")
                    await writer.drain()
                    continue
                if item is None:
                    break
                await self._sse_write(writer, item[0], item[1])
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._sse_queues.discard(q)

    async def _sse_write(self, writer, kind: str, doc) -> None:
        """``doc``: a dict (serialized here) or preserialized payload bytes
        (the publish-time fast path — one encode shared by every stream)."""
        data = doc if isinstance(doc, bytes) else json.dumps(doc).encode()
        writer.write(b"event: " + kind.encode() + b"\ndata: " + data + b"\n\n")
        await writer.drain()

    # -- request plumbing --------------------------------------------------

    async def _handle(self, reader, writer):
        try:
            try:
                head = await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"),
                    timeout=self._header_timeout_s,
                )
            except (
                asyncio.IncompleteReadError,
                asyncio.LimitOverrunError,
                asyncio.TimeoutError,
            ):
                return
            if len(head) > _MAX_HEADER:
                await self._reply(writer, 431, {"error": "headers too large"})
                return
            lines = head.decode("latin-1").split("\r\n")
            parts = lines[0].split(" ")
            if len(parts) != 3:
                await self._reply(writer, 400, {"error": "bad request line"})
                return
            method, target, _version = parts
            headers = {}
            for ln in lines[1:]:
                if ":" in ln:
                    k, _, v = ln.partition(":")
                    headers[k.strip().lower()] = v.strip()
            clen = int(headers.get("content-length", "0") or "0")
            if clen > _MAX_BODY:
                await self._reply(writer, 413, {"error": "body too large"})
                return
            if clen:
                await reader.readexactly(clen)  # body currently unused
            url = urlsplit(target)
            params = {k: v[-1] for k, v in parse_qs(url.query).items()}
            await self._route(writer, method, url.path, params, headers)
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _route(self, writer, method, path, params, headers=None):
        tenant = (headers or {}).get("x-tenant")
        if path == "/healthz":
            await self._reply(
                writer,
                200,
                {
                    "ok": True,
                    "published": self.store.published > 0,
                    "role": self.role,
                },
            )
        elif path == "/stats" and method == "GET":
            await self._reply(writer, 200, self._stats())
        elif path == "/metrics" and method == "GET":
            await self._metrics(writer)
        elif path == "/trace" and method == "GET":
            await self._reply(writer, 200, self.telemetry.spans.to_chrome())
        elif path == "/skyline" and method == "GET":
            t0 = time.perf_counter_ns()
            await self._skyline(writer, params, tenant=tenant)
            self.telemetry.histogram("serve_read_ms").observe(
                (time.perf_counter_ns() - t0) / 1e6
            )
        elif path == "/deltas" and method == "GET":
            t0 = time.perf_counter_ns()
            await self._deltas(writer, params, tenant=tenant)
            self.telemetry.histogram("serve_read_ms").observe(
                (time.perf_counter_ns() - t0) / 1e6
            )
        elif path == "/subscribe" and method == "GET":
            await self._subscribe(writer, params)
        elif path == "/query" and method == "POST":
            await self._query(writer)
        elif path == "/profile" and method == "GET":
            await self._reply(writer, 200, self.telemetry.profiler.doc())
        elif path == "/slo" and method == "GET":
            await self._reply(writer, 200, self.telemetry.slo.evaluate())
        elif path == "/debug/flight" and method == "GET":
            await self._reply(writer, 200, self.telemetry.flight.doc())
        elif path == "/explain" and method == "GET":
            await self._explain(writer, params)
        elif path == "/audit" and method == "GET":
            await self._audit(writer, params)
        elif path == "/dispatch" and method == "GET":
            await self._dispatch(writer)
        elif path == "/fleet" and method == "GET":
            await self._fleet(writer)
        elif path == "/health" and method == "GET":
            await self._health(writer)
        elif path == "/cluster" and method == "GET":
            await self._cluster(writer)
        elif path == "/ops" and method == "GET":
            await self._ops(writer, params)
        elif path == "/cluster/overview" and method == "GET":
            await self._overview(writer)
        else:
            await self._reply(writer, 404, {"error": "not found"})

    def _stats(self) -> dict:
        try:
            out = dict(self.stats_cb()) if self.stats_cb is not None else {}
        except Exception as e:  # observability must not 500 the plane down
            out = {"stats_error": str(e)}
        out["serve"] = self.admission.stats()
        out["serve"]["role"] = self.role
        out["serve"]["sse_subscribers"] = len(self._sse_queues)
        out["serve"]["sse_events"] = self._sse_events
        if self.max_stale_ms is not None:
            out["serve"]["max_stale_ms"] = self.max_stale_ms
        out["snapshot_store"] = self.store.stats()
        if self.bodystore is not None:
            out["bodystore"] = self.bodystore.stats()
        if self.deltas is not None:
            out["delta_ring"] = self.deltas.stats()
        if self.bridge is not None:
            out["serve"]["bridge_depth"] = self.bridge.depth
        return out

    # -- read-side result cache --------------------------------------------

    def _cache_get(self, key) -> bytes | None:
        body = self._read_cache.get(key)
        if body is None:
            self.admission.counters.inc("read_cache_misses")
            return None
        self._read_cache.move_to_end(key)
        self.admission.counters.inc("read_cache_hits")
        return body

    def _cache_put(self, key, body: bytes) -> None:
        if self._read_cache_cap == 0:
            return
        self._read_cache[key] = body
        self._read_cache.move_to_end(key)
        while len(self._read_cache) > self._read_cache_cap:
            self._read_cache.popitem(last=False)

    def _body_get(self, version: int, fmt: int) -> bytes | None:
        """The body store tier between the LRU and serialize-on-miss: the
        publisher's preserialized bytes (primary: retained objects;
        replica: the primary's mmap frames behind the seqlock+fence
        check). Hits/misses/torn reads are counted on the store itself and
        surfaced by /metrics as ``skyline_serve_bodystore_*``."""
        if self.bodystore is None:
            return None
        return self.bodystore.get(version, fmt)

    # -- endpoints ---------------------------------------------------------

    async def _metrics(self, writer):
        """Prometheus text exposition: admission counters (as counters),
        snapshot-store / delta-ring stats (as gauges), histograms."""
        gauges = flatten_gauges({"snapshot_store": self.store.stats()})
        if self.deltas is not None:
            gauges.update(flatten_gauges({"delta_ring": self.deltas.stats()}))
        if self.bridge is not None:
            gauges["serve_bridge_depth"] = float(self.bridge.depth)
        gauges["serve_query_depth"] = float(self.admission.queries.depth)
        gauges["serve_sse_subscribers"] = float(len(self._sse_queues))
        counters = {
            f"serve_{k}": v
            for k, v in self.admission.counters.snapshot().items()
        }
        if self.bodystore is not None:
            # zero-copy body-store families: hits/misses/torn_reads/retries
            # plus the publish-side serializer tallies (RUNBOOK §2u)
            counters.update(
                {
                    f"serve_bodystore_{k}": v
                    for k, v in self.bodystore.stats().items()
                }
            )
        # per-tenant admission series: one labeled family per outcome, so
        # dashboards see exactly who is being shed
        tenants = self.admission.tenant_stats()
        labeled = None
        if tenants:
            labeled = {
                "serve_tenant_reads_admitted": [
                    ((("tenant", t),), row["admitted"])
                    for t, row in tenants.items()
                ],
                "serve_tenant_reads_shed": [
                    ((("tenant", t),), row["shed"])
                    for t, row in tenants.items()
                ],
            }
        body = self.telemetry.render_prometheus(
            gauges=gauges,
            extra_counters=counters,
            extra_labeled_counters=labeled,
        ).encode()
        await self._reply_raw(writer, 200, body, PROMETHEUS_CONTENT_TYPE)

    async def _skyline(self, writer, params, tenant=None):
        ok, retry = self.admission.admit_read(tenant=tenant)
        if not ok:
            await self._reply(
                writer,
                429,
                {"error": "rate limited", "retry_after_s": round(retry, 3)},
                retry_after=retry,
            )
            return
        try:
            max_age = _float_param(params, "max_age_ms")
            max_lag = _int_param(params, "max_version_lag")
        except ValueError as e:
            await self._reply(writer, 400, {"error": str(e)})
            return
        rs = self.store.read(max_age_ms=max_age, max_version_lag=max_lag)
        if rs is None:
            await self._reply(
                writer, 503, {"error": "no snapshot published yet"}
            )
            return
        if (
            self.max_stale_ms is not None
            and rs.staleness_ms is not None
            and rs.staleness_ms > self.max_stale_ms
        ):
            # the staleness fence: a replica that fell too far behind the
            # WAL refuses to answer rather than serve silently ancient
            # data — allow_stale bounds the CLIENT's tolerance, never the
            # server's own honesty contract
            self.admission.counters.inc("fence_rejected")
            await self._reply(
                writer,
                503,
                {
                    "error": "staleness fence exceeded",
                    "role": self.role,
                    "version": rs.snapshot.version,
                    "staleness_ms": round(rs.staleness_ms, 1),
                    "max_stale_ms": self.max_stale_ms,
                    "stale": True,
                },
                retry_after=1.0,
            )
            return
        refresh_triggered = False
        if not rs.fresh:
            self.admission.counters.inc("stale_reads")
            if params.get("refresh") == "1" and self.bridge is not None:
                # fire the refresh merge, serve (or reject) without blocking
                self.bridge.submit()
                self.admission.counters.inc("refreshes_triggered")
                refresh_triggered = True
            if params.get("allow_stale") != "1":
                self.admission.counters.inc("stale_rejected")
                await self._reply(
                    writer,
                    503,
                    {
                        "error": "snapshot stale for requested bound",
                        "version": rs.snapshot.version,
                        "age_ms": round(rs.age_ms, 1),
                        "version_lag": rs.version_lag,
                        "refresh_triggered": refresh_triggered,
                    },
                )
                return
        self.admission.counters.inc("reads_served")
        snap = rs.snapshot
        if params.get("format") == "csv":
            body = self._cache_get((snap.version, "csv"))
            if body is None:
                from skyline_tpu_torch.serve import bodystore as bs

                body = self._body_get(snap.version, bs.FMT_CSV)
                if body is None:
                    body = bs.csv_body(snap)
                self._cache_put((snap.version, "csv"), body)
            await self._reply_raw(
                writer,
                200,
                body,
                "text/plain; charset=utf-8",
                extra_headers={
                    "X-Skyline-Version": str(snap.version),
                    "X-Skyline-Digest": snap.digest,
                    "X-Skyline-Size": str(snap.size),
                    "X-Skyline-Staleness-Ms": str(round(rs.staleness_ms, 1)),
                },
            )
            return
        # the snapshot-derived fields are immutable per version, so the
        # serialized doc caches minus its closing brace; the read-dependent
        # fields (age/lag/staleness) splice on as a tiny per-request suffix
        include_points = params.get("points") != "0"
        # explain bodies MUST NOT share cache entries with plain reads:
        # one flavor cached under the other's key would break the plain
        # body's byte-stability. The plan itself also
        # rides the volatile tail, never the cached prefix — deduped
        # publishes can map several plans onto one snapshot version.
        want_explain = params.get("explain") == "1"
        prefix = self._cache_get(
            (snap.version, "json", include_points, want_explain)
        )
        if prefix is None:
            from skyline_tpu_torch.serve import bodystore as bs

            prefix = self._body_get(
                snap.version, bs.fmt_code("json", include_points, want_explain)
            )
            if prefix is None:
                prefix = bs.json_prefix(snap, include_points=include_points)
            self._cache_put(
                (snap.version, "json", include_points, want_explain), prefix
            )
        tail = (
            f', "age_ms": {round(rs.age_ms, 1)}'
            f', "version_lag": {rs.version_lag}'
            f', "staleness_ms": {round(rs.staleness_ms, 1)}'
            f', "stale": {"true" if not rs.fresh else "false"}'
        )
        if want_explain:
            plan = self.telemetry.explain.by_version(snap.version)
            tail += ', "explain": ' + (
                json.dumps(plan) if plan is not None else "null"
            )
        # the freshness lineage's terminal stage: how old the newest event
        # a CLIENT actually saw was at response time (event-time when the
        # snapshot carries a watermark, publish-age otherwise)
        self.telemetry.histogram(
            "freshness_lag_ms", labels=(("stage", "read"),)
        ).observe(rs.staleness_ms)
        if refresh_triggered:
            tail += ', "refresh_triggered": true'
        if self.store.restored:
            # head was rebuilt from checkpoint + WAL and no live publish has
            # confirmed it yet (crash recovery)
            tail += ', "restored": true'
        await self._reply_raw(
            writer, 200, prefix + tail.encode() + b"}", "application/json"
        )

    async def _explain(self, writer, params):
        """One finalized QueryPlan from the hub's EXPLAIN ring:
        ``?version=N`` maps a snapshot version to the newest plan that
        published it, ``?trace_id=`` joins from a span / flight-ring row,
        and no selector returns the latest plan. 404 carries the ring
        summary so "evicted" vs "never recorded" is diagnosable."""
        try:
            version = _int_param(params, "version")
        except ValueError as e:
            await self._reply(writer, 400, {"error": str(e)})
            return
        trace = params.get("trace_id")
        rec = self.telemetry.explain
        if version is not None:
            plan = rec.by_version(version)
        elif trace:
            plan = rec.by_trace(trace)
        else:
            plan = rec.latest()
        if plan is None:
            await self._reply(
                writer, 404, {"error": "no matching plan", "ring": rec.doc()}
            )
            return
        await self._reply(writer, 200, plan)

    async def _audit(self, writer, params):
        """The audit-plane verdict from the hub's check ring: totals,
        canary path coverage, divergence bundles. ``?trace_id=`` returns
        the single check record for that snapshot's trace — the join back
        into /explain and /trace."""
        rec = self.telemetry.audit
        trace = params.get("trace_id")
        if trace:
            check = rec.by_trace(trace)
            if check is None:
                await self._reply(
                    writer, 404,
                    {"error": "no matching check", "ring": rec.doc()},
                )
                return
            await self._reply(writer, 200, check)
            return
        await self._reply(writer, 200, rec.doc())

    async def _fleet(self, writer):
        """The per-chip fleet join (telemetry/fleet.py): chip loads +
        imbalance index + freshness watermark + last EXPLAIN chip
        attribution. Observability must not 500 the plane down, so the
        stats callback failure degrades to a watermark-less doc."""
        from skyline_tpu_torch.telemetry import fleet_doc

        try:
            stats = dict(self.stats_cb()) if self.stats_cb is not None else {}
        except Exception:
            stats = {}
        await self._reply(writer, 200, fleet_doc(self.telemetry, stats))

    async def _dispatch(self, writer):
        """The declarative cascade table + live tuner decisions: every
        dispatch row's applicability/oracle, the active pins and knob
        overrides, and the controller's recent moves."""
        from skyline_tpu_torch.telemetry.tuner import dispatch_doc

        await self._reply(writer, 200, dispatch_doc(self.telemetry))

    async def _health(self, writer):
        """The /health chip block (RUNBOOK §2p): per-chip health scores +
        quarantine state. Flat workers report {"enabled": false} so probes
        can distinguish "plane off" from "all healthy"."""
        health = getattr(self.telemetry, "health", None)
        if health is None:
            await self._reply(writer, 200, {"ok": True, "enabled": False})
            return
        doc = health.doc()
        doc["ok"] = not doc.get("quarantined")
        doc["enabled"] = True
        await self._reply(writer, 200, doc)

    async def _cluster(self, writer):
        """The /cluster block (RUNBOOK §2r): lease/role state, fenced-write
        and promotion counters, per-host ingest/merge/prune stats.
        Non-cluster workers report {"enabled": false} so probes can
        distinguish "plane off" from "healthy single-host"."""
        status = getattr(self.telemetry, "cluster", None)
        if status is None:
            await self._reply(writer, 200, {"ok": True, "enabled": False})
            return
        try:
            await self._reply(writer, 200, status.doc())
        except Exception as e:  # observability must not 500 the plane down
            await self._reply(writer, 500, {"error": str(e)})

    async def _ops(self, writer, params):
        """The /ops journal tail: the merged cross-process control-plane
        timeline (``telemetry/opslog.py``). Probe-friendly —
        {"enabled": false} when this process opened no journal."""
        from skyline_tpu_torch.telemetry.opslog import ops_doc

        try:
            since = _int_param(params, "since_seq")
            limit = _int_param(params, "limit")
        except ValueError as e:
            await self._reply(writer, 400, {"error": str(e)})
            return
        ops = getattr(self.telemetry, "opslog", None)
        if ops is None:
            await self._reply(writer, 200, {"ok": True, "enabled": False})
            return
        await self._reply(
            writer, 200, ops_doc(ops.wal_dir, since_seq=since, limit=limit)
        )

    async def _overview(self, writer):
        """The /cluster/overview fleet aggregation. The scrape is blocking
        network I/O, so it runs in an executor (a member listing its own URL
        answers its own ``/healthz`` mid-scrape); with no members configured
        it answers ``{"ok": true, "enabled": false}``
        (``telemetry/clusterview.py``)."""
        from skyline_tpu_torch.telemetry.clusterview import overview_doc

        loop = asyncio.get_running_loop()
        doc = await loop.run_in_executor(None, overview_doc, self.telemetry)
        await self._reply(writer, 200, doc)

    async def _deltas(self, writer, params, tenant=None):
        ok, retry = self.admission.admit_read(tenant=tenant)
        if not ok:
            await self._reply(
                writer,
                429,
                {"error": "rate limited", "retry_after_s": round(retry, 3)},
                retry_after=retry,
            )
            return
        if self.deltas is None:
            await self._reply(writer, 503, {"error": "no delta ring attached"})
            return
        try:
            since = _int_param(params, "since")
        except ValueError as e:
            await self._reply(writer, 400, {"error": str(e)})
            return
        if since is None:
            await self._reply(writer, 400, {"error": "missing ?since=<version>"})
            return
        res = self.deltas.since(since)
        if res is None:
            self.admission.counters.inc("deltas_gone")
            await self._reply(
                writer,
                410,
                {
                    "error": "version fell behind the delta ring",
                    # explicit machine-readable marker: a catch-up past the
                    # ring MUST re-baseline from a full snapshot — never
                    # interpret this body as an empty/partial delta list
                    "resync": True,
                    "since": since,
                    "oldest_since": self.deltas.oldest_since,
                    "head_version": self.deltas.head_version,
                    "hint": "re-baseline with GET /skyline",
                },
            )
            return
        entered, left, head = res
        self.admission.counters.inc("deltas_served")
        rs = self.store.read()
        # spliced assembly (byte-identical to json.dumps of the doc —
        # test-asserted): the row arrays go through the body store's
        # encoder
        from skyline_tpu_torch.serve.bodystore import points_json

        sms = round(rs.staleness_ms, 1) if rs is not None else None
        body = (
            b'{"from_version": ' + str(since).encode()
            + b', "to_version": ' + str(head).encode()
            + b', "resync": false'
            + b', "count_entered": ' + str(int(entered.shape[0])).encode()
            + b', "count_left": ' + str(int(left.shape[0])).encode()
            + b', "entered": ' + points_json(entered)
            + b', "left": ' + points_json(left)
            # the freshness watermark rides every read surface
            + b', "staleness_ms": ' + json.dumps(sms).encode()
            + b"}"
        )
        await self._reply_raw(writer, 200, body, "application/json")

    async def _query(self, writer):
        if self.bridge is None:
            await self._reply(
                writer, 503, {"error": "no query plane attached"}
            )
            return
        gate = self.admission.queries
        if not gate.enter():
            await self._reply(
                writer,
                429,
                {"error": "query admission limit exceeded"},
                retry_after=1.0,
            )
            return
        try:
            pending = self.bridge.submit()
            deadline_s = self.admission.query_deadline_ms / 1000.0
            done = await self._loop.run_in_executor(
                None, pending.wait, deadline_s
            )
            if not done:
                self.admission.counters.inc("queries_timed_out")
                await self._reply(
                    writer,
                    503,
                    {
                        "error": "query deadline exceeded",
                        "deadline_ms": self.admission.query_deadline_ms,
                    },
                )
                return
            self.admission.counters.inc("queries_served")
            await self._reply(writer, 200, pending.result)
        finally:
            gate.leave()

    # -- response helpers --------------------------------------------------

    async def _reply(self, writer, code, doc, retry_after=None):
        extra = (
            {"Retry-After": str(max(1, int(retry_after + 0.999)))}
            if retry_after is not None
            else None
        )
        await self._reply_raw(
            writer,
            code,
            json.dumps(doc).encode(),
            "application/json",
            extra_headers=extra,
        )

    async def _reply_raw(self, writer, code, body, ctype, extra_headers=None):
        reason = {
            200: "OK", 400: "Bad Request", 404: "Not Found",
            410: "Gone", 413: "Payload Too Large", 429: "Too Many Requests",
            431: "Request Header Fields Too Large", 503: "Service Unavailable",
        }.get(code, "OK")
        head = [
            f"HTTP/1.1 {code} {reason}",
            f"Content-Type: {ctype}",
            f"Content-Length: {len(body)}",
            "Connection: close",
        ]
        for k, v in (extra_headers or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()


def _float_param(params, name):
    v = params.get(name)
    if v is None:
        return None
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"bad {name}: {v!r}")


def _int_param(params, name):
    v = params.get(name)
    if v is None:
        return None
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"bad {name}: {v!r}")

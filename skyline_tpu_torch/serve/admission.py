"""Admission control and backpressure for the serving plane.

Counterpart of ``skyline_tpu/serve/admission.py``.

Two distinct costs, two distinct limiters:

- Snapshot reads (``GET /skyline``, ``GET /deltas``) are cheap — one
  lock-free reference load — but unbounded fan-in is still unbounded
  work (JSON encoding, socket writes). A token bucket rate-limits them;
  exhaustion sheds with 429 + Retry-After computed from the refill rate.
- Forced consistency merges (``POST /query``) are the expensive path (a
  full engine merge each). A concurrency gate bounds in-flight + queued
  requests and every admitted request carries a deadline; over-bound
  requests shed immediately (429) instead of growing an invisible queue.

Shed / queue-depth / staleness counts go through
``metrics.collector.Counters`` so ``/stats`` and ``/metrics`` report the
same numbers.
"""

from __future__ import annotations

import threading
import time

from skyline_tpu_torch.metrics.collector import Counters


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s, ``burst`` capacity.

    ``rate <= 0`` disables limiting (every acquire succeeds). ``try_acquire``
    returns ``(admitted, retry_after_s)`` — ``retry_after_s`` is how long
    until one token exists again, the 429 Retry-After value.
    """

    def __init__(self, rate: float, burst: int):
        self.rate = float(rate)
        self.burst = max(1, int(burst))
        self._tokens = float(self.burst)
        self._stamp = time.monotonic()
        self._lock = threading.Lock()

    def try_acquire(self, n: int = 1) -> tuple[bool, float]:
        if self.rate <= 0:
            return True, 0.0
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                float(self.burst), self._tokens + (now - self._stamp) * self.rate
            )
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            return False, max(0.01, (n - self._tokens) / self.rate)


class QueryGate:
    """Concurrency limiter + bounded queue for the expensive query path.

    At most ``max_concurrent`` queries execute while up to ``max_queue``
    more wait; anything beyond that sheds immediately. ``enter`` returns
    True when admitted (caller MUST ``leave()`` when done, success or not).
    """

    def __init__(self, max_concurrent: int, max_queue: int, counters: Counters):
        self.max_concurrent = max(1, int(max_concurrent))
        self.max_queue = max(0, int(max_queue))
        self._active = 0
        self._lock = threading.Lock()
        self._counters = counters

    def enter(self) -> bool:
        with self._lock:
            if self._active >= self.max_concurrent + self.max_queue:
                self._counters.inc("queries_shed")
                return False
            self._active += 1
            self._counters.inc("queries_admitted")
            return True

    def leave(self) -> None:
        with self._lock:
            self._active = max(0, self._active - 1)

    @property
    def depth(self) -> int:
        with self._lock:
            return self._active


class AdmissionController:
    """The serving plane's policy bundle: read bucket + query gate + counters.

    Per-tenant admission: when ``tenant_rate > 0``, requests carrying an
    ``X-Tenant`` header are additionally charged against that tenant's own
    token bucket (created on first sight, bounded by ``max_tenants`` with
    LRU-less first-come retention — a flood of fresh tenant names cannot
    grow memory unboundedly; over-bound names share the ``__other__``
    bucket). The global bucket still applies first: tenants compete for
    the plane's total budget, then within their own slice. Per-tenant
    admit/shed counts surface via ``tenant_stats()`` (→ ``/metrics``
    labeled series and the ``/slo`` tenant burn row)."""

    OVERFLOW_TENANT = "__other__"

    def __init__(
        self,
        read_rate: float = 0.0,  # tokens/s; 0 = unlimited
        read_burst: int = 256,
        max_concurrent_queries: int = 2,
        max_query_queue: int = 8,
        query_deadline_ms: float = 10_000.0,
        counters: Counters | None = None,
        tenant_rate: float = 0.0,  # per-tenant tokens/s; 0 = no tenant plane
        tenant_burst: int = 64,
        max_tenants: int = 256,
    ):
        self.counters = counters if counters is not None else Counters()
        self.reads = TokenBucket(read_rate, read_burst)
        self.queries = QueryGate(
            max_concurrent_queries, max_query_queue, self.counters
        )
        self.query_deadline_ms = float(query_deadline_ms)
        self.tenant_rate = float(tenant_rate)
        self.tenant_burst = int(tenant_burst)
        self.max_tenants = max(1, int(max_tenants))
        self._tenants: dict[str, TokenBucket] = {}
        self._tenant_admitted: dict[str, int] = {}
        self._tenant_shed: dict[str, int] = {}
        self._tenant_lock = threading.Lock()

    def _tenant_bucket(self, tenant: str) -> TokenBucket:
        with self._tenant_lock:
            b = self._tenants.get(tenant)
            if b is None:
                if len(self._tenants) >= self.max_tenants:
                    tenant = self.OVERFLOW_TENANT
                    b = self._tenants.get(tenant)
                if b is None:
                    b = TokenBucket(self.tenant_rate, self.tenant_burst)
                    self._tenants[tenant] = b
            return b

    def _tenant_count(self, table: dict[str, int], tenant: str) -> None:
        with self._tenant_lock:
            if tenant not in self._tenants and len(
                self._tenants
            ) >= self.max_tenants:
                tenant = self.OVERFLOW_TENANT
            table[tenant] = table.get(tenant, 0) + 1

    def admit_read(self, tenant: str | None = None) -> tuple[bool, float]:
        ok, retry = self.reads.try_acquire()
        if ok and tenant is not None and self.tenant_rate > 0:
            ok, retry = self._tenant_bucket(tenant).try_acquire()
            if not ok:
                # aggregate across tenants; the per-tenant split lives in
                # tenant_stats() / the labeled /metrics families (distinct
                # name — the labeled family owns *_tenant_reads_shed)
                self.counters.inc("tenant_shed")
        if tenant is not None and self.tenant_rate > 0:
            self._tenant_count(
                self._tenant_admitted if ok else self._tenant_shed, tenant
            )
        if ok:
            self.counters.inc("reads_admitted")
        else:
            self.counters.inc("reads_shed")
        return ok, retry

    def tenant_stats(self) -> dict:
        """{tenant: {"admitted": n, "shed": n}} snapshot (tenant plane off
        → empty)."""
        with self._tenant_lock:
            names = set(self._tenant_admitted) | set(self._tenant_shed)
            return {
                t: {
                    "admitted": self._tenant_admitted.get(t, 0),
                    "shed": self._tenant_shed.get(t, 0),
                }
                for t in sorted(names)
            }

    def stats(self) -> dict:
        out = self.counters.snapshot()
        out["query_depth"] = self.queries.depth
        out["query_deadline_ms"] = self.query_deadline_ms
        tenants = self.tenant_stats()
        if tenants:
            out["tenants"] = tenants
        return out

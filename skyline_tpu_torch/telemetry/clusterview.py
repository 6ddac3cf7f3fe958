"""Fleet-wide aggregation view: one merged doc for the whole cluster.

Counterpart of ``skyline_tpu/telemetry/clusterview.py``. Every
observability surface is scoped to one process — each member serves its own
``/metrics``, ``/cluster``, ``/healthz`` and ``/ops`` tail. ``ClusterView``
is the scraper that polls every member's four surfaces into ONE document
(``GET /cluster/overview`` on the primary,
``python -m skyline_tpu_torch.telemetry.clusterview`` for operators),
carrying:

- per-member identity: role, lease epoch, fence, head version, health;
- per-replica **replication lag**: the delta between the primary's head
  version/watermark and each tailer's folded head (versions), plus the
  member's own tail-lag p99 estimated from its exported
  ``replica_tail_lag_ms`` histogram buckets;
- per-host health and prune fractions from the coordinator block;
- the **epoch-agreement check**: split-brain evidence becomes a NAMED
  finding instead of silent weirdness — ``multiple_primaries`` (two live
  processes both claiming the primary role) and ``primary_below_fence``
  (a live primary whose epoch sits below the fleet's max fence, i.e. a
  writer that would stamp frames the fleet has already fenced out).

The scrape is read-only and failure-tolerant: a dead member becomes a
``{"ok": false, "error": ...}`` row, never an exception — the view of a
degraded fleet is exactly when this doc matters most.
``overview_from_members`` is the pure aggregation core, so tests inject
member docs without sockets.

Knobs: ``SKYLINE_CLUSTERVIEW_MEMBERS`` (comma-separated base URLs served as
``/cluster/overview``), ``SKYLINE_CLUSTERVIEW_TIMEOUT_S`` (per-request
scrape timeout), ``SKYLINE_CLUSTERVIEW_OPS_TAIL`` (ops-journal records
pulled per member).
"""

from __future__ import annotations

import json
import re
import time

_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")
_LE_RE = re.compile(r'le="([^"]+)"')


def parse_prometheus(text: str) -> dict[str, float]:
    """Flatten one exposition doc to ``{name or name{labels}: value}``.
    Only what the overview needs — no type metadata, no escapes beyond
    what our own renderer emits."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, labels, value = m.groups()
        try:
            v = float(value.replace("+Inf", "inf"))
        except ValueError:
            continue
        out[name + (labels or "")] = v
    return out


def hist_quantile(samples: dict[str, float], family: str, q: float) -> float | None:
    """Estimate a quantile from a family's cumulative ``_bucket`` series
    (the same bucket-interpolation the live ``Histogram`` uses past its
    sample cap). ``None`` when the family is absent or empty."""
    buckets: list[tuple[float, float]] = []
    prefix = family + "_bucket{"
    for key, cum in samples.items():
        if key.startswith(prefix):
            m = _LE_RE.search(key)
            if m is not None:
                buckets.append((float(m.group(1).replace("+Inf", "inf")), cum))
    if not buckets:
        return None
    buckets.sort()
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    lo = 0.0
    prev_cum = 0.0
    for le, cum in buckets:
        if cum >= rank:
            hi = le if le != float("inf") else lo
            if cum == prev_cum:
                return hi
            frac = min(1.0, max(0.0, (rank - prev_cum) / (cum - prev_cum)))
            return lo + (hi - lo) * frac
        lo = le
        prev_cum = cum
    return lo


def _get_json(url: str, timeout_s: float):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return json.loads(r.read().decode())


def _get_text(url: str, timeout_s: float) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return r.read().decode()


def scrape_member(base_url: str, timeout_s: float, ops_tail: int = 64) -> dict:
    """Poll one member's four surfaces into a member doc. Each surface
    fails independently; a member is ``ok`` when ``/healthz`` answered."""
    base = base_url.rstrip("/")
    doc: dict = {"url": base, "ok": False}
    try:
        doc["healthz"] = _get_json(f"{base}/healthz", timeout_s)
        doc["ok"] = bool(doc["healthz"].get("ok"))
    except Exception as e:
        doc["error"] = f"{type(e).__name__}: {e}"
        return doc
    for key, path in (
        ("cluster", "/cluster"),
        ("ops", f"/ops?limit={int(ops_tail)}"),
    ):
        try:
            doc[key] = _get_json(base + path, timeout_s)
        except Exception as e:
            doc[f"{key}_error"] = f"{type(e).__name__}: {e}"
    try:
        doc["metrics"] = parse_prometheus(
            _get_text(f"{base}/metrics", timeout_s)
        )
    except Exception as e:
        doc["metrics_error"] = f"{type(e).__name__}: {e}"
    return doc


def _member_role(m: dict) -> str:
    cluster = m.get("cluster") or {}
    if cluster.get("enabled"):
        role = cluster.get("role")
        if role:
            return str(role)
    role = (m.get("healthz") or {}).get("role")
    return str(role) if role else "unknown"


def _member_epoch(m: dict) -> int | None:
    """The epoch this member is operating under: its lease record when it
    (or its supervisor) holds one."""
    cluster = m.get("cluster") or {}
    lease = cluster.get("lease")
    if isinstance(lease, dict) and "epoch" in lease:
        return int(lease["epoch"])
    return None


def _member_fence(m: dict) -> int | None:
    cluster = m.get("cluster") or {}
    fence = cluster.get("fence")
    return int(fence) if isinstance(fence, (int, float)) else None


def _member_head(m: dict) -> int | None:
    metrics = m.get("metrics") or {}
    v = metrics.get("skyline_snapshot_store_head_version")
    return int(v) if v is not None else None


def overview_from_members(members: list[dict], now_ms: float | None = None) -> dict:
    """The pure aggregation core: member docs in, one overview out.

    The epoch-agreement check runs here: findings are NAMED evidence of
    split-brain, computed only from what members themselves report —
    no finding on a healthy grid, by construction of the lease plane
    (one live primary, everyone at/above the fleet fence)."""
    rows = []
    findings: list[dict] = []
    live_primaries = []
    fences = []
    heads = {}
    primary_head = None
    for m in members:
        role = _member_role(m)
        epoch = _member_epoch(m)
        fence = _member_fence(m)
        head = _member_head(m)
        if fence is not None:
            fences.append(fence)
        row = {
            "url": m.get("url"),
            "ok": bool(m.get("ok")),
            "role": role,
            "node": (m.get("cluster") or {}).get("node"),
            "epoch": epoch,
            "fence": fence,
            "head_version": head,
        }
        if m.get("error"):
            row["error"] = m["error"]
        metrics = m.get("metrics") or {}
        lag_p99 = hist_quantile(metrics, "skyline_replica_tail_lag_ms", 0.99)
        if lag_p99 is not None:
            row["tail_lag_p99_ms"] = round(lag_p99, 3)
        fenced = metrics.get("skyline_cluster_fenced_writes_total")
        if fenced:
            row["fenced_writes"] = int(fenced)
        # per-host health/prune fractions from the coordinator block
        hosts = (m.get("cluster") or {}).get("hosts")
        if isinstance(hosts, dict):
            considered = int(hosts.get("hosts_considered_total", 0) or 0)
            pruned = int(hosts.get("hosts_pruned_total", 0) or 0)
            row["hosts"] = {
                "count": hosts.get("hosts"),
                "prune_fraction": (
                    round(pruned / considered, 4) if considered else 0.0
                ),
                "migrations": hosts.get("migrations"),
            }
        ops = m.get("ops") or {}
        if ops.get("enabled"):
            row["ops_records"] = ops.get("total")
            row["ops_writers"] = ops.get("writers")
        rows.append(row)
        if head is not None:
            heads[m.get("url")] = head
        if m.get("ok") and role == "primary":
            live_primaries.append(row)
            if head is not None and (primary_head is None or head > primary_head):
                primary_head = head
    fleet_fence = max(fences) if fences else 0
    # replication lag: primary head minus each non-primary member's head
    if primary_head is not None:
        for row in rows:
            if row["role"] != "primary" and row.get("head_version") is not None:
                row["replication_lag_versions"] = max(
                    0, primary_head - row["head_version"]
                )
    # -- epoch-agreement check --------------------------------------------
    if len(live_primaries) > 1:
        findings.append(
            {
                "name": "multiple_primaries",
                "severity": "critical",
                "detail": (
                    f"{len(live_primaries)} live members claim the primary "
                    "role — split brain"
                ),
                "members": [
                    {"url": r["url"], "epoch": r["epoch"]}
                    for r in live_primaries
                ],
            }
        )
    for r in live_primaries:
        if r["epoch"] is not None and r["epoch"] < fleet_fence:
            findings.append(
                {
                    "name": "primary_below_fence",
                    "severity": "critical",
                    "detail": (
                        f"live primary {r['url']} operates at epoch "
                        f"{r['epoch']} below the fleet max fence "
                        f"{fleet_fence} — its frames are already fenced out"
                    ),
                    "member": r["url"],
                    "epoch": r["epoch"],
                    "fleet_fence": fleet_fence,
                }
            )
    return {
        "ok": not findings,
        "enabled": True,
        "at_ms": time.time() * 1000.0 if now_ms is None else now_ms,
        "members": rows,
        "fleet": {
            "size": len(rows),
            "live": sum(1 for r in rows if r["ok"]),
            "primaries": len(live_primaries),
            "max_fence": fleet_fence,
            "primary_head_version": primary_head,
        },
        "findings": findings,
    }


class ClusterView:
    """The scraping front end around ``overview_from_members``."""

    def __init__(
        self,
        members: list[str],
        timeout_s: float | None = None,
        ops_tail: int | None = None,
    ):
        from skyline_tpu_torch.utils.knobs import env_float, env_int

        self.members = [m for m in members if m]
        self.timeout_s = (
            env_float("SKYLINE_CLUSTERVIEW_TIMEOUT_S", 2.0)
            if timeout_s is None
            else float(timeout_s)
        )
        self.ops_tail = (
            env_int("SKYLINE_CLUSTERVIEW_OPS_TAIL", 64)
            if ops_tail is None
            else int(ops_tail)
        )

    def scrape(self) -> list[dict]:
        return [
            scrape_member(m, self.timeout_s, self.ops_tail)
            for m in self.members
        ]

    def overview(self) -> dict:
        t0 = time.perf_counter_ns()
        doc = overview_from_members(self.scrape())
        doc["scrape_wall_ms"] = round((time.perf_counter_ns() - t0) / 1e6, 3)
        return doc


def members_from_env() -> list[str]:
    """``SKYLINE_CLUSTERVIEW_MEMBERS``: comma-separated member base URLs."""
    from skyline_tpu_torch.utils.knobs import env_str

    raw = env_str("SKYLINE_CLUSTERVIEW_MEMBERS") or ""
    return [m.strip() for m in raw.split(",") if m.strip()]


def overview_doc(telemetry=None) -> dict:
    """The ``GET /cluster/overview`` document for both HTTP surfaces:
    the hub's attached ``ClusterView`` when one is wired, else one built
    from ``SKYLINE_CLUSTERVIEW_MEMBERS``; probe-friendly
    ``{"ok": true, "enabled": false}`` when neither exists. Never raises —
    observability must not 500 the plane."""
    try:
        cv = getattr(telemetry, "clusterview", None) if telemetry is not None else None
        if cv is None:
            members = members_from_env()
            if not members:
                return {"ok": True, "enabled": False}
            cv = ClusterView(members)
        return cv.overview()
    except Exception as e:  # pragma: no cover - diagnostic path
        return {"ok": False, "enabled": True, "error": f"{type(e).__name__}: {e}"}


# --------------------------------------------------------------------------
# CLI (python -m skyline_tpu_torch.telemetry.clusterview)
# --------------------------------------------------------------------------


def _fmt_row(r: dict) -> str:
    lag = r.get("replication_lag_versions")
    bits = [
        f"{r.get('url', '?'):<28}",
        "up  " if r.get("ok") else "DOWN",
        f"{r.get('role', '?'):<8}",
        f"epoch={r.get('epoch')}",
        f"fence={r.get('fence')}",
        f"head={r.get('head_version')}",
    ]
    if lag is not None:
        bits.append(f"lag={lag}v")
    if r.get("tail_lag_p99_ms") is not None:
        bits.append(f"tail_p99={r['tail_lag_p99_ms']}ms")
    if r.get("fenced_writes"):
        bits.append(f"fenced_writes={r['fenced_writes']}")
    if r.get("error"):
        bits.append(f"error={r['error']}")
    return "  ".join(str(b) for b in bits)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m skyline_tpu_torch.telemetry.clusterview",
        description=(
            "Scrape every cluster member's /metrics, /cluster, /healthz and "
            "/ops tail into one overview with replication lag and the "
            "epoch-agreement (split-brain) check. Exit 1 when findings "
            "exist, 0 on a healthy fleet."
        ),
    )
    ap.add_argument(
        "members", nargs="*", metavar="URL",
        help="member base URLs (default: $SKYLINE_CLUSTERVIEW_MEMBERS)",
    )
    ap.add_argument("--json", action="store_true", help="emit the raw doc")
    ap.add_argument("--timeout-s", type=float, default=None)
    a = ap.parse_args(argv)
    members = a.members or members_from_env()
    if not members:
        print(
            "clusterview: no members (pass URLs or set "
            "SKYLINE_CLUSTERVIEW_MEMBERS)"
        )
        return 2
    doc = ClusterView(members, timeout_s=a.timeout_s).overview()
    if a.json:
        print(json.dumps(doc, indent=1))
    else:
        f = doc["fleet"]
        print(
            f"fleet: {f['live']}/{f['size']} live, {f['primaries']} "
            f"primary(ies), max fence {f['max_fence']}, primary head "
            f"{f['primary_head_version']}  "
            f"(scrape {doc.get('scrape_wall_ms', '?')} ms)"
        )
        for r in doc["members"]:
            print("  " + _fmt_row(r))
        if doc["findings"]:
            print("findings:")
            for fd in doc["findings"]:
                print(f"  !! {fd['name']} [{fd['severity']}]: {fd['detail']}")
        else:
            print("findings: none")
    return 1 if doc["findings"] else 0


if __name__ == "__main__":  # pragma: no cover - CLI entry
    raise SystemExit(main())

"""The serve drill: ``scripts/serve_smoke.sh`` on the port.

A worker over the in-memory bus with ``--serve 0`` (an ephemeral port);
``/healthz``, a versioned snapshot read after a trigger, and a forced
query (``POST /query``) over rows no trigger saw, both held against the
numpy oracle. Stream: anti-correlated, seed 11, 4,000 then 1,000 rows,
d = 3, parallelism 2.

``run(ns)`` is written against a namespace of the package under test
(``port_ns``), so a test can drive the same steps through another
package's objects.
"""

from __future__ import annotations

import json
import threading
import time
from types import SimpleNamespace

import numpy as np

from skyline_tpu_torch.deploy.drills.common import port_job_args, say


def port_ns(device: str) -> SimpleNamespace:
    from skyline_tpu_torch.bridge import MemoryBus, SkylineWorker
    from skyline_tpu_torch.bridge.wire import format_trigger, format_tuple_line
    from skyline_tpu_torch.ops.dominance import skyline_np
    from skyline_tpu_torch.serve.snapshot import points_digest
    from skyline_tpu_torch.workload.generators import anti_correlated

    return SimpleNamespace(
        parse_job_args=port_job_args(device), MemoryBus=MemoryBus,
        SkylineWorker=SkylineWorker, format_trigger=format_trigger,
        format_tuple_line=format_tuple_line, skyline_np=skyline_np,
        points_digest=points_digest, anti_correlated=anti_correlated)


def forced_query(worker, base: str, timeout_s: float = 15.0) -> dict:
    """``POST /query`` from a client thread while this thread steps the
    worker (its loop drains the query bridge); the answer's JSON."""
    out = {}

    def post():
        import urllib.request

        req = urllib.request.Request(f"{base}/query", data=b"{}", method="POST")
        with urllib.request.urlopen(req, timeout=timeout_s + 5) as r:
            out["doc"] = json.load(r)

    t = threading.Thread(target=post)
    t.start()
    deadline = time.time() + timeout_s
    while t.is_alive() and time.time() < deadline:
        worker.step()
        time.sleep(0.005)
    t.join(timeout=1)
    assert "doc" in out, "forced query never completed"
    return out["doc"]


def run(ns, bounds: bool = True) -> dict:
    import urllib.request

    cfg = ns.parse_job_args(["--serve", "0", "--parallelism", "2", "--dims", "3",
                             "--serve-query-deadline-ms", "15000"])
    bus = ns.MemoryBus()
    worker = ns.SkylineWorker(bus, cfg.engine_config(), serve_port=cfg.serve_port,
                              serve_config=cfg.serve_config())
    ev = {}
    try:
        port = worker.serve_server.port
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
            doc = json.load(r)
        assert doc["ok"], doc
        say("serve", f"healthz ok on :{port}")

        rng = np.random.default_rng(11)
        x = ns.anti_correlated(rng, 4000, 3, 0, 10000)
        bus.produce_many("input-tuples", [ns.format_tuple_line(i, row) for i, row in enumerate(x)])
        bus.produce("queries", ns.format_trigger(0, 0))
        while worker.step() > 0:
            pass
        expected = ns.skyline_np(x)
        with urllib.request.urlopen(f"{base}/skyline?max_version_lag=0", timeout=5) as r:
            doc = json.load(r)
        assert doc["version"] == 1 and not doc["stale"], doc
        assert doc["skyline_size"] == expected.shape[0], (doc["skyline_size"], expected.shape[0])
        ev["v1"] = {"version": doc["version"], "size": doc["skyline_size"],
                    "digest": ns.points_digest(worker.serve_server.store.latest().points)}
        say("serve", f"snapshot read ok: version=1 size={doc['skyline_size']} "
            f"lag={doc['version_lag']}")

        # new data with no bus trigger: only a forced merge can see it
        y = ns.anti_correlated(rng, 1000, 3, 0, 10000)
        bus.produce_many("input-tuples",
                         [ns.format_tuple_line(4000 + i, row) for i, row in enumerate(y)])
        while worker.step() > 0:
            pass
        doc = forced_query(worker, base)
        expected2 = ns.skyline_np(np.concatenate([x, y]))
        assert doc["skyline_size"] == expected2.shape[0], (doc["skyline_size"],
                                                          expected2.shape[0])
        store = worker.serve_server.store
        ev["forced"] = {"size": doc["skyline_size"], "head_version": store.head_version,
                        "digest": ns.points_digest(store.latest().points)}
        say("serve", f"forced query ok: size={doc['skyline_size']} "
            f"head_version={store.head_version}")
        say("serve", "PASS")
    finally:
        worker.close()
    return ev


def main(device: str, bounds: bool = True) -> dict:
    return run(port_ns(device), bounds)

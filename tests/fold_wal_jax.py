"""Fold a WAL written by the port on a card with the JAX package's replica.

    JAX_PLATFORMS=cpu python tests/fold_wal_jax.py <out_dir>

``<out_dir>`` is a ``chip_smoke.py --out`` directory of a run with the
``replica`` leg: its ``replica_wal/`` is the leg's WAL, read as files, and
``chip_smoke.json``'s ``replica_parity.versions`` the primary's digest at
every version the leg held its replicas to. The JAX ``SkylineReplica``
bootstraps from the newest barrier and tails every delta to the head, and
every delta is folded again from the start with the JAX package's
``apply_delta_record``; the script prints one JSON line (versions compared,
the head) and exits 1 when a digest or the head differs.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def _fold_every_delta(wal_dir: Path) -> dict:
    """Version -> digest of every publish the WAL still holds, folded delta
    by delta with the JAX package's ``apply_delta_record`` from version 0
    (or from the first barrier's snapshot when older segments are gone)."""
    import numpy as np

    from skyline_tpu.resilience.wal import read_records, rows_from_b64
    from skyline_tpu.serve.deltas import apply_delta_record
    from skyline_tpu.serve.snapshot import points_digest

    points, version, got = None, None, {}
    for rec in read_records(str(wal_dir))[0]:
        if rec.get("type") == "ckpt" and "snap" in rec and points is None:
            snap = rec["snap"]
            points = rows_from_b64(snap["rows"], int(snap["d"]))
            version = int(snap["version"])
            got[version] = points_digest(points)
        elif rec.get("type") == "delta":
            if points is None and int(rec["from"]) == 0:
                points, version = np.empty((0, int(rec["d"])), dtype=np.float32), 0
            if points is None or int(rec["from"]) != version:
                continue
            points = apply_delta_record(points, rec)
            version = int(rec["to"])
            got[version] = points_digest(points)
    return got


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    out = Path(argv[0])
    want = dict(json.loads((out / "chip_smoke.json").read_text())["replica_parity"]["versions"])
    want = {int(v): d for v, d in want.items()}
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from skyline_tpu.serve.replica import SkylineReplica

    rep = SkylineReplica(str(out / "replica_wal"), replica_id="jax-fold", start=False)
    try:
        rep.bootstrap()
        while rep.apply_available():
            pass
        head = rep.store.latest()
    finally:
        rep.close()
    got = _fold_every_delta(out / "replica_wal")
    common = sorted(set(got) & set(want))
    bad = [v for v in common if got[v] != want[v]]
    top = max(want)
    ok = not bad and head is not None and head.version == top and head.digest == want[top]
    print(json.dumps({"ok": ok, "versions_compared": common, "mismatched": bad,
                      "head_version": None if head is None else head.version,
                      "head_digest": None if head is None else head.digest,
                      "primary_head": [top, want[top]]}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Divergence repro bundles: everything needed to re-run a failed audit
check on another machine, frozen at detection time.

Counterpart of ``skyline_tpu/audit/bundle.py``, with the same layout: a
bundle frozen by either package replays in the other.

Anatomy of ``<SKYLINE_AUDIT_DIR>/bundle-v<version>-<seq>/``:

- ``manifest.json``   — schema, trace_id, snapshot version + digest, the
  first differing row, row counts, the port's knob registry snapshot
  (set value + declared default for every declared knob — the exact
  configuration the divergence happened under), and the WAL segment
  names captured.
- ``checkpoint.npz``  — the engine state via ``utils.checkpoint
  .save_engine`` (atomic, CRC-guarded; the same writer the resilience
  plane uses), so replay restores the partition skylines that produced
  the divergence.
- ``published.npy`` / ``oracle.npy`` — both skylines, verbatim.
- ``explain.json``    — the diverging query's EXPLAIN plan (null when
  the plan ring already evicted it), for the decision-level diff.
- ``wal/``            — a copy of the live WAL segments at detection
  time, only when ``wal_dir`` is set (a worker with crash safety on sets
  its auditor's ``wal_dir``; ``resilience/wal.py``).

``python -m skyline_tpu_torch.audit replay <bundle>`` (``__main__.py``)
consumes this layout offline.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

BUNDLE_SCHEMA = 1
MANIFEST = "manifest.json"


def freeze_bundle(
    engine,
    snap,
    oracle: np.ndarray,
    diff: dict | None,
    *,
    out_dir: str,
    seq: int,
    plan_doc: dict | None = None,
    wal_dir: str | None = None,
) -> str:
    """Write one self-contained repro bundle; returns its directory."""
    root = os.path.join(out_dir, f"bundle-v{int(snap.version)}-{seq}")
    n = 0
    while os.path.exists(root):  # never clobber earlier evidence
        n += 1
        root = os.path.join(
            out_dir, f"bundle-v{int(snap.version)}-{seq}.{n}"
        )
    os.makedirs(root)

    from skyline_tpu_torch.utils.checkpoint import save_engine

    save_engine(
        engine,
        os.path.join(root, "checkpoint.npz"),
        extra_meta={"audit_bundle": True, "snapshot_version": int(snap.version)},
    )
    np.save(
        os.path.join(root, "published.npy"),
        np.asarray(snap.points, dtype=np.float32),
    )
    np.save(
        os.path.join(root, "oracle.npy"),
        np.asarray(oracle, dtype=np.float32),
    )
    with open(os.path.join(root, "explain.json"), "w") as f:
        json.dump(plan_doc, f, indent=2)

    wal_segments = []
    if wal_dir is not None and os.path.isdir(wal_dir):
        os.makedirs(os.path.join(root, "wal"), exist_ok=True)
        for seg_path in _list_segments(wal_dir):
            shutil.copy2(seg_path, os.path.join(root, "wal"))
            wal_segments.append(os.path.basename(seg_path))

    manifest = {
        "schema": BUNDLE_SCHEMA,
        "created_ms": round(time.time() * 1000.0, 1),
        "trace_id": snap.meta.get("trace_id"),
        "query_id": snap.meta.get("query_id"),
        "version": int(snap.version),
        "digest": snap.digest,
        "dims": int(engine.pset.dims),
        "published_rows": int(np.asarray(snap.points).shape[0]),
        "oracle_rows": int(np.asarray(oracle).shape[0]),
        "first_diff": diff,
        "knobs": knob_snapshot(),
        "wal_segments": wal_segments,
        "has_explain": plan_doc is not None,
    }
    tmp = os.path.join(root, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(root, MANIFEST))
    return root


def _list_segments(directory: str) -> list[str]:
    """The paths of the WAL segments ``wal-<seq>.log`` in ``directory``,
    ascending by sequence number (``resilience/wal.py``
    ``list_segments`` of the reference)."""
    segs = []
    for name in os.listdir(directory):
        if name.startswith("wal-") and name.endswith(".log"):
            try:
                segs.append((int(name[4:-4]), os.path.join(directory, name)))
            except ValueError:
                continue
    return [p for _, p in sorted(segs)]


def knob_snapshot() -> list[dict]:
    """Every knob of the port's registry (``utils/knobs.py`` ``KNOBS``):
    its set value (None = unset) + its default — the exact configuration
    a divergence happened under."""
    from skyline_tpu_torch.utils.knobs import KNOBS, env_str

    return [
        {"name": k.name, "value": env_str(k.name), "default": k.default}
        for k in KNOBS
    ]


def load_bundle(path: str) -> dict:
    """Read a bundle directory back into memory for replay."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("schema") != BUNDLE_SCHEMA:
        raise ValueError(
            f"unsupported bundle schema {manifest.get('schema')!r} in {path}"
        )
    published = np.load(os.path.join(path, "published.npy"))
    oracle = np.load(os.path.join(path, "oracle.npy"))
    plan_doc = None
    explain_path = os.path.join(path, "explain.json")
    if os.path.exists(explain_path):
        with open(explain_path) as f:
            plan_doc = json.load(f)
    return {
        "path": path,
        "manifest": manifest,
        "published": published,
        "oracle": oracle,
        "plan": plan_doc,
        "checkpoint": os.path.join(path, "checkpoint.npz"),
    }

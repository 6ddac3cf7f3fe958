"""Retain-N checkpoint manager: atomic saves, CRC-verified restore with
fallback to the previous good checkpoint.

Files are ``ckpt-<seq>.npz`` under one directory (the WAL lives in a
``wal/`` subdirectory of the same root — see ``resilience/__init__``).
``save`` delegates to ``utils.checkpoint.save_engine`` (tmp +
``os.replace`` + content CRC) and prunes beyond ``retain``;
``restore_latest`` walks newest-first and falls back across torn or
CRC-mismatching files, so one bad save never strands the worker.

The port's copy of ``skyline_tpu/resilience/checkpoints.py``: the files are
the reference's format (``utils/checkpoint.py``), and ``restore_latest``
restores onto ``device`` — the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
import sys

_CKPT_FMT = "ckpt-%08d.npz"


def _ckpt_seq(name: str) -> int | None:
    if name.startswith("ckpt-") and name.endswith(".npz"):
        try:
            return int(name[5:-4])
        except ValueError:
            return None
    return None


class CheckpointManager:
    def __init__(self, directory: str, retain: int = 3, telemetry=None):
        if retain < 1:
            raise ValueError(f"retain must be >= 1, got {retain}")
        self.directory = directory
        self.retain = retain
        self._telemetry = telemetry
        self.saved = 0
        self.fallbacks = 0
        os.makedirs(directory, exist_ok=True)

    def list(self) -> list[tuple[int, str]]:
        """(seq, path) of every checkpoint, ascending."""
        out = []
        for n in os.listdir(self.directory):
            seq = _ckpt_seq(n)
            if seq is not None:
                out.append((seq, os.path.join(self.directory, n)))
        out.sort()
        return out

    def save(self, engine, extra_meta: dict | None = None) -> str:
        from skyline_tpu_torch.utils.checkpoint import save_engine

        existing = self.list()
        seq = (existing[-1][0] + 1) if existing else 1
        path = os.path.join(self.directory, _CKPT_FMT % seq)
        save_engine(engine, path, extra_meta=extra_meta)
        self.saved += 1
        if self._telemetry is not None:
            self._telemetry.inc("checkpoint.saved")
        for old_seq, old_path in existing[: max(0, len(existing) + 1 - self.retain)]:
            try:
                os.unlink(old_path)
            except OSError:  # pragma: no cover - fs race
                pass
        # stray tmps from an interrupted save never load; sweep them here
        # (the save above already renamed its own tmp away)
        for n in os.listdir(self.directory):
            if n.endswith(".npz.tmp"):
                try:
                    os.unlink(os.path.join(self.directory, n))
                except OSError:  # pragma: no cover - fs race
                    pass
        return path

    def restore_latest(self, mesh=None, mesh_chips: int = 0,
                       cluster_hosts: int = 0, tracer=None,
                       telemetry=None, device: str = "cuda"):
        """Newest CRC-valid checkpoint as ``(engine, meta, path)``, or None
        when the directory holds no loadable checkpoint. A bad file (torn
        zip, CRC mismatch, bad meta) logs, counts a fallback, and the next
        older file is tried. The engine is restored onto ``device``.

        ``mesh_chips`` > 0 restores a ``distributed.ShardedEngine`` of that
        many chips from any checkpoint, flat or sharded; ``cluster_hosts`` > 0
        a ``cluster.ClusterEngine`` of that many hosts (``mesh_chips`` chips
        each); ``mesh`` a flat engine on that device mesh, whose places'
        device type then stands for ``device``."""
        from skyline_tpu_torch.utils.checkpoint import load_engine
        from skyline_tpu_torch.utils.devices import resolve_device

        if mesh is not None:
            device = mesh.device_type
        # a missing card raises here, never counted as a bad file
        resolve_device(device)

        for _seq, path in reversed(self.list()):
            try:
                engine, meta = load_engine(
                    path, mesh=mesh, mesh_chips=mesh_chips,
                    cluster_hosts=cluster_hosts, with_meta=True,
                    tracer=tracer, telemetry=telemetry, device=device,
                )
            except Exception as e:
                self.fallbacks += 1
                if self._telemetry is not None:
                    self._telemetry.inc("checkpoint.fallbacks")
                print(
                    f"checkpoint: {path} unusable ({type(e).__name__}: {e}); "
                    "falling back to the previous checkpoint",
                    file=sys.stderr,
                )
                continue
            if self._telemetry is not None:
                self._telemetry.inc("checkpoint.restored")
            return engine, meta, path
        return None

    def stats(self) -> dict:
        return {
            "directory": self.directory,
            "retain": self.retain,
            "saved": self.saved,
            "fallbacks": self.fallbacks,
            "on_disk": len(self.list()),
        }

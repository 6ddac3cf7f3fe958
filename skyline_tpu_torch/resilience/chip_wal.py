"""Chip-local WAL segments and merge-time barrier records of the sharded
engine.

Counterpart of ``skyline_tpu/resilience/chip_wal.py``; the segment files
are byte-equal to the reference writer's on the same calls. The worker's
main WAL journals the ingest stream, and crash replay re-ingests it. What
it cannot tell is whether a restored sharded engine's per-chip groups are
mutually consistent. ``ChipWalPlane`` closes that gap with one small
journal per chip under ``<wal_dir>/chip-NN/``:

- ``flush`` notes: chip ``c`` absorbed ``rows`` pending rows and its epoch
  subvector digest is now ``epoch`` — the per-chip lineage of device state;
- ``chip-barrier`` records: after two-level merge ``seq`` over global epoch
  digest ``epoch``, chip ``c``'s subvector digest was ``chip_epoch`` and
  its chip-local skyline had ``g`` rows. The same ``(seq, epoch)`` pair is
  fanned out to every chip journal, so replay verification reduces to "at
  the highest seq common to all journals, do all chips agree on the global
  epoch digest?" (``verify_chip_barriers``, which every resilient worker
  boot runs). A crash mid-fan-out leaves a partial seq on some journals —
  by construction not common to all, so it is ignored rather than reported
  as divergence.

``SKYLINE_CHIP_BARRIER`` picks merge-time barriers (the default),
checkpoint-only, or off (no plane). A flat worker's WAL directory holds no
chip journal, and ``verify_chip_barriers`` reports zero chips.
"""

from __future__ import annotations

import os

from skyline_tpu_torch.resilience.wal import WalReplayError, WalWriter, read_records

CHIP_WAL_FMT = "chip-%02d"


def chip_wal_dir(wal_dir: str, chip: int) -> str:
    return os.path.join(wal_dir, CHIP_WAL_FMT % chip)


class ChipWalPlane:
    """Per-chip WAL writers for a sharded engine's ``chips`` groups."""

    def __init__(self, wal_dir: str, chips: int, segment_bytes: int = 4_194_304,
                 fsync: str = "batch", telemetry=None):
        self.wal_dir = wal_dir
        self.chips = chips
        self._writers = [
            WalWriter(chip_wal_dir(wal_dir, c), segment_bytes=segment_bytes, fsync=fsync,
                      telemetry=telemetry)
            for c in range(chips)
        ]
        self.barriers_written = 0
        self.flush_notes = 0

    def note_flush(self, chip: int, rows: int, epoch: str) -> None:
        """Journal one chip flush: ``rows`` pending rows absorbed, chip
        epoch digest now ``epoch``."""
        self._writers[chip].append(
            {"type": "flush", "chip": chip, "rows": int(rows), "epoch": epoch}
        )
        self._writers[chip].flush()
        self.flush_notes += 1

    def merge_barrier(self, seq: int, epoch: str, chip_epochs: list[str],
                      chip_counts: list[int]) -> None:
        """Fan one merge-consistency barrier out to every chip journal:
        merge ``seq`` ran over global epoch digest ``epoch`` with chip
        ``c`` at subvector digest ``chip_epochs[c]`` holding
        ``chip_counts[c]`` skyline rows."""
        for c, w in enumerate(self._writers):
            w.append({
                "type": "chip-barrier",
                "seq": int(seq),
                "chip": c,
                "chips": self.chips,
                "epoch": epoch,
                "chip_epoch": chip_epochs[c],
                "g": int(chip_counts[c]),
            })
            w.flush(force=True)
        self.barriers_written += 1

    def checkpoint_barrier(self, rec: dict) -> None:
        """Checkpoint-time barrier: rotate each chip journal to a fresh
        segment (older segments truncate — the checkpoint supersedes them),
        stamped with the shared checkpoint record."""
        for c, w in enumerate(self._writers):
            w.barrier(dict(rec, chip=c, chips=self.chips))

    def failover_window(self, chip: int) -> dict:
        """The chip-local replay window an online failover re-owns:
        ``chip``'s journal records since the last barrier common to all
        chips. Returns the common barrier seq, the post-barrier record and
        row counts, and the chip's newest journaled epoch digest (the
        currency the healed group is checked against)."""
        self._writers[chip].flush(force=True)
        base = verify_chip_barriers(self.wal_dir, self.chips)
        records = read_chip_records(self.wal_dir, self.chips)[chip]
        seq = base["common_seq"]
        tail: list[dict] = []
        seen = seq is None  # no common barrier: the whole journal replays
        for r in records:
            if not seen:
                if r.get("type") == "chip-barrier" and r.get("seq") == seq:
                    seen = True
                continue
            tail.append(r)
        flushes = [r for r in tail if r.get("type") == "flush"]
        last_epoch = (
            flushes[-1]["epoch"] if flushes else (base["epoch"] if seq is not None else None)
        )
        return {
            "common_seq": seq,
            "records": len(tail),
            "replay_flushes": len(flushes),
            "replay_rows": sum(int(r.get("rows", 0)) for r in flushes),
            "last_epoch": last_epoch,
        }

    def close(self) -> None:
        for w in self._writers:
            w.close()

    def stats(self) -> dict:
        return {
            "chips": self.chips,
            "barriers_written": self.barriers_written,
            "flush_notes": self.flush_notes,
            "per_chip": [w.stats() for w in self._writers],
        }


def read_chip_records(wal_dir: str, chips: int) -> list[list[dict]]:
    """Every chip journal's records (torn tails tolerated, as the main
    WAL replay does)."""
    out = []
    for c in range(chips):
        d = chip_wal_dir(wal_dir, c)
        records, _torn = read_records(d) if os.path.isdir(d) else ([], 0)
        out.append(records)
    return out


def discover_chips(wal_dir: str) -> int:
    """How many chip journals exist under ``wal_dir`` (0 when none —
    a kernel-only / single-device WAL layout)."""
    n = 0
    while os.path.isdir(chip_wal_dir(wal_dir, n)):
        n += 1
    return n


def verify_chip_barriers(wal_dir: str, chips: int | None = None) -> dict:
    """Replay-time group-consistency check over the chip journals.

    Finds the highest barrier ``seq`` present in ALL chip journals and
    verifies every chip recorded the same global epoch digest at it. A
    seq missing from some journal is a torn fan-out (crash mid-barrier)
    and is skipped — only a COMMON seq with disagreeing digests is real
    divergence, and that raises ``WalReplayError`` (replaying groups that
    describe different global states would publish fabricated answers).

    Returns ``{"chips", "common_seq", "epoch", "agree"}``;
    ``common_seq`` is None when no barrier is common (fresh WAL, barriers
    off, or single-chip layout)."""
    if chips is None:
        chips = discover_chips(wal_dir)
    if chips == 0:
        return {"chips": 0, "common_seq": None, "epoch": None, "agree": True}
    per_chip = read_chip_records(wal_dir, chips)
    seq_maps: list[dict[int, str]] = []
    for records in per_chip:
        seq_maps.append({
            int(r["seq"]): str(r["epoch"])
            for r in records
            if r.get("type") == "chip-barrier" and "seq" in r
        })
    common = set(seq_maps[0])
    for m in seq_maps[1:]:
        common &= set(m)
    if not common:
        return {
            "chips": chips, "common_seq": None, "epoch": None, "agree": True,
        }
    seq = max(common)
    epochs = [m[seq] for m in seq_maps]
    if len(set(epochs)) != 1:
        raise WalReplayError(
            f"chip barrier divergence at seq {seq}: per-chip global epoch "
            f"digests {epochs} disagree — groups describe different states"
        )
    return {
        "chips": chips, "common_seq": seq, "epoch": epochs[0], "agree": True,
    }

"""Readers of the sharded engine's chip-local WAL journals.

Counterpart of the readers in ``skyline_tpu/resilience/chip_wal.py``:
``chip_wal_dir``, ``read_chip_records``, ``discover_chips`` and
``verify_chip_barriers``, which every resilient worker boot runs. Each chip
journal under ``<wal_dir>/chip-NN/`` holds ``flush`` notes and
``chip-barrier`` records; the same ``(seq, epoch)`` pair is fanned out to
every chip journal, so replay verification reduces to "at the highest seq
common to all journals, do all chips agree on the global epoch digest?". A
crash mid-fan-out leaves a partial seq on some journals — by construction
not common to all, so it is ignored rather than reported as divergence.

The journals' writer (``ChipWalPlane``) waits for the port's sharded
engine (ROADMAP queue 1 item 7); until then a flat worker's WAL directory
holds no chip journal and ``verify_chip_barriers`` reports zero chips — but
a directory written by the reference's sharded worker is still checked.
"""

from __future__ import annotations

import os

from skyline_tpu_torch.resilience.wal import WalReplayError, read_records

CHIP_WAL_FMT = "chip-%02d"


def chip_wal_dir(wal_dir: str, chip: int) -> str:
    return os.path.join(wal_dir, CHIP_WAL_FMT % chip)


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

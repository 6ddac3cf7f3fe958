"""Host-level (third) tournament: the chip witness/summary prefilter lifted
one level up.

Counterpart of ``skyline_tpu/cluster/merge.py``. The sharded engine's
two-level merge (``distributed/sharded.py``) already proves the shape: level
1 builds each unit's local skyline root, a (2d+2)-float summary row per unit
feeds ``prune_witness_mask``, and only surviving roots enter the pairwise
``tree_pair_merge`` ladder. Hosts are just bigger units — each host's "root"
is the result of its OWN two-level merge (or flat merge at one chip),
harvested through the uniform ``global_merge_launch`` /
``merge_points_device`` surface both ``PartitionSet`` and
``ShardedPartitionSet`` expose.

Why byte identity survives a third level: ``tree_pair_merge`` emits the
stable [a|b] compaction, so the FINAL root is always the global skyline in
ascending partition id with per-partition storage order — a canonical form
independent of the merge tree's shape. Any bracketing of hosts, chips or
partitions converges to the same bytes.

Communication accounting: a host's summary is 2d+2 floats; a host whose
summary is witness-dominated ships ZERO point rows to the coordinator.

On a card every pair of the host ladder is two K2 launches
(``dominated_by_rect``). The kernels refuse operands on two devices, so each
surviving leaf — values, partition ids and count — is copied onto the root
device before its pair (``parallel/chips.py`` ``gather_to``); a leaf already
there is not copied.
"""

from __future__ import annotations

import numpy as np
import torch

from skyline_tpu_torch.distributed.sharded import on_device
from skyline_tpu_torch.parallel.chips import gather_to
from skyline_tpu_torch.stream.batched import PartitionSet
from skyline_tpu_torch.stream.window import (
    _active_bucket,
    partition_summaries_device,
    prune_witness_mask,
    tree_pair_merge,
)


def member_device(member) -> torch.device:
    """The device a member's merge root lives on: a flat set's own device,
    a sharded set's chip 0."""
    devices = getattr(member, "devices", None)
    return devices[0] if devices is not None else member.device


def host_leaf(member, want_summary: bool):
    """One host's tournament leaf: launch + harvest the member's own merge,
    take the padded root points on the member's device, and (under the host
    prune) its (2d+2) summary row — the exact shape of
    ``ShardedPartitionSet._level1_chip``, one level up.

    Returns ``(counts, surv, g, pts_dev, summary)`` with ``pts_dev`` /
    ``summary`` None when the host is empty."""
    dev = member_device(member)
    with on_device(dev):
        h = member.global_merge_launch(False)
        counts, surv, g, _ = member.global_merge_harvest(h)
        pts = None
        summary = None
        if g > 0:
            w = _active_bucket(max(g, 1))
            pts = member.merge_points_device(h, w)
            if want_summary:
                cnt = torch.tensor([g], dtype=torch.int64, device=pts.device)
                summary = PartitionSet._host(partition_summaries_device(pts[None], cnt, w))[0]
    return counts, surv, g, pts, summary


def prune_hosts(summaries: list, alive: np.ndarray, d: int):
    """Witness prune over host summaries: ``(pruned, witness_of)`` bool /
    int64 vectors over hosts. Dead hosts contribute +inf rows (they can
    neither prune nor be pruned — the chip level's convention)."""
    rows = [
        s if s is not None else np.full(2 * d + 2, np.inf, dtype=np.float32)
        for s in summaries
    ]
    return prune_witness_mask(np.stack(rows), alive, d)


def tournament(leaves, root_dev):
    """Pairwise merge ladder over host leaves, adjacent pairs in ascending
    host order, odd tail passing through — the cross-chip level's bracket
    discipline, so the final root lands in the canonical ascending-pid
    order.

    ``leaves``: ``[(vals_dev, pids_np_int64, g), ...]`` per surviving host,
    ascending. Each leaf's values, partition ids and count are put on
    ``root_dev`` before any pair. Returns ``(root_vals, root_pids, root_cnt,
    levels, candidates_per_level)``."""
    with on_device(root_dev):
        nodes = []
        for vals, pid_np, g in leaves:
            (vals_root,) = gather_to(root_dev, [vals])
            nodes.append((
                vals_root,
                torch.from_numpy(pid_np).to(root_dev),
                torch.tensor(g, dtype=torch.int64, device=root_dev),
                g,
            ))
        levels = 0
        cand = [len(nodes)]
        while len(nodes) > 1:
            levels += 1
            nxt = []
            for i in range(0, len(nodes) - 1, 2):
                av, ap, ac, aub = nodes[i]
                bv, bp, bc, bub = nodes[i + 1]
                out_cap = _active_bucket(max(aub + bub, 1))
                vals, pids, cnt = tree_pair_merge(av, ap, ac, bv, bp, bc, out_cap)
                nxt.append((vals, pids, cnt, min(aub + bub, out_cap)))
            if len(nodes) % 2:
                nxt.append(nodes[-1])
            nodes = nxt
            cand.append(len(nodes))
        root_vals, root_pids, root_cnt, _ = nodes[0]
    return root_vals, root_pids, root_cnt, levels, cand

"""The device mesh and the sharded two-phase skyline over it.

Counterpart of ``skyline_tpu/parallel/mesh.py``. The reference's mesh is a
``jax.sharding.Mesh`` driven from one process by ``shard_map`` and
``all_gather``; here it is ``Mesh``, an ordered grid of places (each a
``torch.device``) with named axes, driven from one process too: a place's
work runs on its device, and an ``all_gather`` over an axis is a
``torch.cat`` of the shards after ``gather_to`` has copied them to the
receiving place's device (the kernels refuse operands on two cards).
Across processes the host axis rides ``torch.distributed``
(``parallel/multihost.py``).

Places default to ``parallel/chips.py`` ``chip_devices`` (``cuda:i % n``),
so one card hosts every place of a four-place mesh; on the CPU every place
is the CPU. Rows shard as ``NamedSharding(mesh, P(axis))`` shards them:
place i holds the i-th contiguous slice. So the local mask, the gathered
survivors and both outputs of ``build_two_phase`` are the reference's
(the local mask up to the reference's blocked-mask miss documented in
``ops/block_skyline.py``; the global mask always).

The merge: each place masks its own rows (K3 on a card), gathers every
place's rows and local masks, and prunes its survivors against them (K2 on
a card). Local non-survivors need no check (dominance is transitive) and
serve as no dominator. ``global_keep`` is exact and equals an unsharded
``skyline_mask`` whatever the place count.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from skyline_tpu_torch.ops.block_skyline import (
    dominated_by_blocked,
    skyline_mask_blocked,
)
from skyline_tpu_torch.parallel.chips import chip_devices, gather_to, on_device
from skyline_tpu_torch.utils.buckets import next_pow2

AXIS = "p"


@dataclass(frozen=True)
class Mesh:
    """An ordered grid of places with named axes: ``places`` row-major over
    ``grid``, one name per axis. Hashable by value (as the reference's
    ``Mesh`` is by devices and names), so the cached step factories key on it.

    ``process_index`` / ``num_processes``: a mesh whose first axis spans
    ``torch.distributed`` ranks (``parallel/multihost.py``) — row
    ``process_index`` of the grid is this process's; the other rows name
    the places of the other ranks, which this process never touches."""

    places: tuple
    grid: tuple
    axis_names: tuple
    process_index: int = 0
    num_processes: int = 1

    def __post_init__(self):
        if len(self.grid) != len(self.axis_names):
            raise ValueError(f"grid {self.grid} does not match axes {self.axis_names}")
        if math.prod(self.grid) != len(self.places):
            raise ValueError(f"grid {self.grid} does not hold {len(self.places)} places")

    @property
    def size(self) -> int:
        return len(self.places)

    @property
    def shape(self) -> dict:
        """Axis name -> extent, as the reference's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.grid))

    @property
    def devices(self) -> np.ndarray:
        """The places as an object array of shape ``grid``."""
        arr = np.empty(len(self.places), dtype=object)
        arr[:] = list(self.places)
        return arr.reshape(self.grid)

    @property
    def device_type(self) -> str:
        return self.places[0].type

    def axis_places(self, axis: str) -> list:
        """The places along ``axis``, every other axis at index 0 (the
        reference shards over one axis and keeps the others replicated)."""
        k = self.axis_names.index(axis)
        idx = [0] * len(self.grid)
        out = []
        for i in range(self.grid[k]):
            idx[k] = i
            out.append(self.devices[tuple(idx)])
        return out


def make_mesh(n_devices: int | None = None, axis: str = AXIS, device="cuda") -> Mesh:
    """1-D mesh of ``n_devices`` places, the i-th on ``chip_devices``'s
    i-th device: ``cuda:i % n`` over the visible cards (places wrap when
    there are fewer cards), or the CPU for every place with
    ``device="cpu"``. ``None``: one place per visible card (one on the
    CPU). The reference's analogue of Flink's ``setParallelism``."""
    if n_devices is None:
        dev = torch.device(device)
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    return Mesh(tuple(chip_devices(n_devices, device)), (n_devices,), (axis,))


def split_rows(mesh: Mesh, n: int, axis: str) -> list[slice]:
    """The contiguous row slice of each place along ``axis`` (``n`` must be
    a multiple of the axis's extent)."""
    k = int(mesh.shape[axis])
    if n % k:
        raise ValueError(f"{n} rows do not split over {k} places")
    per = n // k
    return [slice(i * per, (i + 1) * per) for i in range(k)]


def device_spans(mesh: Mesh, n: int, axis: str) -> list[tuple[slice, torch.device]]:
    """``split_rows`` with neighbouring places that share a device merged:
    (rows, device) pairs, one for each run of places on one device. The
    partition-parallel steps run each pair as one batched call — per
    partition the same work, so the same bytes — and a mesh whose places
    all sit on one device runs one call over every row."""
    out = []
    for span, dev in zip(split_rows(mesh, n, axis), mesh.axis_places(axis)):
        if out and out[-1][1] == dev:
            out[-1] = (slice(out[-1][0].start, span.stop), dev)
        else:
            out.append((span, dev))
    return out


@dataclass(frozen=True)
class Placed:
    """A stacked state kept where a mesh's places work on it: for each run
    of places on one device (``device_spans``), the span of leading rows
    (partitions) it holds and its slice on that device. The partition-
    parallel steps take and return state in this form, so between steps
    no slice leaves its device."""

    parts: tuple  # of (slice, torch.device, torch.Tensor)

    @classmethod
    def split(cls, mesh: Mesh, state: torch.Tensor, axis: str) -> "Placed":
        """``state``'s slice for each run of places, on its device (a view
        where that is ``state``'s device, else a copy)."""
        return cls(tuple(
            (span, dev, state[span].to(dev))
            for span, dev in device_spans(mesh, state.shape[0], axis)
        ))

    def on(self, device) -> torch.Tensor | None:
        """The whole state when one slice on ``device`` holds it, else None."""
        if len(self.parts) == 1 and self.parts[0][1] == device:
            return self.parts[0][2]
        return None

    def map(self, fn) -> "Placed":
        """``fn`` applied to every slice on its own device."""
        out = []
        for span, dev, t in self.parts:
            with on_device(dev):
                out.append((span, dev, fn(t)))
        return Placed(tuple(out))

    def gather(self, device) -> torch.Tensor:
        """The whole state, one tensor on ``device``."""
        with on_device(device):
            return torch.cat(gather_to(device, [t for _, _, t in self.parts]))


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a))
    return a


def shard_rows(mesh: Mesh, x, valid, axis: str = AXIS):
    """(N, d) rows and (N,) validity (numpy or tensors) as each place's
    contiguous slice on its device: two lists, one entry a place."""
    places = mesh.axis_places(axis)
    x, valid = _as_tensor(x), _as_tensor(valid)
    spans = split_rows(mesh, x.shape[0], axis)
    xs = [x[s].to(dev).contiguous() for s, dev in zip(spans, places)]
    vs = [valid[s].to(dev).contiguous() for s, dev in zip(spans, places)]
    return xs, vs


def _shards(mesh: Mesh, x, valid, axis: str):
    """Per-place shards of ``x``/``valid``: lists as given, else split."""
    if isinstance(x, (list, tuple)):
        return list(x), list(valid)
    return shard_rows(mesh, x, valid, axis)


def gathered(shards: list, places: list) -> dict:
    """Every shard concatenated once on each distinct device of
    ``places``: the ``all_gather`` (tiled) as seen from each place."""
    out = {}
    for dev in places:
        if dev not in out:
            with on_device(dev):
                out[dev] = torch.cat(gather_to(dev, shards))
    return out


def build_two_phase(
    mesh: Mesh,
    *,
    axis: str = AXIS,
    local_block: int = 2048,
    cross_block: int = 8192,
):
    """The sharded two-phase skyline step for ``mesh``:
    ``step(x, valid) -> (local_keep, global_keep)``. ``x`` (N, d) and
    ``valid`` (N,) are whole (split into each place's contiguous slice
    here, N a multiple of the place count) or ``shard_rows``'s per-place
    lists. ``local_keep[j]``: row j survives its place's local phase;
    ``global_keep[j]``: row j is in the global skyline — exact, and equal
    to an unsharded ``skyline_mask``. Both come back whole, on the first
    place's device. A one-place mesh skips the gather and the cross prune
    (its local mask is the answer)."""
    places = mesh.axis_places(axis)
    home = places[0]

    def step(x, valid):
        xs, vs = _shards(mesh, x, valid, axis)
        if len(places) == 1:
            with on_device(home):
                lk = skyline_mask_blocked(xs[0], vs[0], block=local_block)
            return lk, lk
        local = []
        for xi, vi, dev in zip(xs, vs, places):
            with on_device(dev):
                local.append(skyline_mask_blocked(xi, vi, block=local_block))
        all_x = gathered(xs, places)
        all_keep = gathered(local, places)
        glob = []
        for xi, lk, dev in zip(xs, local, places):
            with on_device(dev):
                dom = dominated_by_blocked(
                    xi, all_x[dev], x_valid=all_keep[dev], block=cross_block
                )
                glob.append(lk & ~dom)
        with on_device(home):
            return torch.cat(gather_to(home, local)), torch.cat(gather_to(home, glob))

    return step


# Mesh is hashable by value, so equal meshes share one step
_cached_two_phase = functools.lru_cache(maxsize=32)(
    lambda mesh, axis, local_block, cross_block: build_two_phase(
        mesh, axis=axis, local_block=local_block, cross_block=cross_block
    )
)


def sharded_two_phase_skyline(
    mesh: Mesh,
    x,
    valid,
    *,
    axis: str = AXIS,
    local_block: int = 2048,
    cross_block: int = 8192,
):
    """Build (cached) and run the two-phase step."""
    step = _cached_two_phase(mesh, axis, local_block, cross_block)
    return step(x, valid)


def skyline_keep_np_sharded(
    mesh: Mesh,
    x: np.ndarray,
    *,
    axis: str | None = None,
    local_block: int = 2048,
    cross_block: int = 8192,
) -> np.ndarray:
    """Survivor mask of a host (n, d) array by the sharded two-phase step —
    the mesh counterpart of ``ops.dispatch.skyline_keep_np`` and the
    engine's global merge when it owns a mesh. The rows are padded with
    ``+inf`` rows to a power-of-two capacity (at least 1,024, rounded up to
    a multiple of the place count), the padding invalid, and the exact
    mask of the first n rows comes back. ``axis`` defaults to the mesh's
    first axis, the one ``stream.batched.PartitionSet`` shards over."""
    n, d = x.shape
    if n == 0:
        return np.zeros((0,), dtype=bool)
    if axis is None:
        axis = mesh.axis_names[0]
    n_dev = int(mesh.shape[axis])
    cap = next_pow2(n, min_cap=1024)
    cap = -(-cap // n_dev) * n_dev  # a no-op for power-of-two place counts
    pad = np.full((cap, d), np.inf, dtype=np.float32)
    pad[:n] = x
    valid = np.arange(cap) < n
    _, global_keep = sharded_two_phase_skyline(
        mesh, pad, valid, axis=axis, local_block=local_block, cross_block=cross_block
    )
    return global_keep.cpu().numpy()[:n]

"""Multi-host scale-out: the hierarchical two-phase skyline over a 2-D
``(host, chip)`` mesh.

Counterpart of ``skyline_tpu/parallel/multihost.py``. Chips within a host
merge over in-process copies (the reference's ICI stage); hosts merge over
``torch.distributed`` (its DCN stage), and that stage moves only each
host's compacted survivor buffer, ``host_cap`` rows, not its raw window.

Exactness: pruning against a host's survivors is exact by transitivity (a
pruned row's dominator is itself a survivor). ``host_cap`` is the one
approximation knob: a host with more survivors ships its first
``host_cap`` (the stable ``compact`` order, as the reference's), so only
dominators drop and the result is a SUPERSET of the skyline; the step
counts the participants whose host overflowed (0 on an exact result).
``host_cap = rows_per_host`` is always exact.

One process: the host axis is an even reshape of the places (they wrap
onto the visible cards, or are all the CPU), and every stage is an
in-process copy. Several processes (``init_multihost``): one process a
host, the host axis keyed on the rank, the host stage a
``torch.distributed`` ``all_gather`` (``gloo`` for CPU tensors, ``nccl``
for CUDA; NCCL needs a card of its own per rank). Each rank then passes
and gets back its own host's rows only.
"""

from __future__ import annotations

import torch

from skyline_tpu_torch.ops.block_skyline import dominated_by_blocked, skyline_mask_blocked
from skyline_tpu_torch.ops.dominance import compact
from skyline_tpu_torch.parallel.chips import chip_devices, gather_to, on_device
from skyline_tpu_torch.parallel.mesh import Mesh, _as_tensor, gathered

HOST_AXIS = "host"
CHIP_AXIS = "chip"


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> None:
    """Join a multi-host run: ``torch.distributed.init_process_group``
    at ``coordinator_address`` (``host:port``, or a ``tcp://`` URL) with
    ``num_processes`` ranks, this one ``process_id``; ``gloo`` on the CPU,
    ``nccl`` on a card. The arguments default to ``SKYLINE_COORDINATOR``,
    ``SKYLINE_NUM_PROCESSES`` and ``SKYLINE_PROCESS_ID``. A no-op with one
    process, with nothing configured, or when already joined."""
    from skyline_tpu_torch.utils.knobs import env_int, env_str

    coordinator_address = coordinator_address or env_str("SKYLINE_COORDINATOR")
    if num_processes is None:
        num_processes = env_int("SKYLINE_NUM_PROCESSES", None)
    if process_id is None:
        process_id = env_int("SKYLINE_PROCESS_ID", None)
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None and num_processes is None and process_id is None:
        return
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "a multi-host run needs the coordinator address, the process "
            "count and this process's id"
        )
    if _dist() is not None:
        return
    import torch.distributed as dist

    url = coordinator_address
    if "://" not in url:
        url = "tcp://" + url
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=url, world_size=num_processes, rank=process_id
    )


def make_host_chip_mesh(
    n_hosts: int | None = None,
    chips_per_host: int | None = None,
    *,
    places: int | None = None,
    device="cuda",
) -> Mesh:
    """2-D ``(host, chip)`` mesh.

    Across processes (``init_multihost``) the host axis is the ranks, one
    host a rank, and ``n_hosts`` is ignored, as the reference keys it on
    ``process_index``; rank r's chip c is ``cuda:(r * chips + c) % n`` (on
    the CPU, the CPU), ``chips_per_host`` defaulting to the visible cards
    over the ranks (1 on the CPU).

    In one process the first ``n_hosts * chips_per_host`` of ``places``
    places (default: the visible cards, or 1 on the CPU; they wrap onto
    the cards as ``make_mesh``'s do) reshape evenly into the grid;
    ``chips_per_host`` defaults to ``places // n_hosts``."""
    dev = torch.device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    dist = _dist()
    if dist is not None and dist.get_world_size() > 1:
        world, rank = dist.get_world_size(), dist.get_rank()
        if chips_per_host is None:
            chips_per_host = max(1, n_cards // world) if dev.type == "cuda" else 1
        grid = [
            torch.device("cuda", (h * chips_per_host + c) % n_cards)
            if dev.type == "cuda" else torch.device("cpu")
            for h in range(world)
            for c in range(chips_per_host)
        ]
        return Mesh(tuple(grid), (world, chips_per_host), (HOST_AXIS, CHIP_AXIS),
                    process_index=rank, num_processes=world)
    if places is None:
        places = n_cards
    if n_hosts is None:
        n_hosts = 1
    if chips_per_host is None:
        if places % n_hosts:
            raise ValueError(f"{places} devices not divisible into {n_hosts} hosts")
        chips_per_host = places // n_hosts
    if n_hosts * chips_per_host > places:
        raise ValueError(f"need {n_hosts}x{chips_per_host} devices, have {places}")
    grid = chip_devices(n_hosts * chips_per_host, device)
    return Mesh(tuple(grid), (n_hosts, chips_per_host), (HOST_AXIS, CHIP_AXIS))


def _host_places(mesh: Mesh, h: int) -> list:
    chips = mesh.grid[1]
    return list(mesh.places[h * chips : (h + 1) * chips])


def shard_rows_2d(mesh: Mesh, x, valid):
    """(N, d) rows and (N,) validity as the shards of this process's
    places, each on its device: shard ``h * chips + c`` is the
    (h * chips + c)-th contiguous slice, as ``P((host, chip))`` shards
    them. In one process every host's shards; across processes this
    host's."""
    x, valid = _as_tensor(x), _as_tensor(valid)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} places")
    per = n // mesh.size
    hosts = range(mesh.grid[0]) if mesh.num_processes == 1 else [mesh.process_index]
    xs, vs = [], []
    for h in hosts:
        for c, dev in enumerate(_host_places(mesh, h)):
            s = slice((h * mesh.grid[1] + c) * per, (h * mesh.grid[1] + c + 1) * per)
            xs.append(x[s].to(dev).contiguous())
            vs.append(valid[s].to(dev).contiguous())
    return xs, vs


def build_hierarchical_two_phase(
    mesh: Mesh,
    *,
    rows_per_shard: int,
    host_cap: int | None = None,
    local_block: int = 2048,
    cross_block: int = 8192,
):
    """The hierarchical two-phase step for a ``(host, chip)`` mesh:
    ``step(x, valid) -> (host_keep, global_keep, overflowed)``. ``x`` and
    ``valid`` are ``shard_rows_2d``'s lists or whole arrays (every rank
    passing the same whole window).

    - ``host_keep[j]``: row j survives its host's merge of its chips;
    - ``global_keep[j]``: row j is in the global skyline (exact when
      ``overflowed == 0``, a superset otherwise);
    - ``overflowed``: the participants (chips) whose host had more than
      ``host_cap`` survivors, a 0-d int64 tensor.

    The masks come back on the first local place's device: the whole
    window in one process, this host's rows across processes.
    ``host_cap`` (default ``rows_per_host``, always exact) sizes the
    buffer each host ships; it must be a multiple of 1,024 or equal
    ``rows_per_host``."""
    n_hosts, chips = mesh.grid
    rows_per_host = rows_per_shard * chips
    if host_cap is None:
        host_cap = rows_per_host
    if host_cap % 1024 and host_cap != rows_per_host:
        raise ValueError(f"host_cap {host_cap} must be a multiple of 1024")
    multi = mesh.num_processes > 1
    hosts = [mesh.process_index] if multi else list(range(n_hosts))

    def step(x, valid):
        if isinstance(x, (list, tuple)):
            xs, vs = list(x), list(valid)
        else:
            xs, vs = shard_rows_2d(mesh, x, valid)
        # stage 0: each chip's local mask
        host_rows, host_keep, bufs = [], [], []
        home = _host_places(mesh, hosts[0])[0]
        overflow = torch.zeros((), dtype=torch.int64, device=home)
        for i, h in enumerate(hosts):
            places = _host_places(mesh, h)
            hx_s, hv_s = xs[i * chips : (i + 1) * chips], vs[i * chips : (i + 1) * chips]
            local = []
            for xi, vi, dev in zip(hx_s, hv_s, places):
                with on_device(dev):
                    local.append(skyline_mask_blocked(xi, vi, block=local_block))
            # stage 1: each chip's survivors against every chip of its host
            hx, hlk = gathered(hx_s, places), gathered(local, places)
            hk = []
            for xi, lk, dev in zip(hx_s, local, places):
                with on_device(dev):
                    dom = dominated_by_blocked(xi, hx[dev], x_valid=hlk[dev], block=cross_block)
                    hk.append(lk & ~dom)
            # the host's buffer: the stable compaction of its survivors
            lead = places[0]
            with on_device(lead):
                hhk = torch.cat(gather_to(lead, hk))
                buf, buf_valid, count = compact(hx[lead], hhk, host_cap)
            overflow += (count > host_cap).to(device=home, dtype=torch.int64) * chips
            host_rows.append((hx_s, places))
            host_keep.append(hk)
            bufs.append((buf, buf_valid))
        # stage 2: every host's buffer, over the host axis
        if multi:
            all_buf, all_valid, overflow = _all_gather_hosts(bufs[0], overflow, mesh)
        else:
            all_buf = [b for b, _ in bufs]
            all_valid = [v for _, v in bufs]
        hk_out, gk_out = [], []
        for (hx_s, places), hk in zip(host_rows, host_keep):
            ab, av = gathered(all_buf, places), gathered(all_valid, places)
            for xi, k, dev in zip(hx_s, hk, places):
                with on_device(dev):
                    dom = dominated_by_blocked(xi, ab[dev], x_valid=av[dev], block=cross_block)
                    hk_out.append(k)
                    gk_out.append(k & ~dom)
        with on_device(home):
            return (
                torch.cat(gather_to(home, hk_out)),
                torch.cat(gather_to(home, gk_out)),
                overflow,
            )

    return step


def _all_gather_hosts(buf_pair, overflow, mesh: Mesh):
    """This host's (buffer, validity) and overflow count exchanged with
    every rank: (every host's buffer, every host's validity, in rank
    order; the summed overflow)."""
    dist = _dist()
    buf, buf_valid = buf_pair
    world = mesh.num_processes
    flags = buf_valid.to(torch.uint8)
    bufs = [torch.empty_like(buf) for _ in range(world)]
    vals = [torch.empty_like(flags) for _ in range(world)]
    dist.all_gather(bufs, buf.contiguous())
    dist.all_gather(vals, flags)
    total = overflow.to(buf.device).reshape(1).clone()
    dist.all_reduce(total)
    return bufs, [v.to(torch.bool) for v in vals], total[0].to(overflow.device)

"""The declarative dispatch cascade table: one place for every variant,
path and gate choice the port makes.

Counterpart of ``skyline_tpu/ops/cascade.py``, row for row. Each
:class:`CascadeRow` declares a stage's variant with its applicability
(backend, dimension bounds, legality at a merge-time call site, with a
mesh), the environment knob that forces or excludes it, the knobs a tuner
may move for it and the byte-identity oracle that makes it interchangeable
with its siblings. The dispatch sites resolve here:
``dispatch.skyline_mask_auto`` (``resolve_mask``), the lazy flush's path
(``resolve_flush``), the global merge's path (``merge_cache_on``,
``delta_applies``, ``merge_tree_on``) and the gates (``gate``,
``applies``). The sharded engine's chip prune reads its row
(``gate("chip_prune")``), the cluster merge's host prune its own
(``gate("host_prune")``, ``cluster/coordinator.py``).

Resolution is the reference's: explicit ``auto|on|off`` modes force or
exclude rows, ``auto`` races the applicable candidates on measured
``KernelProfiler`` EMAs (``dispatch.choose_variant``, sticky exploration),
and a merge-time call site ("traced", the reference's calls under
``jax.jit``) swaps only on evidence already measured and records nothing.
Where the reference asks ``on_tpu()``, the port asks whether the call's
device is a CUDA card; the rows keep the reference's vocabulary,
``backends=("tpu",)`` meaning the card, so ``table_doc()`` compares.

Two tuner surfaces sit on top, inert until a controller writes them:

- **pins**: a learned winner per (stage, d, N-bucket, backend, mp) that
  short-circuits the race — accepted only for a row whose oracle is in
  :data:`ORACLES`, and used only where that row is a candidate anyway;
- **overrides**: values of the tunable knobs read by ``_eff_bool`` and
  ``_eff_float``. An explicit environment value always wins, checked at
  read time.
"""

from __future__ import annotations

import dataclasses
import os
import threading

from skyline_tpu_torch.telemetry.profiler import default_backend, n_bucket
from skyline_tpu_torch.utils.devices import device_type
from skyline_tpu_torch.utils.knobs import (
    chip_prune_enabled,
    delta_dirty_cutoff,
    device_cascade_mode,
    flush_prefilter_enabled,
    host_prune_enabled,
    merge_cache_enabled,
    merge_prune_enabled,
    merge_tree_enabled,
    rank_cascade,
    sorted_sfs_mode,
)


@dataclasses.dataclass(frozen=True)
class CascadeRow:
    """One variant, path or gate of the dispatch cascade. ``name`` is the
    profiler's variant name where one applies (``stream/window.py``
    ``KERNEL_VARIANTS``); ``gate`` the knob that forces or excludes the
    row; ``oracle`` a key of :data:`ORACLES` — a row without one is never
    pinned."""

    name: str
    stage: str                      # mask | flush | merge | gate
    backends: tuple = ("*",)        # "tpu" (the card) | "host" (the CPU) | "*"
    d_min: int = 1
    d_max: int | None = None        # inclusive; None = unbounded
    traced_ok: bool = True          # legal at a merge-time call site
    mesh_ok: bool = False           # legal with a device mesh
    gate: str | None = None         # controlling environment knob
    oracle: str | None = None       # byte-identity oracle (ORACLES key)
    knobs: tuple = ()               # tuner-movable knobs of the row
    doc: str = ""


# How each oracle proves a row interchangeable with its siblings. A tuner
# may pin or re-knob only rows whose oracle is registered here.
ORACLES: dict[str, str] = {
    "host_oracle": (
        "exact NumPy double-loop skyline (tests/conftest host oracle); "
        "every mask/flush variant's survivor set is asserted equal in "
        "tests/test_cascade_table.py and the sampled audit plane"
    ),
    "merge_digest": (
        "published-state digest equality across cache/delta/tree/flat "
        "merge paths (merge law + stable compaction order; "
        "scripts/obs_smoke.sh digest legs, tests/test_merge_tree.py)"
    ),
    "prune_identity": (
        "witness-dominance soundness: a pruned partition/chip/host "
        "contributes no skyline point, so pruned and unpruned merges "
        "publish identical bytes (RUNBOOK §2g/§2p; A/B digest checks in "
        "benchmarks and obs_smoke)"
    ),
}


TABLE: tuple[CascadeRow, ...] = (
    # -- mask stage (dispatch.skyline_mask_auto) ---------------------------
    CascadeRow(
        "mask_sweep", "mask", d_max=2, oracle="host_oracle",
        doc="d<=2 sort + prefix-min sweep; unconditional, every backend",
    ),
    CascadeRow(
        "mask_pallas", "mask", backends=("tpu",), d_min=3,
        oracle="host_oracle",
        doc="quadratic Pallas sum-sorted tiles (TPU default kernel)",
    ),
    CascadeRow(
        "mask_rank_pallas", "mask", backends=("tpu",), d_min=3,
        gate="SKYLINE_RANK_CASCADE", oracle="host_oracle",
        doc="Pallas dense-rank cascade; replaces mask_pallas when forced",
    ),
    CascadeRow(
        "mask_device_cascade", "mask", d_min=3,
        gate="SKYLINE_DEVICE_CASCADE", oracle="host_oracle",
        doc="device sorted dominance cascade; jit-safe, all backends",
    ),
    CascadeRow(
        "sorted_sfs_mask", "mask", backends=("host",), d_min=3,
        traced_ok=False, gate="SKYLINE_SORTED_SFS", oracle="host_oracle",
        doc="host sorted-order SFS cascade; concrete non-TPU arrays only",
    ),
    CascadeRow(
        "mask_scan", "mask", backends=("host",), d_min=3,
        oracle="host_oracle",
        doc="lax.scan dominance kernel; the non-TPU device fallback",
    ),
    # -- flush stage (PartitionSet._choose_lazy_path) ----------------------
    CascadeRow(
        "flush_sorted_sfs", "flush", backends=("host",), traced_ok=False,
        gate="SKYLINE_SORTED_SFS", oracle="host_oracle",
        doc="whole lazy flush via the host sorted cascade",
    ),
    CascadeRow(
        "flush_device_cascade", "flush", gate="SKYLINE_DEVICE_CASCADE",
        oracle="host_oracle",
        doc="whole lazy flush via the device sorted cascade; candidates "
            "only when the host cascade is out of play (TPU or sorted=off)",
    ),
    CascadeRow(
        "flush_sfs_vmapped", "flush", mesh_ok=True, oracle="host_oracle",
        doc="one vmapped SFS round per flush level (balanced loads)",
    ),
    CascadeRow(
        "flush_sfs_sequential", "flush", oracle="host_oracle",
        doc="per-partition SFS rounds (routing skew)",
    ),
    # -- merge stage (global_merge_launch path) ----------------------------
    CascadeRow(
        "merge_cache_hit", "merge", gate="SKYLINE_MERGE_CACHE",
        oracle="merge_digest",
        doc="epoch-keyed exact cache hit: zero kernel launches",
    ),
    CascadeRow(
        "merge_tree_delta", "merge", d_min=3, gate="SKYLINE_MERGE_TREE",
        oracle="merge_digest", knobs=("SKYLINE_DELTA_CUTOFF",),
        doc="cached_global ∪ dirty partitions up the pruned tree",
    ),
    CascadeRow(
        "merge_delta", "merge", gate="SKYLINE_MERGE_CACHE",
        oracle="merge_digest", knobs=("SKYLINE_DELTA_CUTOFF",),
        doc="flat cached_global ∪ dirty merge below the cutoff",
    ),
    CascadeRow(
        "merge_tree", "merge", d_min=3, gate="SKYLINE_MERGE_TREE",
        oracle="merge_digest", knobs=("SKYLINE_MERGE_PRUNE",),
        doc="pruned tournament tree over all live partitions",
    ),
    CascadeRow(
        "merge_flat", "merge", mesh_ok=True, oracle="merge_digest",
        doc="single O(U²) union pass; the unconditional fallback",
    ),
    # -- prune/prefilter gates ---------------------------------------------
    CascadeRow(
        "partition_prune", "gate", d_min=3, gate="SKYLINE_MERGE_PRUNE",
        oracle="prune_identity", knobs=("SKYLINE_MERGE_PRUNE",),
        doc="O(P²·d) witness prefilter ahead of the tree merge",
    ),
    CascadeRow(
        "chip_prune", "gate", gate="SKYLINE_CHIP_PRUNE", mesh_ok=True,
        oracle="prune_identity", knobs=("SKYLINE_CHIP_PRUNE",),
        doc="chip-level witness prefilter in the sharded two-level merge",
    ),
    CascadeRow(
        "host_prune", "gate", gate="SKYLINE_CLUSTER_HOST_PRUNE",
        mesh_ok=True, oracle="prune_identity",
        knobs=("SKYLINE_CLUSTER_HOST_PRUNE",),
        doc="host-level witness prefilter in the cluster merge",
    ),
    CascadeRow(
        "flush_prefilter", "gate", d_min=3,
        gate="SKYLINE_FLUSH_PREFILTER", oracle="prune_identity",
        knobs=("SKYLINE_FLUSH_PREFILTER",),
        doc="quantized grid prefilter ahead of the flush merge",
    ),
)

ROW_BY_NAME: dict[str, CascadeRow] = {r.name: r for r in TABLE}

# every knob a row declares tunable: the only names set_override accepts
TUNABLE_KNOBS: frozenset[str] = frozenset(k for r in TABLE for k in r.knobs)

_lock = threading.Lock()
_overrides: dict[str, str] = {}        # guarded-by: _lock
_pins: dict[tuple, str] = {}           # guarded-by: _lock


def _env_pinned(name: str) -> bool:
    """True when the environment sets ``name``: it beats any override,
    checked when the knob is read."""
    v = os.environ.get(name)  # lint: allow-raw-env
    return v is not None and v != ""


# -- tuner override surface ------------------------------------------------

def set_override(name: str, value) -> bool:
    """Install an override of a tunable knob. Refused (False) for knobs no
    row declares tunable and for knobs the environment sets."""
    if name not in TUNABLE_KNOBS or _env_pinned(name):
        return False
    with _lock:
        _overrides[name] = str(value)
    return True


def clear_override(name: str) -> None:
    with _lock:
        _overrides.pop(name, None)


def override(name: str) -> str | None:
    with _lock:
        return _overrides.get(name)


def overrides_doc() -> dict[str, str]:
    with _lock:
        return dict(_overrides)


def _eff_bool(name: str | None, legacy: bool) -> bool:
    if name is None or _env_pinned(name):
        return legacy
    ov = override(name)
    if ov is None:
        return legacy
    return ov.strip().lower() in ("1", "true", "on", "yes")


def _eff_float(name: str, legacy: float) -> float:
    if _env_pinned(name):
        return legacy
    ov = override(name)
    if ov is None:
        return legacy
    try:
        return float(ov)
    except ValueError:
        return legacy


# -- tuner pin surface -----------------------------------------------------

def _pin_key(stage, d, n, mp, backend) -> tuple:
    return (stage, int(d), n_bucket(n), backend or default_backend(), bool(mp))


def pin(stage: str, variant: str, d: int, n: int, mp: bool = False,
        backend: str | None = None) -> bool:
    """Pin a learned winner for (stage, d, N-bucket, backend, mp); only a
    row of that stage with a registered oracle is accepted. ``backend``:
    ``"cuda"`` or ``"cpu"`` (``default_backend()`` if None)."""
    row = ROW_BY_NAME.get(variant)
    if row is None or row.stage != stage or row.oracle not in ORACLES:
        return False
    with _lock:
        _pins[_pin_key(stage, d, n, mp, backend)] = variant
    return True


def unpin(stage: str, d: int, n: int, mp: bool = False,
          backend: str | None = None) -> None:
    with _lock:
        _pins.pop(_pin_key(stage, d, n, mp, backend), None)


def clear_pins(stage: str | None = None) -> None:
    with _lock:
        if stage is None:
            _pins.clear()
        else:
            for k in [k for k in _pins if k[0] == stage]:
                del _pins[k]


def pinned(stage: str, d: int, n: int, mp: bool = False,
           backend: str | None = None) -> str | None:
    with _lock:
        return _pins.get(_pin_key(stage, d, n, mp, backend))


def pins_doc() -> list[dict]:
    with _lock:
        items = list(_pins.items())
    return [
        {"stage": k[0], "d": k[1], "n_bucket": k[2], "backend": k[3],
         "mp": k[4], "variant": v}
        for k, v in sorted(items)
    ]


# -- stage resolution ------------------------------------------------------

def resolve_mask(d: int, n: int, concrete: bool, profiler, mp: bool = False,
                 *, device) -> tuple[str, bool]:
    """The mask-stage row of one ``skyline_mask_auto`` call on ``device``:
    ``(variant, record)``. ``concrete`` is False at a merge-time call site
    (the reference's traced calls). ``record`` is the reference's
    recording rule: races over concrete calls (and the forced host
    cascade) record under ``profiler``; forced device rows and merge-time
    calls do not."""
    from skyline_tpu_torch.ops.dispatch import choose_variant

    if d <= 2:
        return "mask_sweep", False
    dc = device_cascade_mode()
    backend = device_type(device)
    if backend == "cuda":
        dev = "mask_rank_pallas" if gate("mask_rank_pallas") else "mask_pallas"
        if dc == "off":
            return dev, False
        if dc == "on":
            return "mask_device_cascade", False
        if concrete:
            p = pinned("mask", d, n, mp, backend)
            if p in (dev, "mask_device_cascade"):
                return p, True
            return (
                choose_variant(
                    profiler, (dev, "mask_device_cascade"), d, n, mp, backend
                ),
                True,
            )
        # a merge-time call records nothing, so the cascade swaps in only
        # on measured evidence for both candidates
        if profiler is not None:
            e_dev = profiler.ema_ms(dev, d, n, mp, backend)
            e_dc = profiler.ema_ms("mask_device_cascade", d, n, mp, backend)
            if e_dev is not None and e_dc is not None and e_dc < e_dev:
                return "mask_device_cascade", False
        return dev, False
    mode = sorted_sfs_mode()
    if not concrete:
        if dc == "on":
            return "mask_device_cascade", False
        return "mask_scan", False
    if mode == "on":
        return "sorted_sfs_mask", True
    if mode != "off" and dc == "off":
        # the two-way host race
        cands = ("sorted_sfs_mask", "mask_scan")
        p = pinned("mask", d, n, backend=backend)
        if p in cands:
            return p, True
        return choose_variant(profiler, cands, d, n, backend=backend), True
    if dc == "on":
        return "mask_device_cascade", False
    if mode == "off" and dc == "off":
        return "mask_scan", False
    cands = ()
    if mode != "off":
        cands += ("sorted_sfs_mask",)
    cands += ("mask_scan", "mask_device_cascade")
    p = pinned("mask", d, n, backend=backend)
    if p in cands:
        return p, True
    return choose_variant(profiler, cands, d, n, backend=backend), True


def flush_chooser_active(meshed: bool, device) -> bool:
    """Whether any alternative flush row is in play for a set on
    ``device``: the condition under which the set must own a chooser
    profiler before calling :func:`resolve_flush`."""
    if meshed:
        return False
    mode = "off" if device_type(device) == "cuda" else sorted_sfs_mode()
    return not (mode == "off" and device_cascade_mode() == "off")


def resolve_flush(device_variant: str, d: int, total_rows: int, meshed: bool,
                  profiler, *, device) -> str:
    """The path of one lazy flush on ``device``: ``"sorted_sfs"``,
    ``"device_cascade"`` or the SFS rounds' ``device_variant``. The device
    cascade joins the race only where the host cascade is out of play (a
    card, or ``SKYLINE_SORTED_SFS=off``)."""
    from skyline_tpu_torch.ops.dispatch import choose_variant

    if meshed:
        return device_variant
    mode = "off" if device_type(device) == "cuda" else sorted_sfs_mode()
    dc = device_cascade_mode()
    if mode == "off" and dc == "off":
        return device_variant
    if mode == "on":
        return "sorted_sfs"
    if dc == "on":
        return "device_cascade"
    backend = device_type(device)
    cands = []
    if mode != "off":
        cands.append("flush_sorted_sfs")
    cands.append("flush_sfs_" + device_variant)
    if dc != "off" and mode == "off":
        cands.append("flush_device_cascade")
    p = pinned("flush", d, total_rows, backend=backend)
    if p in cands:
        chosen = p
    else:
        chosen = choose_variant(profiler, tuple(cands), d, total_rows, backend=backend)
    if chosen == "flush_sorted_sfs":
        return "sorted_sfs"
    if chosen == "flush_device_cascade":
        return "device_cascade"
    return device_variant


def merge_cache_on(meshed: bool) -> bool:
    """Whether this merge reads and fills the cache (never with a mesh)."""
    return (not meshed) and _eff_bool("SKYLINE_MERGE_CACHE", merge_cache_enabled())


def delta_cutoff() -> float:
    """The effective delta-merge dirty-share cutoff (tuner-movable)."""
    return _eff_float("SKYLINE_DELTA_CUTOFF", delta_dirty_cutoff())


def delta_applies(dirty_fraction: float) -> bool:
    """Whether a merge with this share of dirty partitions takes the delta
    path."""
    return 0.0 < dirty_fraction <= delta_cutoff()


def merge_tree_on(meshed: bool, d: int) -> bool:
    """Whether the tree replaces the flat merge: d > 2 only (at d <= 2 the
    flat merge is the sweep, cheaper than any pairwise work)."""
    return (not meshed) and d > 2 and _eff_bool(
        "SKYLINE_MERGE_TREE", merge_tree_enabled()
    )


def merge_path(use_tree: bool, delta: bool) -> str:
    """The merge-stage row of one launch (an exact hit is decided before
    any of these)."""
    return ("tree_delta" if delta and use_tree
            else "delta" if delta
            else "tree" if use_tree else "flat")


_GATE_LEGACY = {
    "mask_rank_pallas": rank_cascade,
    "partition_prune": merge_prune_enabled,
    "chip_prune": chip_prune_enabled,
    "host_prune": host_prune_enabled,
    "flush_prefilter": flush_prefilter_enabled,
}


def gate(name: str) -> bool:
    """A boolean gate row's state: its environment knob, else a tuner
    override, else the knob's default."""
    row = ROW_BY_NAME[name]
    return _eff_bool(row.gate, _GATE_LEGACY[name]())


def applies(name: str, d: int | None = None, meshed: bool = False) -> bool:
    """The gate's state and the row's declared applicability (mesh,
    dimension bounds) in one call."""
    row = ROW_BY_NAME[name]
    if meshed and not row.mesh_ok:
        return False
    if d is not None:
        if d < row.d_min:
            return False
        if row.d_max is not None and d > row.d_max:
            return False
    return gate(name)


def table_doc() -> dict:
    """Every row with its declared applicability, the oracle registry and
    the tuner surfaces, JSON-safe."""
    rows = [
        {
            "name": r.name, "stage": r.stage, "backends": list(r.backends),
            "d_min": r.d_min, "d_max": r.d_max, "traced_ok": r.traced_ok,
            "mesh_ok": r.mesh_ok, "gate": r.gate, "oracle": r.oracle,
            "knobs": list(r.knobs), "doc": r.doc,
        }
        for r in TABLE
    ]
    return {
        "backend": default_backend(),
        "rows": rows,
        "oracles": dict(ORACLES),
        "pins": pins_doc(),
        "overrides": overrides_doc(),
        "effective": {
            "merge_cache": merge_cache_on(False),
            "merge_tree_d4": merge_tree_on(False, 4),
            "delta_cutoff": delta_cutoff(),
            "partition_prune": gate("partition_prune"),
            "chip_prune": gate("chip_prune"),
            "host_prune": gate("host_prune"),
            "flush_prefilter": gate("flush_prefilter"),
        },
    }

"""Environment knobs of the port.

The port's own copy of the JAX package's knob parsing
(``skyline_tpu/analysis/registry.py`` ``parse_bool``, ``env_bool``,
``env_int`` and ``env_float``, same truthy and falsy words) and the knobs
the port reads. Knobs are read lazily, when a flush or a merge runs, never
at import.
"""

from __future__ import annotations

import os
import warnings

_TRUTHY = frozenset(("1", "true", "yes", "on"))
_FALSY = frozenset(("0", "false", "no", "off"))

_warned: set[str] = set()


def parse_bool(raw: str | None, default=False):
    """``raw`` as a boolean: one of the truthy or falsy words (any case,
    surrounding blanks ignored), else ``default``."""
    if raw is None:
        return default
    s = raw.strip().lower()
    if s == "" or (s not in _FALSY and s not in _TRUTHY):
        return default
    return s in _TRUTHY


def env_bool(name: str, default=False):
    """The boolean environment variable ``name``; an unrecognised value
    warns once and gives ``default``."""
    v = os.environ.get(name)
    if v is not None and v.strip() != "":
        s = v.strip().lower()
        if s not in _FALSY and s not in _TRUTHY and name not in _warned:
            _warned.add(name)
            warnings.warn(
                f"ignoring {name}={v!r}: not a recognized boolean; using the default",
                stacklevel=2,
            )
    return parse_bool(v, default)


def _env_parsed(name: str, default, parse, what: str):
    """The environment variable ``name`` read by ``parse``; an unset or
    blank value gives ``default``, an unparsable one warns once (it is not
    ``what``) and gives ``default``."""
    v = os.environ.get(name)
    if v is None or v.strip() == "":
        return default
    try:
        return parse(v)
    except ValueError:
        if name not in _warned:
            _warned.add(name)
            warnings.warn(
                f"ignoring {name}={v!r}: not {what}; using the default",
                stacklevel=3,
            )
        return default


def env_int(name: str, default=0):
    """The integer environment variable ``name``."""
    return _env_parsed(name, default, int, "an integer")


def env_float(name: str, default=0.0):
    """The float environment variable ``name``."""
    return _env_parsed(name, default, float, "a number")


def rank_cascade() -> bool:
    """``SKYLINE_RANK_CASCADE`` selects the dense-rank dominance cascade
    (K4–K7) for the device-ingest flush and the global merge. Off by
    default, as in the reference (``skyline_tpu/ops/dispatch.py``)."""
    return env_bool("SKYLINE_RANK_CASCADE", False)


def flush_stage_depth() -> int:
    """``SKYLINE_STAGE_DEPTH``: how many incremental flush rounds the host
    assembles and uploads ahead of the round in flight. 1 = double
    buffering (the default, as in the reference); 0 assembles and launches
    strictly in order."""
    return max(0, env_int("SKYLINE_STAGE_DEPTH", 1))


def mixed_precision_enabled(device=None) -> bool:
    """``SKYLINE_MIXED_PRECISION``: the bf16 margin passes of the flush —
    the row pre-drop (``strictly_dominated_bf16``) and the kernels' bf16
    first pass (K1–K3 ``mp``), both exact, so the answer is the same either
    way. An explicit value wins on every device; otherwise it is on where
    ``device`` is a CUDA card and off on the CPU — the reference's
    ``on_tpu()`` default carried to the port's accelerator
    (``skyline_tpu/ops/dispatch.py``)."""
    # a torch.device, or a string such as "cuda:0"
    on_card = str(getattr(device, "type", device)).split(":", 1)[0] == "cuda"
    return env_bool("SKYLINE_MIXED_PRECISION", on_card)


def flush_prefilter_enabled() -> bool:
    """``SKYLINE_FLUSH_PREFILTER``: the quantized-grid prefilter ahead of
    the flush — pending host rows whose grid cell a representative cell of
    their partition's skyline strictly dominates are dropped before any
    merge kernel. On by default, as in the reference; the answer bytes are
    the same either way."""
    return env_bool("SKYLINE_FLUSH_PREFILTER", True)


def flush_prefilter_on(d: int) -> bool:
    """The reference's ``flush_prefilter`` row (``skyline_tpu/ops/
    cascade.py``): d >= 3 (the d <= 2 sweep has no merge kernel to save)
    and the knob; the row's other condition, no mesh, always holds for the
    port's set."""
    return d >= 3 and flush_prefilter_enabled()


# -- the global-merge plane ---------------------------------------------------
#
# The reference reads these through its dispatch table (``skyline_tpu/ops/
# cascade.py`` ``merge_cache_on``, ``delta_applies``, ``merge_tree_on``,
# ``gate("partition_prune")``), where a tuner may override a knob the
# environment left unset. The port has no tuner yet (ROADMAP.md, queue 1
# item 9), so the environment value is the effective value.


def merge_cache_enabled() -> bool:
    """``SKYLINE_MERGE_CACHE``: the epoch-keyed global-merge cache — a
    repeated trigger over unchanged state answers from the cache with no
    kernel launch, and a partly dirty state merges the cached global skyline
    with the dirty partitions. On by default, as in the reference; the
    answer bytes are the same either way."""
    return env_bool("SKYLINE_MERGE_CACHE", True)


def delta_dirty_cutoff() -> float:
    """``SKYLINE_DELTA_CUTOFF``: the largest share of dirty partitions the
    delta merge takes; above it the full merge runs. 0.75 by default, as in
    the reference; 0 turns the delta merge off and keeps the exact hit."""
    return env_float("SKYLINE_DELTA_CUTOFF", 0.75)


def merge_tree_enabled() -> bool:
    """``SKYLINE_MERGE_TREE``: the pruned tournament-tree global merge at
    d > 2 (pairs of partition skylines, two K2 passes each on a card) in
    place of one survivor-mask pass over the whole union. On by default, as
    in the reference; ``0`` gives the flat merge (K3 or K7 on a card) with
    the same answer bytes."""
    return env_bool("SKYLINE_MERGE_TREE", True)


def merge_prune_enabled() -> bool:
    """``SKYLINE_MERGE_PRUNE``: the witness prefilter ahead of the tree —
    a partition whose least corner another partition's witness row strictly
    dominates is dropped whole. On by default, as in the reference."""
    return env_bool("SKYLINE_MERGE_PRUNE", True)


def query_overlap_enabled() -> bool:
    """``SKYLINE_QUERY_OVERLAP``: a trigger launches the global merge and
    returns; the engine harvests it at the next ingest (if its stats have
    landed), trigger or result poll. On by default, as in the reference;
    ``0`` blocks at every trigger. The results are the same either way."""
    return env_bool("SKYLINE_QUERY_OVERLAP", True)


def merge_cache_on() -> bool:
    """Whether this merge reads and fills the cache (the port's set is never
    meshed)."""
    return merge_cache_enabled()


def delta_applies(dirty_fraction: float) -> bool:
    """Whether a merge with this share of dirty partitions takes the delta
    path."""
    return 0.0 < dirty_fraction <= delta_dirty_cutoff()


def merge_tree_on(d: int) -> bool:
    """Whether the tree replaces the flat merge: d > 2 only (at d <= 2 the
    flat merge is the sweep, cheaper than any pairwise work)."""
    return d > 2 and merge_tree_enabled()


def merge_path(use_tree: bool, delta: bool) -> str:
    """The name of one merge launch's path (an exact hit is decided before
    any of these)."""
    if delta:
        return "tree_delta" if use_tree else "delta"
    return "tree" if use_tree else "flat"

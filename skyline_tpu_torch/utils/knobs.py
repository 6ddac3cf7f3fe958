"""Environment knobs of the port.

The port's own copy of the JAX package's knob parsing
(``skyline_tpu/analysis/registry.py`` ``parse_bool``/``env_bool``/``env_int``,
same truthy and falsy words) and the knobs the port reads. Knobs are read
lazily, when a flush or a merge runs, never at import.
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


def env_int(name: str, default=0):
    """The integer environment variable ``name``; an unparsable value warns
    once and gives ``default``."""
    v = os.environ.get(name)
    if v is None or v.strip() == "":
        return default
    try:
        return int(v)
    except ValueError:
        if name not in _warned:
            _warned.add(name)
            warnings.warn(
                f"ignoring {name}={v!r}: not an integer; using the default",
                stacklevel=2,
            )
        return default


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


def mixed_precision_enabled() -> bool:
    """``SKYLINE_MIXED_PRECISION`` asks for the bf16 margin passes of the
    flush kernels. Off by default on every device in the port; the passes
    are exact either way, so off changes no answer. The flush refuses the
    knob when it is on, since the passes are not ported yet (ROADMAP.md,
    queue 1: the ``mp`` bf16 passes)."""
    return env_bool("SKYLINE_MIXED_PRECISION", False)


def refuse_mixed_precision(mp: bool | None = None) -> None:
    """Raise when the bf16 passes are asked for — by ``mp``, or when it is
    None by ``SKYLINE_MIXED_PRECISION`` — instead of ignoring the request."""
    asked = mixed_precision_enabled() if mp is None else mp
    if asked:
        raise NotImplementedError(
            "mixed precision (SKYLINE_MIXED_PRECISION=1 or mp=True): the bf16 "
            "margin passes are not ported yet (ROADMAP.md, queue 1: the mp bf16 "
            "passes); run with it off — the passes are exact, so off changes no "
            "answer"
        )

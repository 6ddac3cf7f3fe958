"""Environment knobs of the port.

The port's own copy of the JAX package's boolean knob parsing
(``skyline_tpu/analysis/registry.py`` ``parse_bool``/``env_bool``, same
truthy and falsy words) and the one knob the port reads. Knobs are read
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


def rank_cascade() -> bool:
    """``SKYLINE_RANK_CASCADE`` selects the dense-rank dominance cascade
    (K4–K7) for the device-ingest flush and the global merge. Off by
    default, as in the reference (``skyline_tpu/ops/dispatch.py``)."""
    return env_bool("SKYLINE_RANK_CASCADE", False)

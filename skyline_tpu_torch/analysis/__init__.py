"""The port's analysis gate: the knob registry's lint, the lock lint and
the graph audit of the flush hot ops.

The port's copy of ``skyline_tpu/analysis/``. The registry and its
accessors live in ``skyline_tpu_torch/utils/knobs.py`` (stdlib only: the
transport's processes read knobs without torch); the three passes are
``knob_lint``, ``graph_audit`` and ``lock_lint``, run together by
``python -m skyline_tpu_torch.analysis`` (``__main__.py``).

Only the registry is re-exported here: importing this package imports
neither torch nor jax (``graph_audit`` imports torch inside ``run``).
"""

from skyline_tpu_torch.utils.knobs import (  # noqa: F401
    KNOBS,
    Knob,
    env_bool,
    env_float,
    env_int,
    env_str,
    knob,
    knob_doc_markdown,
    knob_names,
    parse_bool,
)

__all__ = [
    "KNOBS",
    "Knob",
    "env_bool",
    "env_float",
    "env_int",
    "env_str",
    "knob",
    "knob_doc_markdown",
    "knob_names",
    "parse_bool",
]

"""Pass 1 — knob lint: every environment read goes through the registry.

The port's copy of ``skyline_tpu/analysis/knob_lint.py``, with the same
rules, markers and skipped directories, over the port's tree
(``skyline_tpu_torch/`` and ``chip_smoke.py``; tests excluded). The registry
is ``skyline_tpu_torch/utils/knobs.py``:

- ``raw-env-read`` (error): ``os.environ.get`` / ``os.environ[...]`` /
  ``os.getenv`` / ``"X" in os.environ`` / ``os.environ.setdefault``
  anywhere outside the registry. Writes (``os.environ[k] = v``, ``.pop``,
  ``del``) and whole-mapping passthrough (``dict(os.environ)``,
  ``.items()`` / ``.keys()`` / ``.values()`` / ``.copy()``, or passing
  ``os.environ`` itself along) stay legal.
- ``undeclared-knob`` (error): an accessor call (``env_str`` / ``env_bool``
  / ``env_int`` / ``env_float``) naming a knob the registry does not
  declare.
- ``dynamic-knob-name`` (error): an accessor called with a non-literal
  name — the accessor refuses an undeclared name at runtime, but the
  dead-knob analysis cannot see through it.
- ``dead-knob`` (error): a declared, non-external knob no accessor call in
  the tree reads.
- ``bool-compare`` (error): an environment or accessor string compared
  against a truthiness literal (``env_str(...) != "0"``); use ``env_bool``.
- ``raw-applicability`` (error): a call of one of the dispatch gate
  helpers (``merge_tree_enabled``, ``rank_cascade``, ...) outside
  ``ops/cascade.py`` (the dispatch table) and ``utils/knobs.py`` (where the
  port defines them). Engines resolve through ``cascade.gate`` /
  ``applies`` / ``merge_*`` so tuner overrides and pins apply everywhere.

Suppression: a line containing ``# lint: allow-raw-env`` is exempt from
``raw-env-read`` / ``dynamic-knob-name``; a line containing
``# lint: allow-raw-gate`` is exempt from ``raw-applicability``.
"""

from __future__ import annotations

import ast
import os

from skyline_tpu_torch.analysis.findings import Finding
from skyline_tpu_torch.utils.knobs import ACCESSORS, _BY_NAME

SUPPRESS = "# lint: allow-raw-env"
SUPPRESS_GATE = "# lint: allow-raw-gate"

# dispatch gate helpers whose calls must stay inside the cascade table
# (ops/cascade.py) or their defining module (utils/knobs.py). Anything else
# resolving applicability from these raw gates bypasses the table's tuner
# overrides and pins and forks the dispatch decision.
GATE_HELPERS = frozenset((
    "merge_cache_enabled", "merge_tree_enabled", "merge_prune_enabled",
    "chip_prune_enabled", "host_prune_enabled", "flush_prefilter_enabled",
    "sorted_sfs_mode", "device_cascade_mode", "delta_dirty_cutoff",
    "rank_cascade",
))

# modules allowed to call the gate helpers directly: the table itself and
# the module that defines them
_TABLE_SUFFIXES = (
    os.path.join("ops", "cascade.py"),
    os.path.join("utils", "knobs.py"),
)

# os.environ methods that only read single values (flagged) vs. passthrough
# or write methods (allowed)
_READ_METHODS = frozenset(("get", "setdefault", "__getitem__"))
_ALLOWED_METHODS = frozenset(("items", "keys", "values", "copy", "pop", "update"))

# string literals whose comparison against an env value implies ad-hoc
# truthiness parsing
_TRUTHINESS_LITERALS = frozenset(
    ("0", "1", "true", "false", "yes", "no", "on", "off")
)

# default directories/files skipped inside lint roots
SKIP_DIRS = frozenset(
    ("tests", "__pycache__", ".git", ".jax_cache", "artifacts",
     "bench_out_cpu", "bench_out_tpu", "docs", "node_modules")
)

# the one module allowed to touch os.environ for knob reads
_REGISTRY_SUFFIX = os.path.join("utils", "knobs.py")
REGISTRY_FILE = "skyline_tpu_torch/utils/knobs.py"


def _is_os_environ(node: ast.AST) -> bool:
    """``os.environ`` or a bare ``environ`` imported from os."""
    if isinstance(node, ast.Attribute) and node.attr == "environ":
        return isinstance(node.value, ast.Name) and node.value.id == "os"
    return isinstance(node, ast.Name) and node.id == "environ"


def _is_env_read_call(node: ast.Call) -> str | None:
    """'raw' for flagged env reads, None otherwise."""
    f = node.func
    if isinstance(f, ast.Attribute):
        if _is_os_environ(f.value) and f.attr in _READ_METHODS:
            return "raw"
        if (
            isinstance(f.value, ast.Name)
            and f.value.id == "os"
            and f.attr == "getenv"
        ):
            return "raw"
    return None


def _accessor_name(node: ast.Call) -> str | None:
    f = node.func
    if isinstance(f, ast.Name) and f.id in ACCESSORS:
        return f.id
    if isinstance(f, ast.Attribute) and f.attr in ACCESSORS:
        return f.attr
    return None


def _gate_helper_name(node: ast.Call) -> str | None:
    """The called dispatch-gate helper's name, or None. Matches both the
    bare import (``merge_tree_enabled()``) and the attribute form
    (``dispatch.merge_tree_enabled()``)."""
    f = node.func
    if isinstance(f, ast.Name) and f.id in GATE_HELPERS:
        return f.id
    if isinstance(f, ast.Attribute) and f.attr in GATE_HELPERS:
        return f.attr
    return None


class _FileLint(ast.NodeVisitor):
    def __init__(self, path: str, rel: str, source: str, is_registry: bool,
                 is_table: bool = False):
        self.rel = rel
        self.lines = source.splitlines()
        self.is_registry = is_registry
        self.is_table = is_table
        self.findings: list[Finding] = []
        self.reads: set[str] = set()  # knob names read via accessor

    def _suppressed(self, node: ast.AST, marker: str = SUPPRESS) -> bool:
        for ln in range(node.lineno, getattr(node, "end_lineno", node.lineno) + 1):
            if ln - 1 < len(self.lines) and marker in self.lines[ln - 1]:
                return True
        return False

    def _flag(self, node: ast.AST, rule: str, message: str, severity="error"):
        self.findings.append(
            Finding(self.rel, node.lineno, severity, rule, message)
        )

    # -- raw reads ---------------------------------------------------------

    def visit_Subscript(self, node: ast.Subscript):
        if (
            _is_os_environ(node.value)
            and isinstance(node.ctx, ast.Load)
            and not self.is_registry
            and not self._suppressed(node)
        ):
            self._flag(
                node, "raw-env-read",
                "os.environ[...] read outside the registry accessor "
                "(use skyline_tpu_torch.utils.knobs.env_*)",
            )
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare):
        # "X" in os.environ — presence probe is still a read
        if (
            any(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops)
            and any(_is_os_environ(c) for c in node.comparators)
            and not self.is_registry
            and not self._suppressed(node)
        ):
            self._flag(
                node, "raw-env-read",
                "`in os.environ` presence check outside the registry "
                "accessor (use env_* with default=None)",
            )
        self._check_bool_compare(node)
        self.generic_visit(node)

    def _check_bool_compare(self, node: ast.Compare):
        if not any(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
            return
        operands = [node.left, *node.comparators]
        calls = [
            n for n in operands
            if isinstance(n, ast.Call)
            and (_is_env_read_call(n) or _accessor_name(n) == "env_str")
        ]
        lits = [
            n.value for n in operands
            if isinstance(n, ast.Constant)
            and isinstance(n.value, str)
            and n.value.strip().lower() in _TRUTHINESS_LITERALS
        ]
        if calls and lits and not self.is_registry:
            self._flag(
                node, "bool-compare",
                f"ad-hoc truthiness comparison against {lits[0]!r} — "
                "use env_bool so '0'/'false'/unset parse identically",
            )

    def visit_Call(self, node: ast.Call):
        if (
            _is_env_read_call(node)
            and not self.is_registry
            and not self._suppressed(node)
        ):
            self._flag(
                node, "raw-env-read",
                "os.environ read outside the registry accessor "
                "(use skyline_tpu_torch.utils.knobs.env_*)",
            )
        gate = _gate_helper_name(node)
        if (
            gate is not None
            and not self.is_table
            and not self._suppressed(node, SUPPRESS_GATE)
        ):
            self._flag(
                node, "raw-applicability",
                f"{gate}() called outside the cascade table — resolve "
                "through skyline_tpu_torch.ops.cascade (gate/applies/merge_*/"
                "resolve_*) so tuner overrides and pins apply",
            )
        acc = _accessor_name(node)
        if acc is not None:
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str
            ):
                name = node.args[0].value
                self.reads.add(name)
                if name not in _BY_NAME:
                    self._flag(
                        node, "undeclared-knob",
                        f"{acc}({name!r}) reads a knob the registry does "
                        "not declare — add it to utils/knobs.py KNOBS",
                    )
            elif not self._suppressed(node):
                self._flag(
                    node, "dynamic-knob-name",
                    f"{acc}(...) with a non-literal knob name defeats the "
                    "dead-knob analysis — pass the full name as a string "
                    "literal",
                )
        self.generic_visit(node)


def iter_python_files(roots, skip_dirs=SKIP_DIRS):
    for root in roots:
        if os.path.isfile(root):
            yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d not in skip_dirs]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def lint_paths(roots, base: str | None = None):
    """Run the knob lint over ``roots`` (files or directories).

    Returns ``(findings, reads)`` where ``reads`` is the set of knob names
    seen at accessor call sites (the dead-knob input)."""
    findings: list[Finding] = []
    reads: set[str] = set()
    base = base or os.getcwd()
    for path in iter_python_files(roots):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError) as e:
            findings.append(
                Finding(os.path.relpath(path, base), 1, "error",
                        "parse-error", f"could not parse: {e}")
            )
            continue
        rel = os.path.relpath(path, base)
        apath = os.path.abspath(path)
        is_registry = apath.endswith(_REGISTRY_SUFFIX)
        is_table = any(apath.endswith(sfx) for sfx in _TABLE_SUFFIXES)
        lint = _FileLint(path, rel, source, is_registry, is_table=is_table)
        lint.visit(tree)
        findings.extend(lint.findings)
        reads |= lint.reads
    return findings, reads


def dead_knobs(reads: set[str]) -> list[Finding]:
    out = []
    for name, k in _BY_NAME.items():
        if not k.external and name not in reads:
            out.append(
                Finding(REGISTRY_FILE, 1, "error",
                        "dead-knob",
                        f"{name} is declared but no accessor call in the "
                        "tree reads it — delete the declaration or the "
                        "knob is silently inert")
            )
    return out


def run(roots, base: str | None = None) -> list[Finding]:
    """The full pass 1: per-file lint plus the global dead-knob check."""
    findings, reads = lint_paths(roots, base)
    findings.extend(dead_knobs(reads))
    return findings

"""Pass 3 — lock-discipline lint for shared mutable state.

The port's copy of ``skyline_tpu/analysis/lock_lint.py``, same grammar and
rules. An instance attribute assigned in ``__init__`` (or annotated at
class level) may carry a trailing ``# guarded-by: <lock expr>`` comment::

    self._ring = deque(maxlen=cap)  # guarded-by: self._lock

Every *mutation* of that attribute in every other method of the class —
rebinding, augmented assignment, item assignment, ``del``, or a call of a
known mutating method (``append``, ``popleft``, ``update``, ...) — must be
lexically inside a ``with <lock expr>:`` block, else it is reported
(rule ``unguarded-mutation``, error). Reads are not checked: the serving
plane reads frozen snapshots without a lock and writes under one.

Scope (lexical):

- Nested functions and lambdas defined inside a ``with`` block do NOT
  inherit the held lock: their bodies run when they are called.
- ``__init__`` is exempt: the object is not shared while it is built.
- A line containing ``# unguarded-ok`` (with a reason) suppresses the rule
  for a deliberate lock-free mutation.
- Locks match textually on the normalized expression (``ast.unparse``);
  holding a *different* lock does not count.
"""

from __future__ import annotations

import ast
import os
import re

from skyline_tpu_torch.analysis.findings import Finding
from skyline_tpu_torch.analysis.knob_lint import SKIP_DIRS, iter_python_files

GUARD_RE = re.compile(r"#\s*guarded-by:\s*([^#]+?)\s*(?:#.*)?$")
SUPPRESS_RE = re.compile(r"#\s*unguarded-ok\b")

# method names that mutate their receiver (list/deque/dict/set/OrderedDict
# and numpy's in-place flag setter)
MUTATING_METHODS = frozenset((
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "update", "add", "discard",
    "setdefault", "move_to_end", "sort", "reverse", "rotate", "setflags",
    "fill", "resize",
))


def _normalize_expr(expr: str) -> str:
    try:
        return ast.unparse(ast.parse(expr.strip(), mode="eval"))
    except SyntaxError:
        return expr.strip()


def _self_attr(node: ast.AST) -> str | None:
    """'x' when ``node`` is ``self.x``; None otherwise."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _collect_guards(cls: ast.ClassDef, lines: list[str]) -> dict[str, str]:
    """{attr: normalized lock expr} from guarded-by comments in the class."""
    guards: dict[str, str] = {}

    def note(attr: str | None, node: ast.AST):
        if attr is None:
            return
        end = getattr(node, "end_lineno", node.lineno)
        for ln in range(node.lineno, end + 1):
            if ln - 1 >= len(lines):
                break
            m = GUARD_RE.search(lines[ln - 1])
            if m:
                guards[attr] = _normalize_expr(m.group(1))
                return

    for stmt in ast.walk(cls):
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                note(_self_attr(tgt), stmt)
        elif isinstance(stmt, ast.AnnAssign):
            note(_self_attr(stmt.target), stmt)
    return guards


class _MethodCheck(ast.NodeVisitor):
    """Walk one method body tracking the lexically-held ``with`` locks."""

    def __init__(self, rel, cls_name, guards, lines):
        self.rel = rel
        self.cls_name = cls_name
        self.guards = guards
        self.lines = lines
        self.held: list[str] = []
        self.findings: list[Finding] = []

    def _suppressed(self, node) -> bool:
        ln = node.lineno - 1
        return ln < len(self.lines) and bool(SUPPRESS_RE.search(self.lines[ln]))

    def _check(self, node: ast.AST, attr: str | None, verb: str):
        if attr is None or attr not in self.guards:
            return
        lock = self.guards[attr]
        if lock in self.held or self._suppressed(node):
            return
        self.findings.append(
            Finding(
                self.rel, node.lineno, "error", "unguarded-mutation",
                f"{self.cls_name}.{attr} is guarded-by {lock} but {verb} "
                f"here outside `with {lock}`",
            )
        )

    def _target_attr(self, tgt: ast.AST) -> str | None:
        """The guarded self-attribute a store target touches, if any:
        ``self.x``, ``self.x[i]``, ``self.x.y``."""
        if isinstance(tgt, ast.Subscript):
            return self._target_attr(tgt.value)
        if isinstance(tgt, ast.Starred):
            return self._target_attr(tgt.value)
        return _self_attr(tgt)

    def visit_With(self, node: ast.With):
        self._visit_with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith):
        self._visit_with(node)

    def _visit_with(self, node):
        exprs = [ast.unparse(item.context_expr) for item in node.items]
        self.held.extend(exprs)
        for child in node.body:
            self.visit(child)
        del self.held[-len(exprs):]
        # with-item expressions themselves (lock acquisition) need no check

    def _visit_nested(self, node):
        # a nested function does not inherit the definition site's locks
        saved, self.held = self.held, []
        self.generic_visit(node)
        self.held = saved

    def visit_FunctionDef(self, node):
        self._visit_nested(node)

    def visit_AsyncFunctionDef(self, node):
        self._visit_nested(node)

    def visit_Lambda(self, node):
        self._visit_nested(node)

    def visit_Assign(self, node: ast.Assign):
        for tgt in node.targets:
            for t in ast.walk(tgt) if isinstance(tgt, ast.Tuple) else (tgt,):
                self._check(node, self._target_attr(t), "assigned")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._check(node, self._target_attr(node.target), "updated")
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._check(node, self._target_attr(node.target), "assigned")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete):
        for tgt in node.targets:
            self._check(node, self._target_attr(tgt), "deleted")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in MUTATING_METHODS:
            self._check(node, _self_attr(f.value), f"mutated (.{f.attr})")
        self.generic_visit(node)


def lint_file(path: str, rel: str) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rel, 1, "error", "parse-error", f"could not parse: {e}")]
    lines = source.splitlines()
    findings: list[Finding] = []
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        guards = _collect_guards(cls, lines)
        if not guards:
            continue
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if item.name in ("__init__", "__new__"):
                continue  # not shared until construction completes
            checker = _MethodCheck(rel, cls.name, guards, lines)
            for stmt in item.body:
                checker.visit(stmt)
            findings.extend(checker.findings)
    return findings


def run(roots, base: str | None = None) -> list[Finding]:
    base = base or os.getcwd()
    findings: list[Finding] = []
    for path in iter_python_files(roots, SKIP_DIRS):
        findings.extend(lint_file(path, os.path.relpath(path, base)))
    return findings

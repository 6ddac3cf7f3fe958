"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: every module under ``skybench/``
parsed, each import's top-level name compared whole."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "skyline_tpu"}
# the plain reference and what decides `correct` beside it
INDEPENDENT = ("reference.py", "check.py", "work.py", "data.py")


def top_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", INDEPENDENT)
def test_reference_imports_nothing_of_the_program(name):
    assert top_imports(PKG / name) <= {"__future__", "collections", "hashlib", "numpy", "torch"}


def test_names_compared_whole():
    # the port's name begins with the JAX package's: a prefix test would
    # refuse it, the whole top-level name does not
    assert "skyline_tpu_torch" not in FORBIDDEN
    assert top_imports(PKG / "harness.py") >= {"skybench"}

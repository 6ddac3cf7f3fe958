"""The port's analysis gate against the JAX package's.

``skyline_tpu_torch.analysis`` (the knob lint, the lock lint, the graph
audit and the command line) and the registry in
``skyline_tpu_torch/utils/knobs.py``, held against ``skyline_tpu.analysis``:

1. The port's tree is clean: both lints find nothing, the graph audit runs
   the reference's 22 configurations (the same labels) on the CPU with no
   finding, and ``docs/KNOBS_TORCH.md`` is the registry's table.
2. The seeded violations of ``tests/test_analysis.py`` give the same
   ``(line, severity, rule)`` findings from both packages' lints, and each
   graph-audit rule fires on a fixture made for it.
3. The registry: the reference's fields and parser, and every accessor
   refusing an undeclared name.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from skyline_tpu.analysis import knob_lint as ref_knob_lint
from skyline_tpu.analysis import lock_lint as ref_lock_lint
from skyline_tpu.analysis import registry as ref_registry
from skyline_tpu_torch.analysis import graph_audit, knob_lint, lock_lint
from skyline_tpu_torch.analysis.__main__ import default_roots, main, repo_root
from skyline_tpu_torch.utils import knobs
from skyline_tpu_torch.utils.knobs import KNOBS, knob, knob_doc_markdown

REPO = repo_root()


# -- layer 1: the port's tree is clean ---------------------------------------------


def test_default_roots_are_the_port():
    assert [os.path.relpath(r, REPO) for r in default_roots(REPO)] == [
        "skyline_tpu_torch", "chip_smoke.py"]


def test_knob_lint_clean_on_port_tree():
    findings = knob_lint.run(default_roots(REPO), REPO)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_lock_lint_clean_on_port_tree():
    findings = lock_lint.run(default_roots(REPO), REPO)
    assert findings == [], "\n".join(f.format() for f in findings)


@pytest.mark.parametrize("rel, cls_name, attr", [
    ("skyline_tpu_torch/serve/snapshot.py", "SnapshotStore", "_latest"),
    ("skyline_tpu_torch/serve/deltas.py", "DeltaRing", "_ring"),
    ("skyline_tpu_torch/telemetry/histogram.py", "Histogram", "_counts"),
    ("skyline_tpu_torch/telemetry/spans.py", "SpanRecorder", "_ring"),
    ("skyline_tpu_torch/metrics/collector.py", "Counters", "_counts"),
])
def test_lock_lint_guards_collected_like_reference(rel, cls_name, attr):
    """Zero findings means the mutations are locked, not that no annotation
    was read: both lints collect the same guard map from the port's class."""
    import ast

    src = open(os.path.join(REPO, rel), encoding="utf-8").read()
    cls = next(n for n in ast.walk(ast.parse(src))
               if isinstance(n, ast.ClassDef) and n.name == cls_name)
    guards = lock_lint._collect_guards(cls, src.splitlines())
    assert attr in guards
    assert guards == ref_lock_lint._collect_guards(cls, src.splitlines())


def test_port_guard_annotations_counted():
    """The lock lint reads the port's trailing ``# guarded-by:`` comments
    (52 of them; freshness.py's one on a line of its own is prose)."""
    n = 0
    for path in knob_lint.iter_python_files([os.path.join(REPO, "skyline_tpu_torch")]):
        if os.sep + "analysis" + os.sep in path:
            continue
        n += sum(bool(lock_lint.GUARD_RE.search(line)) for line in open(path, encoding="utf-8"))
    assert n >= 52


def _reference_labels():
    """The reference's 22 configuration labels, in order, read from
    ``jaxpr_audit.run`` with its tracing stubbed out."""
    from skyline_tpu.analysis import jaxpr_audit

    labels = []
    orig = (jaxpr_audit._trace_twice, jaxpr_audit._cache_stability)
    jaxpr_audit._trace_twice = lambda fn, args, label, expect_bf16=None: labels.append(
        (label, expect_bf16)) or []
    jaxpr_audit._cache_stability = lambda jitted, mk, label: labels.append((label, None)) or []
    try:
        _, summary = jaxpr_audit.run()
    finally:
        jaxpr_audit._trace_twice, jaxpr_audit._cache_stability = orig
    return labels, summary


def test_graph_audit_clean_on_cpu_with_the_reference_matrix():
    findings, summary = graph_audit.run(device="cpu")
    assert findings == [], "\n".join(f.format() for f in findings)
    ref_labels, ref_summary = _reference_labels()
    assert summary["configs"] == ref_summary["configs_traced"] == 22
    assert summary["labels"] == ref_labels
    assert summary["dims"] == [2, 4, 8] and summary["device"] == "cpu"
    assert summary["launches"] == {}  # plain versions on the CPU


def test_graph_audit_refuses_unknown_device_and_missing_card(monkeypatch):
    with pytest.raises(ValueError):
        graph_audit.run(device="tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph_audit.run(device="cuda")


def test_cli_on_cpu(capsys):
    assert main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "graph: 22 configurations on cpu, dims [2, 4, 8]; kernels launched: none" in out
    assert out[-1] == ("analysis: knobs: 0 finding(s), graph: 0 finding(s), locks: 0 "
                       "finding(s) — 0 error(s), 0 warning(s)")


def test_cli_lints_and_usage(capsys):
    assert main(["--pass", "knobs,locks"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == (
        "analysis: knobs: 0 finding(s), locks: 0 finding(s) — 0 error(s), 0 warning(s)")
    assert main(["--pass", "knobs,bogus"]) == 2
    assert main(["--pass", "graph", "--dims", "x"]) == 2


def test_knob_doc_is_current(tmp_path, capsys):
    doc = knob_doc_markdown()
    for k in KNOBS:
        assert f"`{k.name}`" in doc, k.name
    with open(os.path.join(REPO, "docs", "KNOBS_TORCH.md"), encoding="utf-8") as f:
        assert f.read() == doc, "regenerate with python -m skyline_tpu_torch.analysis --knob-doc"
    assert main(["--check-doc"]) == 0
    # a drifted or missing table exits 2
    (tmp_path / "docs").mkdir()
    assert main(["--root", str(tmp_path), "--check-doc"]) == 2
    (tmp_path / "docs" / "KNOBS_TORCH.md").write_text(doc + "drift\n")
    assert main(["--root", str(tmp_path), "--check-doc"]) == 2
    assert main(["--root", str(tmp_path), "--knob-doc"]) == 0
    assert main(["--root", str(tmp_path), "--check-doc"]) == 0


def test_import_boundary():
    """``skyline_tpu_torch.analysis`` imports neither torch nor jax; the
    port's new modules import no jax and nothing of the JAX package; the
    package does not import the plots."""
    code = textwrap.dedent("""\
        import sys
        import skyline_tpu_torch.analysis
        assert "torch" not in sys.modules and "jax" not in sys.modules
        import skyline_tpu_torch, skyline_tpu_torch.telemetry.sentinel
        import skyline_tpu_torch.utils.backend_probe, skyline_tpu_torch.analysis.graph_audit
        import skyline_tpu_torch.analysis.knob_lint, skyline_tpu_torch.analysis.lock_lint
        assert not any(m == "skyline_tpu_torch.plots" or m.startswith(("matplotlib", "pandas"))
                       for m in sys.modules)
        try:
            import matplotlib, pandas
        except ImportError:
            pass
        else:
            import skyline_tpu_torch.plots.skyline_2d, skyline_tpu_torch.plots.performance
            import skyline_tpu_torch.plots.by_dimension, skyline_tpu_torch.plots.paper_figures
        bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "skyline_tpu."))
               or m == "skyline_tpu"]
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# -- layer 2: seeded violations, both packages' lints ---------------------------------

# the fixtures of tests/test_analysis.py, with knob names both registries declare
KNOB_FIXTURES = {
    "raw_env_read": """\
        import os

        def f():
            a = os.environ.get("SKYLINE_MERGE_CACHE", "1")
            b = os.environ["SKYLINE_MERGE_TREE"]
            c = os.getenv("SKYLINE_STAGE_DEPTH")
            d = "SKYLINE_MERGE_PRUNE" in os.environ
            return a, b, c, d
        """,
    "raw_env_write_and_passthrough": """\
        import os

        def f():
            os.environ["SKYLINE_MERGE_CACHE"] = "0"
            os.environ.pop("SKYLINE_MERGE_CACHE", None)
            env = dict(os.environ)
            for k, v in os.environ.items():
                env[k] = v
            return env
        """,
    "suppression": """\
        import os

        def snapshot(keys):
            return {k: os.environ.get(k) for k in keys}  # lint: allow-raw-env
        """,
    "undeclared_knob": """\
        from skyline_tpu_torch.utils.knobs import env_bool

        def f():
            return env_bool("SKYLINE_TOTALLY_UNDECLARED", False)
        """,
    "dynamic_knob_name": """\
        from skyline_tpu_torch.utils.knobs import env_int

        def f(name):
            return env_int(f"SKYLINE_{name}", 0)
        """,
    "bool_compare": """\
        import os

        from skyline_tpu_torch.utils.knobs import env_str

        def f():
            return env_str("SKYLINE_ALGO", "") != "0"

        def g():
            return os.environ.get("SKYLINE_MERGE_CACHE") == "true"
        """,
    "non_truthiness_compare": """\
        from skyline_tpu_torch.utils.knobs import env_str

        def f():
            return env_str("SKYLINE_INGEST", "") == "device"
        """,
    "raw_gate": """\
        from skyline_tpu_torch.utils.knobs import merge_tree_enabled, rank_cascade

        def f():
            return merge_tree_enabled() and rank_cascade()

        def g():
            return rank_cascade()  # lint: allow-raw-gate
        """,
}

# the rules each fixture must fire at (line, rule), the reference's expectations
KNOB_EXPECTED = {
    "raw_env_read": {(4, "raw-env-read"), (5, "raw-env-read"), (6, "raw-env-read"),
                     (7, "raw-env-read")},
    "raw_env_write_and_passthrough": set(),
    "suppression": set(),
    "undeclared_knob": {(4, "undeclared-knob")},
    "dynamic_knob_name": {(4, "dynamic-knob-name")},
    "bool_compare": {(6, "bool-compare"), (9, "bool-compare"), (9, "raw-env-read")},
    "non_truthiness_compare": set(),
    "raw_gate": {(4, "raw-applicability")},
}


def _lint(module, tmp_path, source):
    p = tmp_path / "fixture.py"
    p.write_text(textwrap.dedent(source))
    findings, reads = module.lint_paths([str(p)], str(tmp_path))
    assert all(f.file == "fixture.py" for f in findings)
    return sorted((f.line, f.severity, f.rule) for f in findings), reads


@pytest.mark.parametrize("case", sorted(KNOB_FIXTURES))
def test_knob_lint_fixture_matches_reference(case, tmp_path):
    got, reads = _lint(knob_lint, tmp_path, KNOB_FIXTURES[case])
    want, ref_reads = _lint(ref_knob_lint, tmp_path, KNOB_FIXTURES[case])
    assert got == want
    assert reads == ref_reads
    assert {(line, rule) for line, _, rule in got} == KNOB_EXPECTED[case]
    assert all(sev == "error" for _, sev, _ in got)


def test_dead_knob_matches_reference():
    all_names = {k.name for k in KNOBS}
    victim = "SKYLINE_MERGE_PRUNE"
    hits = knob_lint.dead_knobs(all_names - {victim})
    ref_hits = ref_knob_lint.dead_knobs(set(ref_registry.knob_names()) - {victim})
    assert [(f.rule, f.severity) for f in hits] == [(f.rule, f.severity) for f in ref_hits]
    assert victim in hits[0].message and hits[0].file == "skyline_tpu_torch/utils/knobs.py"
    assert knob_lint.dead_knobs(all_names) == []


def test_lint_constants_match_reference():
    assert knob_lint.SKIP_DIRS == ref_knob_lint.SKIP_DIRS
    assert knob_lint.GATE_HELPERS == ref_knob_lint.GATE_HELPERS
    assert (knob_lint.SUPPRESS, knob_lint.SUPPRESS_GATE) == (
        ref_knob_lint.SUPPRESS, ref_knob_lint.SUPPRESS_GATE)
    assert knob_lint._TABLE_SUFFIXES == (os.path.join("ops", "cascade.py"),
                                         os.path.join("utils", "knobs.py"))
    assert lock_lint.MUTATING_METHODS == ref_lock_lint.MUTATING_METHODS
    assert knobs.ACCESSORS == ref_registry.ACCESSORS


LOCK_FIXTURES = {
    "unguarded_mutation": """\
        import threading


        class Store:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []  # guarded-by: self._lock
                self.version = 0  # guarded-by: self._lock

            def good(self, x):
                with self._lock:
                    self._items.append(x)
                    self.version += 1

            def bad_call(self, x):
                self._items.append(x)

            def bad_assign(self):
                self.version = 7

            def wrong_lock(self, other, x):
                with other:
                    self._items.append(x)

            def suppressed(self):
                self.version += 1  # unguarded-ok: single-writer int bump
        """,
    "nested_function": """\
        import threading


        class Store:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []  # guarded-by: self._lock

            def leaky(self):
                with self._lock:
                    def later():
                        self._items.append(1)
                    return later
        """,
    "deletes_and_items": """\
        import threading


        class Ring:
            def __init__(self):
                self._lock = threading.Lock()
                self._slots = {}  # guarded-by: self._lock

            def put(self, k, v):
                self._slots[k] = v

            def drop(self, k):
                with self._lock:
                    del self._slots[k]
                del self._slots[k]
                lam = lambda: self._slots.clear()
                return lam
        """,
}

LOCK_EXPECTED = {"unguarded_mutation": [16, 19, 23], "nested_function": [12],
                 "deletes_and_items": [10, 15, 16]}


@pytest.mark.parametrize("case", sorted(LOCK_FIXTURES))
def test_lock_lint_fixture_matches_reference(case, tmp_path):
    p = tmp_path / "locky.py"
    p.write_text(textwrap.dedent(LOCK_FIXTURES[case]))
    got = lock_lint.lint_file(str(p), "locky.py")
    want = ref_lock_lint.lint_file(str(p), "locky.py")
    assert [(f.line, f.severity, f.rule, f.message) for f in got] == [
        (f.line, f.severity, f.rule, f.message) for f in want]
    assert sorted(f.line for f in got) == LOCK_EXPECTED[case]


# -- layer 2: each graph-audit rule fires on its fixture -----------------------------


def _rows_args(n=64, d=4):
    def make(second):
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.uniform(0, 1, (n, d)).astype(np.float32))
        valid = torch.arange(n) < (n // 2 if second else n - 3)
        return x, valid
    return make


def _audit(fn, expect_bf16=None, label="fixture", make=None):
    audit = graph_audit._Audit("cpu")
    audit.config(label, fn, make or _rows_args(), expect_bf16=expect_bf16)
    assert audit.configs == 1
    return [(f.severity, f.rule, f.message) for f in audit.findings]


def test_graph_clean_fixture_is_silent():
    assert _audit(lambda x, v: torch.where(v[:, None], x * 2.0, float("inf")),
                  expect_bf16=False) == []


def test_graph_f64_fires():
    hits = _audit(lambda x, v: x * torch.full((), 2.0, dtype=torch.float64))
    assert [(s, r) for s, r, _ in hits] == [("error", "graph-f64")]
    assert "float64" in hits[0][2]


@pytest.mark.parametrize("fn, op", [
    (lambda x, v: x * x.sum().item(), "_local_scalar_dense"),
    (lambda x, v: torch.nonzero(v), "nonzero"),
    (lambda x, v: torch.masked_select(x[:, 0], v), "masked_select"),
    (lambda x, v: x[v], "index"),
    (lambda x, v: torch.unique(x[:, 0].round()), "_unique2"),
])
def test_graph_host_sync_fires(fn, op):
    hits = _audit(fn)
    syncs = [m for s, r, m in hits if r == "graph-host-sync"]
    assert len(syncs) == 1 and f"aten.{op} " in syncs[0], hits
    assert all(s == "error" for s, _, _ in hits)


def test_graph_dynamic_shape_fires():
    hits = _audit(lambda x, v: x[v])
    assert "graph-dynamic-shape" in {r for _, r, _ in hits}
    # a data-dependent value of a static shape is not a dynamic shape
    assert _audit(lambda x, v: v.sum()) == []


def test_graph_bf16_gate_fires_both_ways():
    mixed = lambda x, v: x.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    exact = lambda x, v: x + 1.0  # noqa: E731
    assert [r for _, r, m in _audit(mixed, expect_bf16=False)] == ["graph-bf16-gate"]
    assert "leaked" in _audit(mixed, expect_bf16=False)[0][2]
    assert [r for _, r, m in _audit(exact, expect_bf16=True)] == ["graph-bf16-gate"]
    assert _audit(mixed, expect_bf16=True) == [] and _audit(exact, expect_bf16=False) == []


def test_graph_retrace_fires_on_an_env_read(monkeypatch):
    """A knob read inside the op that changes between two runs on the same
    input changes the op sequence."""
    monkeypatch.delenv("SKYLINE_MERGE_TREE", raising=False)

    def flips(x, v):
        on = knobs.merge_tree_enabled() and "SKYLINE_MERGE_TREE" not in os.environ
        os.environ["SKYLINE_MERGE_TREE"] = "1"
        return x + 1.0 if on else (x * 2.0).abs()

    hits = _audit(flips)
    assert [r for _, r, _ in hits] == ["graph-retrace-unstable"]


def test_graph_retrace_fires_on_a_kernel_build(monkeypatch):
    from skyline_tpu_torch.utils import compile_cache

    calls = []

    def builds(x, v):
        calls.append(1)
        if len(calls) == 2:
            compile_cache.note_build(False)
        return x + 1.0

    hits = _audit(builds)
    assert [r for _, r, m in hits] == ["graph-retrace-unstable"] and "build" in hits[0][2]


def test_graph_known_findings_warn_and_are_logged():
    """No port fault is excused any more: a host read — a copy off the
    device, ``aten._to_copy``, the read the device cascade's core made to
    plan its launches — in either configuration that runs the core is an
    error, as it is in every other configuration, and the audit keeps no
    table of known findings."""
    assert not hasattr(graph_audit, "KNOWN")

    def reads(x, v):
        # a copy to another device: what the card sees as a read to the host
        return x.to("meta"), v

    labels = ("device_cascade_core d=8 n=256 mp=1",
              "skyline_mask_auto[device_cascade=on] d=8 n=256", "device_cascade_core")
    for label in labels:
        hits = _audit(reads, label=label)
        assert hits == [("error", "graph-host-sync", hits[0][2])], hits
        assert hits[0][2].startswith(f"[{label}] aten._to_copy reads a device value")


# set_sync_debug_mode as the card would see it: a stand-in op that raises
# CUDA's sync error under "error", as a synchronizing call does there
_SYNC_MODE = ["default"]


@torch.library.custom_op("skyline_audit_fixture::syncs", mutates_args=())
def _syncs(x: torch.Tensor) -> torch.Tensor:
    if _SYNC_MODE[0] == "error":
        raise RuntimeError(graph_audit.SYNC_ERROR)
    return x.clone()


def _outside(x, v):
    raise RuntimeError(graph_audit.SYNC_ERROR)


@pytest.mark.parametrize("fn, reads, want", [
    # a synchronizing op the aten rule does not see
    (lambda x, v: _syncs(x) + 1.0, {}, [("error", "aten.syncs", "1 call")]),
    # a known read first, then one more sync of the same op: the run goes on
    # past the first and the second is found
    (lambda x, v: _syncs(_syncs(x)), {"syncs": 1}, [("error", "aten.syncs", "1 call")]),
    (lambda x, v: _syncs(_syncs(x)), {"syncs": 2}, []),
    (lambda x, v: x * 2.0, {}, []),
    (_outside, {}, [("error", "outside any aten op", "")]),
])
def test_graph_sync_debug_sees_every_sync(fn, reads, want, monkeypatch):
    """The card's run under ``set_sync_debug_mode("error")``: each aten op
    that raises is marked and run again with the mode off, so a sync after a
    known host read is still found; an op's syncs beyond its host reads,
    or a sync outside any aten op, are errors."""
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda mode: _SYNC_MODE.__setitem__(0, mode))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    audit = graph_audit._Audit("cpu")
    audit._sync_debug("fixture", fn, _rows_args()(False), reads)
    assert _SYNC_MODE[0] == "default"
    got = [(f.severity, f.rule, f.message) for f in audit.findings]
    assert [(s, r) for s, r, _ in got] == [("error", "graph-host-sync")] * len(want)
    for (_, _, message), (_, what, calls) in zip(got, want):
        assert what in message and calls in message


def test_graph_sync_debug_passes_other_errors(monkeypatch):
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda mode: _SYNC_MODE.__setitem__(0, mode))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def fails(x, v):
        raise RuntimeError("not a sync")

    with pytest.raises(RuntimeError, match="not a sync"):
        graph_audit._Audit("cpu")._sync_debug("fixture", fails, _rows_args()(False), {})
    assert _SYNC_MODE[0] == "default"


def test_graph_host_copy_rule_reads_devices():
    """A copy between the host and a card is a host read; a copy on one
    device is not (what the card run sees, checked on signatures)."""
    cpu = torch.zeros(4)
    meta = torch.zeros(4, device="meta")
    assert graph_audit._host_read("_to_copy", (meta,), [meta], [cpu])
    assert not graph_audit._host_read("_to_copy", (cpu,), [cpu], [cpu])
    idx = torch.tensor([0, 1])
    assert not graph_audit._host_read("index", (cpu, [idx]), [cpu, idx], [cpu])
    assert graph_audit._host_read("index", (cpu, [idx > 0]), [cpu, idx > 0], [cpu])


# -- layer 3: the registry -----------------------------------------------------------


@pytest.mark.parametrize("accessor", ["env_str", "env_bool", "env_int", "env_float",
                                      "is_set"])
def test_undeclared_knob_raises_in_every_accessor(accessor, monkeypatch):
    monkeypatch.setenv("SKYLINE_NO_SUCH_KNOB", "1")
    with pytest.raises(LookupError):
        getattr(knobs, accessor)("SKYLINE_NO_SUCH_KNOB")
    if accessor != "is_set":
        with pytest.raises(LookupError):
            getattr(ref_registry, accessor)("SKYLINE_NO_SUCH_KNOB")


def test_knob_lookup_matches_reference():
    with pytest.raises(LookupError):
        knob("SKYLINE_NO_SUCH_KNOB")
    assert knobs.knob_names() == tuple(k.name for k in KNOBS)
    assert set(knobs.knob_names()) <= set(ref_registry.knob_names())


@pytest.mark.parametrize("name", [k.name for k in KNOBS])
def test_knob_declaration_matches_reference(name):
    """Type, choices, the JobConfig field and the external flag are the
    reference's (the default is held in tests/test_torch_audit.py)."""
    k, r = knob(name), ref_registry.knob(name)
    assert (k.type, k.choices, k.job_field, k.external, k.runbook) == (
        r.type, r.choices, r.job_field, r.external, r.runbook)
    assert k.description and k.applies_to


def test_registry_defaults_match_port_jobconfig():
    from skyline_tpu_torch.utils.config import JobConfig

    cfg = JobConfig()
    flagged = [k for k in KNOBS if k.job_field]
    assert len(flagged) >= 30
    for k in flagged:
        assert getattr(cfg, k.job_field) == k.default, k.name


def test_knob_validation_matches_reference():
    for bad in (dict(type="list"), dict(type="enum")):
        args = dict(name="SKYLINE_X", type="int", default=0, description="d", applies_to="a")
        args.update(bad)
        with pytest.raises(ValueError):
            knobs.Knob(**args)
        with pytest.raises(ValueError):
            ref_registry.Knob(**args)


@pytest.mark.parametrize("raw", [None, "", "  ", "0", "false", "no", "off", "1", "TRUE",
                                 " On ", "banana"])
@pytest.mark.parametrize("default", [True, False, None])
def test_parse_bool_matches_reference(raw, default):
    assert knobs.parse_bool(raw, default) == ref_registry.parse_bool(raw, default)


@pytest.mark.parametrize("name, raw, default", [
    ("SKYLINE_STAGE_DEPTH", "not-an-int", 1),
    ("SKYLINE_STAGE_DEPTH", " 3 ", 1),
    ("SKYLINE_DELTA_CUTOFF", "nope", 0.75),
    ("SKYLINE_DELTA_CUTOFF", "0.5", 0.75),
    ("SKYLINE_MERGE_TREE", "maybe", True),
    ("SKYLINE_ALGO", "", "mr-angle"),
])
def test_accessors_match_reference(name, raw, default, monkeypatch):
    import warnings

    monkeypatch.setenv(name, raw)
    monkeypatch.setattr(knobs, "_warned", set())
    monkeypatch.setattr(ref_registry, "_warned", set())
    acc = {bool: "env_bool", int: "env_int", float: "env_float", str: "env_str"}[type(default)]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = getattr(knobs, acc)(name, default)
    with warnings.catch_warnings(record=True) as rw:
        warnings.simplefilter("always")
        want = getattr(ref_registry, acc)(name, default)
    assert (type(got), got) == (type(want), want)
    assert len(w) == len(rw)


def test_is_set(monkeypatch):
    monkeypatch.delenv("SKYLINE_PROBE_TIMEOUT_S", raising=False)
    assert not knobs.is_set("SKYLINE_PROBE_TIMEOUT_S")
    monkeypatch.setenv("SKYLINE_PROBE_TIMEOUT_S", " ")
    assert not knobs.is_set("SKYLINE_PROBE_TIMEOUT_S")
    monkeypatch.setenv("SKYLINE_PROBE_TIMEOUT_S", "9")
    assert knobs.is_set("SKYLINE_PROBE_TIMEOUT_S")

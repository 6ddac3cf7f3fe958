"""The port's backend probe against the JAX package's.

``skyline_tpu_torch.utils.backend_probe`` and ``skyline_tpu.utils.
backend_probe`` side by side with the child process stubbed: the same
verdict fields and provenance from the process cache and the
successes-only file cache (the checks of ``tests/test_utils.py``'s
``test_backend_probe_file_cache``), the same retries, timeouts and
failures, and the same timeout precedence. One case runs the real child:
on this machine it sees no card.
"""

import json
import os
import subprocess

import pytest

from skyline_tpu.utils import backend_probe as ref
from skyline_tpu_torch.utils import backend_probe as bp

MODULES = {"port": bp, "ref": ref}
VERDICTS = {
    "port": {"backend": "cuda", "n_devices": 1, "name": "NVIDIA H100 80GB HBM3",
             "capability": [9, 0]},
    "ref": {"backend": "tpu", "n_devices": 1},
}


@pytest.fixture
def isolated(monkeypatch, tmp_path):
    """Each module's caches reset and its file cache under tmp_path."""
    for name, mod in MODULES.items():
        monkeypatch.setattr(mod, "_VERDICT", None)
        path = str(tmp_path / f"{name}_cache.json")
        monkeypatch.setattr(mod, "_cache_path", lambda path=path: path)
    monkeypatch.setenv("SKYLINE_PROBE_CACHE_TTL_S", "3600")
    return tmp_path


class _Child:
    """A stand-in for ``subprocess.run``: replies from ``script`` in turn
    (a verdict dict, ``"timeout"``, ``"crash"`` or ``"garbage"``)."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = []

    def __call__(self, argv, **kw):
        self.calls.append((argv, kw))
        step = self.script.pop(0)
        if step == "timeout":
            raise subprocess.TimeoutExpired(argv, kw["timeout"])
        if step == "crash":
            return subprocess.CompletedProcess(argv, 1, "", "boom")
        if step == "garbage":
            return subprocess.CompletedProcess(argv, 0, "not json\n", "")
        return subprocess.CompletedProcess(argv, 0, "noise\n" + json.dumps(step) + "\n", "")


def _stub(monkeypatch, name, script):
    child = _Child(script)
    monkeypatch.setattr(MODULES[name].subprocess, "run", child)
    monkeypatch.setattr(MODULES[name].time, "sleep", lambda s: None)
    return child


@pytest.mark.parametrize("name", sorted(MODULES))
def test_file_cache_like_reference(name, isolated, monkeypatch):
    mod = MODULES[name]
    good = {**VERDICTS[name], "attempts": 1, "errors": [], "probe_s": 1.2,
            "probe_total_s": 1.3}
    child = _stub(monkeypatch, name, [])
    mod._store_file_verdict(good)
    # a fresh process: served from the file, no child
    v = mod.probe_backend(0.001)
    assert v["cached"] and v["cache_source"] == "file"
    assert v["probe_total_s"] == 0.0 and v["probe_total_s_probed"] == 1.3
    assert v["backend"] == VERDICTS[name]["backend"] and "cache_age_s" in v
    # the same process again: the process cache
    v2 = mod.probe_backend(0.001)
    assert v2["cache_source"] == "process" and v2["probe_total_s_probed"] == 1.3
    assert child.calls == []
    # a failure is never kept
    path = mod._cache_path()
    os.remove(path)
    mod._store_file_verdict({"backend": None, "n_devices": 0})
    assert not os.path.exists(path)
    # an expired entry is ignored
    mod._store_file_verdict(good)
    with open(path) as f:
        rec = json.load(f)
    rec["ts"] -= 10_000_000
    with open(path, "w") as f:
        json.dump(rec, f)
    assert mod._load_file_verdict() is None
    # TTL 0 disables keeping and reading
    monkeypatch.setenv("SKYLINE_PROBE_CACHE_TTL_S", "0")
    os.remove(path)
    mod._store_file_verdict(good)
    assert not os.path.exists(path)


def _shape(v: dict) -> dict:
    """The verdict without the wall clock and the backend's own fields."""
    return {k: v[k] for k in ("attempts", "n_devices", "cached") if k in v} | {
        "backend_set": v["backend"] is not None, "errors": len(v["errors"]),
        "has_probe_s": "probe_s" in v, "kept": v.get("cache_source")}


@pytest.mark.parametrize("script", [
    ["ok"],
    ["timeout", "ok"],
    ["crash", "garbage", "ok"],
    ["timeout", "timeout", "timeout"],
    ["crash", "crash", "garbage"],
], ids=lambda s: "-".join(s))
def test_retries_and_failures_like_reference(script, isolated, monkeypatch):
    got = {}
    for name, mod in MODULES.items():
        child = _stub(monkeypatch, name,
                      [VERDICTS[name] if s == "ok" else s for s in script])
        v = mod.probe_backend(7.0, attempts=3, backoff_s=0.5)
        got[name] = (_shape(v), len(child.calls), os.path.exists(mod._cache_path()))
        assert all(kw["timeout"] == 7.0 for _, kw in child.calls)
        if v["backend"] is None:
            assert any("timed out" in e or "rc=1" in e or "unparseable" in e
                       for e in v["errors"])
            # a failed verdict is served again in-process, never from the file
            again = mod.probe_backend(7.0)
            assert again["cache_source"] == "process" and again["backend"] is None
    assert got["port"] == got["ref"]


def test_verdict_fields(isolated, monkeypatch):
    _stub(monkeypatch, "port", [VERDICTS["port"]])
    v = bp.probe_backend(5.0, use_cache=False)
    assert v["backend"] == "cuda" and v["n_devices"] == 1
    assert v["name"] == "NVIDIA H100 80GB HBM3" and v["capability"] == [9, 0]


@pytest.mark.parametrize("env", [
    {}, {"SKYLINE_PROBE_TIMEOUT_S": "30"}, {"BENCH_PROBE_TIMEOUT": "45"},
    {"SKYLINE_PROBE_TIMEOUT_S": "30", "BENCH_PROBE_TIMEOUT": "45"},
    {"SKYLINE_PROBE_TIMEOUT_S": "", "BENCH_PROBE_TIMEOUT": "45"},
])
def test_timeout_precedence_like_reference(env, monkeypatch):
    for k in ("SKYLINE_PROBE_TIMEOUT_S", "BENCH_PROBE_TIMEOUT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert bp.probe_timeout_s() == ref.probe_timeout_s()
    assert bp.probe_timeout_s(99.0) == ref.probe_timeout_s(99.0)


def test_real_child_sees_no_card_here(isolated):
    """The child imports torch and reports what it sees; this machine has
    no card, so the verdict is cpu — a diagnosis, nothing falls back on
    it."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the verdict would be cuda")
    v = bp.probe_backend(120.0, use_cache=False)
    assert v["backend"] == "cpu" and v["n_devices"] == 1
    assert v["name"] is None and v["capability"] is None and v["errors"] == []

"""The port's perf-trajectory sentinel against the JAX package's.

The synthetic trajectories of ``tests/test_sentinel.py`` in a tmp dir, read
by ``skyline_tpu_torch.telemetry.sentinel`` and ``skyline_tpu.telemetry.
sentinel``: the same exit codes and the same report lines, on stdout and on
stderr.
"""

import json

import pytest

from skyline_tpu.telemetry import sentinel as ref
from skyline_tpu_torch.telemetry import sentinel


def _bench(path, r, value, backend="tpu", extra=None):
    doc = {"parsed": {"value": value, "backend": backend,
                      "p50_window_latency_ms": 1_000_000.0 / value}}
    if extra:
        doc["parsed"].update(extra)
    (path / f"BENCH_r{r:02d}.json").write_text(json.dumps(doc))


def _multichip(path, r, ok=True, skipped=False):
    (path / f"MULTICHIP_r{r:02d}.json").write_text(
        json.dumps({"n_devices": 4, "rc": 0 if ok else 1, "ok": ok,
                    "skipped": skipped, "tail": ""})
    )


def healthy(p):
    for r, v in enumerate([100.0, 110.0, 105.0, 112.0], start=1):
        _bench(p, r, v)
    _multichip(p, 1)
    return [], 0


def slow_drift(p):
    for r, v in enumerate([100.0, 98.0, 101.0, 99.0, 60.0], start=1):
        _bench(p, r, v)
    return ["--threshold", "0.3"], 1


def absolute_rule(p):
    _bench(p, 1, 100.0)
    _bench(p, 2, 101.0, extra={"audit": {"divergence_total": 1}})
    return [], 1


def backend_mismatch(p):
    for r, v in enumerate([5000.0, 5100.0, 5050.0], start=1):
        _bench(p, r, v, backend="tpu")
    _bench(p, 4, 80.0, backend="cpu-fallback")
    return [], 0


def unhealthy_multichip(p):
    _bench(p, 1, 100.0)
    _bench(p, 2, 101.0)
    _multichip(p, 1, ok=True)
    _multichip(p, 2, ok=False)
    return [], 1


def unreadable_round(p):
    (p / "BENCH_r01.json").write_text("{not json")
    (p / "BENCH_r02.json").write_text(json.dumps({"no_parsed": 1}))
    for r, v in enumerate([100.0, 102.0], start=3):
        _bench(p, r, v)
    return [], 0


def empty_dir(p):
    return [], 0


def per_rule_threshold(p):
    # serve_load.read_p99_ms carries its own threshold (2.0): +150% passes
    for r, v in enumerate([10.0, 11.0, 9.0], start=1):
        _bench(p, r, 100.0, extra={"serve_load": {"read_p99_ms": v},
                                   "merge_cache": {"hit_rate": 0.0}})
    _bench(p, 4, 100.0, extra={"serve_load": {"read_p99_ms": 25.0},
                               "merge_cache": {"hit_rate": 0.5}})
    return ["--window", "2"], 0


def rules_file(p):
    for r, v in enumerate([100.0, 101.0, 150.0], start=1):
        _bench(p, r, v, extra={"custom": {"x": v}})
    (p / "rules.json").write_text(json.dumps(
        [{"label": "custom.x", "path": ["custom", "x"], "higher_is_better": False}]))
    return ["--rules", str(p / "rules.json")], 1


def bad_rules_file(p):
    _bench(p, 1, 100.0)
    (p / "rules.json").write_text(json.dumps({"label": "not a list"}))
    return ["--rules", str(p / "rules.json")], 2


def usage_error(p):
    _bench(p, 1, 100.0)
    return ["--window", "0"], 2


def env_knobs(p, monkeypatch):
    for r, v in enumerate([100.0, 98.0, 101.0, 99.0, 80.0], start=1):
        _bench(p, r, v)
    # a 20% drop passes the default 30% and trips a 10% threshold from the env
    monkeypatch.setenv("SKYLINE_SENTINEL_THRESHOLD", "0.1")
    monkeypatch.setenv("SKYLINE_SENTINEL_WINDOW", "2")
    return [], 1


CASES = [healthy, slow_drift, absolute_rule, backend_mismatch, unhealthy_multichip,
         unreadable_round, empty_dir, per_rule_threshold, rules_file, bad_rules_file,
         usage_error, env_knobs]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_same_exit_and_report_as_reference(case, tmp_path, capsys, monkeypatch):
    args, want = (case(tmp_path, monkeypatch) if case is env_knobs else case(tmp_path))
    argv = ["--dir", str(tmp_path), *args]
    rc = sentinel.main(argv)
    out, err = capsys.readouterr()
    ref_rc = ref.main(argv)
    ref_out, ref_err = capsys.readouterr()
    assert rc == ref_rc == want
    assert out.splitlines() == ref_out.splitlines()
    # the bad-rules message names the parser's error; the rest is the same
    if case is bad_rules_file:
        assert err.startswith("sentinel: bad --rules file: ") and ref_err.startswith(
            "sentinel: bad --rules file: ")
    else:
        assert err.splitlines() == ref_err.splitlines()
    if want == 1:
        assert "REGRESSION" in out


def test_default_rules_are_the_references():
    assert sentinel.DEFAULT_RULES == ref.DEFAULT_RULES

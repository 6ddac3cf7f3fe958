"""A configuration, a traffic mix and a metric reader added as files in a
copy of the benchmark are found by name, with no edit to its code."""

import json
import shutil
import time
from pathlib import Path

from skybench import harness

REPO = Path(__file__).resolve().parent.parent.parent
TINY = {"window_rows": 3000, "chunk_rows": 1024, "pool_windows": 1}


def copy_benchmark(tmp: Path) -> Path:
    shutil.copytree(REPO / "skybench", tmp / "skybench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


def test_dotted_metric_falls_back_to_its_stem():
    assert harness.reader("flush_ms.bulk").__code__.co_filename.endswith("metrics/flush_ms.py")
    assert harness.reader("merge_ms.bulk").__code__.co_filename.endswith("metrics/merge_ms.py")


def test_cells_are_listed_from_benchmark_json():
    names = harness.cell_names()
    assert names == [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
    for n in names:
        cell = harness.load_cell(n)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "tuples_per_s"}
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]))


def test_added_files_are_found(tmp_path):
    root = copy_benchmark(tmp_path)
    conf = json.loads((root / "skybench/configs/anti3d_mrangle.json").read_text())
    conf["engine"]["dims"] = 4
    conf["name"] = "anti4d_mrgrid"
    conf["engine"]["algo"] = "mr-grid"
    (root / "skybench/configs/anti4d_mrgrid.json").write_text(json.dumps(conf))
    (root / "skybench/traffic/twice.json").write_text(json.dumps(
        {"window_rows": 3000, "chunk_rows": 1024, "trigger_every_chunks": 2,
         "pool_windows": 1, "check_windows": 1, "trace_windows": 1}))
    (root / "skybench/metrics/triggers_per_window.py").write_text(
        "def read(run):\n    return len(run.flush_ms) / run.windows if run.windows else None\n")
    # a program span read by its name, with no edit to the harness
    (root / "skybench/metrics/ingest_spans_per_window.py").write_text(
        "def read(run):\n    n = len(run.spans.get('ingest', []))\n"
        "    return n / run.windows if n and run.windows else None\n")
    # and a program counter
    (root / "skybench/metrics/answers_counted_per_window.py").write_text(
        "def read(run):\n    n = run.counters.get('queries.answered', 0)\n"
        "    return n / run.windows if n and run.windows else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "anti4d_mrgrid", "source": "test",
                             "file": "skybench/configs/anti4d_mrgrid.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "anti4d_mrgrid.twice", "config": "anti4d_mrgrid",
                               "traffic": "twice", "chips": 1, "why": "test"})
    for metric, source in (("triggers_per_window", "host_clock"),
                           ("ingest_spans_per_window", "program_span"),
                           ("answers_counted_per_window", "program_counter"),
                           ("flush_ms.twice", "program_span")):
        bench["per_layer"].append({"name": metric, "unit": "1", "better": "lower",
                                   "source": source, "layer": "test",
                                   "moves": "tuples_per_s", "workloads": ["anti4d_mrgrid.twice"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    assert "anti4d_mrgrid.twice" in harness.cell_names(root)
    cell = harness.load_cell("anti4d_mrgrid.twice", root)
    assert cell.config["engine"]["dims"] == 4 and cell.traffic["trigger_every_chunks"] == 2
    assert [m["name"] for m in cell.per_layer][-4:] == [
        "triggers_per_window", "ingest_spans_per_window", "answers_counted_per_window",
        "flush_ms.twice"]
    out = harness.run_cell("anti4d_mrgrid.twice", 5, 0.01, True, t_start=time.perf_counter(),
                           device="cpu", root=root, log=lambda *_: None)
    assert out["correct"], out["checks"]
    # 3 chunks: triggers after chunks 2 and 3
    assert out["metrics"]["triggers_per_window"]["value"] == 2
    # one ingest span a process_records call: 3 chunks a window
    assert out["metrics"]["ingest_spans_per_window"]["value"] == 3
    assert out["metrics"]["answers_counted_per_window"]["value"] == 2
    # no file of its own: metrics/flush_ms.py reads it
    assert out["metrics"]["flush_ms.twice"]["value"] > 0
    assert out["attempted"] == 2 * 2  # the measured window and the traced one


def test_alone_without_the_program(tmp_path):
    """A checkout of BENCHMARK.json and skybench/ only: no result, and an
    exit code other than 0."""
    import subprocess
    import sys

    root = copy_benchmark(tmp_path)
    code = ("import sys; from skybench import run; sys.exit(run.main(["
            "'--workload', 'indep8d_mrdim.bulk', '--seed', '1', '--seconds', '1'], "
            f"require_card=False, device='cpu', overrides={TINY!r}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert "skyline_tpu_torch" in p.stderr
    assert '"correct"' not in p.stdout

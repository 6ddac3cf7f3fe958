"""The port's launcher (``skyline_tpu_torch/deploy/launch.py``) on the CPU
against the reference's (``deploy/launch.py``).

- Both launchers' ``--demo --cpu`` runs on the same flags, each with its
  own free bootstrap port, ``--stats-port 0`` and its own log directory, at
  d = 3 and 20,000 rows, tumbling and with ``--window 10000 --slide
  5000``: both exit 0 and their result rows are equal with the timing
  columns (``*(ms)``) and ``TraceID`` aside.
- The two launchers' flags and defaults are equal; ``--window`` without
  ``--slide`` errors.
- A worker that cannot start makes the port's launcher exit 1 naming
  ``worker.log``; without ``--cpu`` on a machine with no card the worker
  fails and nothing runs on the CPU.
- ``import skyline_tpu_torch.deploy`` (and every module under it, the
  drills' port namespaces built) in a fresh interpreter loads no ``jax``
  and nothing of ``skyline_tpu``; the launcher alone loads no ``torch``.

Tolerance: exact rows (strings) outside the timing columns.
"""

import argparse
import csv
import importlib.util
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from skyline_tpu_torch.deploy import launch as tlaunch
from test_torch_wire import _whole_reference_native  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _reference_parser() -> argparse.ArgumentParser:
    """The parser ``deploy/launch.py``'s ``main`` builds, caught at its
    ``parse_args``."""
    spec = importlib.util.spec_from_file_location("reference_launch", REPO / "deploy" / "launch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Caught(Exception):
        pass

    def catch(self, *a, **kw):
        raise Caught(self)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        mod.main([])
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("the reference launcher built no parser")


def _flags(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, getattr(a, "choices", None))
            for a in parser._actions if a.dest != "help"}


def test_launchers_take_the_same_flags_and_defaults():
    assert _flags(tlaunch.build_parser()) == _flags(_reference_parser())


def test_window_without_slide_errors(capsys):
    for argv in (["--window", "10000"], ["--slide", "5000"]):
        with pytest.raises(SystemExit) as ex:
            tlaunch.main(argv)
        assert ex.value.code == 2
        assert "--window and --slide must be given together" in capsys.readouterr().err


def _run(cmd, tmp: Path, extra, env_extra=None, timeout=240):
    """One launcher run: (exit code, stderr, result rows or None)."""
    out = tmp / "results.csv"
    argv = [*cmd, "--bootstrap", f"127.0.0.1:{_free_port()}", "--stats-port", "0",
            "--log-dir", str(tmp / "logs"), "--out-csv", str(out), *extra]
    env = dict(os.environ, **(env_extra or {}))
    r = subprocess.run([sys.executable, *argv], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    rows = None
    if out.exists():
        with open(out, newline="") as f:
            rows = list(csv.reader(f))
    return r.returncode, r.stderr, rows


def _untimed(rows):
    header = rows[0]
    keep = [i for i, h in enumerate(header) if not h.endswith("(ms)") and h != "TraceID"]
    return [[row[i] for i in keep] for row in rows]


@pytest.mark.parametrize("window", [[], ["--window", "10000", "--slide", "5000"]],
                         ids=["tumbling", "sliding"])
def test_demo_rows_match_the_reference(tmp_path, window):
    flags = ["--demo", "--cpu", "--dims", "3", "--demo-records", "20000", *window]
    rc, err, port_rows = _run(["-m", "skyline_tpu_torch.deploy.launch"], tmp_path / "port",
                              flags)
    assert rc == 0, err
    assert "[launch] demo OK" in err
    rc, err, ref_rows = _run([str(REPO / "deploy" / "launch.py")], tmp_path / "jax", flags,
                             {"JAX_PLATFORMS": "cpu"})
    assert rc == 0, err
    assert len(port_rows) == len(ref_rows) == 2
    assert _untimed(port_rows) == _untimed(ref_rows)
    assert int(port_rows[1][2]) > 0  # SkylineSize
    # the worker ran on the CPU as asked, its banner says so
    banner = (tmp_path / "port" / "logs" / "worker.log").read_text()
    assert "skyline worker:" in banner and "device=cpu" in banner


def test_a_worker_that_cannot_start_fails_the_launcher(tmp_path):
    rc, err, rows = _run(["-m", "skyline_tpu_torch.deploy.launch"], tmp_path,
                         ["--demo", "--cpu", "--algo", "no-such-algo"], timeout=120)
    assert rc == 1
    assert "[launch] FAILED: worker exited" in err and "worker.log" in err
    assert rows is None


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="needs a machine with no card")
def test_without_cpu_and_no_card_the_worker_fails_and_nothing_runs_on_the_cpu(tmp_path):
    rc, err, rows = _run(["-m", "skyline_tpu_torch.deploy.launch"], tmp_path,
                         ["--demo", "--dims", "3", "--demo-records", "2000"], timeout=120)
    assert rc == 1
    assert "worker exited rc=1" in err and f"{tmp_path / 'logs'}/worker.log" in err
    log = (tmp_path / "logs" / "worker.log").read_text()
    assert "CUDA is not available" in log
    assert "skyline worker:" not in log  # no banner: it never ran anywhere
    assert rows is None
    assert not (tmp_path / "logs" / "producer.log").exists()


def test_deploy_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        "importlib.import_module('skyline_tpu_torch.deploy.launch')\n"
        "print('torch' in sys.modules)\n"
        "for m in ('skyline_tpu_torch.deploy', 'skyline_tpu_torch.deploy.drills',\n"
        "          'skyline_tpu_torch.deploy.drills.__main__'):\n"
        "    importlib.import_module(m)\n"
        "for d in ('serve', 'chaos', 'mesh', 'obs'):\n"
        "    importlib.import_module('skyline_tpu_torch.deploy.drills.' + d).port_ns('cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'skyline_tpu' or m.startswith('skyline_tpu.'))\n"
        "print(len(bad), bad[:5])\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["False", "0 []"]

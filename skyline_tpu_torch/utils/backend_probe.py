"""Child-process probe of the torch backend.

The port's copy of ``skyline_tpu/utils/backend_probe.py``: the same
signature (timeout, attempts, backoff), the same process cache and the same
successes-only file cache with its TTL knob. The child imports torch and
reports what it sees: ``backend`` is ``"cuda"`` when a card is visible,
``"cpu"`` when none is, and None when every attempt failed or timed out (a
hung driver, a torch that does not import). Probing in a child bounds a
hang in device initialisation; retries with backoff give a flaky one a
second chance.

A diagnosis, never a fallback: no entry point of the port reads the
verdict to choose its device. Entry points run on the device their caller
names, and a CUDA device without a card raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

_PROBE_SRC = (
    "import json, torch; c = torch.cuda.is_available(); "
    "n = torch.cuda.device_count() if c else 0; "
    "print(json.dumps({'backend': 'cuda' if c else 'cpu', "
    "'n_devices': n if c else 1, "
    "'name': torch.cuda.get_device_name(0) if n else None, "
    "'capability': list(torch.cuda.get_device_capability(0)) if n else None}))"
)

# Process-lifetime verdict cache: the backend a probe reports cannot change
# within one process, so repeat callers reuse the first verdict instead of
# paying the child (and, on a hung driver, the full timeout) again.
# ``cached: True`` marks reuse.
_VERDICT: dict | None = None

# Cross-process verdict cache: a successful verdict is kept under
# skyline_tpu_torch/_build/ and reused until ``SKYLINE_PROBE_CACHE_TTL_S``
# (seconds, default 3600; 0 disables the file cache) expires. Only
# SUCCESSFUL probes are kept — a failure must not outlive the process that
# saw it, or a recovered driver would stay invisible for the whole TTL.
_CACHE_FILE = "backend_probe_cache.json"


def _cache_path() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here, "..", "_build", _CACHE_FILE)


def probe_cache_ttl_s() -> float:
    from skyline_tpu_torch.utils.knobs import env_float

    return env_float("SKYLINE_PROBE_CACHE_TTL_S", 3600.0)


def _load_file_verdict() -> dict | None:
    """A fresh-enough kept verdict, or None. Never raises."""
    ttl = probe_cache_ttl_s()
    if ttl <= 0:
        return None
    try:
        with open(_cache_path()) as f:
            rec = json.load(f)
        age = time.time() - float(rec["ts"])
        verdict = rec["verdict"]
        if age < 0 or age >= ttl or verdict.get("backend") is None:
            return None
        verdict["cache_age_s"] = round(age, 1)
        return verdict
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return None


def _store_file_verdict(diag: dict) -> None:
    """Keep a successful verdict (atomic rename). Never raises."""
    if probe_cache_ttl_s() <= 0 or diag.get("backend") is None:
        return
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"ts": time.time(), "verdict": diag}, f)
        os.replace(tmp, path)
    except OSError:
        pass


def probe_timeout_s(default: float = 150.0) -> float:
    """The probe timeout: ``SKYLINE_PROBE_TIMEOUT_S`` wins, then the legacy
    ``BENCH_PROBE_TIMEOUT``, then ``default``."""
    from skyline_tpu_torch.utils.knobs import env_float, is_set

    if is_set("SKYLINE_PROBE_TIMEOUT_S"):
        return env_float("SKYLINE_PROBE_TIMEOUT_S", 150.0)
    if is_set("BENCH_PROBE_TIMEOUT"):
        return env_float("BENCH_PROBE_TIMEOUT", 150.0)
    return default


def probe_backend(
    timeout_s: float,
    attempts: int = 1,
    backoff_s: float = 0.0,
    use_cache: bool = True,
) -> dict:
    """Returns ``{"backend": str|None, "n_devices": int, "name": str|None,
    "capability": [major, minor]|None, "attempts": int, "errors": [str],
    "probe_s": float, "probe_total_s": float}``; ``backend`` is None if
    every attempt failed or timed out.

    ``probe_total_s`` covers the whole call, failed attempts and backoff
    sleeps included (``probe_s``: the one successful attempt). The verdict
    is cached for the process's life and — successes only — kept under
    skyline_tpu_torch/_build/ for ``SKYLINE_PROBE_CACHE_TTL_S`` seconds so
    sibling processes skip the child too (``use_cache=False`` forces a
    fresh probe). A cache hit stamps provenance: ``probe_total_s`` becomes
    the (near-zero) time to serve it, the probed wall moves to
    ``probe_total_s_probed``, and ``cache_source`` says which cache hit.
    """
    global _VERDICT
    if use_cache and _VERDICT is not None:
        out = dict(_VERDICT)
        out["cached"] = True
        out["cache_source"] = "process"
        out["probe_total_s_probed"] = out.get("probe_total_s")
        out["probe_total_s"] = 0.0
        return out
    if use_cache:
        out = _load_file_verdict()
        if out is not None:
            _VERDICT = dict(out)  # before the stamp: keeps the probed wall
            out["cached"] = True
            out["cache_source"] = "file"
            out["probe_total_s_probed"] = out.get("probe_total_s")
            out["probe_total_s"] = 0.0
            return out
    wall0 = time.time()
    diag: dict = {"attempts": 0, "errors": [], "n_devices": 0}
    for i in range(attempts):
        diag["attempts"] = i + 1
        t0 = time.time()
        err = None
        try:
            r = subprocess.run(
                [sys.executable, "-c", _PROBE_SRC],
                capture_output=True,
                text=True,
                timeout=timeout_s,
                env=dict(os.environ),
            )
            if r.returncode == 0:
                try:
                    info = json.loads(r.stdout.strip().splitlines()[-1])
                    diag.update(info)
                    diag["probe_s"] = round(time.time() - t0, 1)
                    diag["probe_total_s"] = round(time.time() - wall0, 1)
                    _VERDICT = dict(diag)
                    _store_file_verdict(diag)
                    return diag
                except (ValueError, IndexError):
                    err = (
                        f"probe attempt {i + 1}: unparseable output "
                        f"{r.stdout[-200:]!r}"
                    )
            else:
                err = (
                    f"probe attempt {i + 1}: rc={r.returncode}: "
                    f"{(r.stderr or '')[-400:]}"
                )
        except subprocess.TimeoutExpired:
            err = (
                f"probe attempt {i + 1}: timed out after {timeout_s:.0f}s "
                "(device initialisation hang)"
            )
        except OSError as e:
            err = f"probe attempt {i + 1}: {e}"
        diag["errors"].append(err)
        if i + 1 < attempts:
            time.sleep(backoff_s)
    diag["backend"] = None
    diag["probe_total_s"] = round(time.time() - wall0, 1)
    _VERDICT = dict(diag)
    return diag

"""What the drills share: HTTP reads, polled waits, the progress line, the
environment scope and the reset of the port's process-global state.

Stdlib only; the port is imported inside the functions that need it.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
import urllib.error
import urllib.request

import numpy as np


def say(drill: str, msg: str) -> None:
    """The reference scripts' progress line, ``[<drill>-smoke] msg``."""
    print(f"[{drill}-smoke] {msg}", flush=True)


def http(url: str, data: bytes | None = None, headers: dict | None = None,
         method: str | None = None, timeout: float = 10.0):
    """(status, body bytes, headers) of one request; an HTTP error status is
    returned, not raised."""
    req = urllib.request.Request(url, data=data, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def wait_until(pred, timeout_s: float, what: str, every_s: float = 0.005):
    """Poll ``pred`` until it returns a true value (returned) or
    ``timeout_s`` passes (AssertionError naming ``what``)."""
    deadline = time.monotonic() + timeout_s
    while True:
        got = pred()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout_s} s")
        time.sleep(every_s)


def sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def points_sha256(pts) -> str:
    """sha256 of a point buffer's float32 bytes."""
    return sha256(np.ascontiguousarray(np.asarray(pts, dtype=np.float32)).tobytes())


@contextlib.contextmanager
def env_scope(**values):
    """Set the given environment variables (None unsets one) for the block;
    the whole environment is restored after it, so a leg's knobs do not
    reach the next, as each reference leg's fresh interpreter ensures."""
    saved = dict(os.environ)
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def reset_process_state() -> None:
    """The port's process-global registries back to a fresh interpreter's:
    no fault plan, no cascade pins or overrides, no registered mask
    profiler."""
    from skyline_tpu_torch.ops import cascade, dispatch
    from skyline_tpu_torch.resilience import faults

    faults.clear()
    cascade.clear_pins()
    for name in list(cascade.overrides_doc()):
        cascade.clear_override(name)
    dispatch._MASK_PROFILER = None


def port_job_args(device: str):
    """The port's ``parse_job_args`` with ``--device`` appended."""
    from skyline_tpu_torch.utils.config import parse_job_args

    return lambda argv: parse_job_args(list(argv) + ["--device", device])


def port_engine_config(device: str):
    import functools

    from skyline_tpu_torch.stream import EngineConfig

    return functools.partial(EngineConfig, device=device)

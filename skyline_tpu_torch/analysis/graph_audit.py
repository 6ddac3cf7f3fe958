"""Pass 2 — graph audit of the flush hot ops on eager torch.

The port's counterpart of ``skyline_tpu/analysis/jaxpr_audit.py``. The
reference traces its hot ops with ``jax.make_jaxpr`` and checks the closed
jaxprs; eager torch has no graph to trace, so this pass runs each op and
records every aten op it dispatches — name, input and output dtypes and
shapes — under a ``TorchDispatchMode``. The matrix is the reference's 22
configurations, labelled as the reference labels them: the backend-auto
mask (``ops/dispatch.py`` ``skyline_mask_auto``, at its merge-time call
site, the reference's traced call), the same with the host sorted cascade
and with the device cascade forced on, the device cascade's core
(``ops/device_cascade.py`` ``_cascade_core``), the SFS round
(``ops/sfs.py`` ``sfs_round_single``), the incremental merge step
(``stream/window.py`` ``merge_step_active``), the flush-tail summaries
(``partition_summaries_device``, ``grid_summary_device``) and three
cache-stability legs. Each configuration runs twice on one input and once
on a second input of the same shapes with other valid counts:

- ``graph-f64``: no float64 or complex128 anywhere.
- ``graph-host-sync``: no aten op reads a device value to the host —
  ``_local_scalar_dense`` (``.item()``), ``nonzero``, ``masked_select``,
  the ``unique`` family, indexing by a boolean mask, a copy between the
  host and the card. The reference runs each of these ops as one traced
  computation; a host read inside one stalls the pipeline. On the card
  each configuration also runs under
  ``torch.cuda.set_sync_debug_mode("error")``, every aten op that raises
  there marked and run again with the mode off so the run goes on past
  it: an op that synchronizes more often than this rule saw it read, or a
  synchronizing call outside any aten op, is a finding too. This rule
  stands in for the reference's ``jaxpr-host-callback``.
- ``graph-dynamic-shape``: the output shapes depend only on the input
  shapes (the second input gives the first input's output shapes).
- ``graph-bf16-gate``: bfloat16 appears iff the mixed-precision flag is on
  for the call. On the card the bf16 work is inside the kernels, so there
  a launch of a pre-drop entry (``mp_predrop_kernel``,
  ``strictly_dominated_bf16_kernel``, or ``cascade_scan_mp``, the device
  cascade's scan with its pre-drop) counts as bfloat16 too.
- ``graph-retrace-unstable``: the two runs on one input dispatch the same
  op sequence, and the second does not grow the kernel build count
  (``utils/compile_cache.py``).

Every finding is an error: the port has no known fault left to excuse (the
device cascade's core, which read its block summary to the host to plan
its launches, now runs on the device end to end). The audit takes an
explicit ``device``: ``cuda`` (the default) or ``cpu``. It never falls
back from one to the other.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

from skyline_tpu_torch.analysis.findings import Finding

HERE = "skyline_tpu_torch/analysis/graph_audit.py"
DEFAULT_DIMS = (2, 4, 8)
RULES = (
    "graph-bf16-gate", "graph-dynamic-shape", "graph-f64", "graph-host-sync",
    "graph-retrace-unstable",
)

# aten ops that read a device value to the host
HOST_SYNC_OPS = frozenset((
    "_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique",
    "_unique2", "unique_dim", "unique_consecutive", "unique_dim_consecutive",
))
_INDEX_OPS = frozenset(("index", "index_put", "index_put_", "_index_put_impl_"))
_COPY_OPS = frozenset(("_to_copy", "copy_", "_copy_from", "_copy_from_and_resize"))
PREDROP_ENTRIES = ("mp_predrop_kernel", "strictly_dominated_bf16_kernel", "cascade_scan_mp")


def _op_name(func) -> str:
    """``aten.nonzero.default`` -> ``nonzero``."""
    return func.__name__.split(".")[0] if hasattr(func, "__name__") else str(func)


def _tensors(obj):
    """Every tensor in a (nested) argument structure."""
    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _sig(ts) -> tuple:
    return tuple((str(t.dtype), tuple(t.shape), t.device.type) for t in ts)


def _host_read(name: str, args: tuple, ins: list, outs: list) -> bool:
    """Does this aten op read a device value to the host?"""
    import torch

    if name in HOST_SYNC_OPS:
        return True
    if name in _INDEX_OPS and len(args) > 1:
        # a boolean mask index: its true count sizes the output
        return any(t.dtype in (torch.bool, torch.uint8) for t in _tensors(args[1]))
    if name in _COPY_OPS:
        kinds = {t.device.type for t in ins + outs}
        return len(kinds) > 1  # between the host and a card
    return False


# what ``set_sync_debug_mode("error")`` raises at a synchronizing call
SYNC_ERROR = "called a synchronizing CUDA operation"


def _recorder(catch_sync: bool = False):
    """A ``TorchDispatchMode`` that keeps one ``(name, input signature,
    output signature, host read, synchronized)`` record per aten op. With
    ``catch_sync`` (under ``set_sync_debug_mode("error")``) an op that
    raises at a synchronizing call is marked, then run again with the mode
    at ``default``, so the run goes on and every such op is seen."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops: list[tuple] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            synced = False
            try:
                out = func(*args, **kwargs)
            except RuntimeError as e:
                if not catch_sync or SYNC_ERROR not in str(e):
                    raise
                synced = True
                torch.cuda.set_sync_debug_mode("default")
                try:
                    out = func(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode("error")
            name = _op_name(func)
            ins = list(_tensors((args, kwargs)))
            outs = list(_tensors(out))
            self.ops.append((name, _sig(ins), _sig(outs), _host_read(name, args, ins, outs),
                             synced))
            return out

    return _Recorder()


@contextlib.contextmanager
def _env(values: dict):
    """Set environment knobs for the duration of one configuration."""
    prev = {k: os.environ.get(k) for k in values}  # lint: allow-raw-env
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Audit:
    """The findings, counts and kernel launches of one audit run."""

    def __init__(self, device: str):
        self.device = device
        self.findings: list[Finding] = []
        self.configs = 0
        self.labels: list[tuple[str, bool | None]] = []
        self.launches: dict[str, int] = {}

    def flag(self, label: str, rule: str, message: str) -> None:
        """An error finding of ``rule`` for configuration ``label``."""
        self.findings.append(Finding(HERE, 1, "error", rule, f"[{label}] {message}"))

    def _count(self, before: dict) -> dict:
        """The kernel launches since ``before`` (a copy of ``LAUNCHES``),
        added to the run's totals."""
        from skyline_tpu_torch.ops.dominance_kernels import LAUNCHES

        launched = {k: v - before[k] for k, v in LAUNCHES.items() if v > before[k]}
        for k, v in launched.items():
            self.launches[k] = self.launches.get(k, 0) + v
        return launched

    def _run(self, fn, args):
        """One recorded run: (ops, outputs, kernel launches, build misses)."""
        from skyline_tpu_torch.ops.dominance_kernels import LAUNCHES
        from skyline_tpu_torch.utils.compile_cache import compile_cache_stats

        before = dict(LAUNCHES)
        rec = _recorder()
        with rec:
            out = fn(*args)
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()
        return rec.ops, out, self._count(before), compile_cache_stats()["misses"]

    def _sync_debug(self, label: str, fn, args, host_reads: dict) -> None:
        """On the card: run once under ``set_sync_debug_mode("error")``,
        each aten op that synchronizes marked and the run carried on past
        it (``_recorder``). An op that synchronizes more often than the aten
        rule saw it read to the host (``host_reads``: its calls by name, on
        the same input), or a synchronizing call outside any aten op, is its
        own finding."""
        import torch

        from skyline_tpu_torch.ops.dominance_kernels import LAUNCHES

        before = dict(LAUNCHES)
        rec = _recorder(catch_sync=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with rec:
                fn(*args)
            err = None
        except RuntimeError as e:
            if SYNC_ERROR not in str(e):
                raise
            err = str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        self._count(before)
        if err is not None:
            self.flag(label, "graph-host-sync",
                      f"a synchronizing CUDA call outside any aten op: {err}")
        synced = [name for name, _, _, _, hit in rec.ops if hit]
        for name in sorted(set(synced)):
            extra = synced.count(name) - host_reads.get(name, 0)
            if extra > 0:
                self.flag(label, "graph-host-sync",
                          f"aten.{name} synchronizes under set_sync_debug_mode('error') "
                          f"({extra} call(s)) where no host read shows")

    def config(self, label: str, fn, make_args, expect_bf16=None, env=None) -> None:
        """Audit one configuration: ``make_args(second)`` builds fresh
        inputs (``second``: the same shapes, other valid counts)."""
        self.configs += 1
        self.labels.append((label, expect_bf16))
        with _env(env or {}):
            ops1, out1, launched, miss1 = self._run(fn, make_args(False))
            ops2, _, _, miss2 = self._run(fn, make_args(False))
            _, out3, _, _ = self._run(fn, make_args(True))
            reads = [name for name, _, _, host, _ in ops1 if host]
            if self.device == "cuda":
                self._sync_debug(label, fn, make_args(False),
                                 {name: reads.count(name) for name in reads})
        dtypes = {dt for _, ins, outs, _, _ in ops1 for dt, _, _ in ins + outs}
        for dt in sorted(dtypes & {"torch.float64", "torch.complex128"}):
            op = next(name for name, ins, outs, _, _ in ops1
                      if dt in {x for x, _, _ in ins + outs})
            self.flag(label, "graph-f64",
                      f"{dt.removeprefix('torch.')} value in aten.{op} — the engine is "
                      "f32-only")
        for name in sorted(set(reads)):
            self.flag(label, "graph-host-sync",
                      f"aten.{name} reads a device value to the host ({reads.count(name)} "
                      "call(s))")
        shapes1 = [tuple(t.shape) for t in _tensors(out1)]
        shapes3 = [tuple(t.shape) for t in _tensors(out3)]
        if shapes1 != shapes3:
            self.flag(label, "graph-dynamic-shape",
                      f"output shapes {shapes3} on other valid counts, {shapes1} on the "
                      "first input — the shapes must follow the input shapes only")
        if expect_bf16 is not None:
            # on a card the bf16 pass is inside the pre-drop kernels
            saw = "torch.bfloat16" in dtypes or any(launched.get(k, 0) for k in PREDROP_ENTRIES)
            if expect_bf16 and not saw:
                self.flag(label, "graph-bf16-gate",
                          "mixed-precision call has no bf16 pass — the margin pre-drop "
                          "did not run")
            if saw and not expect_bf16:
                self.flag(label, "graph-bf16-gate", "bf16 leaked into an exact (mp=off) call")
        if [o[:3] for o in ops1] != [o[:3] for o in ops2]:
            first = next((i for i, (a, b) in enumerate(zip(ops1, ops2)) if a[:3] != b[:3]),
                         min(len(ops1), len(ops2)))
            self.flag(label, "graph-retrace-unstable",
                      f"a second run on the same input dispatched another op sequence "
                      f"({len(ops1)} vs {len(ops2)} ops, first difference at op {first})")
        if miss2 > miss1:
            self.flag(label, "graph-retrace-unstable",
                      f"a second run on the same input built a kernel ({miss1} -> {miss2} "
                      "builds)")


def run(dims=DEFAULT_DIMS, n: int = 256, device: str = "cuda") -> tuple[list[Finding], dict]:
    """The full matrix on ``device``. Returns ``(findings, summary)``; the
    summary holds the configurations run, the device (and the card's name),
    the dims, the rules and every kernel launched, by name."""
    import torch

    from skyline_tpu_torch.ops.device_cascade import _cascade_core
    from skyline_tpu_torch.ops.dispatch import skyline_mask_auto
    from skyline_tpu_torch.ops.sfs import sfs_round_single
    from skyline_tpu_torch.stream.window import (
        grid_summary_device,
        merge_step_active,
        partition_summaries_device,
    )

    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("graph audit on cuda: no CUDA device is visible")
    dev = torch.device(device)
    audit = _Audit(device)
    seed = [0]

    def rows(rng, shape):
        return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)

    def fresh():
        seed[0] += 1
        return seed[0]

    # the mask configurations hold the reference's exact (mp off) condition
    exact = {"SKYLINE_MIXED_PRECISION": "0"}

    def mask_args(d, k):
        def make(second):
            rng = np.random.default_rng(k)
            x = rows(rng, (n, d))
            valid = torch.arange(n, device=dev) < (n // 2 if second else n - 3)
            return x, valid
        return make

    def mask(x, valid):
        return skyline_mask_auto(x, valid, traced=True)

    # the backend-auto mask, the op the engine routes every self-skyline
    # through: d = 2 takes the sweep, d > 2 the scan or K3
    for d in dims:
        audit.config(f"skyline_mask_auto d={d} n={n}", mask, mask_args(d, fresh()),
                     expect_bf16=False, env=exact)

    # the host sorted cascade forced on: a merge-time mask must still run on
    # the device (the host path steps aside)
    d_max = max(dims)
    if d_max > 2:
        audit.config(f"skyline_mask_auto[sorted_sfs=on] d={d_max} n={n}", mask,
                     mask_args(d_max, fresh()), expect_bf16=False,
                     env={**exact, "SKYLINE_SORTED_SFS": "on"})

        # the device cascade, at both mp settings, then forced on through the
        # mask
        for mp in (False, True):
            audit.config(
                f"device_cascade_core d={d_max} n={n} mp={int(mp)}",
                lambda x, v, mp=mp: _cascade_core(x, v, 64, mp),
                mask_args(d_max, fresh()), expect_bf16=mp,
            )
        audit.config(f"skyline_mask_auto[device_cascade=on] d={d_max} n={n}", mask,
                     mask_args(d_max, fresh()), expect_bf16=False,
                     env={**exact, "SKYLINE_DEVICE_CASCADE": "on"})

    # the SFS round and the incremental merge step, mp off and on
    for d in (min(dims), max(dims)):
        cap, b, p = 64, 32, 2

        def sfs_args(second, d=d, k=fresh()):
            rng = np.random.default_rng(k)
            sky = torch.full((cap, d), float("inf"), dtype=torch.float32, device=dev)
            cnt = torch.zeros((), dtype=torch.int64, device=dev)
            if second:
                sky[:16] = rows(rng, (16, d))
                cnt.fill_(16)
            block = rows(rng, (b, d))
            bvalid = torch.arange(b, device=dev) < (b // 3 if second else b)
            return sky, cnt, block, bvalid

        def merge_args(second, d=d, k=fresh()):
            rng = np.random.default_rng(k)
            sky = torch.full((p, cap, d), float("inf"), dtype=torch.float32, device=dev)
            sval = torch.zeros((p, cap), dtype=torch.bool, device=dev)
            if second:
                sky[:, :8] = rows(rng, (p, 8, d))
                sval[:, :8] = True
            batch = rows(rng, (p, b, d))
            bval = torch.arange(b, device=dev)[None, :].expand(p, b) < (b // 2 if second else b)
            return sky, sval, batch, bval.contiguous()

        for mp in (False, True):
            audit.config(f"sfs_round_single d={d} mp={int(mp)}",
                         lambda s, c, bl, bv, mp=mp: sfs_round_single(s, c, bl, bv, cap, mp),
                         sfs_args, expect_bf16=mp)
            audit.config(f"merge_step_active d={d} mp={int(mp)}",
                         lambda s, sv, ba, bv, mp=mp: merge_step_active(
                             s, sv, ba, bv, cap, cap + b, mp),
                         merge_args, expect_bf16=mp)

    # the flush-tail summaries, which feed the host prefilters
    def summary_args(d, k, cap=64, p=2):
        def make(second):
            rng = np.random.default_rng(k)
            sky = rows(rng, (p, cap, d))
            counts = torch.tensor([7, 60] if second else [cap // 2, cap // 4],
                                  dtype=torch.int64).to(dev)
            return sky, counts
        return make

    for d in (min(dims), max(dims)):
        audit.config(f"partition_summaries_device d={d}",
                     lambda s, c: partition_summaries_device(s, c, 64),
                     summary_args(d, fresh()), expect_bf16=False)
        audit.config(f"grid_summary_device d={d}",
                     lambda s, c: grid_summary_device(s, c, 64),
                     summary_args(d, fresh()), expect_bf16=False)

    # the cache-stability legs: a second call on same-shaped inputs must
    # neither build a kernel nor change the op sequence
    audit.config("grid_summary_device", lambda s, c: grid_summary_device(s, c, 64),
                 summary_args(d_max, fresh()))
    audit.config("partition_summaries_device",
                 lambda s, c: partition_summaries_device(s, c, 64),
                 summary_args(d_max, fresh()))

    def cascade_args(second, k=fresh()):
        rng = np.random.default_rng(k)
        x = rows(rng, (128, d_max))
        valid = torch.arange(128, device=dev) < (100 if second else 128)
        return x, valid

    audit.config("device_cascade_core", lambda x, v: _cascade_core(x, v, 64, False),
                 cascade_args)

    summary = {
        "device": device,
        "card": torch.cuda.get_device_name(dev) if device == "cuda" else None,
        "configs": audit.configs,
        "labels": audit.labels,
        "dims": list(dims),
        "rules": list(RULES),
        "launches": dict(sorted(audit.launches.items())),
        "findings": len(audit.findings),
    }
    return audit.findings, summary

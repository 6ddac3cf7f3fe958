"""``chip_smoke.py --parent``'s call of the parent tree's cascade kernels
(``_parent_call``), on the CPU.

The parent is this tree's ``skyline_tpu_torch/ops/dominance_kernels.py``
loaded as a module of its own, as ``parent_library`` loads a parent
checkout's (without its nvcc build): the next tree's A/B run takes this one
as its parent. Both branches — the window pass (``cascade_windows``) and
the scan (``cascade_scan``) — must resolve to the parent's entry of the
same name, pass on only the keywords its signature takes, and return the
mask this tree's entry returns on the core's own recorded arguments. A
parent from before the window pass had a kernel of its own (no
``cascade_windows``) still gets its windowed K2 call.

Tolerance: exact masks.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke as cs
from skyline_tpu_torch.ops import device_cascade as tdc
from skyline_tpu_torch.ops import dominance_kernels as dk
from skyline_tpu_torch.workload.generators import anti_correlated

REPO = Path(__file__).resolve().parents[1]


def _as_parent():
    src = REPO / "skyline_tpu_torch" / "ops" / "dominance_kernels.py"
    spec = importlib.util.spec_from_file_location("parent_dominance_kernels", src)
    lib = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lib)
    return lib


def _rows(d: int, n: int = 600):
    x = anti_correlated(np.random.default_rng(5), n, d, 0, 10000).astype(np.float32)
    return torch.as_tensor(x)


@pytest.mark.parametrize("d", [3, 8])
@pytest.mark.parametrize("site", ["windows", "scan"])
def test_parent_call_resolves_against_this_tree(site, d):
    parent = _as_parent()
    name = cs.CASCADE_SITES[site]
    args = cs._core_args(tdc, name, _rows(d))
    # the scan takes mp by position (as the core calls it), the window pass
    # by keyword
    kws = [{}, {"a_later_keyword": 1}] + ([{"mp": True}] if site == "windows" else [])
    for kw in kws:
        call = cs._parent_call(torch, parent, site, args, kw)
        want = getattr(dk, name)(*args, **{k: v for k, v in kw.items() if k == "mp"})
        got = call()
        assert got.dtype == torch.bool and torch.equal(got, want)


def test_parent_without_cascade_windows_gets_its_windowed_k2():
    seen = {}

    def dominated_by_rect_windows(xt, ok, yt, first, ends, mp=False):
        seen.update(xt=xt.shape, yt=yt.shape, first=first.tolist(), ends=ends.tolist(), mp=mp)
        return torch.zeros(yt.shape[0] * yt.shape[2], dtype=torch.bool)

    old = SimpleNamespace(dominated_by_rect_windows=dominated_by_rect_windows)
    args = cs._core_args(tdc, "cascade_windows", _rows(3))
    cand, block, band_end = args[:3]
    out = cs._parent_call(torch, old, "windows", args, {"mp": True})()
    n = cand.shape[0]
    assert out.shape == (n,)
    assert seen["xt"] == (3, n) and seen["yt"] == (n // block, 3, block) and seen["mp"]
    assert seen["first"] == list(range(0, n, block))
    assert seen["ends"] == [int(e) * block for e in band_end.tolist()]

"""Hand-written CUDA dominance kernels (K1–K3, K5–K7), their wrappers and
the rank transform K4.

The engine's hot op — "is row j dominated by any valid row i" — runs in two
CUDA kernels. ``csrc/dominance.cu`` compares float32 values:

- K1 ``dominated_by_any(xt, valid)``: one set against itself; replaces
  ``skyline_tpu/ops/pallas_dominance.py`` ``dominated_by_any_pallas``.
- K2 ``dominated_by_rect(xt, x_valid, yt)``: victims ``yt`` against
  dominators ``xt``; replaces ``dominated_by_pallas`` (renamed so it does
  not clash with the plain ``ops.dominance.dominated_by``).
- K3 ``skyline_mask_kernel(x, valid)``: stable sum-sort, K1, unsort;
  replaces ``skyline_mask_pallas``; (P, N, d) points sort, launch once and
  unsort per partition in place of the reference's ``jax.vmap``.
- ``mp=True`` on K1–K3 (the TPU kernels' ``mp``, ``_dom_tile_mp``)
  launches the same f32 compare kernel, counted under the ``_mp`` name: on
  this card the f32 predicate is already the cheapest exact test (step 7
  of the source).
- The row pre-drop of the mixed-precision flush (XLA in the reference,
  ``skyline_tpu/ops/dominance.py`` ``strictly_dominated_bf16``), in the
  same source, behind two entry points: ``strictly_dominated_bf16_kernel
  (y, x, x_valid)``, the certified mask, and ``mp_predrop_kernel(dom,
  dom_ok, block, bvalid)``, the flush's drop with its epilogue fused.

``csrc/dominance_rank.cu`` compares int32 dense ranks (the rank cascade):

- K4 ``rank_transform(x, valid)``: per-dimension dense ranks and their
  int32 sum, ``(d+1, N)``. XLA in the reference, torch ops here (a sort and
  a batched ``searchsorted``); no kernel of its own.
- K5 ``dominated_by_any_rank(rt, valid)``; replaces
  ``dominated_by_any_rank_pallas``.
- K6 ``dominated_by_rank_rect(xt, x_valid, yt)``; replaces
  ``dominated_by_rank_pallas``.
- K7 ``skyline_mask_rank_kernel(x, valid)``: stable sum-sort, K4, K5,
  unsort; replaces ``skyline_mask_rank_pallas``.

The kernels keep the TPU kernels' transposed ``(d, N)`` / ``(d+1, N)``
layout at their surface and take an optional leading partition dimension
``(P, ·, N)`` in place of ``jax.vmap``. They mask their ragged edges, so no
shape needs to be a tile multiple. ``triangular`` is accepted and changes
nothing: the kernels skip only by exact bounds, never by position.

Each kernel first runs a summary pass (per-tile minima of the coordinates
or ranks and of the sums, per-victim-block maxima) into scratch this module
allocates, then compares each victim block only with the tiles its summary
cannot rule out. ``tile_skip_plain`` (values), ``rank_tile_skip_plain``
(ranks) and ``predrop_skip_plain`` (the pre-drop) are the plain mirrors of
the three skip rules, for the tests and ``chip_smoke.py`` (nothing on the
main path calls them).

Each wrapper checks device, dtype, contiguity and shape and raises on
anything else (the pre-drop's rows need only be contiguous within a
partition, so a prefix of a wider buffer is read in place). On a CPU tensor it runs the plain PyTorch version beside it
(the CPU tests' path); on a CUDA tensor it launches the kernel or raises —
there is no fallback. ``LAUNCHES`` counts kernel launches per entry point
(K3 and K7 count their own launches, not K1's or K5's; K4 counts its calls
on the card); a K1–K3 launch with ``mp`` counts under the entry point's
name with ``_mp`` appended.

Each source is built at first use with ``nvcc`` into
``skyline_tpu_torch/_build/`` (keyed by a hash of the source, the local
headers it includes and the flags; one ``nvcc`` per source, all started
together) and bound through ``ctypes`` with a plain C interface;
``utils/compile_cache.py`` counts each source's cached builds and ``nvcc``
runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from skyline_tpu_torch.ops.dominance import (
    bf16_round,
    dominated_by,
    dominated_by_rank,
    skyline_mask,
    strictly_dominated_bf16,
)
from skyline_tpu_torch.utils.compile_cache import note_build

_PKG = Path(__file__).resolve().parents[1]
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# library name -> (source, {C entry point: argument types}, C error-string
# function). The compare entry points: x, validity, y, out and three scratch
# buffers; P, d, nx, ny; the stream. The pre-drop: y, its validity, x, its
# validity, four outputs and three scratch buffers; P, d, nx, ny; four
# partition strides; the stream.
SOURCES = {
    "dominance": (
        _PKG / "csrc" / "dominance.cu",
        {"skyline_dominated": [_P] * 7 + [_I] * 4 + [_P],
         "skyline_predrop": [_P] * 11 + [_I] * 4 + [_L] * 4 + [_P]},
        "skyline_error_string",
    ),
    "dominance_rank": (
        _PKG / "csrc" / "dominance_rank.cu",
        {"skyline_rank_dominated": [_P] * 7 + [_I] * 4 + [_P]},
        "skyline_rank_error_string",
    ),
}
BUILD_DIR = _PKG / "_build"
# -Xptxas -v only reports registers/shared memory/spills into the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the kernels are instantiated for these dimension counts
MAX_DIMS = 16
# both kernels' geometry (csrc/dominance.cu, csrc/dominance_rank.cu):
# dominator rows per shared-memory tile, and victims per block (128
# threads, 2 victims each)
TILE_ROWS = 256
BLOCK_VICTIMS = 256

LAUNCHES = {
    "dominated_by_any": 0, "dominated_by_rect": 0, "skyline_mask_kernel": 0,
    "dominated_by_any_mp": 0, "dominated_by_rect_mp": 0, "skyline_mask_kernel_mp": 0,
    "strictly_dominated_bf16_kernel": 0, "mp_predrop_kernel": 0,
    "rank_transform": 0, "dominated_by_any_rank": 0, "dominated_by_rank_rect": 0,
    "skyline_mask_rank_kernel": 0,
}
# entry point -> the library whose kernel it launches
_LIBRARY_OF = {
    "dominated_by_any": "dominance", "dominated_by_rect": "dominance",
    "skyline_mask_kernel": "dominance", "dominated_by_any_rank": "dominance_rank",
    "dominated_by_rank_rect": "dominance_rank",
    "skyline_mask_rank_kernel": "dominance_rank",
}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the dominance kernels build with the CUDA toolkit"
    )


def _local_includes(source: Path, seen: set[Path] | None = None) -> list[Path]:
    """``source`` and every file it pulls in with ``#include "..."``,
    recursively, in first-seen order."""
    seen = set() if seen is None else seen
    source = source.resolve()
    if source in seen:
        return []
    seen.add(source)
    files = [source]
    for line in source.read_text().splitlines():
        words = line.strip().split(None, 1)
        if len(words) == 2 and words[0] == "#include" and words[1].startswith('"'):
            files += _local_includes(source.parent / words[1].strip('"'), seen)
    return files


def _library_path(name: str) -> Path:
    """The library's path, keyed by the bytes of its source, of every local
    header it includes, and of the flags — so an edit anywhere rebuilds."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _local_includes(SOURCES[name][0]):
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build() -> dict[str, tuple[Path, str]]:
    """Compile every source in ``SOURCES`` for sm_90a unless a library
    built from the same source and flags exists — one ``nvcc`` per source,
    all started together. Returns {name: (library path, compiler log —
    empty when the build was cached)}. Raises when an nvcc fails, after
    every nvcc has ended."""
    built: dict[str, tuple[Path, str]] = {}
    missing = []
    for name in SOURCES:
        lib = _library_path(name)
        note_build(lib.exists())
        if lib.exists():
            built[name] = (lib, "")
        else:
            missing.append((name, lib))
    if missing:
        nvcc = _nvcc()  # once, before any compiler starts
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name, lib in missing:
        tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp"
        log = BUILD_DIR / f"{lib.stem}.{os.getpid()}.log"
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name][0])],
                stdout=subprocess.DEVNULL, stderr=fh,
            )
        running.append((name, lib, tmp, log, proc))
    failures = []
    for name, lib, tmp, log, proc in running:
        rc = proc.wait()
        text = log.read_text()
        log.unlink(missing_ok=True)
        if rc:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {name} with code {rc}:\n{text}")
            continue
        os.replace(tmp, lib)
        built[name] = (lib, text)
    if failures:
        raise RuntimeError("\n".join(failures))
    return built


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        path = build()[name][0]
        lib = ctypes.CDLL(str(path))
        _, entries, errstr = SOURCES[name]
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, errstr)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def _batched(
    t: torch.Tensor, valid: torch.Tensor | None, name: str, dtype=torch.float32
):
    """Validate a (rows, N) / (P, rows, N) tensor of ``dtype`` (+ its (N,) /
    (P, N) validity) and return 3-D/2-D views plus whether a batch dim was
    given."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() not in (2, 3):
        raise ValueError(f"{name}: expected (d, N) or (P, d, N), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: coordinates must be contiguous")
    batched = t.dim() == 3
    t3 = t if batched else t.unsqueeze(0)
    if valid is None:
        return t3, None, batched
    if valid.dtype != torch.bool:
        raise TypeError(f"{name}: validity must be bool, got {valid.dtype}")
    if not valid.is_contiguous():
        raise ValueError(f"{name}: validity must be contiguous")
    if valid.device != t.device:
        raise ValueError(f"{name}: validity on {valid.device}, coordinates on {t.device}")
    v2 = valid if batched else valid.unsqueeze(0)
    if tuple(v2.shape) != (t3.shape[0], t3.shape[2]):
        raise ValueError(
            f"{name}: validity shape {tuple(valid.shape)} does not match "
            f"coordinates {tuple(t.shape)}"
        )
    return t3, v2, batched


def _device_path(t: torch.Tensor, name: str) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def _call(library: str, entry: str, args: list) -> None:
    """Call C entry point ``entry`` of ``library`` on the current stream of
    the device, raising with the CUDA error when it reports one."""
    lib = _lib(library)
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, entry)(*args, stream)
    if rc:
        raise RuntimeError(
            f"{library} kernel launch failed: "
            + getattr(lib, SOURCES[library][2])(rc).decode()
        )


def _scratch(P: int, rows: int, d: int, nx: int, ny: int, like: torch.Tensor) -> list:
    """Scratch of a summary pass, in ``like``'s type and device: the
    dominators row-major in whole tiles, a row (``rows`` values: d, or d
    ranks and their sum) padded to 16 bytes; one summary per tile and per
    victim block (d bounds and a sum bound, padded to 16 bytes)."""
    tiles, blocks = -(-nx // TILE_ROWS), -(-ny // BLOCK_VICTIMS)
    dp, sw = -(-rows // 4) * 4, -(-(d + 1) // 4) * 4
    return [
        torch.empty((P, tiles * TILE_ROWS, dp), dtype=like.dtype, device=like.device),
        torch.empty((P, tiles, sw), dtype=like.dtype, device=like.device),
        torch.empty((P, blocks, sw), dtype=like.dtype, device=like.device),
    ]


def _one_device(name: str, **tensors) -> None:
    """Raise ``ValueError`` naming ``name`` unless every tensor lies on one
    device. The kernels take raw pointers: an operand left on another card
    would be an illegal address or a silent wrong read, not an error."""
    devs = {k: t.device for k, t in tensors.items()}
    if len(set(devs.values())) > 1:
        raise ValueError(
            f"{name}: operands on different devices "
            + ", ".join(f"{k} on {d}" for k, d in devs.items())
        )


def _launch(
    name: str, x3: torch.Tensor, v2: torch.Tensor, y3: torch.Tensor, mp: bool = False
) -> torch.Tensor:
    """One kernel launch on the current stream of the operands' device for
    entry point ``name``, counted in ``LAUNCHES`` (under ``name + "_mp"``
    with ``mp``; the value kernel is the same either way): (P, ny) bool.
    Rank inputs carry a sum row on top of their ``d`` rank rows. Every
    operand, the output and the scratch must lie on one device
    (``ValueError`` otherwise)."""
    _one_device(name, dominators=x3, validity=v2, victims=y3)
    P, rows, nx = x3.shape
    ny = y3.shape[2]
    library = _LIBRARY_OF[name]
    d = rows - 1 if library == "dominance_rank" else rows
    if not 1 <= d <= MAX_DIMS:
        raise ValueError(f"the dominance kernels take 1..{MAX_DIMS} dims, got {d}")
    if max(nx, ny) >= 2**31:
        raise ValueError("the dominance kernels take fewer than 2^31 rows")
    if mp and library != "dominance":
        raise ValueError(f"{name}: the rank kernel has no mixed-precision variant")
    out = torch.empty((P, ny), dtype=torch.uint8, device=x3.device)
    if P == 0 or ny == 0:
        return out.view(torch.bool)
    scratch = _scratch(P, rows, d, nx, ny, x3)
    _one_device(name, dominators=x3, output=out, **{f"scratch{i}": t for i, t in enumerate(scratch)})
    args = [x3.data_ptr(), v2.view(torch.uint8).data_ptr(), y3.data_ptr(), out.data_ptr()]
    args += [t.data_ptr() for t in scratch] + [P, d, nx, ny]
    with torch.cuda.device(x3.device):
        _call(library, "skyline_dominated" if library == "dominance"
              else "skyline_rank_dominated", args)
    LAUNCHES[name + ("_mp" if mp else "")] += 1
    return out.view(torch.bool)


# -- plain versions (any device; the wrappers' CPU path) ----------------------


def dominated_by_any_plain(xt: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain K1: (d, N) or (P, d, N) -> (N,) or (P, N)."""
    x3, v2, batched = _batched(xt, valid, "dominated_by_any")
    out = torch.zeros((x3.shape[0], x3.shape[2]), dtype=torch.bool, device=xt.device)
    for p in range(x3.shape[0]):
        out[p] = dominated_by(x3[p].T, x3[p].T, v2[p])
    return out if batched else out[0]


def dominated_by_rect_plain(
    xt: torch.Tensor, x_valid: torch.Tensor, yt: torch.Tensor
) -> torch.Tensor:
    """Plain K2: victims (d, Ny) / (P, d, Ny) against dominators xt."""
    x3, v2, y3, batched = _rect_args(xt, x_valid, yt)
    out = torch.zeros((y3.shape[0], y3.shape[2]), dtype=torch.bool, device=yt.device)
    for p in range(x3.shape[0]):
        out[p] = dominated_by(y3[p].T, x3[p].T, v2[p])
    return out if batched else out[0]


def skyline_mask_plain(x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain K3: the dense ``skyline_mask`` of (N, d) points, or of each
    partition's valid rows of (P, N, d) points with (P, N) validity -> (P, N)
    (invalid rows neither dominate nor survive, so a partition's mask is
    that of its valid rows)."""
    _mask_args(x, valid, batch=True)
    if x.dim() == 2:
        return skyline_mask(x, valid)
    out = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
    for p in range(x.shape[0]):
        if valid is None:
            out[p] = skyline_mask(x[p])
        else:
            out[p, valid[p]] = skyline_mask(x[p][valid[p]])
    return out


def row_sums(w: torch.Tensor) -> torch.Tensor:
    """float32 sums over axis 1 — (N, d) -> (N,), or (P, d, N) -> (P, N) —
    added left to right, dimension by dimension: the order XLA's
    ``jnp.sum(axis=1)`` rounds in, so sort keys tie and break ties as in the
    reference, and the order the value kernel adds its row sums in."""
    s = w[:, 0]
    for k in range(1, w.shape[1]):
        s = s + w[:, k]
    return s


def _per_group(t: torch.Tensor, size: int, fill: float, reduce) -> torch.Tensor:
    """Reduce the last axis of ``t`` in groups of ``size`` (the ragged last
    group padded with ``fill``)."""
    n = t.shape[-1]
    groups = -(-n // size)
    pad = torch.full((*t.shape[:-1], groups * size - n), fill, dtype=t.dtype, device=t.device)
    return reduce(torch.cat([t, pad], dim=-1).reshape(*t.shape[:-1], groups, size), -1)


def tile_skip_plain(
    x3: torch.Tensor, v2: torch.Tensor, y3: torch.Tensor, tile: int, block: int
) -> torch.Tensor:
    """The value kernel's skip decisions, in plain PyTorch: (P, blocks,
    tiles) bool, True where victim block ``b`` (``block`` victims of
    ``y3``) never compares dominator tile ``t`` (``tile`` rows of ``x3``).
    x3: (P, d, Nx) f32 dominators, v2: (P, Nx) bool, y3: (P, d, Ny) f32.

    Summaries: a tile's per-dimension minimum ``lo`` over the rows that can
    dominate (valid, no NaN coordinate) and its minimum valid row sum
    (invalid +inf, NaN sum -inf); a block's per-dimension maximum ``hi``
    over the victims that can be dominated (no NaN coordinate, invalid and
    +inf rows included) and its maximum sum (NaN +inf). A pair is skipped
    when ``min sum > max sum``, or ``lo_k > hi_k`` for some k, or
    ``lo_k >= hi_k`` for every k. The proof is in ``csrc/dominance.cu``."""
    inf = float("inf")
    can_dom = v2 & ~torch.isnan(x3).any(dim=1)
    lo = _per_group(torch.where(can_dom[:, None], x3, inf), tile, inf, torch.amin)
    xs = row_sums(x3)
    xs = torch.where(v2, torch.where(torch.isnan(xs), -inf, xs), inf)
    tmin = _per_group(xs, tile, inf, torch.amin)
    can_be = ~torch.isnan(y3).any(dim=1)
    hi = _per_group(torch.where(can_be[:, None], y3, -inf), block, -inf, torch.amax)
    ys = row_sums(y3)
    bmax = _per_group(torch.where(torch.isnan(ys), inf, ys), block, -inf, torch.amax)
    # (P, d, blocks, tiles) coordinate tests
    lo4, hi4 = lo[:, :, None, :], hi[:, :, :, None]
    return (
        (tmin[:, None, :] > bmax[:, :, None])
        | (lo4 > hi4).any(dim=1)
        | (lo4 >= hi4).all(dim=1)
    )


def predrop_skip_plain(
    y: torch.Tensor, x: torch.Tensor, xv: torch.Tensor, tile: int, block: int,
    yv: torch.Tensor | None = None,
) -> torch.Tensor:
    """The pre-drop kernel's skip decisions, in plain PyTorch: (P, blocks,
    tiles) bool, True where victim block ``b`` (``block`` rows of ``y``)
    never compares dominator tile ``t`` (``tile`` rows of ``x``). y (P, B,
    d) and x (P, L, d) float32 rows, xv (P, L) bool, yv (P, B) bool or None
    (every victim, the mask entry).

    Summaries on the values rounded to bf16: a tile's per-dimension minimum
    ``lo`` and least row sum over the rows that can certify (valid and
    finite); a block's per-dimension maximum ``hi`` and greatest row sum
    over its valid, finite victims. A pair is skipped when ``lo_k >= hi_k``
    for some k, or ``min sum > max sum``. The proof is in
    ``csrc/dominance.cu``, step 8."""
    inf = float("inf")
    xb, yb = bf16_round(x), bf16_round(y)
    can = xv & torch.isfinite(xb).all(dim=-1)
    lo = _per_group(torch.where(can[..., None], xb, inf).transpose(1, 2), tile, inf, torch.amin)
    tmin = _per_group(torch.where(can, row_sums(xb.transpose(1, 2)), inf), tile, inf, torch.amin)
    ok = torch.isfinite(yb).all(dim=-1)
    if yv is not None:
        ok = ok & yv
    hi = _per_group(torch.where(ok[..., None], yb, -inf).transpose(1, 2), block, -inf, torch.amax)
    ys = torch.where(ok, row_sums(yb.transpose(1, 2)), -inf)
    bmax = _per_group(ys, block, -inf, torch.amax)
    # (P, d, blocks, tiles) coordinate tests
    lo4, hi4 = lo[:, :, None, :], hi[:, :, :, None]
    return (tmin[:, None, :] > bmax[:, :, None]) | (lo4 >= hi4).any(dim=1)


def rank_tile_skip_plain(
    x3: torch.Tensor, v2: torch.Tensor, y3: torch.Tensor, tile: int, block: int
) -> torch.Tensor:
    """The rank kernel's skip decisions, in plain PyTorch: (P, blocks,
    tiles) bool, True where victim block ``b`` (``block`` victims of
    ``y3``) never compares dominator tile ``t`` (``tile`` rows of ``x3``).
    x3: (P, d+1, Nx) int32 dominators, v2: (P, Nx) bool, y3: (P, d+1, Ny)
    int32 (d rank rows and the sum row).

    Summaries: a tile's per-row minimum over its valid rows (int32 max when
    there are none) — ``lo_k`` for the rank rows, the least valid rank sum
    for the sum row; a block's per-row maximum over its victims, invalid
    ones included. A pair is skipped when ``min sum >= max sum``, or
    ``lo_k > hi_k`` for some k. The proof is in ``csrc/dominance_rank.cu``."""
    big, small = torch.iinfo(torch.int32).max, torch.iinfo(torch.int32).min
    lo = _per_group(torch.where(v2[:, None], x3, big), tile, big, torch.amin)
    hi = _per_group(y3, block, small, torch.amax)
    # (P, d+1, blocks, tiles) tests
    lo4, hi4 = lo[:, :, None, :], hi[:, :, :, None]
    return (lo4[:, -1] >= hi4[:, -1]) | (lo4[:, :-1] > hi4[:, :-1]).any(dim=1)


def dominated_by_any_rank_plain(rt: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain K5: (d+1, N) or (P, d+1, N) int32 -> (N,) or (P, N)."""
    x3, v2, batched = _batched(rt, valid, "dominated_by_any_rank", torch.int32)
    out = torch.zeros((x3.shape[0], x3.shape[2]), dtype=torch.bool, device=rt.device)
    for p in range(x3.shape[0]):
        out[p] = dominated_by_rank(x3[p].T, x3[p].T, v2[p])
    return out if batched else out[0]


def dominated_by_rank_rect_plain(
    xt: torch.Tensor, x_valid: torch.Tensor, yt: torch.Tensor
) -> torch.Tensor:
    """Plain K6: victims (d+1, Ny) / (P, d+1, Ny) against dominators xt."""
    x3, v2, y3, batched = _rect_args(xt, x_valid, yt, torch.int32, "dominated_by_rank_rect")
    out = torch.zeros((y3.shape[0], y3.shape[2]), dtype=torch.bool, device=yt.device)
    for p in range(x3.shape[0]):
        out[p] = dominated_by_rank(y3[p].T, x3[p].T, v2[p])
    return out if batched else out[0]


def skyline_mask_rank_plain(
    x: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain K7: K4 over the whole set, then the plain rank predicate. The
    compared universe is exactly ``x``'s valid rows, so the rank embedding
    is exact and the mask equals the value-space skyline mask."""
    _mask_args(x, valid, "skyline_mask_rank_kernel")
    if valid is None:
        valid = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    rt = rank_transform(x, valid)
    return ~dominated_by_any_rank_plain(rt, valid) & valid


# -- K4: the rank transform (torch ops on any device) -------------------------


def sort_columns(x: torch.Tensor) -> torch.Tensor:
    """(N, d) -> (d, N): each dimension's values ascending (stable, so equal
    values such as -0.0 and 0.0 keep their order, as XLA's sort does)."""
    return torch.sort(x.T.contiguous(), dim=1, stable=True).values


def searchsorted_cols(sorted_t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-dimension dense ranks: sorted_t (d, M) ascending rows (from
    ``sort_columns``), q (N, d) -> (N, d) int32, the count of values of the
    dimension strictly below each query (``side="left"``). int32 keeps rank
    sums exact past float32's 2^24 limit."""
    return torch.searchsorted(
        sorted_t, q.T.contiguous(), side="left", out_int32=True
    ).T


def with_rank_sum(ranks: torch.Tensor) -> torch.Tensor:
    """(N, d) int32 ranks -> (N, d+1) with their int32 sum as the last
    column."""
    return torch.cat([ranks, ranks.sum(dim=1, keepdim=True, dtype=torch.int32)], dim=1)


def rank_transform(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """K4: per-dimension dense ranks plus rank sum over one point set (the
    compared universe). x: (N, d) float32; valid: (N,) bool. Invalid rows
    rank as +inf values: every dimension gets the count of finite entries,
    so they are inert like +inf padding. Returns ``(d+1, N)`` int32 — ranks
    transposed with the rank sum as the last row, the layout K5 takes."""
    if valid is None:
        raise ValueError("rank_transform: validity is required")
    _mask_args(x, valid, "rank_transform")
    xm = torch.where(valid[:, None], x, float("inf"))
    rt = with_rank_sum(searchsorted_cols(sort_columns(xm), xm)).T.contiguous()
    if x.device.type == "cuda":
        LAUNCHES["rank_transform"] += 1
    return rt


# -- kernel entry points -------------------------------------------------------


def dominated_by_any(
    xt: torch.Tensor,
    valid: torch.Tensor,
    triangular: bool = False,
    mp: bool = False,
) -> torch.Tensor:
    """K1: ``out[j]`` = some valid column ``i`` of ``xt`` dominates column
    ``j``. xt: (d, N) or (P, d, N) float32; valid: (N,) or (P, N) bool.
    Returns (N,) or (P, N) bool.

    ``triangular`` marks input sorted ascending by coordinate sum, as the
    reference's tile-index skip requires. The kernel never skips by
    position — only by the exact in-kernel sum bound, which on sum-sorted
    input drops the same tiles and stays exact whatever the sort key's
    rounding — so the flag changes nothing here. ``mp`` counts the launch
    under ``dominated_by_any_mp`` (the same kernel, the same mask)."""
    del triangular
    if not _device_path(xt, "dominated_by_any"):
        return dominated_by_any_plain(xt, valid)
    x3, v2, batched = _batched(xt, valid, "dominated_by_any")
    out = _launch("dominated_by_any", x3, v2, x3, mp)
    return out if batched else out[0]


def _rect_args(xt, x_valid, yt, dtype=torch.float32, name="dominated_by_rect"):
    x3, v2, batched = _batched(xt, x_valid, name, dtype)
    y3, _, ybatched = _batched(yt, None, name, dtype)
    if ybatched != batched or y3.shape[:2] != x3.shape[:2] or yt.device != xt.device:
        raise ValueError(
            f"{name}: victims {tuple(yt.shape)} on {yt.device} do "
            f"not match dominators {tuple(xt.shape)} on {xt.device}"
        )
    return x3, v2, y3, batched


def dominated_by_rect(
    xt: torch.Tensor, x_valid: torch.Tensor, yt: torch.Tensor, mp: bool = False
) -> torch.Tensor:
    """K2: ``out[j]`` = some valid dominator column of ``xt`` dominates
    victim column ``j`` of ``yt``. xt: (d, Nx) / (P, d, Nx); x_valid: (Nx,)
    / (P, Nx) bool; yt: (d, Ny) / (P, d, Ny). Returns (Ny,) / (P, Ny).
    ``mp`` counts the launch under ``dominated_by_rect_mp`` (the same
    kernel, the same mask)."""
    if not _device_path(xt, "dominated_by_rect"):
        return dominated_by_rect_plain(xt, x_valid, yt)
    x3, v2, y3, batched = _rect_args(xt, x_valid, yt)
    out = _launch("dominated_by_rect", x3, v2, y3, mp)
    return out if batched else out[0]


def _mask_args(x, valid, name="skyline_mask_kernel", batch: bool = False):
    """Check (N, d) points — or (P, N, d) with ``batch`` — and their (N,) /
    (P, N) validity."""
    if x.dim() not in ((2, 3) if batch else (2,)):
        want = "(N, d) or (P, N, d)" if batch else "(N, d)"
        raise ValueError(f"{name}: expected {want}, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: points must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: points must be contiguous")
    if valid is not None and (
        valid.dtype != torch.bool
        or tuple(valid.shape) != tuple(x.shape[:-1])
        or valid.device != x.device
    ):
        raise ValueError(
            f"{name}: validity must be a bool {tuple(x.shape[:-1])} tensor on the "
            "points' device"
        )


def _sum_sorted(x: torch.Tensor, valid: torch.Tensor | None):
    """Stable sort by valid row sum, invalid rows last, of (N, d) points or
    of each partition of (P, N, d): (order, validity in sorted order), each
    (N,) / (P, N). The key (``torch.sum``) may round differently from a
    kernel's own sums; that moves only work, never a mask, because the
    kernels skip on their own exact sums."""
    if valid is None:
        valid = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    keys = torch.where(valid, x.sum(dim=-1), float("inf"))
    order = torch.argsort(keys, dim=-1, stable=True)
    return order, torch.gather(valid, -1, order)


def _unsort(order: torch.Tensor, keep_sorted: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)


def skyline_mask_kernel(
    x: torch.Tensor, valid: torch.Tensor | None = None, mp: bool = False
) -> torch.Tensor:
    """K3: survivor mask of (N, d) points — valid and dominated by no valid
    point — or of each partition of (P, N, d) points with (P, N) validity,
    returning (N,) / (P, N) bool. Per partition a stable sort by valid row
    sum (invalid rows last), a gather into one contiguous (P, d, N)
    transpose, ONE K1 launch over every partition, a scatter back to the
    caller's order; nothing is read back to the host. No padding to a tile
    multiple: the kernel masks its ragged edge. ``mp`` counts the launch
    under ``skyline_mask_kernel_mp``; the sliding engine's slide step calls without
    it, as the reference's does (``SKYLINE_MIXED_PRECISION`` does not
    reach it)."""
    if not _device_path(x, "skyline_mask_kernel"):
        return skyline_mask_plain(x, valid)
    _mask_args(x, valid, batch=True)
    batched = x.dim() == 3
    x3 = x if batched else x[None]
    v2 = valid if valid is None or batched else valid[None]
    order, vs = _sum_sorted(x3, v2)
    xs_t = torch.gather(x3, 1, order[..., None].expand_as(x3)).transpose(1, 2).contiguous()
    dom = _launch("skyline_mask_kernel", xs_t, vs, xs_t, mp)
    keep = _unsort(order, ~dom & vs)
    return keep if batched else keep[0]


# -- the bf16 row pre-drop -----------------------------------------------------


def _rows(t: torch.Tensor, name: str, what: str, dims: int) -> torch.Tensor:
    """Check (N, d) / (P, N, d) float32 rows (``dims`` 3: batched) whose
    last two dimensions are contiguous — a partition may start anywhere, as
    a prefix of a wider buffer does — and return a (P, N, d) view."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
    if t.dim() != dims:
        want = "(P, N, d)" if dims == 3 else "(N, d)"
        raise ValueError(f"{name}: expected {what} as {want}, got {tuple(t.shape)}")
    if t.stride(-1) != 1 or (t.shape[-2] > 1 and t.stride(-2) != t.shape[-1]):
        raise ValueError(f"{name}: the rows of {what} must be contiguous")
    return t if dims == 3 else t[None]


def _flags(t: torch.Tensor, name: str, what: str, shape) -> torch.Tensor:
    """Check a bool validity of (P, N) ``shape`` (or (N,)) whose last
    dimension is contiguous; return a (P, N) view."""
    v2 = t if t.dim() == 2 else t[None]
    if t.dtype != torch.bool or tuple(v2.shape) != tuple(shape):
        raise ValueError(
            f"{name}: {what} must be a bool {tuple(shape)} tensor, got "
            f"{tuple(t.shape)} {t.dtype}"
        )
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: {what} must be contiguous along its rows")
    return v2


def _predrop_call(y3, yv2, x3, xv2, fused: bool, scratch: list | None = None):
    """One pre-drop launch (summary pass and compare) on the current
    stream of the operands' device; shapes and strides checked by the
    caller. Every operand and scratch buffer must lie on one device
    (``ValueError`` otherwise). Returns the mask (P, ny) uint8, or with
    ``fused`` (block', validity' uint8, counts (P, ceil(ny / 256)) int32).
    ``scratch`` (``_scratch``'s three buffers), when given, keeps the
    summaries for the caller to read."""
    operands = dict(victims=y3, dominators=x3, dominator_validity=xv2)
    if fused:
        operands["victim_validity"] = yv2
    for i, t in enumerate(scratch or ()):
        operands[f"scratch{i}"] = t
    _one_device("strictly_dominated_bf16_kernel" if not fused else "mp_predrop_kernel",
                **operands)
    P, ny, d = y3.shape
    nx = x3.shape[1]
    if not 1 <= d <= MAX_DIMS:
        raise ValueError(f"the pre-drop takes 1..{MAX_DIMS} dims, got {d}")
    if max(nx, ny) >= 2**31:
        raise ValueError("the pre-drop takes fewer than 2^31 rows")
    dev = y3.device
    blocks = -(-ny // BLOCK_VICTIMS)
    if fused:
        outs = [torch.empty((P, ny, d), dtype=torch.float32, device=dev),
                torch.empty((P, ny), dtype=torch.uint8, device=dev),
                torch.empty((P, blocks), dtype=torch.int32, device=dev)]
        ptrs = [0] + [t.data_ptr() for t in outs]
    else:
        outs = [torch.empty((P, ny), dtype=torch.uint8, device=dev)]
        ptrs = [outs[0].data_ptr(), 0, 0, 0]
    if P and ny:
        scratch = _scratch(P, d, d, nx, ny, y3) if scratch is None else scratch
        args = [y3.data_ptr(), yv2.view(torch.uint8).data_ptr() if fused else 0,
                x3.data_ptr(), xv2.view(torch.uint8).data_ptr(), *ptrs]
        args += [t.data_ptr() for t in scratch] + [P, d, nx, ny]
        args += [y3.stride(0), yv2.stride(0) if fused else 0, x3.stride(0), xv2.stride(0)]
        with torch.cuda.device(dev):
            _call("dominance", "skyline_predrop", args)
    return outs if fused else outs[0]


def strictly_dominated_bf16_plain(y, x, x_valid):
    """Plain pre-drop: ``ops.dominance.strictly_dominated_bf16`` per
    partition. y (B, d) / (P, B, d), x (L, d) / (P, L, d), x_valid (L,) /
    (P, L) -> (B,) / (P, B) bool."""
    if y.dim() == 2:
        return strictly_dominated_bf16(y, x, x_valid)
    out = torch.zeros(y.shape[:2], dtype=torch.bool, device=y.device)
    for p in range(y.shape[0]):
        out[p] = strictly_dominated_bf16(y[p], x[p], x_valid[p])
    return out


def strictly_dominated_bf16_kernel(
    y: torch.Tensor, x: torch.Tensor, x_valid: torch.Tensor
) -> torch.Tensor:
    """The bf16 row pre-drop's mask: ``out[j]`` = some valid row of ``x``
    certainly strictly dominates row ``j`` of ``y`` by the bf16 margin test
    of ``strictly_dominated_bf16``, its arithmetic operation for operation.
    y: (B, d) / (P, B, d) float32 victims; x: (L, d) / (P, L, d)
    dominators; x_valid: (L,) / (P, L) bool. Rows must be contiguous; a
    partition may start anywhere. Returns (B,) / (P, B) bool. On the card:
    the summary pass and the compare in one call, counted once."""
    name = "strictly_dominated_bf16_kernel"
    if not _device_path(y, name):
        return strictly_dominated_bf16_plain(y, x, x_valid)
    dims = y.dim()
    y3, x3 = _rows(y, name, "victims", dims), _rows(x, name, "dominators", dims)
    xv2 = _flags(x_valid, name, "the dominators' validity", x3.shape[:2])
    if x3.shape[0] != y3.shape[0] or x3.shape[2] != y3.shape[2] or not (
        x.device == y.device == x_valid.device
    ):
        raise ValueError(
            f"{name}: victims {tuple(y.shape)} on {y.device} and dominators "
            f"{tuple(x.shape)} on {x.device} do not match"
        )
    out = _predrop_call(y3, None, x3, xv2, fused=False)
    LAUNCHES[name] += int(bool(y3.shape[0] and y3.shape[1]))
    out = out.view(torch.bool)
    return out if dims == 3 else out[0]


def mp_predrop_plain(dom, dom_ok, block, bvalid):
    """Plain fused pre-drop, the composition the flush ran before the
    kernel fused it: dom (P, L, d) dominators with validity dom_ok (P, L),
    block (P, B, d) victims with validity bvalid (P, B). Returns (block'
    with +inf on every row that is invalid or certified, bvalid & ~certified,
    certified counts (P, ceil(B / 256)) int32, one per victim block)."""
    pre = strictly_dominated_bf16_plain(block, dom, dom_ok) & bvalid
    keep = bvalid & ~pre
    counts = _per_group(pre.to(torch.int32), BLOCK_VICTIMS, 0, torch.sum).to(torch.int32)
    return torch.where(keep[..., None], block, float("inf")), keep, counts


def mp_predrop_kernel(dom, dom_ok, block, bvalid):
    """The flush's bf16 pre-drop with its epilogue fused: the same results
    as ``mp_predrop_plain``. dom (P, L, d) float32 dominators, read in place
    (rows contiguous; a prefix of a wider buffer is fine), dom_ok (P, L)
    bool; block (P, B, d) float32 victims and bvalid (P, B) bool, likewise.
    On the card one call (summary pass and compare) writes new tensors —
    nothing in place — and counts one launch."""
    name = "mp_predrop_kernel"
    if not _device_path(block, name):
        return mp_predrop_plain(dom, dom_ok, block, bvalid)
    y3, x3 = _rows(block, name, "victims", 3), _rows(dom, name, "dominators", 3)
    yv2 = _flags(bvalid, name, "the victims' validity", y3.shape[:2])
    xv2 = _flags(dom_ok, name, "the dominators' validity", x3.shape[:2])
    if x3.shape[0] != y3.shape[0] or x3.shape[2] != y3.shape[2] or not (
        dom.device == dom_ok.device == block.device == bvalid.device
    ):
        raise ValueError(
            f"{name}: victims {tuple(block.shape)} on {block.device} and dominators "
            f"{tuple(dom.shape)} on {dom.device} do not match"
        )
    out, keep, counts = _predrop_call(y3, yv2, x3, xv2, fused=True)
    LAUNCHES[name] += int(bool(y3.shape[0] and y3.shape[1]))
    return out, keep.view(torch.bool), counts


def dominated_by_any_rank(
    rt: torch.Tensor, valid: torch.Tensor, triangular: bool = False
) -> torch.Tensor:
    """K5: ``out[j]`` = some valid column ``i`` of ``rt`` dominates column
    ``j`` in rank space. rt: (d+1, N) or (P, d+1, N) int32 (``d`` rank rows
    and the rank-sum row, over one universe); valid: (N,) or (P, N) bool.
    ``triangular`` changes nothing (see K1)."""
    del triangular
    if not _device_path(rt, "dominated_by_any_rank"):
        return dominated_by_any_rank_plain(rt, valid)
    x3, v2, batched = _batched(rt, valid, "dominated_by_any_rank", torch.int32)
    out = _launch("dominated_by_any_rank", x3, v2, x3)
    return out if batched else out[0]


def dominated_by_rank_rect(
    xt: torch.Tensor, x_valid: torch.Tensor, yt: torch.Tensor
) -> torch.Tensor:
    """K6: the rectangular rank twin of K2. xt: (d+1, Nx) / (P, d+1, Nx)
    int32 dominators; x_valid: (Nx,) / (P, Nx) bool; yt: (d+1, Ny) /
    (P, d+1, Ny) int32 victims over the same rank universe. Returns (Ny,) /
    (P, Ny)."""
    if not _device_path(xt, "dominated_by_rank_rect"):
        return dominated_by_rank_rect_plain(xt, x_valid, yt)
    x3, v2, y3, batched = _rect_args(xt, x_valid, yt, torch.int32, "dominated_by_rank_rect")
    out = _launch("dominated_by_rank_rect", x3, v2, y3)
    return out if batched else out[0]


def skyline_mask_rank_kernel(
    x: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """K7: survivor mask of (N, d) points through the rank cascade — stable
    sort by valid row sum, K4 over the sorted set (the compared universe is
    exactly the valid rows), K5, unsort. The mask equals K3's."""
    if not _device_path(x, "skyline_mask_rank_kernel"):
        return skyline_mask_rank_plain(x, valid)
    _mask_args(x, valid, "skyline_mask_rank_kernel")
    order, vs = _sum_sorted(x, valid)
    rt = rank_transform(x[order], vs)
    dom = _launch("skyline_mask_rank_kernel", rt[None], vs[None], rt[None])[0]
    return _unsort(order, ~dom & vs)

"""Count-based sliding-window continuous skyline, device-resident.

Counterpart of ``skyline_tpu/stream/sliding.py`` (BASELINE.json config #4,
"sliding-window continuous skyline, count-based, high window overlap").

Skyline under deletion by bucket decomposition: a window of W tuples
sliding by S is K = W/S buckets; each bucket keeps the skyline of ITS OWN
tuples (computed once, when the bucket closes), and the window skyline is
the skyline of the union of the K bucket skylines — exact by the merge law.
Eviction is an overwrite of the oldest ring slot; no "resurrected" point is
ever re-examined because bucket skylines never pruned across buckets.

The K bucket skylines live on the device as a ``(K, C, d)`` ring (C = the
slide's power-of-two bucket, so the ring never grows). Each completed slide
is one step on the device: bucket-skyline the new rows (the chunked scan,
``ops/block_skyline.py``), write the ring slot, skyline the masked union of
the flat ring, compact survivors — only the count and the survivor rows
cross back to the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from skyline_tpu_torch.ops.block_skyline import skyline_mask_scan
from skyline_tpu_torch.ops.dispatch import skyline_of_np
from skyline_tpu_torch.ops.dominance import compact
from skyline_tpu_torch.utils.buckets import next_pow2
from skyline_tpu_torch.utils.devices import resolve_device, upload_async


def _slide_step(ring, ring_valid, slot: int, rows, rows_valid):
    """One slide: close the new bucket into ``slot`` (in place) and
    window-merge.

    ring (K, C, d), ring_valid (K, C), rows (C, d) padded, rows_valid (C,).
    Returns (sky (K*C, d), sky_valid, sky_count) with the window skyline
    compacted to the front of ``sky``, in the flat ring's slot order."""
    k, c, d = ring.shape
    bucket_keep = skyline_mask_scan(rows, rows_valid)
    bvals, bvalid, _ = compact(rows, bucket_keep, c)
    ring[slot] = bvals
    ring_valid[slot] = bvalid
    flat = ring.reshape(k * c, d)
    fvalid = ring_valid.reshape(k * c)
    wkeep = skyline_mask_scan(flat, fvalid)
    return compact(flat, wkeep, k * c)


class SlidingSkyline:
    """Continuous skyline over the last ``window_size`` tuples, emitting one
    result every ``slide`` tuples. ``window_size % slide == 0``. The ring
    lives on ``device``: the card unless the caller passes ``"cpu"``."""

    def __init__(self, window_size: int, slide: int, dims: int, device="cuda"):
        if window_size % slide != 0:
            raise ValueError(
                f"window_size {window_size} must be a multiple of slide {slide}"
            )
        self.device = resolve_device(device)
        self.window_size = window_size
        self.slide = slide
        self.dims = dims
        self.k = window_size // slide
        self._cap = next_pow2(slide, min_cap=128)
        self._ring = torch.full(
            (self.k, self._cap, dims), float("inf"), dtype=torch.float32, device=self.device
        )
        self._ring_valid = torch.zeros((self.k, self._cap), dtype=torch.bool, device=self.device)
        self._slot = 0
        self._buckets_closed = 0
        self._pending: list[np.ndarray] = []
        self._pending_rows = 0
        self._tuples_seen = 0
        self._last_sky: np.ndarray | None = None
        self.device_ns = 0

    def push(self, values: np.ndarray) -> list[dict]:
        """Feed a micro-batch; returns one result dict per completed slide:
        ``{"window_end": id, "skyline": (k, d) array, "window_filled": bool}``
        (window_filled is False while fewer than window_size tuples exist —
        the result then covers the partial window)."""
        out = []
        n = values.shape[0]
        pos = 0
        while pos < n:
            take = min(self.slide - self._pending_rows, n - pos)
            # copy: pending rows outlive this call and the caller may reuse
            # its batch buffer
            self._pending.append(np.array(values[pos : pos + take]))
            self._pending_rows += take
            pos += take
            self._tuples_seen += take
            if self._pending_rows == self.slide:
                out.append(self._close_bucket())
        return out

    def _close_bucket(self) -> dict:
        t0 = time.perf_counter_ns()
        rows = (
            self._pending[0]
            if len(self._pending) == 1
            else np.concatenate(self._pending, axis=0)
        )
        self._pending = []
        self._pending_rows = 0
        padded = np.full((self._cap, self.dims), np.inf, dtype=np.float32)
        padded[: rows.shape[0]] = rows
        rvalid = np.arange(self._cap) < rows.shape[0]
        sky, _, count = _slide_step(
            self._ring,
            self._ring_valid,
            self._slot,
            upload_async(padded, self.device),
            upload_async(rvalid, self.device),
        )
        self._slot = (self._slot + 1) % self.k
        self._buckets_closed += 1
        c = int(count)  # one sync; transfer only the survivors below
        result_sky = sky[:c].cpu().numpy()
        # private copy: the caller owns result_sky and may mutate it; the
        # cache must stay pristine for current_skyline reads
        self._last_sky = result_sky.copy()
        self.device_ns += time.perf_counter_ns() - t0
        return {
            "window_end": self._tuples_seen - 1,
            "skyline": result_sky,
            "window_filled": self._buckets_closed >= self.k,
        }

    @property
    def current_skyline(self) -> np.ndarray:
        """Skyline over the current (possibly partial) window, including
        pending rows not yet forming a full slide."""
        if not self._pending_rows and self._last_sky is not None:
            # nothing changed since the last slide closed: its compacted
            # window skyline is exactly current; copy so callers cannot
            # corrupt the cache
            return self._last_sky.copy()
        closed = min(self._buckets_closed, self.k)
        ring = self._ring[:closed].cpu().numpy()
        ring_valid = self._ring_valid[:closed].cpu().numpy()
        parts = [ring[s][ring_valid[s]] for s in range(closed)]
        if self._pending_rows:
            parts.append(np.concatenate(self._pending, axis=0))
        if not parts:
            return np.empty((0, self.dims), dtype=np.float32)
        return skyline_of_np(np.concatenate(parts, axis=0), self.dims, self.device)

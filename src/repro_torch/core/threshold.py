"""Target-drop-rate -> utility-threshold mapping (paper §IV-C, Eq. 16–17).

A sliding window of recent frame utilities approximates the utility CDF;
the threshold for target drop rate r is the smallest utility u_th with
CDF(u_th) >= r. The window is seeded from the training set and updated
online so the mapping tracks content drift.

Three forms of the same Eq. 17:

``threshold_from_sorted``
    The scalar definition on one sorted array (float64 Python index
    math) — ``UtilityCDF`` and the single-camera ``LoadShedder`` use it.

``thresholds_from_lanes_dev`` / ``thresholds_from_lanes_host``
    The camera-array form on ``(C, W)`` ring-buffer lanes: ONE batched
    masked sort + per-row quantile gather. The device version is torch
    on the session's device (CUDA or CPU); the host version is its
    bit-identical NumPy twin. Both compute the quantile index in *float32*
    (``ceil(f32(r) * f32(n))``), so the two are bitwise interchangeable;
    this can differ from the scalar float64 path by one rank only when
    ``r * n`` rounds across an integer in float32 — astronomically rare
    and bounded by one sample.

``thresholds_from_counts_dev`` / ``thresholds_from_counts_host``
    The O(bins) form on an incrementally-maintained ``(C, bins)``
    bucket-count histogram of the same window (the session carries the
    counts as checkpointed state and updates them with push/evict
    deltas inside the serve step). A tick is then one ``(C, bins)``
    cumsum + rank compare instead of a ``(C, W)`` sort. The returned
    threshold is the *upper edge* of the bucket holding the rank-k
    order statistic, so it always satisfies ``th >= exact_nextafter_th``
    (never sheds less than Eq. 17 asks) and, for utilities inside the
    configured ``[lo, hi)`` range, drifts by at most one bucket width.
    Out-of-range utilities clip into the edge buckets and only coarsen
    resolution there. Dev/host twins are bit-identical (same float32
    binning arithmetic, exact int32 counting).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Iterable, Optional

import numpy as np
import torch

# Per-thread scratch for the O(bins) host tick: the (C, bins) cumsum
# and rank-compare outputs are written into reused buffers (keyed by
# shape) instead of fresh allocations — this is the serving hot path,
# called every control tick. Thread-local so concurrent sessions in
# different threads never share a buffer.
_tick_scratch = threading.local()

_INF = float("inf")
_NEG_INF = float("-inf")


def _f32(x: float) -> float:
    """``x`` rounded to float32, so the tensor op that takes it as a
    scalar computes with the same constant as the float32 reference."""
    return float(np.float32(x))


def _scratch(shape, dtype) -> np.ndarray:
    cache = getattr(_tick_scratch, "bufs", None)
    if cache is None:
        cache = _tick_scratch.bufs = {}
    key = (shape, np.dtype(dtype).str)
    buf = cache.get(key)
    if buf is None:
        buf = cache[key] = np.empty(shape, dtype)
    return buf


def threshold_from_sorted(v: np.ndarray, r: float) -> float:
    """Eq. 17 on a sorted utility array: min u_th with CDF(u_th) >= r.

    The single definition of the quantile-index + nextafter formula —
    ``UtilityCDF`` (scalar, float64) and the session's per-camera lanes
    (float32 rows) both follow it, so they cannot drift apart. The
    threshold is the next representable value *in the array's dtype*
    above the r-quantile, dropping everything <= it; r <= 0 maps to
    -inf (shed nothing).
    """
    if len(v) == 0 or r <= 0.0:
        return float(-np.inf)
    idx = int(np.ceil(min(r, 1.0) * len(v))) - 1
    idx = max(0, min(idx, len(v) - 1))
    return float(np.nextafter(v[idx], np.asarray(np.inf, v.dtype)))


def thresholds_from_lanes_dev(cdf_buf, cdf_len, rates):
    """Batched Eq. 17 over camera lanes — ONE (C, W) sort on the lanes'
    device.

    cdf_buf: (C, W) float32 ring buffers (valid entries occupy slots
    [0, cdf_len) — the ring writes 0..W-1 before wrapping, and once
    wrapped every slot is live). cdf_len: (C,) int32. rates: (C,)
    float32 target drop rates. Returns (C,) float32 thresholds
    (-inf for empty windows or r <= 0).
    """
    C, W = cdf_buf.shape
    dev = cdf_buf.device
    n = cdf_len.to(torch.int32)
    live = torch.arange(W, dtype=torch.int32, device=dev)[None, :] < n[:, None]
    v = torch.sort(torch.where(live, cdf_buf, _INF), dim=-1).values
    r = rates.to(torch.float32)
    idx = (torch.ceil(torch.clamp_max(r, 1.0) * n.to(torch.float32))
           .to(torch.int32) - 1)
    idx = torch.minimum(torch.clamp_min(idx, 0), torch.clamp_min(n - 1, 0))
    q = torch.gather(v, 1, idx[:, None].to(torch.int64))[:, 0]
    th = torch.nextafter(q, torch.full_like(q, float("inf")))
    return torch.where((n == 0) | (r <= 0.0), _NEG_INF, th).to(torch.float32)


def thresholds_from_lanes_host(cdf_buf: np.ndarray, cdf_len: np.ndarray,
                               rates: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`thresholds_from_lanes_dev` (bit-identical:
    the r-quantile order statistic is the same value whether found by a
    full sort or a partial select). Uses ``np.partition`` per live row
    — O(W) selection instead of O(W log W) — and skips rows that map to
    -inf anyway (empty window or r <= 0, where Eq. 17 sheds nothing)."""
    C, W = cdf_buf.shape
    n = np.asarray(cdf_len, np.int32)
    r = np.asarray(rates, np.float32)
    idx = (np.ceil(np.minimum(r, np.float32(1.0))
                   * n.astype(np.float32)).astype(np.int32) - 1)
    idx = np.clip(idx, 0, np.maximum(n - 1, 0))
    th = np.full((C,), -np.inf, np.float32)
    for c in np.flatnonzero((n > 0) & (r > 0.0)):
        k = int(idx[c])
        th[c] = np.nextafter(
            np.partition(cdf_buf[c, :n[c]], k)[k], np.float32(np.inf))
    return th


def bucket_index_dev(u, lo: float, inv_width: float, bins: int):
    """Map utilities to bucket indices: ``clip(floor((u - lo) * B/(hi-lo)),
    0, B-1)``. Float32 arithmetic so the host twin is bit-identical."""
    b = torch.floor((u.to(torch.float32) - _f32(lo)) * _f32(inv_width))
    return torch.clamp(b.to(torch.int32), 0, bins - 1)


def bucket_index_host(u, lo: float, inv_width: float, bins: int):
    """NumPy twin of :func:`bucket_index_dev` (same f32 ops bit-for-bit)."""
    b = np.floor((np.asarray(u, np.float32) - np.float32(lo))
                 * np.float32(inv_width))
    return np.clip(b.astype(np.int32), 0, bins - 1)


def counts_from_ring_host(buf: np.ndarray, ln: np.ndarray, lo: float,
                          inv_width: float, bins: int) -> np.ndarray:
    """Recount a ``(C, W)`` ring's live entries (slots ``[0, len)``) into
    ``(C, bins)`` int32 bucket counts — the ground truth the session's
    incremental maintenance must always equal (property-tested)."""
    C, _ = buf.shape
    counts = np.zeros((C, bins), np.int32)
    for c in range(C):
        n = int(ln[c])
        if n:
            np.add.at(counts[c], bucket_index_host(buf[c, :n], lo,
                                                   inv_width, bins), 1)
    return counts


def thresholds_from_counts_dev(counts, cdf_len, rates, lo: float,
                               width: float):
    """O(bins) Eq. 17 over incremental bucket counts — no (C, W) sort.

    counts: (C, bins) int32 live-entry histogram of the CDF window.
    cdf_len: (C,) int32 live window lengths (== counts.sum(-1)).
    rates: (C,) float32 target drop rates. Returns (C,) float32
    thresholds: the upper edge of the bucket containing the rank-k
    order statistic, where k is exactly the Eq. 17 float32 rank
    (``clip(ceil(min(r,1) * f32(n)), 1, n)`` — the same index the sort
    path gathers). -inf for empty windows or r <= 0.
    """
    C, B = counts.shape
    n = cdf_len.to(torch.int32)
    r = rates.to(torch.float32)
    k = torch.ceil(torch.clamp_max(r, 1.0) * n.to(torch.float32)).to(torch.int32)
    k = torch.minimum(torch.clamp_min(k, 1), torch.clamp_min(n, 1))
    cum = torch.cumsum(counts, dim=-1)
    b = torch.clamp_max((cum < k[:, None]).sum(dim=-1), B - 1).to(torch.int32)
    th = _f32(lo) + (b + 1).to(torch.float32) * _f32(width)
    return torch.where((n == 0) | (r <= 0.0), _NEG_INF, th).to(torch.float32)


def thresholds_from_counts_host(counts: np.ndarray, cdf_len: np.ndarray,
                                rates: np.ndarray, lo: float,
                                width: float) -> np.ndarray:
    """NumPy twin of :func:`thresholds_from_counts_dev` (bit-identical:
    integer rank compare + the same f32 edge arithmetic)."""
    C, B = counts.shape
    n = np.asarray(cdf_len, np.int32)
    r = np.asarray(rates, np.float32)
    k = np.ceil(np.minimum(r, np.float32(1.0))
                * n.astype(np.float32)).astype(np.int32)
    k = np.clip(k, 1, np.maximum(n, 1))
    cum = np.cumsum(counts, axis=-1, out=_scratch((C, B), counts.dtype))
    below = np.less(cum, k[:, None], out=_scratch((C, B), bool))
    b = np.minimum(below.sum(axis=-1).astype(np.int32), B - 1)
    th = np.float32(lo) + (b + 1).astype(np.float32) * np.float32(width)
    th[(n == 0) | (r <= 0.0)] = -np.inf
    return th


class UtilityCDF:
    def __init__(self, history: Optional[Iterable[float]] = None,
                 window: int = 4096):
        self._buf = deque(maxlen=window)
        if history is not None:
            self.update(history)
        self._sorted: Optional[np.ndarray] = None

    def __len__(self):
        return len(self._buf)

    def update(self, utilities):
        if hasattr(utilities, "__next__"):      # consume generators once
            utilities = list(utilities)
        us = np.atleast_1d(np.asarray(utilities, np.float64)).reshape(-1)
        w = self._buf.maxlen
        if w is not None and us.size > w:     # only the tail can survive
            us = us[-w:]
        self._buf.extend(us.tolist())
        self._sorted = None

    def _view(self) -> np.ndarray:
        if self._sorted is None:
            self._sorted = np.sort(np.asarray(self._buf, np.float64))
        return self._sorted

    def cdf(self, u: float) -> float:
        """Eq. 16: fraction of history with utility <= u."""
        v = self._view()
        if len(v) == 0:
            return 0.0
        return float(np.searchsorted(v, u, side="right")) / len(v)

    def threshold_for_drop_rate(self, r: float) -> float:
        """Eq. 17: min u_th such that CDF(u_th) >= r.

        The shedder drops frames with utility < u_th, so r=0 maps to
        -inf (shed nothing).
        """
        return threshold_from_sorted(self._view(), r)

    def observed_drop_rate(self, u_th: float) -> float:
        """Fraction of history that would be dropped at threshold u_th."""
        v = self._view()
        if len(v) == 0:
            return 0.0
        return float(np.searchsorted(v, u_th, side="left")) / len(v)


__all__ = ["UtilityCDF", "threshold_from_sorted",
           "thresholds_from_lanes_dev", "thresholds_from_lanes_host",
           "thresholds_from_counts_dev", "thresholds_from_counts_host",
           "bucket_index_dev", "bucket_index_host", "counts_from_ring_host"]

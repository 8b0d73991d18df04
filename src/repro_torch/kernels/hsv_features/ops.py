"""Public wrappers around the HSV kernels.

``frame_pf`` / ``batch_pf`` are the staged entry point for callers that
bring their own background model: RGB frames plus a precomputed
foreground mask go through the histogram kernel (``kernel.hsv_hist_batch``,
one call for a whole batch) and come back as PF matrices and hue
fractions.

``ingest_pipeline`` is the camera-side hot path: a ``(T, H, W, 3)`` RGB
frame batch — or a whole camera array ``(C, T, H, W, 3)`` — goes through
the fused ingest once and comes back as PF matrices, hue fractions and
(when a trained model is supplied) utility scores, with the per-camera
background-subtraction state ``IngestState`` carried explicitly across
calls (chunked streaming scores identically to one long batch).

Every call goes through ``kernel.hsv_hist_batch`` or
``kernel.ingest_batch``, which launch the CUDA kernel for a CUDA tensor
and run the plain PyTorch version for a CPU one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.colors import Color
from repro_torch.core.utility import B_S, B_V, UtilityModel
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.hsv_features.kernel import (
    hsv_hist_batch,
    ingest_batch,
)
from repro_torch.kernels.hsv_features.ref import pf_from_counts


def _as_tensor(x, device: DeviceLike) -> torch.Tensor:
    """A tensor is used where it lies; a numpy array is moved to
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def batch_pf(rgb, fg, colors: Sequence[Color], bs: int = B_S, bv: int = B_V,
             device: DeviceLike = None):
    """(T, H, W, 3) RGB + (T, H, W) foreground -> (pf (T, nc, bs, bv),
    hf (T, nc)) through ONE histogram kernel call for all T frames.

    fg is a bool mask (the documented type; counted exactly) or float
    weights. A numpy input is moved to ``device``, a tensor is used where
    it lies."""
    rgb = _as_tensor(rgb, device).to(torch.float32)
    fg = _as_tensor(fg, rgb.device)
    if fg.dtype != torch.bool:
        fg = fg.to(torch.float32)
    if fg.device != rgb.device:
        raise ValueError(f"fg on {fg.device}, rgb on {rgb.device}")
    T = rgb.shape[0]
    n = rgb.shape[1] * rgb.shape[2]
    hue_ranges = tuple(tuple(c.hue_ranges) for c in colors)
    counts, totals, fgtot = hsv_hist_batch(
        rgb.reshape(T, n, 3).contiguous(), fg.reshape(T, n).contiguous(),
        hue_ranges, bs, bv)
    pf = pf_from_counts(counts, totals, bs, bv)
    hf = totals / torch.clamp_min(fgtot, 1.0)[:, None]
    return pf, hf


def frame_pf(rgb, fg, colors: Sequence[Color], bs: int = B_S, bv: int = B_V,
             device: DeviceLike = None):
    """One frame -> (pf (nc, bs, bv), hue_fraction (nc,)).

    rgb: (H, W, 3) float32 (0..255); fg: (H, W) bool (or float weights).
    """
    pf, hf = batch_pf(rgb[None], fg[None], colors, bs, bv, device=device)
    return pf[0], hf[0]


@dataclass(frozen=True)
class IngestState:
    """Background-model state carried across ingest batches.

    Single-camera states are ``bg (N,), gain ()``; a camera array
    carries one state lane per camera: ``bg (C, N), gain (C,)``.
    """
    bg: torch.Tensor          # (N,) / (C, N) Value-channel background
    gain: torch.Tensor        # () / (C,) illumination gain estimate

    @property
    def num_cameras(self) -> Optional[int]:
        """Camera-lane count, or None for a single-camera state."""
        return self.bg.shape[0] if self.bg.ndim == 2 else None


def ingest_core(rgb, bg0, gain0, M_pos, norm, *, hue_ranges, bs, bv,
                alpha, threshold, use_fg, bg_valid, op, width: int = 0):
    """Fused ingest on flattened frames through ``kernel.ingest_batch``
    (the CUDA kernel on a CUDA tensor, the plain version on the CPU).

    rgb: (T, N, 3) or (C, T, N, 3) float32. Returns the kernel tuple
    (counts, totals, fg_total, utility, bg, gain); ``width > 0`` appends
    the per-frame foreground bounding box.
    """
    return ingest_batch(rgb, bg0, gain0, M_pos, norm, hue_ranges, bs, bv,
                        alpha=alpha, threshold=threshold, use_fg=use_fg,
                        bg_valid=bg_valid, op=op, width=width)


def query_constants(model, nc: int, bs: int, bv: int, op: Optional[str],
                    device: DeviceLike = None):
    """Resolve the (M_pos, norm, op) constants a shedder runs with on
    ``device``: the trained model's matrices and composition op when
    present, inert zeros/ones (utilities identically 0) otherwise.
    """
    dev = resolve_device(device)
    if model is not None:
        M_pos = torch.as_tensor(np.asarray(model.M_pos, np.float32),
                                device=dev).reshape(nc, bs * bv)
        norm = torch.as_tensor(np.asarray(model.norm, np.float32), device=dev)
        # the trained model defines how per-color utilities compose; a
        # caller-supplied op (e.g. the label op) must not override it
        op = model.op
    else:
        M_pos = torch.zeros((nc, bs * bv), dtype=torch.float32, device=dev)
        norm = torch.ones((nc,), dtype=torch.float32, device=dev)
        op = op or "or"
    if op == "single":
        op = "or"
    if op not in ("or", "and"):
        raise ValueError(f"unknown composition op {op!r}")
    return M_pos.contiguous(), norm.contiguous(), op


def ingest_pipeline(rgb, colors: Sequence[Color],
                    model: Optional[UtilityModel] = None, *,
                    state: Optional[IngestState] = None,
                    alpha: float = 0.05, threshold: float = 18.0,
                    use_foreground: bool = True, op: Optional[str] = None,
                    bs: int = B_S, bv: int = B_V,
                    with_bbox: bool = False, device: DeviceLike = None):
    """Fused ingest for one frame batch.

    rgb: (T, H, W, 3) float32 RGB in [0, 255], or (C, T, H, W, 3) for a
    C-camera array (state then carries per-camera ``(bg, gain)`` lanes);
    a numpy array is moved to ``device``, a tensor is used where it lies.
    Returns (pf (T, nc, bs, bv), hf (T, nc), util (T,) | None, state'),
    each with a leading camera lane iff the input had one. ``util`` is
    None when no trained ``model`` is supplied. ``with_bbox=True``
    appends the per-frame foreground bounding box (``(T, 4)`` int32,
    all -1 when the mask is empty).
    """
    if isinstance(rgb, torch.Tensor):
        rgb = rgb.to(torch.float32)
    else:
        rgb = torch.as_tensor(np.asarray(rgb, np.float32),
                              device=resolve_device(device))
    dev = rgb.device
    hue_ranges = tuple(tuple(c.hue_ranges) for c in colors)
    nc = len(hue_ranges)
    has_cams = rgb.ndim == 5
    lead = rgb.shape[:2] if has_cams else rgb.shape[:1]
    n = rgb.shape[-3] * rgb.shape[-2]
    width = int(rgb.shape[-2]) if with_bbox else 0
    rgb_flat = rgb.reshape(*lead, n, 3).contiguous()
    bg_shape = (lead[0], n) if has_cams else (n,)

    bg_valid = state is not None
    bg0 = (state.bg.to(dev, torch.float32).contiguous() if bg_valid
           else torch.zeros(bg_shape, dtype=torch.float32, device=dev))
    gain0 = (state.gain.to(dev, torch.float32) if bg_valid
             else torch.ones(bg_shape[:-1], dtype=torch.float32, device=dev))

    M_pos, norm, op = query_constants(model, nc, bs, bv, op, device=dev)
    res = ingest_core(
        rgb_flat, bg0, gain0, M_pos, norm, hue_ranges=hue_ranges, bs=bs,
        bv=bv, alpha=alpha, threshold=threshold, use_fg=use_foreground,
        bg_valid=bg_valid, op=op, width=width)
    counts, totals, fgtot, util, bg, gain = res[:6]

    pf = pf_from_counts(counts, totals, bs, bv)
    hf = totals / torch.clamp_min(fgtot, 1.0)[..., None]
    new_state = IngestState(bg=bg, gain=gain)
    out = (pf, hf, (util if model is not None else None), new_state)
    if with_bbox:
        return out + (res[6],)
    return out


__all__ = ["frame_pf", "batch_pf", "ingest_pipeline", "ingest_core", "query_constants",
           "IngestState"]

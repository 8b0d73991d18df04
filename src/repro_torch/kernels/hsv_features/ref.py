"""Plain PyTorch versions of the HSV kernels.

``hsv_hist_ref`` computes what the CUDA kernel ``kernel.hsv_hist`` /
``kernel.hsv_hist_batch`` computes: RGB->HSV, per-color hue masks times a
precomputed foreground weight, and a scatter-add over the joint
(sat, val) bin index.

``ingest_batch_ref`` computes what the CUDA kernel
``kernel.ingest_batch`` computes, op for op in float32: RGB->HSV, EMA
background subtraction with one-frame-lagged mean-gain illumination
compensation (a Python loop over frames carries the ``(bg, gain)``
state), per-color PF histograms, the utility score and, with
``width > 0``, the per-frame foreground bounding box. A ``(C, T, N, 3)``
camera array carries one ``(bg, gain)`` lane per camera.

They are the CPU path of the port and the versions the kernels are held
to on the card. Pass ``(bg, gain)`` from one batch to the next and a chunked
stream scores identically to one long batch.
"""
from __future__ import annotations

import torch

from repro_torch.core.colors import rgb_to_hsv
from repro_torch.core.utility import B_S, B_V, joint_bin_index
from repro_torch.data.background import GAIN_MAX, GAIN_MIN


def color_masks(h: torch.Tensor, hue_ranges) -> torch.Tensor:
    """(nc, ...) bool hue masks."""
    ms = []
    for ranges in hue_ranges:
        m = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
        for lo, hi in ranges:
            m |= (h >= lo) & (h < hi)
        ms.append(m)
    return torch.stack(ms)


def hsv_hist_ref(rgb, fg, hue_ranges, bs: int = B_S, bv: int = B_V):
    """rgb: (N, 3) float32 in [0, 255]; fg: (N,) bool mask or float
    weights — or a batch, (T, N, 3) and (T, N). hue_ranges: one tuple of
    (lo, hi) per color.

    Returns (counts (nc, bs*bv), totals (nc,), fg_total ()) float32, each
    with a leading frame axis for a batch.
    """
    hsv = rgb_to_hsv(rgb)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    fgf = fg.to(torch.float32)
    joint = joint_bin_index(s, v, bs, bv)
    weights = color_masks(h, hue_ranges).to(torch.float32) * fgf[None]
    counts = masked_hist(joint, weights, bs * bv)      # (..., nc, nb)
    totals = torch.movedim(weights.sum(dim=-1), 0, -1)
    return counts, totals, fgf.sum(dim=-1)


def pf_from_counts(counts, totals, bs: int = B_S, bv: int = B_V):
    pf = counts / torch.clamp_min(totals[..., None], 1.0)
    return pf.reshape(*counts.shape[:-1], bs, bv)


def ema_background_scan(v_frames, bg0, gain0, *, alpha=0.05, threshold=18.0,
                        bg_valid=True):
    """The kernel's background recurrence, one frame at a time.

    v_frames: (..., T, N) Value channel; bg0 (..., N); gain0 (...) or a
    scalar. Returns (fg (..., T, N) bool, bg (..., N), gain (...)).
    With ``bg_valid=False`` frame 0 seeds the background (yielding an
    all-background mask), like the host model's first call.
    """
    v_frames = v_frames.to(torch.float32)
    bg = (v_frames[..., 0, :] if not bg_valid else bg0).to(torch.float32)
    gain = torch.as_tensor(gain0, dtype=torch.float32,
                           device=v_frames.device).expand(bg.shape[:-1])
    fgs = []
    for t in range(v_frames.shape[-2]):
        v = v_frames[..., t, :]
        g = torch.clamp(gain, GAIN_MIN, GAIN_MAX)
        comp = v / g[..., None]
        fgs.append(torch.abs(comp - bg) > threshold)
        new_bg = (1.0 - alpha) * bg + alpha * comp
        gain = torch.clamp(v.sum(dim=-1) / torch.clamp_min(bg.sum(dim=-1),
                                                           1e-6),
                           GAIN_MIN, GAIN_MAX)
        bg = new_bg
    return torch.stack(fgs, dim=-2), bg, gain


def masked_hist(joint, weights, nb: int):
    """Per-(row, color) histograms by scatter-add.

    joint: (..., N) bin indices; weights: (nc, ..., N) hue mask x
    foreground weight. Returns counts (..., nc, nb) float32: sums of 0/1
    below 2**24 are exact in any order.
    """
    idx = joint.to(torch.int64).unsqueeze(0).expand(weights.shape)
    counts = torch.zeros((*weights.shape[:-1], nb), dtype=torch.float32,
                         device=weights.device)
    counts.scatter_add_(-1, idx, weights.to(torch.float32))
    return torch.movedim(counts, 0, -2)


def foreground_bbox(fgf, width: int):
    """Per-frame bounding box of the foreground mask, over flattened
    pixels.

    fgf: (..., N) {0, 1} foreground weights; ``width`` is the frame's
    pixel-row stride (N = H * W). Returns (..., 4) int32
    ``(row_min, row_max, col_min, col_max)`` — inclusive bounds — or
    all ``-1`` for frames with no foreground.
    """
    n = fgf.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=fgf.device)
    rows = idx // width
    cols = idx % width
    on = fgf > 0
    big = torch.tensor(n, dtype=torch.int32, device=fgf.device)
    neg = torch.tensor(-1, dtype=torch.int32, device=fgf.device)
    rmin = torch.where(on, rows, big).amin(dim=-1)
    rmax = torch.where(on, rows, neg).amax(dim=-1)
    cmin = torch.where(on, cols, big).amin(dim=-1)
    cmax = torch.where(on, cols, neg).amax(dim=-1)
    bbox = torch.stack([rmin, rmax, cmin, cmax], dim=-1).to(torch.int32)
    empty = ~on.any(dim=-1)
    return torch.where(empty[..., None], neg, bbox)


def ingest_batch_ref(rgb, bg0, gain0, M_pos, norm, hue_ranges,
                     bs: int = B_S, bv: int = B_V, *, alpha: float = 0.05,
                     threshold: float = 18.0, use_fg: bool = True,
                     bg_valid: bool = True, op: str = "or",
                     width: int = 0):
    """Plain version of ``kernel.ingest_batch`` (same signature/returns).

    rgb: (T, N, 3) float32, or (C, T, N, 3) with bg0 (C, N) and
    gain0 (C,) or a scalar. Returns (counts (T, nc, bs*bv), totals
    (T, nc), fg_total (T,), utility (T,), bg (N,), gain ()) — each with
    a leading camera lane iff the input had one; ``width > 0`` appends
    the per-frame foreground bounding box (T, 4) int32.
    """
    has_cams = rgb.ndim == 4
    if not has_cams:
        rgb, bg0 = rgb[None], bg0[None]
    C = rgb.shape[0]
    dev = rgb.device
    gain0 = torch.as_tensor(gain0, dtype=torch.float32,
                            device=dev).reshape(-1).expand(C)

    hsv = rgb_to_hsv(rgb)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]      # (C, T, N)
    fg, bg, gain = ema_background_scan(v, bg0, gain0, alpha=alpha,
                                       threshold=threshold, bg_valid=bg_valid)
    fgf = fg.to(torch.float32) if use_fg else torch.ones_like(v)

    joint = joint_bin_index(s, v, bs, bv)                # (C, T, N)
    weights = color_masks(h, hue_ranges).to(torch.float32) * fgf[None]

    counts = masked_hist(joint, weights, bs * bv)        # (C, T, nc, nb)
    totals = torch.movedim(weights.sum(dim=-1), 0, -1)   # (C, T, nc)
    fgtot = fgf.sum(dim=-1)                              # (C, T)

    M_pos = torch.as_tensor(M_pos, dtype=torch.float32, device=dev)
    norm = torch.as_tensor(norm, dtype=torch.float32, device=dev)
    pf = counts / torch.clamp_min(totals, 1.0)[..., None]
    u = (pf * M_pos).sum(dim=-1) / torch.clamp_min(norm, 1e-9)
    util = u.amin(dim=-1) if op == "and" else u.amax(dim=-1)
    out = [counts, totals, fgtot, util, bg, gain]
    if width:
        out.append(foreground_bbox(fgf, int(width)))     # (C, T, 4)
    if has_cams:
        return tuple(out)
    return tuple(o[0] for o in out)


__all__ = ["color_masks", "hsv_hist_ref", "pf_from_counts", "ema_background_scan",
           "masked_hist", "foreground_bbox", "ingest_batch_ref"]

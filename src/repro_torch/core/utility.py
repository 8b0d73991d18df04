"""Per-frame utility function (paper §IV-B, Eq. 6–15).

Pipeline: HSV pixels (+ foreground mask) -> per-color pixel-fraction
matrix PF_C (Eq. 10) -> utility U_C = <M_C,+ve, PF_C> (Eq. 14), where
M_C,+ve is the mean PF over positive training frames (Eq. 12).
Composite queries compose *normalized* per-color utilities: OR -> max,
AND -> min (Eq. 15).

The batched PF computation has a CUDA kernel
(`repro_torch.kernels.hsv_features`); this module is the plain PyTorch
form and the training/runtime logic around it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.colors import Color, hue_mask
from repro_torch.device import DeviceLike, resolve_device

B_S = 8   # saturation bins (paper §V-B: 8x8, bin size 32)
B_V = 8   # value bins


def joint_bin_index(s: torch.Tensor, v: torch.Tensor, bs: int = B_S,
                    bv: int = B_V) -> torch.Tensor:
    """Joint (sat, val) bin index in [0, bs*bv), int32. The scaled
    float32 value is truncated toward zero to int32 and then clipped,
    as the reference does; the CUDA kernel repeats this formula."""
    sb = torch.clamp((s * (bs / 256.0)).to(torch.int32), 0, bs - 1)
    vb = torch.clamp((v * (bv / 256.0)).to(torch.int32), 0, bv - 1)
    return sb * bv + vb


def pixel_fraction_matrix(hsv: torch.Tensor, color: Color, fg_mask=None,
                          bs: int = B_S, bv: int = B_V) -> torch.Tensor:
    """Eq. 9–11: PF matrix for one frame (or batch, leading dims kept).

    hsv: (..., H, W, 3) with channels (hue, sat, val).
    Returns (..., bs, bv) float32; rows sum to 1 where the frame has any
    color pixels, all-zero otherwise. The histogram is a scatter-add over
    the joint bin index: no (H, W, bs*bv) one-hot is materialized.
    """
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    m = hue_mask(h, color)
    if fg_mask is not None:
        m = m & fg_mask
    joint = joint_bin_index(s, v, bs, bv)
    lead = joint.shape[:-2]
    npix = joint.shape[-2] * joint.shape[-1]
    w = m.to(torch.float32).reshape(-1, npix)
    counts = torch.zeros((w.shape[0], bs * bv), dtype=torch.float32,
                         device=hsv.device)
    counts.scatter_add_(1, joint.reshape(-1, npix).to(torch.int64), w)
    total = w.sum(dim=1)
    pf = counts / torch.clamp_min(total, 1.0)[:, None]
    return pf.reshape(*lead, bs, bv)


# ---------------------------------------------------------------------------
# Utility model: training (Eq. 12–13) and scoring (Eq. 14–15)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class UtilityModel:
    colors: Tuple[Color, ...]
    M_pos: np.ndarray        # (n_colors, bs, bv) — Eq. 12
    M_neg: np.ndarray        # (n_colors, bs, bv) — Eq. 13 (analysis only)
    norm: np.ndarray         # (n_colors,) max train utility per color
    op: str = "single"       # single | or | and

    def score(self, pf: torch.Tensor) -> torch.Tensor:
        """pf: (..., n_colors, bs, bv) tensor -> utility (...,). Eq. 14–15."""
        if self.op not in ("single", "or", "and"):
            raise ValueError(self.op)
        return _score(pf.to(torch.float32),
                      torch.as_tensor(self.M_pos, dtype=torch.float32,
                                      device=pf.device),
                      torch.as_tensor(self.norm, dtype=torch.float32,
                                      device=pf.device), self.op)


def _score(pfs, M_pos, norm, op):
    u = (pfs * M_pos).sum(dim=(-2, -1)) / torch.clamp_min(norm, 1e-9)
    return u.amin(dim=-1) if op == "and" else u.amax(dim=-1)


def batch_utilities(model: UtilityModel, pfs, device: DeviceLike = None
                    ) -> np.ndarray:
    """Score a stack of PF matrices (N, n_colors, bs, bv) in one batched
    call on ``device``; returns a float32 numpy array."""
    if model.op not in ("single", "or", "and"):
        raise ValueError(model.op)
    dev = resolve_device(device)
    pfs = torch.as_tensor(np.asarray(pfs, np.float32), device=dev)
    return _score(pfs, torch.as_tensor(model.M_pos, dtype=torch.float32,
                                       device=dev),
                  torch.as_tensor(model.norm, dtype=torch.float32,
                                  device=dev), model.op).cpu().numpy()


def train_utility_model(pfs, labels, colors: Sequence[Color],
                        op: str = "single") -> UtilityModel:
    """pfs: (N, n_colors, bs, bv); labels: (N,) in {0,1}.

    For composite queries the paper trains each color's function on its
    own positives; here labels may be (N, n_colors) per-color or (N,)
    shared.
    """
    pfs = np.asarray(pfs, np.float32)
    labels = np.asarray(labels)
    nc = len(colors)
    if labels.ndim == 1:
        labels = np.repeat(labels[:, None], nc, axis=1)
    M_pos = np.zeros((nc,) + pfs.shape[-2:], np.float32)
    M_neg = np.zeros_like(M_pos)
    norm = np.zeros((nc,), np.float32)
    for ci in range(nc):
        pos = labels[:, ci] > 0
        if pos.any():
            M_pos[ci] = pfs[pos, ci].mean(axis=0)
        if (~pos).any():
            M_neg[ci] = pfs[~pos, ci].mean(axis=0)
        u_train = np.sum(pfs[:, ci] * M_pos[ci], axis=(-2, -1))
        norm[ci] = float(u_train.max()) if len(u_train) else 1.0
    return UtilityModel(tuple(colors), M_pos, M_neg, norm,
                        op if nc > 1 else "single")


__all__ = ["B_S", "B_V", "joint_bin_index", "pixel_fraction_matrix",
           "UtilityModel", "batch_utilities", "train_utility_model"]

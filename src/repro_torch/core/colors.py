"""Color definitions and HSV conversion (paper §IV-B1).

Conventions follow the paper (OpenCV-style): Hue in [0, 180), Saturation
and Value in [0, 256). A query color is a union of hue ranges, e.g. RED
is [0,10) ∪ [170,180).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Color:
    name: str
    hue_ranges: Tuple[Tuple[int, int], ...]   # [lo, hi) in [0, 180)


RED = Color("red", ((0, 10), (170, 180)))
YELLOW = Color("yellow", ((20, 35),))
BLUE = Color("blue", ((100, 130),))
GREEN = Color("green", ((40, 80),))

COLORS = {c.name: c for c in (RED, YELLOW, BLUE, GREEN)}


def hue_mask(hue: torch.Tensor, color: Color) -> torch.Tensor:
    """hue: tensor in [0,180). Returns bool mask of pixels in the color."""
    m = torch.zeros(hue.shape, dtype=torch.bool, device=hue.device)
    for lo, hi in color.hue_ranges:
        m = m | ((hue >= lo) & (hue < hi))
    return m


def floor_mod6(x: torch.Tensor) -> torch.Tensor:
    """``x % 6.0`` with the sign of the divisor, computed as JAX does:
    ``fmod`` then ``+6`` where the remainder is non-zero and negative
    (``fmod`` alone keeps the dividend's sign). The CUDA kernel writes
    the same two steps."""
    m = torch.fmod(x, 6.0)
    return torch.where((m != 0) & (m < 0), m + 6.0, m)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """Float RGB (..., 3) in [0, 255] -> HSV (..., 3), H in [0,180),
    S and V in [0,256); float32, op for op the reference's formula."""
    rgb = rgb.to(torch.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    c = v - torch.minimum(torch.minimum(r, g), b)
    s = torch.where(v > 0, c / torch.clamp_min(v, 1e-9) * 255.0,
                    torch.zeros_like(v))
    hc = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(v == r, floor_mod6((g - b) / hc),
                    torch.where(v == g, (b - r) / hc + 2.0,
                                (r - g) / hc + 4.0))
    h = torch.where(c > 0, h * 30.0, torch.zeros_like(h))
    return torch.stack([h, s, v], dim=-1)


def rgb_to_hsv_np(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB (..., 3) -> HSV with H in [0,180), S,V in [0,256) (uint8-ish float32)."""
    rgb = rgb.astype(np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.max(rgb, axis=-1)
    c = v - np.min(rgb, axis=-1)
    s = np.where(v > 0, c / np.maximum(v, 1e-9) * 255.0, 0.0)
    # hue in degrees [0, 360)
    hc = np.where(c > 0, c, 1.0)
    h = np.where(v == r, (g - b) / hc % 6.0,
                 np.where(v == g, (b - r) / hc + 2.0, (r - g) / hc + 4.0))
    h = np.where(c > 0, h * 30.0, 0.0)          # 60 deg -> 30 "OpenCV" units
    return np.stack([h, s, v], axis=-1)


def hsv_to_rgb_np(hsv: np.ndarray) -> np.ndarray:
    """HSV (H in [0,180), S,V in [0,256)) -> uint8 RGB."""
    h = hsv[..., 0] * 2.0                        # degrees
    s = hsv[..., 1] / 255.0
    v = hsv[..., 2]
    c = v * s
    hp = h / 60.0
    x = c * (1 - np.abs(hp % 2 - 1))
    z = np.zeros_like(c)
    conds = [hp < 1, hp < 2, hp < 3, hp < 4, hp < 5, hp >= 5]
    rgbs = [(c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c), (c, z, x)]
    r = np.select(conds, [t[0] for t in rgbs])
    g = np.select(conds, [t[1] for t in rgbs])
    b = np.select(conds, [t[2] for t in rgbs])
    m = v - c
    rgb = np.stack([r + m, g + m, b + m], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)

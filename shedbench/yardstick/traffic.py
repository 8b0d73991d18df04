"""Frozen traffic generator: procedural city-camera scenes.

A copy of ``generate_scenario`` and its helpers from
``src/repro_torch/data/synthetic.py`` and of ``hsv_to_rgb_np`` from
``src/repro_torch/core/colors.py``, both at commit b67978d. The benchmark
keeps its own copy so that a change to the program cannot change the
traffic it is measured on. Only the imports and this docstring differ
from the originals; ``combined_label`` is copied too, for the utility
model's training labels.

Each camera is a seeded scenario: moving coloured vehicles over a static
background with hue-overlapping low-saturation clutter, shadows,
illumination drift and sensor noise, rendered as HSV and converted to
uint8 RGB.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


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


# Palette: name -> (hue center, hue spread, sat range, val range, is-vivid)
VEHICLE_PALETTE = {
    "red": (4.0, 3.0, (200, 252), (150, 235)),
    "yellow": (27.0, 3.0, (200, 252), (160, 240)),
    "blue": (112.0, 6.0, (180, 245), (120, 225)),
    "white": (20.0, 10.0, (0, 28), (200, 250)),
    "gray": (90.0, 40.0, (0, 35), (70, 150)),
    "black": (90.0, 40.0, (0, 50), (10, 55)),
}
# clutter sharing hue with targets but low/spread sat and val (brown
# walls, dust, haze) — overlaps in hue, separable in S/V
CLUTTER_FOR = {
    "red": (5.0, 4.0, (20, 130), (40, 160)),       # brownish
    "yellow": (28.0, 4.0, (20, 120), (50, 170)),   # dusty
    "blue": (110.0, 8.0, (20, 100), (100, 210)),   # hazy sky
}


@dataclass
class Vehicle:
    color_name: str
    obj_id: int
    t_enter: int
    t_exit: int
    y: int
    h: int
    w: int
    speed: float       # px / frame (signed)
    x0: float
    hue: float
    sat: int
    val: int


@dataclass
class VideoScenario:
    """One camera's 'recording'."""
    frames_hsv: np.ndarray            # (T, H, W, 3) float32 HSV
    labels: dict                      # color name -> (T,) bool
    objects: dict                     # color name -> list[set[int]] per frame
    busy: np.ndarray                  # (T,) bool — any big vehicle blob
    meta: dict = field(default_factory=dict)

    @property
    def num_frames(self):
        return self.frames_hsv.shape[0]

    def frames_rgb(self) -> np.ndarray:
        return hsv_to_rgb_np(self.frames_hsv)


def _base_background(rng, T, H, W, clutter_colors: Sequence[str],
                     clutter_density: float):
    """Static background with hue-overlapping low-sat clutter + road."""
    hue = rng.uniform(60, 100, (H, W)).astype(np.float32)     # greenish-gray
    sat = rng.uniform(10, 60, (H, W)).astype(np.float32)
    val = rng.uniform(90, 170, (H, W)).astype(np.float32)
    # road band
    road_top = int(H * 0.55)
    sat[road_top:] = rng.uniform(0, 25, (H - road_top, W))
    val[road_top:] = rng.uniform(60, 110, (H - road_top, W))
    # clutter patches (buildings etc.) sharing target hues at low sat/val
    n_patch = int(clutter_density * 12)
    for cname in clutter_colors:
        if cname not in CLUTTER_FOR:
            continue
        hc, hs, (slo, shi), (vlo, vhi) = CLUTTER_FOR[cname]
        for _ in range(n_patch):
            ph, pw = rng.integers(H // 8, H // 3), rng.integers(W // 10, W // 3)
            py, px = rng.integers(0, road_top), rng.integers(0, W - pw)
            hue[py:py + ph, px:px + pw] = np.clip(
                rng.normal(hc, hs, (min(ph, H - py), pw)), 0, 179.9)
            sat[py:py + ph, px:px + pw] = rng.uniform(slo, shi, (min(ph, H - py), pw))
            val[py:py + ph, px:px + pw] = rng.uniform(vlo, vhi, (min(ph, H - py), pw))
    return np.stack([hue, sat, val], axis=-1)


def _spawn_vehicles(rng, T, H, W, color_mix: dict, rate: float,
                    next_id: int, scale=1.0) -> Tuple[List[Vehicle], int]:
    vehicles = []
    names = list(color_mix)
    probs = np.asarray([color_mix[n] for n in names], np.float64)
    probs = probs / probs.sum()
    road_top = int(H * 0.58)
    t = 0
    while t < T:
        gap = rng.geometric(min(rate, 0.999))
        t += int(gap)
        if t >= T:
            break
        name = str(rng.choice(names, p=probs))
        hc, hs, (slo, shi), (vlo, vhi) = VEHICLE_PALETTE[name]
        # scale may be a (lo, hi) range: per-vehicle size jitter (tiny
        # below-min_blob blobs next to full-size ones — identical PF
        # signatures, different ground truth; the cascade benchmark's
        # scenario). A scalar draws nothing extra, so the default RNG
        # stream is unchanged.
        sc = (float(rng.uniform(scale[0], scale[1]))
              if isinstance(scale, (tuple, list)) else float(scale))
        h = max(2, int(rng.integers(H // 10, H // 5) * sc))
        w = max(3, int(rng.integers(W // 8, W // 4) * sc))
        speed = float(rng.uniform(W / 80, W / 25)) * (1 if rng.random() < 0.5 else -1)
        dur = int(abs((W + w) / speed)) + 1
        vehicles.append(Vehicle(
            color_name=name, obj_id=next_id, t_enter=t,
            t_exit=min(T, t + dur),
            y=int(rng.integers(road_top, H - h)), h=h, w=w,
            speed=speed, x0=(-w if speed > 0 else W),
            hue=float(np.clip(rng.normal(hc, hs), 0, 179.9)),
            sat=int(rng.integers(slo, shi)), val=int(rng.integers(vlo, vhi))))
        next_id += 1
    return vehicles, next_id


def _spawn_confusers(rng, T, H, W, colors: Sequence[str],
                     rate: float) -> List[Vehicle]:
    """Saturated thin vertical strips (banners/poles/light streaks) in
    the TARGET palette: the same hue/sat/val distribution as a vehicle
    — so their PF matrices are indistinguishable from real positives —
    but a shape no vehicle has, and NO label. The color histogram
    cannot tell them apart; a shape-aware stage-2 scorer can."""
    out: List[Vehicle] = []
    names = [c for c in colors if c in VEHICLE_PALETTE]
    if not names or rate <= 0:
        return out
    t = 0
    while t < T:
        t += int(rng.geometric(min(rate, 0.999)))
        if t >= T:
            break
        name = str(rng.choice(names))
        hc, hs, (slo, shi), (vlo, vhi) = VEHICLE_PALETTE[name]
        h = max(8, int(H * 0.45))
        w = max(2, W // 50)
        speed = float(rng.uniform(W / 80, W / 25)) * (
            1 if rng.random() < 0.5 else -1)
        dur = int(abs((W + w) / speed)) + 1
        out.append(Vehicle(
            color_name=name, obj_id=-1, t_enter=t, t_exit=min(T, t + dur),
            y=int(rng.integers(0, max(1, H - h))), h=h, w=w,
            speed=speed, x0=(-w if speed > 0 else W),
            hue=float(np.clip(rng.normal(hc, hs), 0, 179.9)),
            sat=int(rng.integers(slo, shi)), val=int(rng.integers(vlo, vhi))))
    return out


def generate_scenario(seed: int, num_frames: int = 600, height: int = 96,
                      width: int = 160, vehicle_rate: float = 0.05,
                      color_mix: Optional[dict] = None,
                      target_colors: Sequence[str] = ("red", "yellow"),
                      clutter_density: float = 1.0,
                      illumination_drift: bool = True,
                      vehicle_scale=1.0,
                      confuser_rate: float = 0.0,
                      start_id: int = 0) -> VideoScenario:
    """Render one camera stream with ground truth.

    ``vehicle_scale`` is a scalar multiplier or a ``(lo, hi)`` range
    drawn per vehicle (sub-``min_blob`` blobs stay unlabeled).
    ``confuser_rate > 0`` adds saturated target-palette strips that are
    histogram-identical to real positives but never labeled — the
    stimuli separating a semantic cascade from the color stage. Both
    default to the historical behavior bit-for-bit.
    """
    rng = np.random.default_rng(seed)
    color_mix = color_mix or {"red": 0.18, "yellow": 0.15, "blue": 0.2,
                              "white": 0.17, "gray": 0.2, "black": 0.1}
    bg = _base_background(rng, num_frames, height, width,
                          clutter_colors=target_colors,
                          clutter_density=clutter_density)
    vehicles, _ = _spawn_vehicles(rng, num_frames, height, width, color_mix,
                                  vehicle_rate, start_id, scale=vehicle_scale)
    confusers = (_spawn_confusers(rng, num_frames, height, width,
                                  target_colors, confuser_rate)
                 if confuser_rate > 0 else [])
    T, H, W = num_frames, height, width
    frames = np.empty((T, H, W, 3), np.float32)
    labels = {c: np.zeros(T, bool) for c in target_colors}
    objects = {c: [set() for _ in range(T)] for c in target_colors}
    busy = np.zeros(T, bool)
    min_blob = (H * W) / 400.0          # "filter" stage blob-size threshold

    for t in range(T):
        f = bg.copy()
        if illumination_drift:
            gain = 1.0 + 0.18 * np.sin(2 * np.pi * t / max(120, T // 3)) \
                + float(rng.normal(0, 0.015))
            f[..., 2] = np.clip(f[..., 2] * gain, 0, 255)
        # shadows: slow-moving, mild (stays under the bg-subtraction
        # threshold so static clutter does not flood the foreground)
        sh_w = W // 4
        sx = int((t * 0.7) % (W + sh_w)) - sh_w
        lo, hi = max(0, sx), min(W, sx + sh_w)
        if hi > lo:
            f[:, lo:hi, 2] *= 0.90
        # moving dull-colored distractors (pedestrians/debris): share the
        # target hue at LOW saturation — they enter the foreground mask,
        # so negatives have nonzero PF mass (paper Fig. 9a spread)
        for di, cname in enumerate(target_colors):
            if cname not in CLUTTER_FOR:
                continue
            hc, hs, (slo, shi), (vlo, vhi) = CLUTTER_FOR[cname]
            dx = int((t * (1.3 + 0.7 * di)) % (W + 8)) - 8
            dy = int(H * 0.3 + 10 * di) % max(1, H - 6)
            x1, x2 = max(0, dx), min(W, dx + 6)
            if x2 > x1:
                f[dy:dy + 5, x1:x2, 0] = np.clip(
                    rng.normal(hc, hs, (min(5, H - dy), x2 - x1)), 0, 179.9)
                f[dy:dy + 5, x1:x2, 1] = rng.uniform(slo, shi, (min(5, H - dy), x2 - x1))
                f[dy:dy + 5, x1:x2, 2] = rng.uniform(max(vlo, 60), vhi, (min(5, H - dy), x2 - x1))
        # confusers: painted exactly like vehicles (same palette, same
        # per-pixel noise) but thin — and NEVER labeled
        for cf in confusers:
            if not (cf.t_enter <= t < cf.t_exit):
                continue
            x = int(cf.x0 + cf.speed * (t - cf.t_enter))
            x1, x2 = max(0, x), min(W, x + cf.w)
            if x2 <= x1:
                continue
            y1, y2 = cf.y, min(H, cf.y + cf.h)
            f[y1:y2, x1:x2, 0] = np.clip(
                cf.hue + rng.normal(0, 1.0, (y2 - y1, x2 - x1)), 0, 179.9)
            f[y1:y2, x1:x2, 1] = np.clip(
                cf.sat + rng.normal(0, 6, (y2 - y1, x2 - x1)), 0, 255)
            f[y1:y2, x1:x2, 2] = np.clip(
                cf.val + rng.normal(0, 6, (y2 - y1, x2 - x1)), 0, 255)
        # vehicles
        for vh in vehicles:
            if not (vh.t_enter <= t < vh.t_exit):
                continue
            x = int(vh.x0 + vh.speed * (t - vh.t_enter))
            x1, x2 = max(0, x), min(W, x + vh.w)
            if x2 <= x1:
                continue
            y1, y2 = vh.y, min(H, vh.y + vh.h)
            f[y1:y2, x1:x2, 0] = np.clip(
                vh.hue + rng.normal(0, 1.0, (y2 - y1, x2 - x1)), 0, 179.9)
            f[y1:y2, x1:x2, 1] = np.clip(
                vh.sat + rng.normal(0, 6, (y2 - y1, x2 - x1)), 0, 255)
            f[y1:y2, x1:x2, 2] = np.clip(
                vh.val + rng.normal(0, 6, (y2 - y1, x2 - x1)), 0, 255)
            area = (y2 - y1) * (x2 - x1)
            if area >= min_blob and vh.color_name in target_colors:
                # paper query: filter-1 (blob size) AND filter-2 (target
                # color) must pass before the DNN runs -> 'busy'
                busy[t] = True
                labels[vh.color_name][t] = True
                objects[vh.color_name][t].add(vh.obj_id)
        # sensor noise
        f[..., 1:] = np.clip(f[..., 1:] + rng.normal(0, 2.0, (H, W, 2)), 0, 255)
        frames[t] = f

    return VideoScenario(frames, labels, objects, busy,
                         meta={"seed": seed, "vehicles": len(vehicles),
                               "confusers": len(confusers)})


def combined_label(sc: VideoScenario, colors: Sequence[str], op: str):
    """Per-frame label for single/OR/AND queries over target colors."""
    ls = [sc.labels[c] for c in colors]
    if op == "and":
        return np.logical_and.reduce(ls)
    return np.logical_or.reduce(ls)

"""Second-stage semantic scorers for the shedding cascade.

The color-utility shedder (stage 1) is size/shape-blind by
construction: PF matrices are *normalized* distributions over the
(sat, val) bins of the foreground pixels, so a 10-pixel red blob and a
300-pixel red vehicle score identically. Stage 2 re-scores the frames
that pass the color threshold with a tiny learned head over a
downsampled crop of the ingest kernel's foreground bounding box (the ROI
comes out of the same fused ingest, ``ingest_pipeline(with_bbox=True)``),
which *can* express size, aspect and layout.

``SemanticScorer``
    The protocol: ``score(frames, bboxes) -> (B,)`` float32 scores.

``MLPScorer``
    Fixed-grid ROI resample -> chroma features -> 2-layer MLP ->
    softsign, on the device its parameters live on, in full float32.
    Parameters checkpoint via ``repro_torch.train.checkpoint`` (the
    reference's file format).

``CallableScorer``
    Wraps any callable — mocks, tests, or an external model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.colors import rgb_to_hsv
from repro_torch.device import DeviceLike, resolve_device

# geometry rider appended to the flattened crop: the fixed-grid resample
# normalizes away absolute scale (a tight bbox around a 6-pixel blob
# fills the ROI exactly like a vehicle does), so the bbox extent itself
# must reach the head as a feature
N_GEO = 4


@runtime_checkable
class SemanticScorer(Protocol):
    """Stage-2 scorer contract: batched frames + foreground bboxes ->
    per-frame semantic utilities."""

    def score(self, frames, bboxes) -> torch.Tensor:
        """frames: (B, H, W, 3) float32 RGB in [0, 255]; bboxes: (B, 4)
        int32 (row_min, row_max, col_min, col_max), all -1 = empty; a
        session passes tensors on its device. Returns (B,) float32."""
        ...


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true float32 division on every device (a Python
    scalar divisor becomes a reciprocal product on the card). The divisor
    is filled on ``x``'s device: a tensor copied from the host would sync
    the stream."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def extract_rois(frames: torch.Tensor, bboxes: torch.Tensor,
                 size: int) -> torch.Tensor:
    """Crop each frame to its foreground bbox and resample to a fixed
    ``(size, size)`` grid (nearest neighbour). Empty bboxes (all -1) fall
    back to the full frame.

    frames: (B, H, W, 3); bboxes: (B, 4) int32 inclusive bounds, both on
    one device. Returns (B, size, size, 3) float32.
    """
    frames = frames.to(torch.float32)
    B, H, W = frames.shape[:3]
    bb = bboxes.to(torch.int32)
    empty = bb[:, 1] < 0
    r0 = torch.where(empty, 0, bb[:, 0])
    r1 = torch.where(empty, H - 1, bb[:, 1])
    c0 = torch.where(empty, 0, bb[:, 2])
    c1 = torch.where(empty, W - 1, bb[:, 3])
    t = _div(torch.arange(size, dtype=torch.float32, device=frames.device)
             + 0.5, float(size))
    ys = r0[:, None] + torch.floor(t[None, :] * (r1 - r0 + 1)[:, None]).to(
        torch.int32)
    xs = c0[:, None] + torch.floor(t[None, :] * (c1 - c0 + 1)[:, None]).to(
        torch.int32)
    ys = torch.clamp(ys, 0, H - 1).to(torch.int64)
    xs = torch.clamp(xs, 0, W - 1).to(torch.int64)
    rows = torch.arange(B, device=frames.device)[:, None, None]
    return frames[rows, ys[:, :, None], xs[:, None, :]]


def roi_geometry(bboxes: torch.Tensor, height: int, width: int
                 ) -> torch.Tensor:
    """(B, 4) float32 bbox geometry in [0, 1]: height fraction, width
    fraction, area fraction, and a foreground-present flag. Empty bboxes
    (all -1) are all-zero."""
    bb = bboxes.to(torch.int32)
    empty = bb[:, 1] < 0
    hf = _div((bb[:, 1] - bb[:, 0] + 1).to(torch.float32), float(height))
    wf = _div((bb[:, 3] - bb[:, 2] + 1).to(torch.float32), float(width))
    geo = torch.stack([hf, wf, hf * wf, torch.ones_like(hf)], dim=-1)
    return torch.where(empty[:, None], 0.0, geo)


def _crop_features(crops: torch.Tensor) -> torch.Tensor:
    """RGB crops -> chroma-weighted hue vector + value, all in [-1, 1].

    Hue is an angle (target reds straddle the 0/180 wrap), so it enters
    as a (cos, sin) unit vector scaled by saturation — hue is noise at
    low chroma, and S and H are invariant to the illumination drift the
    scenarios carry, which raw RGB is not."""
    hsv = rgb_to_hsv(crops.to(torch.float32))
    ang = hsv[..., 0] * (2.0 * math.pi / 180.0)
    sat = _div(hsv[..., 1:2], 255.0)
    return torch.cat([torch.cos(ang)[..., None] * sat,
                      torch.sin(ang)[..., None] * sat,
                      _div(hsv[..., 2:3], 255.0)], dim=-1)


def scorer_logits(params: Dict[str, torch.Tensor], crops: torch.Tensor,
                  geo: torch.Tensor) -> torch.Tensor:
    """The MLP head: (B, size, size, 3) RGB crops + (B, N_GEO) bbox
    geometry -> (B,) logits."""
    f = _crop_features(crops)
    x = torch.cat([f.reshape(f.shape[0], -1), geo.to(torch.float32)],
                  dim=-1)
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return (h @ params["w2"] + params["b2"])[:, 0]


@dataclass
class MLPScorer:
    """Tiny MLP over the downsampled foreground ROI. ``params`` (``w1``
    (d, hidden), ``b1``, ``w2`` (hidden, 1), ``b2``; d = roi_size**2 * 3 +
    N_GEO) are float32 tensors on one device, where ``score`` runs.
    Batches are scored as they come: the reference's power-of-two batch
    padding bounds JAX retraces only, and a row's score does not depend
    on the other rows."""
    params: Dict[str, torch.Tensor]
    roi_size: int = 16

    @classmethod
    def init(cls, seed: int = 0, *, roi_size: int = 16, hidden: int = 32,
             device: DeviceLike = None) -> "MLPScorer":
        """Seeded weights, drawn on the CPU from a ``torch.Generator`` (so
        the same on every device) and placed on ``device``."""
        dev = resolve_device(device)
        d = roi_size * roi_size * 3 + N_GEO
        gen = torch.Generator().manual_seed(int(seed))
        w1 = torch.randn((d, hidden), generator=gen) / math.sqrt(d)
        w2 = torch.randn((hidden, 1), generator=gen) / math.sqrt(hidden)
        params = {"w1": w1, "b1": torch.zeros((hidden,)),
                  "w2": w2, "b2": torch.zeros((1,))}
        return cls(params={k: v.to(dev) for k, v in params.items()},
                   roi_size=roi_size)

    def score(self, frames, bboxes) -> torch.Tensor:
        """(B,) float32 scores on the parameters' device; numpy or tensor
        inputs are moved there."""
        dev = self.params["w1"].device
        frames = torch.as_tensor(frames).to(dev, torch.float32)
        bboxes = torch.as_tensor(bboxes).to(dev, torch.int32)
        if frames.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.float32, device=dev)
        crops = extract_rois(frames, bboxes, self.roi_size)
        geo = roi_geometry(bboxes, frames.shape[1], frames.shape[2])
        # softsign, not sigmoid: a well-trained head drives float32
        # sigmoid to exactly 0.0/1.0, and a point mass at the extremes is
        # invisible to the stage-2 quantile threshold; x/(8+|x|) is
        # strictly monotone with no float32 saturation at realistic logit
        # magnitudes
        x = scorer_logits(self.params, crops, geo)
        return 0.5 * (1.0 + x / (8.0 + torch.abs(x)))

    # -- persistence (the reference's checkpoint format) ---------------------

    def save(self, path, step: int = 0, *, async_: bool = False):
        from repro_torch.train import checkpoint as ckpt
        meta = {"kind": "cascade_scorer", "roi_size": int(self.roi_size),
                "hidden": int(self.params["b1"].shape[0])}
        return ckpt.save(path, step, dict(self.params), metadata=meta,
                         async_=async_)

    @classmethod
    def from_checkpoint(cls, path, *, roi_size: int = 16, hidden: int = 32,
                        step: Optional[int] = None,
                        device: DeviceLike = None) -> "MLPScorer":
        from repro_torch.train import checkpoint as ckpt
        d = roi_size * roi_size * 3 + N_GEO
        template = {"w1": np.zeros((d, hidden), np.float32),
                    "b1": np.zeros((hidden,), np.float32),
                    "w2": np.zeros((hidden, 1), np.float32),
                    "b2": np.zeros((1,), np.float32)}
        out, _, meta = ckpt.restore(path, template, step=step, device=device)
        return cls(params=out, roi_size=int(meta.get("roi_size", roi_size)))


@dataclass
class CallableScorer:
    """Adapter: any callable as a SemanticScorer (mocks/tests). ``fn``
    gets the session's tensors and may return a tensor or anything
    ``np.asarray`` takes."""
    fn: Callable[[Any, Any], Any]
    roi_size: int = 16

    def score(self, frames, bboxes) -> torch.Tensor:
        out = self.fn(frames, bboxes)
        if not isinstance(out, torch.Tensor):
            out = torch.as_tensor(np.asarray(out, np.float32))
        return out.to(torch.float32).reshape(-1)


@dataclass
class Cascade:
    """Cascade spec handed to ``ShedSession(cascade=...)``.

    ``gate_fraction`` splits the Eq. 19 combined target drop rate r:
    stage 1 (color) sheds ``r1 = gate_fraction * r`` of all arrivals at
    its CDF quantile, stage 2 sheds the conditional remainder
    ``r2 = (r - r1) / (1 - r1)`` of the survivors at the stage-2 score
    quantile — so the combined realized rate tracks r exactly and the
    degraded-mode floor (applied to r before the split) bounds the
    *combined* rate. ``window`` sizes the per-camera stage-2 score ring
    (``SessionState.s2_buf``).
    """
    scorer: Any
    gate_fraction: float = 0.5
    window: int = 1024

    def __post_init__(self) -> None:
        if not 0.0 <= float(self.gate_fraction) <= 1.0:
            raise ValueError(
                f"gate_fraction {self.gate_fraction} outside [0, 1]")
        if int(self.window) < 1:
            raise ValueError("cascade window must be >= 1")


__all__ = ["SemanticScorer", "MLPScorer", "CallableScorer", "Cascade",
           "N_GEO", "extract_rois", "roi_geometry", "scorer_logits"]

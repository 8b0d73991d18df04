"""Background subtraction (paper §V-F: runs co-located with the camera).

Two models:

``RunningAverageBackground`` — the original host-side reference: running
average on the Value channel with *median*-ratio global-gain
compensation computed from the current frame.

``EMABackground`` — the model the fused CUDA ingest kernel implements
(see ``repro_torch.kernels.hsv_features.kernel.ingest_batch``): same EMA
update, but the illumination gain is the *mean*-ratio of the previous
frame (one-frame lag). The lag makes the gain computable in a single
streaming pass over pixels — a global median (or even a same-frame
mean) would need a second pass — and is negligible for slow lighting
drift. Its ``(bg, gain)`` tuple is exactly the kernel's carried state,
so host and kernel can hand the stream to each other mid-video.
"""
from __future__ import annotations

import numpy as np

GAIN_MIN, GAIN_MAX = 0.25, 4.0


class RunningAverageBackground:
    def __init__(self, alpha: float = 0.05, threshold: float = 18.0):
        self.alpha = alpha
        self.threshold = threshold
        self._bg = None  # (H, W) value-channel background

    def __call__(self, hsv_frame: np.ndarray) -> np.ndarray:
        """hsv_frame: (H, W, 3). Returns bool foreground mask (H, W)."""
        val = hsv_frame[..., 2].astype(np.float32)
        if self._bg is None:
            self._bg = val.copy()
            return np.zeros(val.shape, bool)   # no evidence yet -> all bg
        gain = np.median(val) / max(np.median(self._bg), 1e-6)
        comp = val / max(gain, 1e-6)
        mask = np.abs(comp - self._bg) > self.threshold
        self._bg = (1 - self.alpha) * self._bg + self.alpha * comp
        return mask


class EMABackground:
    """Host-side mirror of the fused kernel's background recurrence.

    State: ``bg`` (per-pixel Value background) and ``gain`` (lagged
    mean-ratio illumination estimate). ``state`` round-trips with
    ``repro_torch.kernels.hsv_features.ops.IngestState``.
    """

    def __init__(self, alpha: float = 0.05, threshold: float = 18.0,
                 bg: np.ndarray | None = None, gain: float = 1.0):
        self.alpha = alpha
        self.threshold = threshold
        self._bg = None if bg is None else np.asarray(bg, np.float32)
        self._gain = float(gain)

    @property
    def state(self):
        return self._bg, self._gain

    def __call__(self, hsv_frame: np.ndarray) -> np.ndarray:
        """hsv_frame: (H, W, 3). Returns bool foreground mask (H, W)."""
        val = hsv_frame[..., 2].astype(np.float32)
        if self._bg is None:
            self._bg = val            # frame seeds bg -> |comp-bg| == 0
        gain = float(np.clip(self._gain, GAIN_MIN, GAIN_MAX))
        comp = val / gain
        mask = np.abs(comp - self._bg) > self.threshold
        self._gain = float(np.clip(
            val.sum() / max(self._bg.sum(), 1e-6), GAIN_MIN, GAIN_MAX))
        self._bg = (1 - self.alpha) * self._bg + self.alpha * comp
        return mask


def batch_foreground(frames_hsv: np.ndarray, alpha=0.05, threshold=18.0,
                     model: str = "median"):
    """Apply a background model over a (T,H,W,3) sequence.

    ``model``: "median" -> RunningAverageBackground (legacy reference),
    "ema" -> EMABackground (the fused kernel's model).
    """
    cls = {"median": RunningAverageBackground, "ema": EMABackground}[model]
    bg = cls(alpha, threshold)
    return np.stack([bg(f) for f in frames_hsv])

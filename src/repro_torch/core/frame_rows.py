"""``FrameRows``: the rows of a session step's frame batch that a stage-2
scorer is asked to score, named by index and not copied.

A cascade session hands its scorer one of these as ``frames``. A ROI
scorer (``repro_torch.cascade.MLPScorer``) crops the rows where they
lie; a scorer that needs whole frames calls ``gather()``, and the session
counts the frames so copied (``cascade.frames_gathered``). This module
imports nothing else from the package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class FrameRows:
    """B rows of a frame batch: ``batch[cams[i], ts[i]]`` is row i.
    ``batch`` is (C, T, H, W, 3); ``cams`` and ``ts`` are (B,) int64 on
    its device (the colour gate's survivors, as ``nonzero`` gives them).
    ``gathered`` is set once ``gather()`` has copied the rows out."""
    batch: torch.Tensor
    cams: torch.Tensor
    ts: torch.Tensor
    gathered: bool = field(default=False, init=False, compare=False)

    def gather(self) -> torch.Tensor:
        """(B, H, W, 3): the rows' whole frames, a copy."""
        self.gathered = True
        return self.batch[self.cams, self.ts]


__all__ = ["FrameRows"]

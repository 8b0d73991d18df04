"""Device scratch that the port's CUDA kernels share.

``tickets`` hands out the int32 tickets with which a kernel's blocks find
the last of a group (``hist.cu``'s frames, ``flash.cu``'s split q tiles):
zero when made, and every kernel that takes tickets sets the ones it used
back to zero before it ends, so each call finds them zero. Kernels on one
stream run in order, so they share one scratch; two streams use two, so
calls running at once never share tickets.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def device_index(device) -> int:
    """The CUDA device index of ``device`` (the current one if unset)."""
    idx = torch.device(device).index
    return torch.cuda.current_device() if idx is None else idx


def tickets(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zero int32 tickets on ``device`` for kernels
    launched on ``stream`` (its ``cuda_stream`` handle)."""
    key = (device_index(device), stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


__all__ = ["device_index", "tickets"]

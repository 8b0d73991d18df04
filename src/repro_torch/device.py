"""Device policy of the PyTorch port.

Every entry point takes an explicit ``device``. ``None`` means the CUDA
card: the port is built for it, so a CPU-only machine raises instead of
carrying on silently on the CPU. Pass ``device="cpu"`` to run the plain
PyTorch path on purpose (the CPU tests do).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:       # compare equal to tensors' devices
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


__all__ = ["DeviceLike", "resolve_device"]

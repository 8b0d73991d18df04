"""Plain PyTorch version of the flash attention kernel: the port's copy
of ``src/repro/kernels/flash_attention/ref.py::attention_ref``.

The tests hold the CUDA kernel to it, and ``kernel.flash_attention``
runs it for a CPU tensor. Nothing on the card's path calls it.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None):
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Sk, d). GQA via Hq % Hkv == 0.

    Scores and softmax in float32 (float64 for float64 inputs, which
    gives a yardstick for the float32 versions); the causal (and
    sliding-window) mask puts q at the cache tail (offset ``Sk - Sq``); a
    row with no visible key gives 0. Returns (B, Hq, Sq, d) in q's dtype.
    """
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, Hkv, g, Sq, d).to(ct)
    scale = scale if scale is not None else d ** -0.5
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(ct)) * scale
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        off = Sk - Sq                         # q positions at the cache tail
        mask = kp <= (qp + off)
        if window is not None:
            mask &= (qp + off - kp) < window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # fully masked rows
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.to(ct))
    return out.reshape(B, Hq, Sq, d).to(q.dtype)


__all__ = ["attention_ref"]

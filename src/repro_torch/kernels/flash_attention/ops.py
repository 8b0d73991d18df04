"""Model-layout entry point of the flash attention kernel: the port's
``src/repro/kernels/flash_attention/ops.py::flash_attention_bsnh``."""
from __future__ import annotations

from typing import Optional

import torch.nn.functional as F

from repro_torch.kernels.flash_attention.kernel import (
    DEFAULT_BLOCK_K,
    DEFAULT_BLOCK_Q,
    flash_attention,
)


def flash_attention_bsnh(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None):
    """q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd). Returns (B, Sq, Hq, hd).

    Pads sequences to block multiples; padded K positions are masked by
    the causal predicate (they sit beyond the last real position), and
    padded Q rows are sliced off. Without padding the head-major views
    reach the kernel as strided views, not copies.
    """
    B, Sq, Hq, hd = q.shape
    Sk = k.shape[1]
    bq = min(DEFAULT_BLOCK_Q, max(16, Sq))
    bk = min(DEFAULT_BLOCK_K, max(16, Sk))
    pad_q = (-Sq) % bq
    pad_k = (-Sk) % bk
    if pad_q or pad_k:
        # padding shifts the q/k position offset unless the seqs match
        assert Sq == Sk and pad_q == pad_k, (Sq, Sk, pad_q, pad_k)
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    if pad_q:
        qt = F.pad(qt, (0, 0, 0, pad_q))
    if pad_k:
        kt = F.pad(kt, (0, 0, 0, pad_k))
        vt = F.pad(vt, (0, 0, 0, pad_k))
    assert causal or pad_k == 0, "non-causal padding would attend to pad keys"
    out = flash_attention(qt, kt, vt, causal=causal, window=window,
                          block_q=bq, block_k=bk)
    out = out[:, :, :Sq] if pad_q else out
    return out.transpose(1, 2)


__all__ = ["flash_attention_bsnh"]

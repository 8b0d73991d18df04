"""Shared model building blocks: the port of
``src/repro/models/common.py`` (plain functions on tensors).

Weights are kept in their parameter dtype and cast to the activation
dtype where they are used, as the reference does.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.api import DTYPES, ParamSpec, constrain


def cdtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def remat(fn, enabled: bool):
    """``fn`` under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``) when ``enabled`` and grad is on: what it saves
    for the backward is recomputed there instead of kept. ``fn`` itself
    otherwise. The models draw no random numbers: no RNG state is
    stashed."""
    if not (enabled and torch.is_grad_enabled()):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def rmsnorm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    """In numpy float32, as the reference computes them (the angles'
    bits depend on it)."""
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int."""
    if theta <= 0.0:
        return x
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), device=x.device)
    ang = positions[..., :, None].float() * freqs       # (..., S, hd/2)
    ang = ang[..., :, None, :]                          # broadcast over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(positions, d_model: int):
    """positions: (...,) -> (..., d_model) float32 sinusoidal embeddings.

    The frequencies are computed on the host in float64 and rounded once
    to float32, so that every device gets the same bits: a last-bit
    difference of a device's float32 ``exp`` moves the angle at position
    1500 (whisper's encoder) by ~1e-4."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float64) / max(1, half - 1)).float()
    ang = positions[..., None].float() * freqs.to(positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Dense layers
# ---------------------------------------------------------------------------

def dense_spec(d_in: int, d_out: int, axes, scale=None) -> ParamSpec:
    return ParamSpec((d_in, d_out), axes, scale=scale)


def dense(x, w, dtype=None):
    """x (..., d) @ w (d, f) in ``dtype`` (default: x's)."""
    dtype = dtype or x.dtype
    return torch.matmul(x.to(dtype), w.to(dtype))


def mlp_specs(d: int, d_ff: int) -> dict:
    return {
        "gate": dense_spec(d, d_ff, ("embed", "mlp")),
        "up": dense_spec(d, d_ff, ("embed", "mlp")),
        "down": dense_spec(d_ff, d, ("mlp", "embed")),
    }


def silu(x):
    """x * sigmoid(x) with the sigmoid as 1 / (1 + exp(-x)), each step
    rounded to x's dtype: the reference's ``jax.nn.silu`` as XLA computes
    it in bfloat16 (one fused float32 ``F.silu`` differs from it in the
    last bit of ~1/3 of the values)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp(params, x):
    h = silu(dense(x, params["gate"])) * dense(x, params["up"])
    h = constrain(h, "batch", None, "mlp")
    return dense(h, params["down"])


__all__ = ["apply_rope", "cdtype", "dense", "dense_spec", "mlp", "remat",
           "mlp_specs", "rmsnorm", "rmsnorm_spec", "rope_freqs", "silu",
           "sinusoidal_pos"]

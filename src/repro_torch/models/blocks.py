"""Block-level composition: norm -> mixer -> residual (+ MLP half) — the
port of ``src/repro/models/blocks.py`` for the dense attention kinds.

A "block" is one entry of ``cfg.block_pattern``. The port has the
full-sequence forward of ``ATTN`` and ``LOCAL_ATTN`` blocks with a dense
MLP half. Every other kind (``SHARED_ATTN``, ``MAMBA2``, ``MLSTM``,
``SLSTM``) and a mixture-of-experts MLP half raise
``NotImplementedError`` naming the ROADMAP item that ports them; the
one-token decode step is not ported yet.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ATTN, LOCAL_ATTN, SHARED_ATTN
from repro_torch.models.attention import attend_full, attention_specs
from repro_torch.models.common import mlp, mlp_specs, rmsnorm, rmsnorm_spec

DENSE_KINDS = (ATTN, LOCAL_ATTN)


def _check(cfg, kind) -> None:
    """Raise for a block the port cannot build yet."""
    if kind == SHARED_ATTN:
        what = "the SHARED_ATTN kind"
    elif kind not in DENSE_KINDS:
        what = f"models/ssm.py ({kind!r} blocks)"
    elif cfg.num_experts > 0:
        what = "models/moe.py"
    else:
        return
    raise NotImplementedError(f"{cfg.name}: {what} is not ported yet "
                              "(ROADMAP.md Queue 1 item 10)")


def _has_mlp_half(cfg, kind) -> bool:
    return kind in DENSE_KINDS and cfg.d_ff > 0


def block_specs(cfg, kind) -> dict:
    _check(cfg, kind)
    d = cfg.d_model
    sp = {"norm1": rmsnorm_spec(d), "attn": attention_specs(cfg)}
    if _has_mlp_half(cfg, kind):
        sp["norm2"] = rmsnorm_spec(d)
        sp["mlp"] = mlp_specs(d, cfg.d_ff)
    return sp


def _window(cfg, kind) -> Optional[int]:
    return cfg.sliding_window if kind == LOCAL_ATTN else None


def _mlp_half(cfg, params, x):
    """Second residual half (a dense MLP has no auxiliary loss)."""
    if "mlp" in params:
        x = x + mlp(params["mlp"], rmsnorm(x, params["norm2"], cfg.norm_eps))
    return x


def block_apply_full(cfg, kind, params, x, positions):
    """Full-sequence forward of one block (no cache: the port builds
    none yet)."""
    _check(cfg, kind)
    h = rmsnorm(x, params["norm1"], cfg.norm_eps)
    out, _ = attend_full(params["attn"], cfg, h, positions, causal=True,
                         window=_window(cfg, kind))
    return _mlp_half(cfg, params, x + out)


__all__ = ["DENSE_KINDS", "block_apply_full", "block_specs"]

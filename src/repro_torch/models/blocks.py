"""Block-level composition: norm -> mixer -> residual (+ MLP/MoE half) —
the port of ``src/repro/models/blocks.py`` for the attention kinds.

A "block" is one entry of ``cfg.block_pattern``. The port has the
``ATTN`` and ``LOCAL_ATTN`` kinds with a dense or a mixture-of-experts
MLP half, in three entry points with the reference's signatures:

  block_specs(cfg, kind)                             -> ParamSpec tree
  block_apply_full(cfg, kind, params, x, positions)  -> (x, cache|None, aux)
  block_apply_step(cfg, kind, params, x, cache, pos) -> (x, cache)

``SHARED_ATTN`` and the recurrent kinds (``MAMBA2``, ``MLSTM``,
``SLSTM``) raise ``NotImplementedError`` naming the ROADMAP item that
ports them (Queue 1 items 10.4 and 10.3).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ATTN, LOCAL_ATTN, SHARED_ATTN
from repro_torch.device import DeviceLike
from repro_torch.models.attention import (
    attend_decode,
    attend_full,
    attention_specs,
    init_kv_cache,
    prefill_into_cache,
)
from repro_torch.models.common import mlp, mlp_specs, rmsnorm, rmsnorm_spec
from repro_torch.models.moe import moe_apply, moe_specs

PORTED_KINDS = (ATTN, LOCAL_ATTN)


def _check(cfg, kind) -> None:
    """Raise for a block the port cannot build yet."""
    if kind in PORTED_KINDS:
        return
    if kind == SHARED_ATTN:
        what, item = "the SHARED_ATTN kind", "10.4"
    else:
        what, item = f"models/ssm.py ({kind!r} blocks)", "10.3"
    raise NotImplementedError(f"{cfg.name}: {what} is not ported yet "
                              f"(ROADMAP.md Queue 1 item {item})")


def _has_mlp_half(cfg, kind) -> bool:
    return kind in PORTED_KINDS and (cfg.d_ff > 0 or cfg.num_experts > 0)


def block_specs(cfg, kind) -> dict:
    _check(cfg, kind)
    d = cfg.d_model
    sp = {"norm1": rmsnorm_spec(d), "attn": attention_specs(cfg)}
    if _has_mlp_half(cfg, kind):
        sp["norm2"] = rmsnorm_spec(d)
        if cfg.num_experts > 0:
            sp["moe"] = moe_specs(cfg)
        else:
            sp["mlp"] = mlp_specs(d, cfg.d_ff)
    return sp


def _window(cfg, kind) -> Optional[int]:
    return cfg.sliding_window if kind == LOCAL_ATTN else None


def _mlp_half(cfg, params, x):
    """Second residual half. Returns (x, aux_loss); aux is 0.0 without
    experts."""
    aux = 0.0
    if "moe" in params:
        h, aux = moe_apply(params["moe"], cfg,
                           rmsnorm(x, params["norm2"], cfg.norm_eps))
        x = x + h
    elif "mlp" in params:
        x = x + mlp(params["mlp"], rmsnorm(x, params["norm2"], cfg.norm_eps))
    return x, aux


def block_apply_full(cfg, kind, params, x, positions, *, want_cache=False,
                     max_seq=None):
    """Full-sequence forward (train / prefill). Returns (x, cache, aux);
    with ``want_cache`` the cache is a new one of ``max_seq`` slots (the
    window's in a ring) holding this sequence's keys and values."""
    _check(cfg, kind)
    h = rmsnorm(x, params["norm1"], cfg.norm_eps)
    window = _window(cfg, kind)
    out, (k, v) = attend_full(params["attn"], cfg, h, positions, causal=True,
                              window=window)
    x = x + out
    cache = None
    if want_cache:
        cache = init_kv_cache(cfg, x.shape[0], max_seq, window=window,
                              device=x.device)
        prefill_into_cache(cache, k, v, positions, window=window)
    x, aux = _mlp_half(cfg, params, x)
    return x, cache, aux


def block_apply_step(cfg, kind, params, x, cache, pos):
    """One-token decode; ``cache`` is updated in place. Returns (x, cache)."""
    _check(cfg, kind)
    h = rmsnorm(x, params["norm1"], cfg.norm_eps)
    out, cache = attend_decode(params["attn"], cfg, h, cache, pos,
                               window=_window(cfg, kind))
    x, _ = _mlp_half(cfg, params, x + out)
    return x, cache


def block_init_cache(cfg, kind, batch, max_seq, device: DeviceLike = None):
    _check(cfg, kind)
    return init_kv_cache(cfg, batch, max_seq, window=_window(cfg, kind),
                         device=device)


__all__ = ["PORTED_KINDS", "block_apply_full", "block_apply_step",
           "block_init_cache", "block_specs"]

"""Block-level composition: norm -> mixer -> residual (+ MLP/MoE half) —
the port of ``src/repro/models/blocks.py``.

A "block" is one entry of ``cfg.block_pattern``. Every block kind
(``ATTN``, ``LOCAL_ATTN``, ``SHARED_ATTN``, ``MAMBA2``, ``MLSTM``,
``SLSTM``) has three entry points with the reference's signatures:

  block_specs(cfg, kind)                             -> ParamSpec tree
  block_apply_full(cfg, kind, params, x, positions)  -> (x, cache|None, aux)
  block_apply_step(cfg, kind, params, x, cache, pos) -> (x, cache)

The attention kinds (and only they) have an MLP or MoE half. The
SHARED_ATTN kind reuses one weight-tied parameter set across all pattern
repetitions (Zamba-style): the caller passes it, and its *cache* is per
repetition. A step writes into the caller's cache in place and returns
the same dict: an attention cache gets the token's k/v, a recurrent
state its new leaves (``copy_``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ATTENTION_KINDS, LOCAL_ATTN, MAMBA2, \
    MLSTM, SLSTM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ssm
from repro_torch.models.attention import (
    attend_decode,
    attend_full,
    attention_specs,
    init_kv_cache,
    prefill_into_cache,
)
from repro_torch.models.common import mlp, mlp_specs, rmsnorm, rmsnorm_spec
from repro_torch.models.moe import moe_apply, moe_specs
from repro_torch.sharding.api import batch_local

# kind -> (specs, train, step, init_state) of its recurrent mixer
_MIXERS = {
    MAMBA2: (ssm.mamba2_specs, ssm.mamba2_train, ssm.mamba2_step,
             ssm.mamba2_init_state),
    MLSTM: (ssm.mlstm_specs, ssm.mlstm_train, ssm.mlstm_step,
            ssm.mlstm_init_state),
    SLSTM: (ssm.slstm_specs, ssm.slstm_train, ssm.slstm_step,
            ssm.slstm_init_state),
}
PORTED_KINDS = ATTENTION_KINDS + tuple(_MIXERS)


def _has_mlp_half(cfg, kind) -> bool:
    return kind in ATTENTION_KINDS and (cfg.d_ff > 0 or cfg.num_experts > 0)


def block_specs(cfg, kind) -> dict:
    d = cfg.d_model
    sp = {"norm1": rmsnorm_spec(d)}
    if kind in ATTENTION_KINDS:
        sp["attn"] = attention_specs(cfg)
    elif kind in _MIXERS:
        sp["mixer"] = _MIXERS[kind][0](cfg)
    else:
        raise ValueError(kind)
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


def _mixer(cfg, kind, params, h, fn, *state):
    """``fn(params, h, *state)``: a Mamba2 mixer split over its heads
    where its weights split them (``ssm.mamba2_head_split``), as the
    reference runs it; on DTensors elsewhere, and for the other
    recurrent kinds, on each rank's batch rows with the weights gathered
    (``batch_local``); plain tensors go straight through either."""
    if kind == MAMBA2 and ssm.mamba2_head_split(params, cfg, h) is not None:
        return fn(params, h, *state)
    return batch_local(fn, params, h, *state)


def block_apply_full(cfg, kind, params, x, positions, *, want_cache=False,
                     max_seq=None):
    """Full-sequence forward (train / prefill). Returns (x, cache, aux);
    with ``want_cache`` the cache is a new one holding this sequence: an
    attention block's of ``max_seq`` slots (the window's in a ring), a
    recurrent block's state after the last token."""
    h = rmsnorm(x, params["norm1"], cfg.norm_eps)
    cache = None
    if kind in ATTENTION_KINDS:
        window = _window(cfg, kind)
        out, (k, v) = attend_full(params["attn"], cfg, h, positions,
                                  causal=True, window=window)
        if want_cache:
            cache = init_kv_cache(cfg, x.shape[0], max_seq, window=window,
                                  device=x.device)
            prefill_into_cache(cache, k, v, positions, window=window)
    else:
        out = _mixer(cfg, kind, params["mixer"], h, lambda prm, h: _MIXERS[
            kind][1](prm, cfg, h, return_state=want_cache))
        out, cache = out if want_cache else (out, None)
    x, aux = _mlp_half(cfg, params, x + out)
    return x, cache, aux


def block_apply_step(cfg, kind, params, x, cache, pos):
    """One-token decode; ``cache`` is updated in place. Returns (x, cache)."""
    h = rmsnorm(x, params["norm1"], cfg.norm_eps)
    if kind in ATTENTION_KINDS:
        out, cache = attend_decode(params["attn"], cfg, h, cache, pos,
                                   window=_window(cfg, kind))
    else:
        out, new = _mixer(cfg, kind, params["mixer"], h,
                          lambda prm, h, st: _MIXERS[kind][2](prm, cfg, h, st),
                          cache)
        for name, leaf in new.items():
            cache[name].copy_(leaf)
    x, _ = _mlp_half(cfg, params, x + out)
    return x, cache


def block_init_cache(cfg, kind, batch, max_seq, device: DeviceLike = None):
    if kind in ATTENTION_KINDS:
        return init_kv_cache(cfg, batch, max_seq, window=_window(cfg, kind),
                             device=device)
    if kind in _MIXERS:
        return _MIXERS[kind][3](cfg, batch, resolve_device(device))
    raise ValueError(kind)


__all__ = ["PORTED_KINDS", "block_apply_full",
           "block_apply_step", "block_init_cache", "block_specs"]

"""Top-level language model: embedding -> block stack -> logits — the
port of the decoder-only, full-sequence part of
``src/repro/models/lm.py``.

Parameters keep the reference's layout: one period of the block pattern
(e.g. gemma3's 5 local + 1 global) per entry of ``params["blocks"]``,
each leaf stacked over the pattern repetitions as ``(reps, ...)``. The
forward is inference only: a Python loop over the repetitions indexes
the stacked weights (no scan, no remat). The encoder-decoder path,
caches, prefill and decode wait for ROADMAP Queue 1 item 10.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.common import cdtype, rmsnorm, rmsnorm_spec, \
    sinusoidal_pos
from repro_torch.sharding.api import ParamSpec, constrain, tree_map, \
    tree_map_specs

VOCAB_PAD_MULTIPLE = 256


def padded_vocab(cfg) -> int:
    v, m = cfg.vocab_size, VOCAB_PAD_MULTIPLE
    return (v + m - 1) // m * m


def _stack_specs(tree, reps: int):
    return tree_map_specs(
        lambda s: ParamSpec((reps,) + s.shape, ("layers",) + s.axes,
                            init=s.init, dtype=s.dtype, scale=s.scale), tree)


def _check_decoder_only(cfg) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder path is not ported yet "
            "(ROADMAP.md Queue 1 item 10)")


def lm_specs(cfg: ModelConfig) -> dict:
    """Parameter specs of a decoder-only model whose blocks the port
    builds (dense ``ATTN``/``LOCAL_ATTN``), tied or untied head."""
    _check_decoder_only(cfg)
    d, vp = cfg.d_model, padded_vocab(cfg)
    reps = cfg.pattern_repeats
    d_axis = "table_d" if cfg.opt_head_nofsdp else "embed"
    specs = {
        "embed": ParamSpec((vp, d), ("vocab", d_axis), scale=0.02),
        "final_norm": rmsnorm_spec(d),
        "blocks": tuple(_stack_specs(B.block_specs(cfg, kind), reps)
                        for kind in cfg.block_pattern),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, vp), (d_axis, "vocab"), scale=0.02)
    return specs


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed_tokens(cfg, params, tokens, positions):
    x = params["embed"][tokens].to(cdtype(cfg))
    if cfg.rope_theta <= 0.0:           # sinusoidal absolute positions
        x = x + sinusoidal_pos(positions, cfg.d_model).to(x.dtype)[None]
    return constrain(x, "batch", None, "embed")


def logits_fn(cfg, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x, head.to(x.dtype))
    vp = logits.shape[-1]
    if vp != cfg.vocab_size:            # mask padded vocab entries
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    if cfg.logit_softcap > 0.0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return constrain(logits, "batch", None, "vocab")


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def lm_forward(cfg, params, batch, *, want_cache=False,
               last_logit_only=False):
    """batch: {"tokens": (B, S) integer tensor}.

    Returns (logits, None, aux_loss) — aux is 0 for dense blocks.
    ``want_cache=True`` raises: caches are not ported yet.
    """
    _check_decoder_only(cfg)
    if want_cache:
        raise NotImplementedError(
            "lm_forward(want_cache=True): KV caches and lm_prefill are not "
            "ported yet (ROADMAP.md Queue 1 item 10)")
    tokens = batch["tokens"]
    S = tokens.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = embed_tokens(cfg, params, tokens, positions)
    for r in range(cfg.pattern_repeats):
        for p_idx, kind in enumerate(cfg.block_pattern):
            prm = tree_map(lambda a: a[r], params["blocks"][p_idx],
                           is_leaf=torch.is_tensor)
            x = B.block_apply_full(cfg, kind, prm, x, positions)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_logit_only:
        x = x[:, -1:, :]
    logits = logits_fn(cfg, params, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, None, aux


__all__ = ["embed_tokens", "lm_forward", "lm_specs", "logits_fn",
           "padded_vocab"]

"""Top-level language model: embedding -> block stack -> logits — the
port of the decoder-only part of ``src/repro/models/lm.py``: the
full-sequence forward, prefill and one-token decode over KV caches.

Parameters keep the reference's layout: one period of the block pattern
(e.g. gemma3's 5 local + 1 global) per entry of ``params["blocks"]``,
each leaf stacked over the pattern repetitions as ``(reps, ...)``, and
so do caches: ``{"blocks": (one dict per pattern entry, each leaf
(reps, ...)), "cross_kv": None}``. The forward is inference only: a
Python loop over the repetitions indexes the stacked weights and caches
(no scan, no remat). The encoder-decoder path waits for ROADMAP Queue 1
item 10.5, the SSM and SHARED_ATTN blocks for items 10.3 and 10.4.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
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
            "(ROADMAP.md Queue 1 item 10.5)")


def lm_specs(cfg: ModelConfig) -> dict:
    """Parameter specs of a decoder-only model whose blocks the port
    builds (``ATTN``/``LOCAL_ATTN`` with a dense or MoE MLP half), tied or
    untied head."""
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
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _rep(tree, r):
    """Repetition ``r`` of a tree stacked over repetitions: views, so an
    in-place write to a cache leaf lands in the stacked tensor."""
    return tree_map(lambda a: a[r], tree, is_leaf=torch.is_tensor)


def _stack(trees):
    """Trees of one nesting -> one tree whose leaves are stacked on a new
    leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in sorted(trees[0])}
    return torch.stack(trees)


def lm_forward(cfg, params, batch, *, want_cache=False, max_seq=None,
               last_logit_only=False):
    """batch: {"tokens": (B, S) integer tensor}.

    Returns (logits, caches, aux_loss): caches is None unless
    ``want_cache`` (then caches of ``max_seq`` slots, default S, holding
    the sequence), aux the float32 sum of the MoE blocks' losses (0
    without experts).
    """
    _check_decoder_only(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    max_seq = max_seq or S
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = embed_tokens(cfg, params, tokens, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = [[] for _ in cfg.block_pattern]
    for r in range(cfg.pattern_repeats):
        for p_idx, kind in enumerate(cfg.block_pattern):
            x, cache, a = B.block_apply_full(
                cfg, kind, _rep(params["blocks"][p_idx], r), x, positions,
                want_cache=want_cache, max_seq=max_seq)
            caches[p_idx].append(cache)
            aux = aux + a
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_logit_only:
        x = x[:, -1:, :]
    logits = logits_fn(cfg, params, x)
    out_caches = None
    if want_cache:
        out_caches = {"blocks": tuple(_stack(c) for c in caches),
                      "cross_kv": None}
    return logits, out_caches, aux


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------

def lm_prefill(cfg, params, batch, *, max_seq):
    """Caches of ``max_seq`` slots holding ``batch``'s tokens, and the
    logits (B, vocab) after the last of them."""
    logits, caches, _ = lm_forward(cfg, params, batch, want_cache=True,
                                   max_seq=max_seq, last_logit_only=True)
    return caches, logits[:, 0, :]


def init_caches(cfg, batch_size, max_seq, encoder_seq=None,
                device: DeviceLike = None):
    """Empty caches on ``device``, leaves stacked over the pattern
    repetitions: k/v ``(reps, B, W, nkv, hd)``, ``pos`` ``(reps, W)``."""
    _check_decoder_only(cfg)
    dev = resolve_device(device)
    blocks = tuple(
        _stack([B.block_init_cache(cfg, kind, batch_size, max_seq, dev)
                for _ in range(cfg.pattern_repeats)])
        for kind in cfg.block_pattern)
    return {"blocks": blocks, "cross_kv": None}


def lm_decode_step(cfg, params, caches, tokens, pos):
    """tokens: (B, 1) integer tensor; pos: int, the current absolute
    position.

    Updates ``caches`` in place (each block's slot for ``pos``) and
    returns (caches, logits (B, vocab)), the same caches object.
    """
    _check_decoder_only(cfg)
    pos = int(pos)
    positions = torch.full((1,), pos, dtype=torch.int32, device=tokens.device)
    x = embed_tokens(cfg, params, tokens, positions)
    for r in range(cfg.pattern_repeats):
        for p_idx, kind in enumerate(cfg.block_pattern):
            x, _ = B.block_apply_step(
                cfg, kind, _rep(params["blocks"][p_idx], r), x,
                _rep(caches["blocks"][p_idx], r), pos)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return caches, logits_fn(cfg, params, x)[:, 0, :]


__all__ = ["embed_tokens", "init_caches", "lm_decode_step", "lm_forward",
           "lm_prefill", "lm_specs", "logits_fn", "padded_vocab"]

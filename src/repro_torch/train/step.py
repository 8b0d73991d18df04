"""Step functions: the cascade scorer's training step on
``torch.autograd`` (``make_scorer_train_step``) and the language model's
serving steps (``make_prefill_step``, ``make_decode_step``) for every
config, an encoder-decoder one with ``batch["audio_embed"]`` at prefill.
The language model's training step waits for ROADMAP.md Queue 1 item
10.6.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm_decode_step, lm_prefill
from repro_torch.sharding.api import tree_leaves, tree_map
from repro_torch.train.optimizer import AdamW


def make_scorer_train_step(loss_fn, opt: AdamW):
    """Generic supervised step for small heads (e.g. the cascade's
    semantic scorer): ``loss_fn(params, batch) -> (loss, metrics)`` on a
    tree of tensors. Returns ``step(params, opt_state, batch) -> (params',
    opt_state', metrics)``, the reference's contract; ``metrics`` holds
    the loss function's metrics, the optimizer's and ``"loss"``, all
    detached tensors."""
    def scorer_step(params, opt_state, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, tree_leaves(live))
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **opt_metrics,
                                   "loss": loss.detach()}
    return scorer_step


def make_prefill_step(cfg, max_seq: int):
    def prefill_step(params, batch):
        return lm_prefill(cfg, params, batch, max_seq=max_seq)
    return prefill_step


def make_decode_step(cfg, sample: bool = False):
    """Greedy decoding; ``sample`` is accepted and unused, as in the
    reference."""
    def serve_step(params, caches, tokens, pos):
        """One-token decode for a running batch; greedy next token
        ``(B, 1)`` int32. ``caches`` is updated in place and returned."""
        caches, logits = lm_decode_step(cfg, params, caches, tokens, pos)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return caches, next_tok, logits
    return serve_step


__all__ = ["make_decode_step", "make_prefill_step", "make_scorer_train_step"]

"""Step functions on ``torch.autograd``: the language model's training
step (``make_train_step``) and the cascade scorer's
(``make_scorer_train_step``), and the language model's serving steps
(``make_prefill_step``, ``make_decode_step``) for every config, an
encoder-decoder one with ``batch["audio_embed"]``.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm_decode_step, lm_loss, lm_prefill
from repro_torch.sharding.api import gather_dim, is_dtensor, tree_leaves, \
    tree_map, tree_unflatten
from repro_torch.train.optimizer import AdamW


def value_and_grad(loss_fn, params, *args):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)`` on
    autograd: ``((loss, metrics), grads)``, ``grads`` a tree like
    ``params`` (zeros for a leaf the loss does not reach; a DTensor
    parameter's gradient placed as the parameter is), the loss and
    metrics detached."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = tree_unflatten(params, [
        torch.zeros_like(p) if g is None else
        g.redistribute(p.device_mesh, p.placements) if is_dtensor(g) else g
        for p, g in zip(leaves, grads)])
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), grads


def make_train_step(cfg, opt: AdamW):
    """``step(params, opt_state, batch) -> (params', opt_state',
    metrics)``: one AdamW step on ``lm_loss``'s gradient; ``metrics``
    holds ``lm_loss``'s, ``grad_norm``, ``lr`` and ``loss_total`` (the
    loss with the aux term), all detached."""
    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(
            lambda p: lm_loss(cfg, p, batch), params)
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        return params, opt_state, {**metrics, **opt_metrics,
                                   "loss_total": loss}
    return train_step


def make_scorer_train_step(loss_fn, opt: AdamW):
    """Generic supervised step for small heads (e.g. the cascade's
    semantic scorer): ``loss_fn(params, batch) -> (loss, metrics)`` on a
    tree of tensors. Returns ``step(params, opt_state, batch) -> (params',
    opt_state', metrics)``, the reference's contract; ``metrics`` holds
    the loss function's metrics, the optimizer's and ``"loss"``, all
    detached tensors."""
    def scorer_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}
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
        # the argmax of vocab shards is unreliable in some torch versions
        next_tok = torch.argmax(gather_dim(logits, -1), dim=-1).to(
            torch.int32)[:, None]
        return caches, next_tok, logits
    return serve_step


__all__ = ["make_decode_step", "make_prefill_step", "make_scorer_train_step",
           "make_train_step", "value_and_grad"]

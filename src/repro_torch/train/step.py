"""Training step functions on ``torch.autograd``.

Only the cascade scorer's step is here (``make_scorer_train_step``); the
language model's train, prefill and decode steps follow with its KV
caches and training (ROADMAP.md Queue 1 item 10).
"""
from __future__ import annotations

import torch

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


__all__ = ["make_scorer_train_step"]

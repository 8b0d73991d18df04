"""Step functions on ``torch.autograd``: the language model's training
step (``make_train_step``) and the cascade scorer's
(``make_scorer_train_step``), and the language model's serving steps
(``make_prefill_step``, ``make_decode_step``) for every config, an
encoder-decoder one with ``batch["audio_embed"]``.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm_decode_step, lm_loss, lm_prefill
from repro_torch.sharding.api import all_gather, is_dtensor, shards_dim, \
    tree_leaves, tree_map, tree_unflatten
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


def _greedy_token(logits):
    """The index of each row's largest logit, ``(B, V) -> (B,)``, the
    lowest one among equal maxima: ``jnp.argmax``'s. Plain logits and
    DTensor logits whole along the vocab take ``torch.argmax``. Logits
    split along the vocab stay split (DTensor's own argmax of vocab
    shards is unreliable in some torch versions): each rank takes its
    shard's largest logit and its first index, offset by the shard's
    start; the (max, index) pairs of the ranks are gathered over each
    vocab-split mesh dim and the first of the largest kept."""
    if not shards_dim(logits, -1):
        return torch.argmax(logits, dim=-1)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, vd, place = logits.device_mesh, logits.ndim - 1, logits.placements
    x = logits.to_local()
    _, offset = compute_local_shape_and_global_offset(logits.shape, mesh,
                                                      place)
    idx = torch.argmax(x, dim=-1, keepdim=True)
    # float64 holds both a bf16 / float32 logit and an index exactly
    best = torch.cat([x.gather(-1, idx).double(),
                      (idx + offset[vd]).double()], dim=-1)       # (b, 2)
    for i, p in enumerate(place):
        if p == Shard(vd):
            pairs = all_gather(best, mesh.get_group(i))           # (n, b, 2)
            top = pairs[..., 0].amax(0)
            first = torch.where(pairs[..., 0] == top, pairs[..., 1],
                                torch.inf).amin(0)
            best = torch.stack([top, first], dim=-1)
    rows = [Replicate() if p == Shard(vd) else p for p in place]
    return DTensor.from_local(best[..., 1].long(), mesh, rows,
                              run_check=False)


def make_decode_step(cfg, sample: bool = False):
    """Greedy decoding; ``sample`` is accepted and unused, as in the
    reference."""
    def serve_step(params, caches, tokens, pos):
        """One-token decode for a running batch; greedy next token
        ``(B, 1)`` int32. ``caches`` is updated in place and returned."""
        caches, logits = lm_decode_step(cfg, params, caches, tokens, pos)
        next_tok = _greedy_token(logits).to(torch.int32)[:, None]
        return caches, next_tok, logits
    return serve_step


__all__ = ["make_decode_step", "make_prefill_step", "make_scorer_train_step",
           "make_train_step", "value_and_grad"]

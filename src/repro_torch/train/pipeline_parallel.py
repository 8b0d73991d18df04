"""GPipe-style pipeline parallelism over a one-axis mesh — the port of
``src/repro/train/pipeline_parallel.py``.

The repetitions of the block stack are split into contiguous stages, one
per mesh entry: stage ``s`` holds repetitions ``[s*R/S, (s+1)*R/S)`` on
``mesh.devices[s]``. Microbatches stream through in the classic
fill-drain schedule (M microbatches, S stages, M+S-1 slots); at slot
``t`` stage ``s`` runs microbatch ``t - s``, and a finished microbatch
moves to the next stage's device with ``.to()``, through which autograd
carries the backward as ``jax.grad`` does through the reference's
``ppermute``. The reference computes bubble slots on garbage and masks
them out of the loss; here they are skipped, which gives the same loss.
Each repetition runs under activation checkpointing, as the reference's
``jax.checkpoint(body)`` does.

One process drives every stage (as the fleet drives its shards), so a
mesh may hold one device several times. The embedding runs on stage 0;
the last stage takes each microbatch through the final norm, the head
and its mean CE as it finishes, and the loss is the mean of those (the
reference stashes the finished microbatches and takes one mean over all
of them: the same value for equal microbatches, up to the order of the
float sums). A microbatch thus goes through exactly the operations of
``lm_loss`` on its rows.

Scope: decoder-only models with a one-kind pattern; the loss is the mean
next-token CE (no aux term, no mask), as in the reference.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.blocks import block_apply_full
from repro_torch.models.common import rmsnorm
from repro_torch.models.lm import embed_tokens, logits_fn, token_ce
from repro_torch.sharding.api import tree_map


def make_pp_loss(cfg, mesh, num_microbatches: int, axis: str = "stage"):
    """Returns ``loss_fn(params, batch)`` computing the pipelined CE loss
    on the last stage's device.

    params: the standard lm param tree (blocks stacked over reps).
    batch: tokens/labels (B, S) with B % num_microbatches == 0.
    Raises ``ValueError`` where the reference asserts: a pattern of more
    than one block kind, repetitions the stage count does not divide, a
    batch the microbatch count does not divide; and for an
    encoder-decoder config, whose decoder needs the encoder's output.
    """
    if len(cfg.block_pattern) != 1:
        raise ValueError("pipeline parallelism needs a one-kind block "
                         f"pattern, {cfg.name} has {cfg.block_pattern}")
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: pipeline parallelism is for "
                         "decoder-only models")
    kind = cfg.block_pattern[0]
    devices = tuple(mesh.devices)
    nstages = mesh.shape[axis]
    M = num_microbatches
    R = cfg.pattern_repeats
    if R % nstages:
        raise ValueError(f"{R} repetitions do not split over {nstages} "
                         "stages")
    per = R // nstages

    def run_stage(x, blocks_local, positions):
        def body(x, prm):
            return block_apply_full(cfg, kind, prm, x, positions)[0]

        for r in range(per):
            prm = tree_map(lambda a: a[r], blocks_local,
                           is_leaf=torch.is_tensor)
            if torch.is_grad_enabled():
                x = checkpoint(body, x, prm, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = body(x, prm)
        return x

    def loss_fn(params, batch):
        B, S = batch["tokens"].shape
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} "
                             "microbatches")
        mb = B // M
        toks = batch["tokens"].reshape(M, mb, S)
        blocks = params["blocks"][0]
        stages = [tree_map(lambda a: a[s * per:(s + 1) * per].to(dev),
                           blocks, is_leaf=torch.is_tensor)
                  for s, dev in enumerate(devices)]
        first, last = devices[0], devices[-1]
        positions = [torch.arange(S, dtype=torch.int32, device=d)
                     for d in devices]
        head = {"embed": params["embed"].to(last)}
        if "lm_head" in params:
            head["lm_head"] = params["lm_head"].to(last)
        final_norm = params["final_norm"].to(last)
        labels = batch["labels"].reshape(M, mb, S).to(last)

        # slot t: stage s runs microbatch t - s on what stage s - 1
        # handed it at slot t - 1
        held = [None] * nstages
        losses = []
        for t in range(M + nstages - 1):
            for s in reversed(range(nstages)):      # read before overwrite
                m = t - s
                if not 0 <= m < M:
                    continue
                if s == 0:
                    x = embed_tokens(cfg, {"embed": params["embed"].to(first)},
                                     toks[m].to(first), positions[0])
                else:
                    x = held[s - 1].to(devices[s])
                h = run_stage(x, stages[s], positions[s])
                if s == nstages - 1:
                    logits = logits_fn(cfg, head, rmsnorm(h, final_norm,
                                                          cfg.norm_eps))
                    losses.append(token_ce(logits, labels[m]).mean())
                else:
                    held[s] = h
        return torch.stack(losses).mean()

    return loss_fn


__all__ = ["make_pp_loss"]

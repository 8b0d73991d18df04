"""AdamW and learning-rate schedules on torch tensors.

The reference's contract (``src/repro/train/optimizer.py``): the
optimizer state mirrors the parameter tree — ``{"m": tree, "v": tree,
"step": int32 scalar}`` — and ``update(grads, state, params)`` returns
``(params', state', {"grad_norm", "lr"})`` without touching its inputs.
Every step is float32 arithmetic in the reference's order, on the
parameters' device. Trees are nested dicts / tuples / lists of tensors
(``repro_torch.sharding.api``: dict keys in sorted order).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.sharding.api import tree_leaves, tree_map, tree_unflatten


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device (a tensor operand, so
    a division by it is a true division on every device)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> Callable:
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / _f32(max(1.0, warmup_steps), step)
        t = (step - warmup_steps) / _f32(max(1.0, total_steps - warmup_steps),
                                         step)
        t = torch.clamp(t, 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def constant_lr(lr: float) -> Callable:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params):
        leaf = tree_leaves(params)[0]
        return {
            "m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
        }

    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = (torch.clamp_max(_f32(self.grad_clip, gnorm)
                                 / torch.clamp_min(gnorm, 1e-9), 1.0)
                 if self.grad_clip else 1.0)
        b1, b2 = self.b1, self.b2
        gs, ms, vs = (tree_leaves(t) for t in (grads, state["m"], state["v"]))
        m = [b1 * mo + (1 - b1) * g * scale for mo, g in zip(ms, gs)]
        v = [b2 * vo + (1 - b2) * (g * scale) ** 2 for vo, g in zip(vs, gs)]
        sf = step.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(b1, sf), sf)
        bc2 = 1 - torch.pow(_f32(b2, sf), sf)
        lr = self.lr(step)

        def upd(p, mo, vo):
            mhat = mo / bc1
            vhat = vo / bc2
            return p - lr * (mhat / (torch.sqrt(vhat) + self.eps)
                             + self.weight_decay * p)

        new = [upd(p, mo, vo)
               for p, mo, vo in zip(tree_leaves(params), m, v)]
        return (tree_unflatten(params, new),
                {"m": tree_unflatten(params, m),
                 "v": tree_unflatten(params, v), "step": step},
                {"grad_norm": gnorm, "lr": lr})


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))


__all__ = ["AdamW", "constant_lr", "global_norm", "warmup_cosine"]

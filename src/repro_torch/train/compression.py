"""Gradient compression for cross-pod reduction (int8 / top-k + error
feedback) — the port of ``src/repro/train/compression.py``.

On a multi-pod deployment the once-per-step gradient all-reduce over
the 'pod' axis crosses the slow links, so each pod sends int8 (4x fewer
bytes) or its top-k values; an error-feedback accumulator makes the
compression unbiased over time (EF-SGD style: the residual is replayed
into the next step).

Two layers:
  * ``ef_compressed_psum`` — the collective: one gradient tree and one
    error-feedback tree per mesh entry, each entry's ``g + e``
    compressed, the results summed in mesh order (the reference's
    ``psum`` over the pod axis) and each entry's new residual returned.
  * ``make_dp_compressed_train_step`` — a data-parallel train step using
    it over a one-axis mesh (``.devices``, ``.shape``: the
    ``CameraMesh`` of ``repro_torch.core.fleet.fleet_mesh``). One
    process drives every pod, as in the fleet: pod ``i`` computes its
    gradient on its rows of the batch on ``mesh.devices[i]``, and the
    model, its optimizer state and the reduced gradient live on the
    first pod's device (the one copy of the reference's replicas).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.sharding.api import tree_leaves, tree_map, tree_unflatten
from repro_torch.train.step import value_and_grad


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------

def int8_quantize(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float scale); ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q, scale):
    return q.to(torch.float32) * scale


def topk_mask(x, frac: float):
    """Keep the top-|frac| fraction of entries (by magnitude), zero rest;
    every entry tied with the k-th largest magnitude is kept."""
    flat = torch.abs(x.reshape(-1))
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat, k).values[-1]
    return torch.where(torch.abs(x) >= thresh, x, torch.zeros_like(x))


def compress(x, method: str, topk_frac: float):
    if method == "int8":
        q, s = int8_quantize(x)
        return int8_dequantize(q, s)
    if method == "topk":
        return topk_mask(x, topk_frac)
    if method == "none":
        return x
    raise ValueError(method)


# ---------------------------------------------------------------------------
# Error-feedback compressed sum over mesh entries
# ---------------------------------------------------------------------------

def ef_compressed_psum(grads: Sequence, ef_state: Sequence,
                       method: str = "int8", topk_frac: float = 0.05):
    """grads/ef_state: one tree of local gradients and one of error
    accumulators per mesh entry, in mesh order. Returns (the sum over
    entries of each entry's compressed ``g + e``, on the first entry's
    device; the list of each entry's new accumulator ``g + e -
    compressed``, on its own device)."""
    total, new_ef = None, []
    for g_tree, e_tree in zip(grads, ef_state):
        gs = [g.to(torch.float32) + e
              for g, e in zip(tree_leaves(g_tree), tree_leaves(e_tree))]
        approx = [compress(g, method, topk_frac) for g in gs]
        new_ef.append(tree_unflatten(e_tree,
                                     [g - a for g, a in zip(gs, approx)]))
        if total is None:
            total = approx
        else:
            total = [t + a.to(t.device) for t, a in zip(total, approx)]
    return tree_unflatten(grads[0], total), new_ef


# ---------------------------------------------------------------------------
# Pure-DP compressed train step (pod axis = data parallel)
# ---------------------------------------------------------------------------

def make_dp_compressed_train_step(loss_fn, opt, mesh, axis: str = "pod",
                                  method: str = "int8",
                                  topk_frac: float = 0.05):
    """loss_fn(params, batch) -> (loss, metrics). The model is one copy
    on ``mesh.devices[0]``; the batch is split by its leading rows over
    the ``mesh.shape[axis]`` pods. Returns ``(step, init_ef)``:
    ``init_ef(params)`` is the error-feedback state, float32 zeros with a
    leading per-pod axis, and ``step(params, opt_state, ef, batch) ->
    (params', opt_state', ef', metrics)`` reduces the pods' compressed
    gradients, divides them by the pod count, takes one optimizer step
    and averages the loss function's metrics over the pods in pod order
    (the optimizer's metrics beside them)."""
    n = mesh.shape[axis]
    devices = tuple(mesh.devices)

    def init_ef(params):
        return tree_map(lambda p: torch.zeros((n,) + tuple(p.shape),
                                              dtype=torch.float32,
                                              device=p.device), params)

    def step(params, opt_state, ef, batch):
        rows = {k: v.shape[0] // n for k, v in batch.items()}
        grads, efs, metrics = [], [], []
        for i, dev in enumerate(devices):
            local = {k: v[i * rows[k]:(i + 1) * rows[k]].to(dev)
                     for k, v in batch.items()}
            p_i = tree_map(lambda p: p.to(dev), params)
            (_, m), g = value_and_grad(loss_fn, p_i, local)
            grads.append(g)
            efs.append(tree_map(lambda e: e[i].to(dev), ef))
            metrics.append(m)
        red, new_ef = ef_compressed_psum(grads, efs, method, topk_frac)
        home = tree_leaves(params)[0].device
        red = tree_map(lambda g: g.to(home) / n, red)
        ef = tree_unflatten(ef, [torch.stack([e.to(home) for e in es])
                                 for es in zip(*(tree_leaves(e)
                                                 for e in new_ef))])
        metrics = {k: sum(m[k].to(home) for m in metrics) / n
                   for k in metrics[0]}
        params, opt_state, om = opt.update(red, opt_state, params)
        return params, opt_state, ef, {**metrics, **om}

    return step, init_ef


__all__ = ["compress", "ef_compressed_psum", "int8_dequantize",
           "int8_quantize", "make_dp_compressed_train_step", "topk_mask"]

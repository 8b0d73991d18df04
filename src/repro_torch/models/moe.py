"""Top-k Mixture-of-Experts with scatter-based dispatch — the port of
``src/repro/models/moe.py``.

Tokens are scattered into per-expert capacity buffers (bytes, not
FLOPs), the experts run as batched products over their buffers, and the
results are gathered back for the combine. The GShard one-hot dispatch
is kept (``impl='onehot'``) as the reference keeps it, a baseline.

Capacity is applied per sequence (group = batch row), giving a fixed
(E, C) buffer shape: C = ceil(top_k * capacity_factor * S / E). A token
past its expert's capacity is dropped: it adds zeros into slot C - 1,
which a kept token may hold, so the dispatch is an add, never an
assignment.

The dispatch and the combine work row by row, as the reference's
``vmap`` over batch rows does: on a mesh each rank scatters into, and
gathers from, the buffers of its own batch rows only
(``sharding.api.batch_local``), the expert dim of the outputs gathered.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import silu
from repro_torch.sharding.api import ParamSpec, batch_local, constrain, \
    contiguous_grad, is_dtensor


def moe_specs(cfg) -> dict:
    d, dff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamSpec((d, E), ("embed", "expert"), scale=0.02),
        "gate": ParamSpec((E, d, dff), ("expert", "embed", "expert_mlp")),
        "up": ParamSpec((E, d, dff), ("expert", "embed", "expert_mlp")),
        "down": ParamSpec((E, dff, d), ("expert", "expert_mlp", "embed")),
    }


def capacity(cfg, seq_len: int) -> int:
    return max(1, math.ceil(cfg.top_k * cfg.moe_capacity_factor * seq_len
                            / cfg.num_experts))


def _one_hot(idx, n, dtype):
    """``idx[..., None] == arange(n)`` as ``dtype`` (``F.one_hot`` checks
    its indices' range on the host: a device synchronisation a call)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(params, cfg, x):
    """x: (B,S,d) -> (top_idx, top_w, aux_loss). top_*: (B,S,k).

    The top k are taken by a stable descending sort, so that of tied
    probabilities the lower expert comes first, as ``lax.top_k`` gives
    them (router logits are in the activation dtype: bf16 ties occur).
    """
    logits = torch.matmul(x, params["router"].to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[..., :cfg.top_k], top_idx[..., :cfg.top_k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    # Switch-style load-balance aux loss
    E = cfg.num_experts
    assign = _one_hot(top_idx, E, torch.float32).sum(dim=2)     # (B,S,E)
    frac_tokens = assign.mean(dim=(0, 1)) / cfg.top_k
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return top_idx, top_w.to(x.dtype), aux


def _positions_in_expert(top_idx, E):
    """Assignment order positions. top_idx: (B,S,k) -> pos (B,S,k) int32.

    The count runs along the last axis of an (B, E, S*k) one-hot: a scan
    over the middle axis of (B, S*k, E), as the reference lays it out,
    took 3.8 ms a layer on an H100 at 4 x 2048 tokens (PERF.md §6)."""
    B, S, k = top_idx.shape
    flat = top_idx.reshape(B, 1, S * k).long()
    onehot = (flat == torch.arange(E, device=flat.device)[:, None]).to(
        torch.int32)                                            # (B,E,Sk)
    pos = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot
    return torch.gather(pos, 1, flat)[:, 0].reshape(B, S, k)


def _expert_parallel(params, xe):
    """``_expert_ffn`` over DTensors, each rank on its own experts (those
    of the mesh dims that split ``gate``'s experts) and batch rows, the
    weights' other splits gathered: DTensor cannot flatten the batch and
    sharded expert dims of a batched product in some torch versions.
    Where the experts do not divide a mesh dim that splits their d_ff
    (the ``"expert_mlp"`` fallback: ``gate``/``up`` on dim 2, ``down`` on
    dim 1), the d_ff stays split: ``gate``/``up`` are column-parallel,
    ``down`` row-parallel, so the output, and ``xe``'s gradient, are
    partial sums over that dim. A weight's local gradient comes from the
    rank's batch rows alone: a partial sum over the mesh dims that split
    the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ref = next(t for t in (xe, params["gate"]) if is_dtensor(t))
    mesh = ref.device_mesh
    rep = [Replicate()] * mesh.ndim
    names = ("gate", "up", "down")
    pg, pu, pd = (params[n].placements if is_dtensor(params[n]) else rep
                  for n in names)
    px = xe.placements if is_dtensor(xe) else rep
    ep = [p == Shard(0) for p in pg]
    fp = [g == u == Shard(2) and d == Shard(1) and x != Shard(0)
          for g, u, d, x in zip(pg, pu, pd, px)]
    place_x = [Shard(1) if e else Shard(0) if p == Shard(0) else Replicate()
               for e, p in zip(ep, px)]
    place_w = [[Shard(0) if e else Shard(dim) if f else Replicate()
                for e, f in zip(ep, fp)] for dim in (2, 2, 1)]
    grad_w = [[Partial() if x == Shard(0) else p
               for x, p in zip(place_x, w)] for w in place_w]
    place_y = [Partial() if f else p for f, p in zip(fp, place_x)]
    return local_map(
        lambda x, *w: _expert_ffn(
            dict(zip(names, map(contiguous_grad, w))), contiguous_grad(x)),
        out_placements=place_y, in_placements=(place_x, *place_w),
        in_grad_placements=(place_y, *grad_w),
        device_mesh=mesh, redistribute_inputs=True)(
            xe, *(params[n] for n in names))


def _expert_ffn(params, xe):
    """xe: (B,E,C,d) -> (B,E,C,d)."""
    if is_dtensor(xe) or is_dtensor(params["gate"]):
        return _expert_parallel(params, xe)
    dt = xe.dtype
    h = silu(torch.matmul(xe, params["gate"].to(dt)))
    h = h * torch.matmul(xe, params["up"].to(dt))
    h = constrain(h, "batch", "expert", None, "expert_mlp")
    return torch.matmul(h, params["down"].to(dt))


def _flat_rows(slot, n_slots):
    """Row b's slots (B, Sk) as rows of one flat buffer of B * n_slots
    rows: b * n_slots + slot."""
    B = slot.shape[0]
    return (slot + torch.arange(B, device=slot.device)[:, None] * n_slots
            ).reshape(-1)


def _dispatch(vals, slot, E, C):
    """Row b's values added into its E * C slots at ``slot[b]``. vals:
    (B, Sk, d), slot: (B, Sk) -> (B, E, C, d), by one ``index_add``."""
    B, Sk, d = vals.shape
    xe = torch.zeros((B * E * C, d), dtype=vals.dtype, device=vals.device)
    return xe.index_add(0, _flat_rows(slot, E * C),
                        vals.reshape(B * Sk, d)).reshape(B, E, C, d)


def _combine_rows(ye, slot):
    """Row b's expert outputs at ``slot[b]``. ye: (B, E, C, d), slot:
    (B, Sk) -> (B, Sk, d)."""
    B, E, C, d = ye.shape
    return ye.reshape(B * E * C, d)[_flat_rows(slot, E * C)].reshape(B, -1, d)


def moe_scatter(params, cfg, x):
    """Scatter-based MoE. x: (B,S,d) -> (y, aux_loss)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = capacity(cfg, S)
    top_idx, top_w, aux = _route(params, cfg, x)
    pos = _positions_in_expert(top_idx, E)                      # (B,S,k)
    keep = pos < C
    flat_slot = top_idx * C + torch.clamp(pos, max=C - 1)       # (B,S,k)

    x_rep = x[:, :, None, :].expand(B, S, k, d).reshape(B, S * k, d)
    slot = flat_slot.reshape(B, S * k)
    keep_f = keep.reshape(B, S * k, 1).to(x.dtype)
    # each rank its own batch rows (a DTensor's batch split): DTensor has
    # no rule for a scatter or gather by computed rows
    xe = batch_local(lambda _, v, s: _dispatch(v, s, E, C), None,
                     x_rep * keep_f, slot)
    xe = constrain(xe, "batch", "expert", None, None)
    ye = _expert_ffn(params, xe)

    y_sel = batch_local(lambda _, ye, s: _combine_rows(ye, s), None,
                        ye, slot)                               # (B,Sk,d)
    w = top_w.reshape(B, S * k, 1).to(x.dtype) * keep_f
    y = torch.sum((y_sel * w).reshape(B, S, k, d), dim=2)
    return constrain(y, "batch", None, "embed"), aux


def moe_onehot(params, cfg, x):
    """GShard-style one-hot dispatch (the reference's baseline; its
    (B,S,k,E,C) dispatch tensor costs T*E*C*d MACs)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = capacity(cfg, S)
    top_idx, top_w, aux = _route(params, cfg, x)
    pos = _positions_in_expert(top_idx, E)
    keep = pos < C
    expert_1h = _one_hot(top_idx, E, x.dtype)                   # (B,S,k,E)
    disp = (expert_1h[..., None]
            * _one_hot(torch.clamp(pos, max=C - 1), C, x.dtype)[..., None, :]
            * keep[..., None, None].to(x.dtype))                # (B,S,k,E,C)
    disp = torch.sum(disp, dim=2)                               # (B,S,E,C)
    xe = torch.einsum("bsec,bsd->becd", disp, x)
    ye = _expert_ffn(params, xe)
    comb = disp * torch.sum(top_w[..., None, None] * expert_1h[..., None],
                            dim=2)
    y = torch.einsum("bsec,becd->bsd", comb, ye)
    return constrain(y, "batch", None, "embed"), aux


def moe_apply(params, cfg, x, impl: str = "scatter"):
    if impl == "onehot":
        return moe_onehot(params, cfg, x)
    return moe_scatter(params, cfg, x)


__all__ = ["capacity", "moe_apply", "moe_onehot", "moe_scatter", "moe_specs"]

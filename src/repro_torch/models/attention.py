"""GQA attention: full-sequence (train/prefill) and one-token decode
over KV caches — the port of ``src/repro/models/attention.py``.

Layouts (as in the reference):
  activations x:        (B, S, d)
  q/k/v:                (B, S, n_heads, head_dim)
  KV cache:             {"k": (B, W, n_kv, hd), "v": same, "pos": (W,) int32}
      W = max_seq for global layers, the sliding window for local ones.
      ``pos[slot]`` is the absolute position held by the slot (-1 = empty).
      An int8 cache adds "k_scale"/"v_scale" (B, W, n_kv) bf16.
  scores:               (B, n_kv, group, S_q, S_k), softmax in fp32.

Attention is computed as the reference computes it, outside any kernel:
the score product in the promoted dtype of q and k, then
``.float() * scale``, the mask value -1e30, the softmax in float32, and
the probabilities cast to ``v``'s dtype before the PV product. A cache is
bf16 (or int8) whatever the activation dtype, so in a float32 config the
decode scores are float32 and its output is bf16, as in the reference.
The flash attention kernel is a separate entry point
(``repro_torch.kernels.flash_attention``), as in the reference;
``cfg.attention_impl`` selects nothing.

Unlike the reference's functional updates, ``prefill_into_cache`` and
``attend_decode`` write into the caller's cache tensors in place and
return the same dict: a step costs the new entries, not a copy of the
cache.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import apply_rope, remat
from repro_torch.sharding.api import ParamSpec, all_reduce, constrain, \
    contiguous_grad, distribute_like, is_dtensor, reshape, shards_dim, \
    write_index

Q_CHUNK = 1024  # q-chunk length above which the queries go in blocks


def _pick_chunk(S: int) -> int:
    """Largest divisor of S that is <= Q_CHUNK (S itself if none > 1)."""
    if S <= Q_CHUNK:
        return S
    for c in range(Q_CHUNK, 0, -1):
        if S % c == 0:
            return c
    return S


def attention_specs(cfg, cross=False) -> dict:
    """head_dim is never sharded (see the reference's note)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    specs = {
        "wq": ParamSpec((d, nq, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, nkv, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, nkv, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((nq, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias and not cross:
        specs["bq"] = ParamSpec((nq, hd), ("heads", None), init="zeros")
        specs["bk"] = ParamSpec((nkv, hd), ("kv_heads", None), init="zeros")
        specs["bv"] = ParamSpec((nkv, hd), ("kv_heads", None), init="zeros")
    return specs


def _proj(x, w):
    """'bsd,dnh->bsnh' as one matrix product."""
    d, n, h = w.shape
    y = torch.matmul(x, reshape(w.to(x.dtype), d, n * h))
    return reshape(y, *x.shape[:-1], n, h)


def _project_q(params, x):
    q = _proj(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    return constrain(q, "batch", None, "heads", None)


def _project_kv(params, x):
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bk" in params:
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    return k, v


def _query_split(q, k, place, pq):
    """The mesh dim that splits the query heads alone (k and v whole on
    it), where each rank's block of ``nq / M`` query heads lines up with
    the groups (``nq / M`` divides the group size ``g`` or ``g`` divides
    it) and no mesh dim splits the heads of all three; else None."""
    from torch.distributed.tensor import Shard
    dims = [i for i, (a, p) in enumerate(zip(pq, place))
            if a == Shard(2) and p != Shard(2)]
    if len(dims) != 1 or Shard(2) in place:
        return None
    nq, nkv = q.shape[2], k.shape[2]
    M, g = q.device_mesh.size(dims[0]), nq // nkv
    if nq % M or (g % (nq // M) and (nq // M) % g):
        return None
    return dims[0]


def _sharded_heads(q, k, v, mask, scale):
    """Attention over DTensors whose heads are sharded (k and v whole
    along the sequence). DTensor cannot flatten a batched product's
    sharded non-leading dim (the heads of the 5-D scores, in some torch
    versions), so each rank attends its own batch rows and heads
    (``local_map``; query heads ``i*g..`` go with key head ``i``, so
    blocks of both stay aligned); with no head sharded, ``None`` and q,
    k, v for DTensor's own propagation. Where the KV heads do not divide
    a mesh dim that splits the query heads (``_query_split``), k and v
    are whole on it, as the reference's GSPMD keeps them: each rank
    attends its own query heads against the KV heads they group with,
    and k's and v's gradients are partial sums over that dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t.device_mesh for t in (q, k, v) if is_dtensor(t))
    rep = (Replicate(),) * mesh.ndim
    pq, pk, pv = (t.placements if is_dtensor(t) else rep for t in (q, k, v))
    if not any(Shard(2) in p for p in (pq, pk, pv)):
        return None, (q, k, v)
    place = [Shard(0) if a == Shard(0) else Shard(2)
             if a == b == c == Shard(2) else Replicate()
             for a, b, c in zip(pq, pk, pv)]
    place_q, grad_kv = place, place
    qdim = _query_split(q, k, place, pq) if is_dtensor(q) else None
    if qdim is not None:
        place_q, grad_kv = list(place), list(place)
        place_q[qdim], grad_kv[qdim] = Shard(2), Partial()
        nl, g = q.shape[2] // mesh.size(qdim), q.shape[2] // k.shape[2]
        lo, n = mesh.get_local_rank(qdim) * nl // g, max(1, nl // g)

    def attend(q, k, v, mask, scale):
        k, v = contiguous_grad(k), contiguous_grad(v)
        if qdim is not None:             # the rank's query heads' KV heads
            k, v = k[:, :, lo:lo + n], v[:, :, lo:lo + n]
        return _gqa_scores_softmax_out(contiguous_grad(q), k, v, mask, scale)
    return local_map(
        attend, out_placements=place_q,
        in_placements=(place_q, place, place, list(rep), None),
        in_grad_placements=(place_q, grad_kv, grad_kv, list(rep), None),
        device_mesh=mesh, redistribute_inputs=True)(
            q, k, v, mask, scale), None


def _slot_role(pq, pkv) -> str:
    """The role of a mesh dim in ``_slot_split``, from q's placement and
    k's (and v's) on it: the cache's split decides (it never moves),
    then q's batch rows."""
    from torch.distributed.tensor import Shard
    role = {Shard(0): "batch", Shard(1): "slots", Shard(2): "heads",
            Shard(3): "head_dim"}.get(pkv)
    return role or ("batch" if pq == Shard(0) else "whole")


def _slot_placements(role: str) -> tuple:
    """q's, k's and v's, and the output's placements on a mesh dim of
    ``role``: the output is a partial sum over the slots."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if role == "slots":
        return Replicate(), Shard(1), Partial()
    if role == "whole":
        return (Replicate(),) * 3
    return (Shard({"batch": 0, "heads": 2, "head_dim": 3}[role]),) * 3


def _slot_split(q, k, v, mask, scale):
    """Decode attention over k and v split along their slots (``Shard(1)``
    on one or more mesh dims: a cache placed by ``sharding.caches``), as
    the reference's GSPMD partitions it: nothing of the cache moves.
    Each mesh dim takes a role (``_slot_role``): on a slot-split dim
    each rank attends to its own slots with q whole (one token); on a
    head-split dim (k and v ``Shard(2)``) each rank keeps its own heads,
    query heads ``i*g..`` with KV head ``i``; a batch split stays; on a
    head_dim split (the ``head_dim`` fallback of the cache's KV heads)
    each rank's partial scores are summed over it; anything else is
    whole. A dim that splits both q's heads and the slots (``decode_32k``:
    ``cache_seq`` and ``heads`` both on ``model``) holds q whole.

    The reference's order of operations, over the rank's slots: float32
    scores times ``scale``, -1e30 where masked, the max all-reduced over
    the slot-split dims, ``exp(s - max)``, its sum all-reduced likewise,
    the probabilities normalised and cast to ``v``'s dtype, the PV
    product in ``v``'s dtype (its accumulation float32) and its partial
    outputs summed in float32 over the slot-split dims (``Partial``,
    redistributed to q's placements), then one cast to ``v``'s dtype.
    A rank whose slots are all masked gives them zero weight. ``mask``
    (a decode's: (1, 1, 1, 1, W)) is whole; each rank takes its slots'
    part from its offset. For decode: no gradient flows through the
    collectives."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = k.device_mesh
    rep = [Replicate()] * mesh.ndim
    q, v = (t if is_dtensor(t) else DTensor.from_local(
        t, mesh, rep, run_check=False) for t in (q, v))
    roles = [_slot_role(a, b) for a, b in zip(q.placements, k.placements)]
    place_q, place_kv, place_out = (
        list(p) for p in zip(*map(_slot_placements, roles)))
    groups = {r: [mesh.get_group(i) for i, x in enumerate(roles) if x == r]
              for r in ("slots", "head_dim")}
    shape, offset = compute_local_shape_and_global_offset(k.shape, mesh,
                                                          place_kv)
    lo, n = offset[1], shape[1]

    def attend(q, k, v, mask):
        mask = mask[..., lo:lo + n]
        B, Sq, nq, hd = q.shape
        nkv = k.shape[2]
        g = nq // nkv
        dt = torch.promote_types(q.dtype, k.dtype)
        qg = q.reshape(B, Sq, nkv, g, hd).permute(0, 2, 3, 1, 4).reshape(
            B, nkv, g * Sq, hd)               # no copy of k for each of g
        s = torch.matmul(qg.to(dt), k.permute(0, 2, 3, 1).to(dt)).float()
        s = all_reduce(s, "sum", groups["head_dim"]).reshape(
            B, nkv, g, Sq, -1) * scale
        s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype,
                                              device=s.device))
        e = torch.exp(s - all_reduce(s.amax(-1, keepdim=True), "max",
                                     groups["slots"]))
        p = (e / all_reduce(e.sum(-1, keepdim=True), "sum",
                            groups["slots"])).to(v.dtype)
        # in v's dtype: a float32 copy of v would double the largest
        # temporary of a decode step
        out = torch.matmul(p.reshape(B, nkv, g * Sq, -1),
                           v.permute(0, 2, 1, 3)).float()
        return out.reshape(B, nkv, g, Sq, -1).permute(0, 3, 1, 2, 4).reshape(
            B, Sq, nq, -1)
    out = local_map(attend, out_placements=place_out,
                    in_placements=(place_q, place_kv, place_kv, rep),
                    device_mesh=mesh, redistribute_inputs=True)(q, k, v, mask)
    return out.redistribute(mesh, q.placements).to(v.dtype)


def _gqa_scores_softmax_out(q, k, v, mask, scale):
    """q: (B,Sq,nq,hd) k/v: (B,Sk,nkv,hd) mask: broadcastable (B,n,g,Sq,Sk)."""
    if shards_dim(k, 1):                 # a cache split along its slots
        return _slot_split(q, k, v, mask, scale)
    if is_dtensor(q) or is_dtensor(k) or is_dtensor(v):
        out, qkv = _sharded_heads(q, k, v, mask, scale)
        if out is not None:
            return out
        q, k, v = qkv
    B, Sq, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    dt = torch.promote_types(q.dtype, k.dtype)    # as jnp.einsum promotes
    qg = reshape(q, B, Sq, nkv, g, hd).permute(0, 2, 3, 1, 4)  # (B,n,g,Sq,hd)
    kt = k.permute(0, 2, 3, 1).unsqueeze(2)                    # (B,n,1,hd,Sk)
    scores = torch.matmul(qg.to(dt), kt.to(dt)).float() * scale
    scores = torch.where(mask, scores, torch.tensor(
        -1e30, dtype=scores.dtype, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v.permute(0, 2, 1, 3).unsqueeze(2))
    return reshape(out.permute(0, 3, 1, 2, 4), B, Sq, nq, hd)


def _full_attention(q, k, v, q_positions, k_positions, *, causal, window,
                    scale):
    """Masked attention for one q block against all of k."""
    qp = q_positions[:, None]
    kp = k_positions[None, :]
    if causal:
        mask = kp <= qp
        if window is not None:
            mask &= (qp - kp) < window
    else:
        mask = torch.ones((q_positions.shape[0], k_positions.shape[0]),
                          dtype=torch.bool, device=q.device)
    return _gqa_scores_softmax_out(q, k, v, mask[None, None, None], scale)


def _wo(params, out):
    """'bsnh,nhd->bsd' as one matrix product."""
    n, h, d = params["wo"].shape
    y = torch.matmul(reshape(out, *out.shape[:-2], n * h),
                     reshape(params["wo"].to(out.dtype), n * h, d))
    return constrain(y, "batch", None, "embed")


def attend_full(params, cfg, x, positions, *, causal=True, window=None,
                kv_override=None, kv_positions=None):
    """Full-sequence attention, the queries in chunks of ``_pick_chunk(S)``
    when longer than ``Q_CHUNK`` (each chunk against all keys), each
    chunk under ``torch.utils.checkpoint`` with ``cfg.opt_attn_remat``
    while grad is enabled (nested inside block remat).

    kv_override: (k, v) for cross-attention (with causal=False).
    Returns (out, (k, v)).
    """
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    q = _project_q(params, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    if kv_override is None:
        k, v = _project_kv(params, x)
        k = apply_rope(k, positions, cfg.rope_theta)
        kv_pos = positions
    else:
        k, v = kv_override
        kv_pos = kv_positions
    S = x.shape[1]
    chunk = _pick_chunk(S)
    # opt_attn_remat: a chunk's probabilities are recomputed in the
    # backward instead of saved: O(chunk * S) of them live, not O(S^2)
    attend = remat(functools.partial(_full_attention, causal=causal,
                                     window=window, scale=scale),
                   cfg.opt_attn_remat and S > chunk)
    out = torch.cat([
        attend(q[:, i:i + chunk], k, v, positions[i:i + chunk], kv_pos)
        for i in range(0, S, chunk)], dim=1)
    return _wo(params, out), (k, v)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def _quantize_kv(x):
    """(..., hd) -> int8 values + per-(token, head) bf16 scale."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(q, scale):
    return q.to(torch.bfloat16) * scale[..., None].to(torch.bfloat16)


def init_kv_cache(cfg, batch, max_seq, *, window: Optional[int] = None,
                  dtype=torch.bfloat16, device: DeviceLike = None):
    """A zeroed cache on ``device``: a global one (``window`` None) of
    ``max_seq`` slots whose ``pos`` is ``arange``, or a ring of
    ``min(window, max_seq)`` empty slots (``pos`` -1)."""
    dev = resolve_device(device)
    nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    W = max_seq if window is None else min(window, max_seq)
    kv_dtype = torch.int8 if cfg.opt_kv_int8 else dtype
    cache = {"k": torch.zeros((batch, W, nkv, hd), dtype=kv_dtype, device=dev),
             "v": torch.zeros((batch, W, nkv, hd), dtype=kv_dtype, device=dev)}
    if window is None:
        cache["pos"] = torch.arange(W, dtype=torch.int32, device=dev)
    else:
        cache["pos"] = torch.full((W,), -1, dtype=torch.int32, device=dev)
    if cfg.opt_kv_int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((batch, W, nkv), dtype=torch.bfloat16,
                                      device=dev)
    return cache


def _put(cache, name, slots, val):
    """``cache[name][:, slots] = val``, ``slots`` a slice or an index
    tensor of unique slots. A fresh plain cache meeting DTensor keys
    becomes a DTensor placed like them; a DTensor cache, sharded along
    its slots or not, is written shard by shard, each rank the slots it
    holds (``sharding.api.write_index``)."""
    if is_dtensor(val) and not is_dtensor(cache[name]):
        cache[name] = distribute_like(cache[name], val)
    write_index(cache[name], 1, slots, val)


def _write(cache, slots, k, v):
    """k/v (B, n, nkv, hd) into ``slots`` (a slice or an index tensor of
    n slots), quantized first in an int8 cache; in place."""
    if "k_scale" in cache:
        k, ks = _quantize_kv(k)
        v, vs = _quantize_kv(v)
        _put(cache, "k_scale", slots, ks)
        _put(cache, "v_scale", slots, vs)
    _put(cache, "k", slots, k)
    _put(cache, "v", slots, v)


def prefill_into_cache(cache, k, v, positions, *, window: Optional[int]):
    """Write prefill keys/values (B, S, nkv, hd) into ``cache`` in place
    and return it: a global cache takes them at slots 0..S-1, a ring the
    last W positions at ``p % W`` (and their positions in ``pos``)."""
    W = cache["k"].shape[1]
    if window is None:
        S = k.shape[1]
        if S > W:
            raise ValueError(f"prefill of {S} tokens into a global cache of "
                             f"{W} slots")
        _write(cache, slice(0, S), k, v)
        return cache
    take = min(k.shape[1], W)                        # keep last W positions
    p_tail = positions[-take:].to(torch.int32)
    slots = (p_tail % W).long()
    _write(cache, slots, k[:, -take:], v[:, -take:])
    write_index(cache["pos"], 0, slots, p_tail)
    return cache


def attend_decode(params, cfg, x, cache, pos, *, window: Optional[int] = None,
                  cross=False):
    """One-token decode. x: (B, 1, d); pos: int, the current position.

    Writes the token's k/v (and, in a ring, its position) into ``cache``
    in place and returns (out (B, 1, d), cache). A global cache holds
    positions 0..W-1 only: ``pos >= W`` raises ``ValueError`` (the
    reference clamps the write to the last slot). ``cross=True`` attends
    to every slot of ``cache`` and writes nothing.
    """
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    pos = int(pos)
    W = cache["k"].shape[1]
    if not cross and window is None and not 0 <= pos < W:
        raise ValueError(f"decode at position {pos} past a global cache of "
                         f"{W} slots")
    pos_t = torch.tensor([pos], dtype=torch.int32, device=x.device)
    q = _project_q(params, x)                        # (B,1,nq,hd)
    q = apply_rope(q, pos_t, cfg.rope_theta)

    if cross:
        mask = torch.ones((1, 1, 1, 1, W), dtype=torch.bool, device=x.device)
        out = _gqa_scores_softmax_out(q, cache["k"], cache["v"], mask, scale)
        return _wo(params, out), cache

    k_new, v_new = _project_kv(params, x)            # (B,1,nkv,hd)
    k_new = apply_rope(k_new, pos_t, cfg.rope_theta)
    slot = pos if window is None else pos % W
    _write(cache, slice(slot, slot + 1), k_new, v_new)
    if window is not None:
        cache["pos"][slot] = pos
    slot_pos = cache["pos"]
    valid = (slot_pos >= 0) & (slot_pos <= pos)      # (W,)
    if "k_scale" in cache:
        k_att = _dequantize_kv(cache["k"], cache["k_scale"])
        v_att = _dequantize_kv(cache["v"], cache["v_scale"])
    else:
        k_att, v_att = cache["k"], cache["v"]
    out = _gqa_scores_softmax_out(q, k_att, v_att,
                                  valid[None, None, None, None], scale)
    return _wo(params, out), cache


__all__ = ["Q_CHUNK", "attend_decode", "attend_full", "attention_specs",
           "init_kv_cache", "prefill_into_cache"]

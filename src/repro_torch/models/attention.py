"""GQA attention, full-sequence forward: the port of the train/prefill
part of ``src/repro/models/attention.py``.

Layouts (as in the reference):
  activations x:        (B, S, d)
  q/k/v:                (B, S, n_heads, head_dim)
  scores:               (B, n_kv, group, S_q, S_k), softmax in fp32.

Attention is computed as the reference computes it, outside any kernel:
the score product in the activation dtype, then ``.float() * scale``,
the mask value -1e30, the softmax in float32, and the probabilities cast
to ``v``'s dtype before the PV product. The flash attention kernel is a
separate entry point (``repro_torch.kernels.flash_attention``), as in the
reference; ``cfg.attention_impl`` selects nothing. KV caches,
``attend_decode`` and int8 KV wait for the decode path (ROADMAP Queue 1
item 10).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import apply_rope
from repro_torch.sharding.api import ParamSpec, constrain

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
    y = torch.matmul(x, w.to(x.dtype).reshape(d, n * h))
    return y.reshape(*x.shape[:-1], n, h)


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


def _gqa_scores_softmax_out(q, k, v, mask, scale):
    """q: (B,Sq,nq,hd) k/v: (B,Sk,nkv,hd) mask: broadcastable (B,n,g,Sq,Sk)."""
    B, Sq, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    qg = q.reshape(B, Sq, nkv, g, hd).permute(0, 2, 3, 1, 4)  # (B,n,g,Sq,hd)
    kt = k.permute(0, 2, 3, 1).unsqueeze(2)                    # (B,n,1,hd,Sk)
    scores = torch.matmul(qg, kt).float() * scale              # (B,n,g,Sq,Sk)
    scores = torch.where(mask, scores, torch.tensor(
        -1e30, dtype=scores.dtype, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v.permute(0, 2, 1, 3).unsqueeze(2))
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, nq, hd)


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
    y = torch.matmul(out.reshape(*out.shape[:-2], n * h),
                     params["wo"].to(out.dtype).reshape(n * h, d))
    return constrain(y, "batch", None, "embed")


def attend_full(params, cfg, x, positions, *, causal=True, window=None,
                kv_override=None, kv_positions=None):
    """Full-sequence attention, the queries in chunks of ``_pick_chunk(S)``
    when longer than ``Q_CHUNK`` (each chunk against all keys).

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
    out = torch.cat([
        _full_attention(q[:, i:i + chunk], k, v, positions[i:i + chunk],
                        kv_pos, causal=causal, window=window, scale=scale)
        for i in range(0, S, chunk)], dim=1)
    return _wo(params, out), (k, v)


__all__ = ["Q_CHUNK", "attend_full", "attention_specs"]

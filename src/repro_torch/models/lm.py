"""Top-level language model: embedding -> block stack -> logits — the
port of ``src/repro/models/lm.py``: the full-sequence forward, prefill
and one-token decode over caches, for every block kind and for the
encoder-decoder path.

Parameters keep the reference's layout: one period of the block pattern
(e.g. gemma3's 5 local + 1 global, zamba2's 5 Mamba2 + 1 shared) per
entry of ``params["blocks"]``, each leaf stacked over the pattern
repetitions as ``(reps, ...)``, and so do caches: ``{"blocks": (one dict
per pattern entry, each leaf (reps, ...)), "cross_kv": None or {"k", "v"}
(num_layers, B, T, nkv, hd)}``. A ``SHARED_ATTN`` entry of ``blocks`` is
``{}``: its one weight-tied tree is ``params["shared"]``, used by every
repetition, while its cache is per repetition. Encoder-decoder (whisper)
adds ``params["encoder"]`` (stacked blocks, final norm) and
``params["cross"]`` (one cross-attention per decoder layer, stacked).
A Python loop over the repetitions indexes the stacked weights and caches
(no scan). ``lm_loss`` is the training objective: under autograd, with
``cfg.remat == "block"``, each repetition's body (and each encoder
layer) runs under ``torch.utils.checkpoint`` as the reference's
``jax.checkpoint`` body does: its activations are recomputed in the
backward instead of kept. Remat moves memory, not values, and it is the
identity while grad is disabled, so serving is unchanged.

The reference's memory levers (``cfg.opt_*``, the dry run's ``--opt``)
move memory, not values: ``opt_seq_shard`` splits the saved block
inputs along the sequence over "model" (``lm_forward``),
``opt_attn_remat`` recomputes each attention q-chunk
(``attention.attend_full``), ``opt_chunk_remat`` each SSM chunk
(``ssm.mamba2_train``/``mlstm_train``); ``opt_decode_carry`` (caches
updated in place) is what ``lm_decode_step`` always does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SHARED_ATTN, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.attention import attend_decode, attend_full, \
    attention_specs, _proj
from repro_torch.models.common import cdtype, mlp, mlp_specs, remat, \
    rmsnorm, rmsnorm_spec, sinusoidal_pos
from repro_torch.sharding.api import ParamSpec, all_reduce, constrain, \
    contiguous_grad, gather_dim, is_dtensor, shards_dim, tree_map, \
    tree_map_specs

VOCAB_PAD_MULTIPLE = 256


def padded_vocab(cfg) -> int:
    v, m = cfg.vocab_size, VOCAB_PAD_MULTIPLE
    return (v + m - 1) // m * m


def _stack_specs(tree, reps: int):
    return tree_map_specs(
        lambda s: ParamSpec((reps,) + s.shape, ("layers",) + s.axes,
                            init=s.init, dtype=s.dtype, scale=s.scale), tree)


def lm_specs(cfg: ModelConfig) -> dict:
    """Parameter specs, the reference's tree: ``embed``, ``final_norm``,
    ``blocks`` (``{}`` at a SHARED_ATTN entry), an untied ``lm_head``,
    ``shared`` (SHARED_ATTN), ``encoder`` and ``cross`` (encoder-decoder)."""
    d, vp = cfg.d_model, padded_vocab(cfg)
    reps = cfg.pattern_repeats
    d_axis = "table_d" if cfg.opt_head_nofsdp else "embed"
    specs = {
        "embed": ParamSpec((vp, d), ("vocab", d_axis), scale=0.02),
        "final_norm": rmsnorm_spec(d),
        "blocks": tuple(_stack_specs(B.block_specs(cfg, kind), reps)
                        if kind != SHARED_ATTN else {}
                        for kind in cfg.block_pattern),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, vp), (d_axis, "vocab"), scale=0.02)
    if SHARED_ATTN in cfg.block_pattern:
        specs["shared"] = B.block_specs(cfg, SHARED_ATTN)
    if cfg.is_encoder_decoder:
        enc_block = {
            "norm1": rmsnorm_spec(d), "attn": attention_specs(cfg),
            "norm2": rmsnorm_spec(d), "mlp": mlp_specs(d, cfg.d_ff),
        }
        specs["encoder"] = {
            "blocks": _stack_specs(enc_block, cfg.encoder_layers),
            "final_norm": rmsnorm_spec(d),
        }
        cross_block = {"norm_cross": rmsnorm_spec(d),
                       "cross": attention_specs(cfg, cross=True)}
        specs["cross"] = _stack_specs(cross_block, cfg.num_layers)
    return specs


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed_tokens(cfg, params, tokens, positions):
    table = params["embed"]
    if is_dtensor(table):
        x = _vocab_parallel_embed(table, tokens, cdtype(cfg))
    else:
        x = F.embedding(tokens, table).to(cdtype(cfg))
    if cfg.rope_theta <= 0.0:           # sinusoidal absolute positions
        x = x + sinusoidal_pos(positions, cfg.d_model).to(x.dtype)[None]
    return constrain(x, "batch", None, "embed")


def _vocab_parallel_embed(table, tokens, dtype):
    """The lookup of token rows in the DTensor ``table`` (vp, d), each
    rank in its own vocab range (Megatron's vocab-parallel embedding):
    the tokens outside ``[lo, hi)`` look up row 0 and are zeroed, and the
    rows are summed over the mesh dims that split the vocab (one
    non-zero term each: exact). The table's other splits (FSDP's d_model
    shards) are gathered and the tokens keep their batch split; the
    local table's gradient is the rank's own vocab shard, a partial sum
    over the batch-split mesh dims. DTensor's own rules for the lookup
    would gather the table whole on every rank, or leave masked partial
    sums that some torch versions cannot add to or send a gradient
    through. Returns a DTensor (B, S, d) in ``dtype``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, \
        Shard, distribute_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = table.device_mesh
    tok_place = (tokens.placements if is_dtensor(tokens)
                 else (Replicate(),) * mesh.ndim)
    vocab = [p == Shard(0) for p in table.placements]
    rows = [Shard(0) if p == Shard(0) and not v else Replicate()
            for p, v in zip(tok_place, vocab)]
    want = [Shard(0) if v else Replicate() for v in vocab]
    grads = [Shard(0) if v else Partial() if r == Shard(0) else Replicate()
             for v, r in zip(vocab, rows)]
    local = contiguous_grad(table.redistribute(mesh, want).to_local(
        grad_placements=grads))
    tok = (tokens.redistribute(mesh, rows) if is_dtensor(tokens)
           else distribute_tensor(tokens, mesh, rows, src_data_rank=None)
           ).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        table.shape, mesh, want)
    lo, hi = offset[0], offset[0] + shape[0]
    mine = (tok >= lo) & (tok < hi)
    x = F.embedding(torch.where(mine, tok - lo, 0), local).to(dtype)
    x = x.masked_fill(~mine[..., None], 0)
    x = _SumOverShards.apply(x, [mesh.get_group(i)
                                 for i, v in enumerate(vocab) if v])
    return DTensor.from_local(x, mesh, rows, run_check=False)


def logits_fn(cfg, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    # x summed over "model" (a norm of partial sums is one) and the
    # head's d_model shards (FSDP) gathered, before the product: else
    # DTensor splits the contraction and leaves partial logits whole
    # along the vocab (both no-ops unsharded)
    x = constrain(x, "batch", None, "embed")
    logits = torch.matmul(x, gather_dim(head, 0).to(x.dtype))
    vp = logits.shape[-1]
    if vp != cfg.vocab_size:            # mask padded vocab entries
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    if cfg.logit_softcap > 0.0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return constrain(logits, "batch", None, "vocab")


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------

def _rep(tree, r):
    """Repetition ``r`` of a tree stacked over repetitions: views, so an
    in-place write to a cache leaf lands in the stacked tensor."""
    return tree_map(lambda a: a[r], tree, is_leaf=torch.is_tensor)


def encode(cfg, params, audio_embed):
    """audio_embed: (B, T, d) precomputed frontend stub output."""
    enc = params["encoder"]
    T = audio_embed.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=audio_embed.device)
    x = audio_embed.to(cdtype(cfg))
    x = x + sinusoidal_pos(positions, cfg.d_model).to(x.dtype)[None]

    def body(x, r):
        prm = _rep(enc["blocks"], r)
        h = rmsnorm(x, prm["norm1"], cfg.norm_eps)
        out, _ = attend_full(prm["attn"], cfg, h, positions, causal=False)
        x = x + out
        return x + mlp(prm["mlp"], rmsnorm(x, prm["norm2"], cfg.norm_eps))

    run = remat(body, cfg.remat == "block")
    for r in range(cfg.encoder_layers):
        x = run(x, r)
    return rmsnorm(x, enc["final_norm"], cfg.norm_eps)


def _cross_kv(cfg, cross_params, encoder_out):
    """Cross-attention K/V of every decoder layer, stacked:
    {"k", "v"} (num_layers, B, T, nkv, hd) in the encoder output's
    dtype."""
    ks, vs = [], []
    for r in range(cross_params["cross"]["wk"].shape[0]):
        prm = _rep(cross_params["cross"], r)
        ks.append(_proj(encoder_out, prm["wk"]))
        vs.append(_proj(encoder_out, prm["wv"]))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def _apply_cross(cfg, prm, x, cross_kv, positions):
    h = rmsnorm(x, prm["norm_cross"], cfg.norm_eps)
    T = cross_kv["k"].shape[1]
    kv_pos = torch.arange(T, dtype=torch.int32, device=x.device)
    out, _ = attend_full(prm["cross"], cfg, h, positions, causal=False,
                         kv_override=(cross_kv["k"], cross_kv["v"]),
                         kv_positions=kv_pos)
    return x + out


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _stack(trees):
    """Trees of one nesting -> one tree whose leaves are stacked on a new
    leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in sorted(trees[0])}
    return torch.stack(trees)


def _block_params(params, kind, p_idx, r):
    """Repetition ``r``'s parameters of pattern entry ``p_idx``: the one
    shared tree for a SHARED_ATTN entry."""
    if kind == SHARED_ATTN:
        return params["shared"]
    return _rep(params["blocks"][p_idx], r)


def lm_forward(cfg, params, batch, *, want_cache=False, max_seq=None,
               last_logit_only=False):
    """batch: {"tokens": (B, S) integer tensor [, "audio_embed": (B, T, d)
    for an encoder-decoder config]}.

    Returns (logits, caches, aux_loss): caches is None unless
    ``want_cache`` (then caches of ``max_seq`` slots, default S, holding
    the sequence, and the encoder's ``cross_kv``), aux the float32 sum of
    the MoE blocks' losses (0 without experts).
    """
    tokens = batch["tokens"]
    S = tokens.shape[1]
    max_seq = max_seq or S
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = embed_tokens(cfg, params, tokens, positions)
    cross_kv = None
    if cfg.is_encoder_decoder:
        if len(cfg.block_pattern) != 1:   # cross params/K/V are per layer
            raise ValueError(f"{cfg.name}: an encoder-decoder pattern has "
                             "one block kind")
        cross_kv = _cross_kv(cfg, params["cross"],
                             encode(cfg, params, batch["audio_embed"]))

    # cfg.opt_seq_shard: Megatron-style sequence sharding of the block
    # inputs that remat saves, split along the sequence over "model"
    # (the reference's constraint at the top of its checkpointed body;
    # here before the call, since ``checkpoint`` saves the tensor it is
    # given). The body gathers the sequence back first: a recomputed
    # temporary, and no product then meets a batch and sequence split
    # at once (some torch versions cannot flatten them).
    seq_shard = (cfg.opt_seq_shard and not want_cache
                 and not cfg.is_encoder_decoder)

    def body(x, r):
        """Repetition ``r``: (x, its caches, its aux)."""
        if seq_shard:
            x = constrain(x, "batch", None, "embed")
        rep_caches, aux = [], torch.zeros((), dtype=torch.float32,
                                          device=x.device)
        for p_idx, kind in enumerate(cfg.block_pattern):
            x, cache, a = B.block_apply_full(
                cfg, kind, _block_params(params, kind, p_idx, r), x,
                positions, want_cache=want_cache, max_seq=max_seq)
            rep_caches.append(cache)
            aux = aux + a
        if cross_kv is not None:
            x = _apply_cross(cfg, _rep(params["cross"], r), x,
                             _rep(cross_kv, r), positions)
        return x, rep_caches, aux

    run = remat(body, cfg.remat == "block" and not want_cache)
    caches = [[] for _ in cfg.block_pattern]
    auxs = []
    for r in range(cfg.pattern_repeats):
        if seq_shard:
            x = constrain(x, "batch", "seq_shard", None)
        x, rep_caches, a = run(x, r)
        for p_idx, cache in enumerate(rep_caches):
            caches[p_idx].append(cache)
        auxs.append(a)
    aux = torch.stack(auxs).sum()
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_logit_only:
        x = x[:, -1:, :]
    logits = logits_fn(cfg, params, x)
    out_caches = None
    if want_cache:
        out_caches = {"blocks": tuple(_stack(c) for c in caches),
                      "cross_kv": cross_kv}
    return logits, out_caches, aux


def token_ce(logits, labels):
    """Per-token next-token cross-entropy, float32: the float32
    ``logsumexp`` of the logits less the label's logit. The reference sums
    ``logits * one_hot(labels)``, one non-zero term, so a ``gather`` is
    the same value. DTensor has no working rule for a ``gather`` along a
    sharded vocab dim, so DTensor logits take the reference's form: the
    label's logit is picked by a mask and summed (exactly: the other
    terms are zeros). Logits split along the vocab: ``_vocab_sharded_ce``."""
    if shards_dim(logits, -1):
        return _vocab_sharded_ce(logits, labels)
    logz = torch.logsumexp(logits.float(), dim=-1)
    if is_dtensor(logits):
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        label_logit = torch.where(labels.long()[..., None] == vocab, logits,
                                  torch.zeros((), dtype=logits.dtype,
                                              device=labels.device)).sum(-1)
    else:
        label_logit = torch.gather(logits, -1,
                                   labels.long()[..., None])[..., 0]
    return logz - label_logit.float()


class _SumOverShards(torch.autograd.Function):
    """The sum of each rank's partial result over ``groups`` (the mesh
    dims that split the vocab). Its gradient passes through: the sum's
    gradient is alike on every rank, and each partial's is that."""

    @staticmethod
    def forward(ctx, t, groups):
        return all_reduce(t, "sum", groups)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _vocab_sharded_ce(logits, labels):
    """``token_ce`` of DTensor logits split along the vocab, each rank
    on its own (batch rows, vocab slice): the max, the sum of
    exponentials and the masked label logit are partial results over the
    vocab shards, summed as (B, S) tensors, as the reference's
    partitioned program does. DTensor's own rules for ``logsumexp``, for
    the mask and for the gradient's broadcast gather the logits whole
    along the vocab, or the batch, first. The max is taken apart from
    the gradient, as in ``logsumexp``'s own."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, \
        distribute_tensor
    mesh, vd = logits.device_mesh, logits.ndim - 1
    place = [Replicate() if p.is_partial() else p for p in logits.placements]
    logits = logits.redistribute(mesh, place)
    rows = [Replicate() if p == Shard(vd) else p for p in place]
    groups = [mesh.get_group(i) for i, p in enumerate(place)
              if p == Shard(vd)]
    x = logits.to_local()
    lab = labels.redistribute(mesh, rows).to_local()
    vocab = distribute_tensor(
        torch.arange(logits.shape[-1], device=x.device), mesh,
        [Shard(0) if p == Shard(vd) else Replicate() for p in place],
        src_data_rank=None).to_local()
    xf = x.float()
    m = all_reduce(xf.detach().amax(-1), "max", groups)
    sum_exp = _SumOverShards.apply((xf - m[..., None]).exp().sum(-1), groups)
    label_logit = _SumOverShards.apply(torch.where(
        lab.long()[..., None] == vocab, x,
        torch.zeros((), dtype=x.dtype, device=x.device)).sum(-1), groups)
    ce = sum_exp.log() + m - label_logit.float()
    return DTensor.from_local(ce, mesh, rows, run_check=False)


def lm_loss(cfg, params, batch):
    """Next-token CE. batch: tokens (B, S), labels (B, S), optional
    ``loss_mask`` (B, S) [, ``audio_embed``]. Returns ``(loss + 0.01 *
    aux, {"loss", "aux_loss", "tokens"})``: the mean CE (under a mask,
    its masked sum over ``max(sum(mask), 1)``), the MoE aux loss, and
    the label count as float32."""
    logits, _, aux = lm_forward(cfg, params, batch)
    labels = batch["labels"]
    ce = token_ce(logits, labels)
    mask = batch.get("loss_mask")
    if mask is None:
        loss = ce.mean()
    else:
        mask = mask.to(ce.dtype)
        loss = (ce * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux,
                   "tokens": torch.tensor(float(labels.numel()),
                                          dtype=torch.float32,
                                          device=ce.device)}


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------

def lm_prefill(cfg, params, batch, *, max_seq):
    """Caches of ``max_seq`` slots holding ``batch``'s tokens, and the
    logits (B, vocab) after the last of them."""
    logits, caches, _ = lm_forward(cfg, params, batch, want_cache=True,
                                   max_seq=max_seq, last_logit_only=True)
    return caches, logits[:, 0, :]


def init_caches(cfg, batch_size, max_seq, encoder_seq=None,
                device: DeviceLike = None):
    """Empty caches on ``device``, leaves stacked over the pattern
    repetitions (k/v ``(reps, B, W, nkv, hd)``, ``pos`` ``(reps, W)``, a
    recurrent state's leaves ``(reps, B, ...)``); an encoder-decoder
    config's ``cross_kv`` is bf16 zeros ``(num_layers, B, T, nkv, hd)``,
    T = ``encoder_seq`` or ``cfg.encoder_seq``."""
    dev = resolve_device(device)
    blocks = tuple(
        _stack([B.block_init_cache(cfg, kind, batch_size, max_seq, dev)
                for _ in range(cfg.pattern_repeats)])
        for kind in cfg.block_pattern)
    cross_kv = None
    if cfg.is_encoder_decoder:
        shape = (cfg.num_layers, batch_size, encoder_seq or cfg.encoder_seq,
                 cfg.num_kv_heads, cfg.resolved_head_dim)
        cross_kv = {name: torch.zeros(shape, dtype=torch.bfloat16,
                                      device=dev) for name in ("k", "v")}
    return {"blocks": blocks, "cross_kv": cross_kv}


def lm_decode_step(cfg, params, caches, tokens, pos):
    """tokens: (B, 1) integer tensor; pos: int, the current absolute
    position.

    Updates ``caches`` in place (each attention block's slot for ``pos``,
    each recurrent block's state) and returns (caches, logits (B,
    vocab)), the same caches object.
    """
    pos = int(pos)
    positions = torch.full((1,), pos, dtype=torch.int32, device=tokens.device)
    x = embed_tokens(cfg, params, tokens, positions)
    for r in range(cfg.pattern_repeats):
        for p_idx, kind in enumerate(cfg.block_pattern):
            x, _ = B.block_apply_step(
                cfg, kind, _block_params(params, kind, p_idx, r), x,
                _rep(caches["blocks"][p_idx], r), pos)
        if cfg.is_encoder_decoder:
            prm = _rep(params["cross"], r)
            h = rmsnorm(x, prm["norm_cross"], cfg.norm_eps)
            out, _ = attend_decode(prm["cross"], cfg, h,
                                   _rep(caches["cross_kv"], r), pos,
                                   cross=True)
            x = x + out
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return caches, logits_fn(cfg, params, x)[:, 0, :]


__all__ = ["embed_tokens", "encode", "init_caches", "lm_decode_step",
           "lm_forward", "lm_loss", "lm_prefill", "lm_specs", "logits_fn",
           "padded_vocab", "token_ce"]

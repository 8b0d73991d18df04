"""Configuration system: model configs, shape configs, registry — the
port's copy of ``src/repro/configs/base.py`` (plain dataclasses).

Every assigned architecture is a ``ModelConfig`` in its own module under
``repro_torch/configs``; ``get_config(arch_id)`` resolves it. Shapes (the
assignment's train/prefill/decode/long cells) live in ``SHAPES``.
``attention_impl`` is kept as a field; as in the reference, nothing
dispatches on it.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# Block kinds used to describe a model as a repeating pattern of blocks.
ATTN = "attn"            # global self-attention block
LOCAL_ATTN = "local"     # sliding-window self-attention block
MLSTM = "mlstm"          # xLSTM matrix-memory block (chunked linear attn)
SLSTM = "slstm"          # xLSTM scalar-memory block (sequential scan)
MAMBA2 = "mamba2"        # Mamba2 / SSD block
SHARED_ATTN = "shared"   # Zamba-style shared (weight-tied) attention block

ATTENTION_KINDS = (ATTN, LOCAL_ATTN, SHARED_ATTN)
RECURRENT_KINDS = (MLSTM, SLSTM, MAMBA2)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description, rich enough for all 10 assigned archs."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # Block pattern: one *period* of block kinds; tiled to num_layers.
    # E.g. gemma3 = 5 local + 1 global, zamba2 = 5 mamba2 + 1 shared attn.
    block_pattern: Tuple[str, ...] = (ATTN,)

    head_dim: Optional[int] = None   # default d_model // num_heads
    qkv_bias: bool = False
    sliding_window: int = 1024       # for LOCAL_ATTN blocks
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / xlstm)
    ssm_state: int = 0               # N, the SSM state size per head
    ssm_head_dim: int = 64           # P, channels per SSM head
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_chunk: int = 256             # chunk length for the SSD scan

    # Encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500          # stub audio-frame count
    frontend: str = "none"           # none | audio_stub | vq_tokens

    # numerics / implementation knobs
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "block"             # none | block  (checkpoint each block group)
    attention_impl: str = "xla"      # xla | pallas
    scan_layers: bool = True         # lax.scan over pattern repetitions
    logit_softcap: float = 0.0

    # beyond-paper performance levers (see EXPERIMENTS.md §Perf).
    # False = naive baseline; the dry-run toggles these per --opt.
    opt_head_nofsdp: bool = False    # keep embed/lm-head d_model unsharded
    opt_decode_carry: bool = False   # KV caches as scan carry (in-place)
    opt_seq_shard: bool = False      # shard saved scan carries over seq
    opt_attn_remat: bool = False     # rematerialize per-q-chunk attention
    opt_kv_int8: bool = False        # int8 KV cache (per-token/head scales)
    opt_chunk_remat: bool = False    # remat SSM chunk bodies (drop O(Q^2) residuals)

    notes: str = ""

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def pattern_repeats(self) -> int:
        assert self.num_layers % len(self.block_pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not a multiple of "
            f"pattern length {len(self.block_pattern)}")
        return self.num_layers // len(self.block_pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if no block needs a full-sequence KV cache... i.e. every
        attention block is sliding-window or the model is recurrent."""
        return ATTN not in self.block_pattern or all(
            k in RECURRENT_KINDS for k in self.block_pattern)

    @property
    def supports_long_decode(self) -> bool:
        """long_500k runs for SSM/hybrid/SWA archs (sub-quadratic decode
        working set); pure full-attention archs skip it."""
        kinds = set(self.block_pattern)
        if kinds & set(RECURRENT_KINDS):
            return True
        return ATTN not in kinds or LOCAL_ATTN in kinds  # SWA-dominant mixes run it

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def num_params(self) -> int:
        """Analytic parameter count (matches init exactly; asserted in tests)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d                     # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                # lm head
        total += d                                      # final norm

        def attn_params() -> int:
            p = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
            if self.qkv_bias:
                p += nq * hd + 2 * (nkv * hd)
            return p

        def mlp_params() -> int:
            return 3 * d * self.d_ff                    # gate, up, down

        def moe_params() -> int:
            return d * self.num_experts + self.num_experts * 3 * d * self.d_ff

        def mamba2_params() -> int:
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            p = d * (2 * d_in + 2 * self.ssm_state + nheads)  # in_proj: z,x,B,C,dt
            p += nheads * 2                              # A_log, D
            p += d_in                                    # dt_bias ... folded in nheads? keep explicit:
            p += d_in * d                                # out_proj
            return p

        def mlstm_params() -> int:
            d_in = self.ssm_expand * d
            p = d * 2 * d_in                             # up proj (z, x)
            p += 3 * d_in * d_in // max(1, 1)            # q,k,v  (within d_in)
            p += 3 * d_in                                # i,f,o gate projections (per-channel from x)
            p += d_in * d                                # down proj
            return p

        def slstm_params() -> int:
            # 4 gates, recurrent + input projections at model width
            return 4 * (d * d + d * d) + 4 * d + 2 * d * self.d_ff if self.d_ff else 8 * d * d + 4 * d

        shared_attn_counted = False
        for kind in self.block_pattern:
            reps = self.pattern_repeats
            if kind == ATTN or kind == LOCAL_ATTN:
                total += reps * (attn_params() + (mlp_params() if self.d_ff and self.num_experts == 0 else 0)
                                 + (moe_params() if self.num_experts else 0) + 2 * d)
            elif kind == SHARED_ATTN:
                # weight-tied across repeats: counted once
                if not shared_attn_counted:
                    total += attn_params() + 2 * d
                    shared_attn_counted = True
            elif kind == MAMBA2:
                total += reps * (mamba2_params() + d)
            elif kind == MLSTM:
                total += reps * (mlstm_params() + d)
            elif kind == SLSTM:
                total += reps * (slstm_params() + d)
        if self.is_encoder_decoder:
            # encoder blocks: self-attn + mlp; decoder cross-attn already above? No:
            # enc-dec handled by encdec module; count encoder + cross-attn here.
            enc = self.encoder_layers * (attn_params() + mlp_params() + 2 * d) + d
            cross = self.num_layers * (attn_params() + d)
            total += enc + cross
        return total


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

ARCH_IDS = (
    "chameleon-34b",
    "gemma3-12b",
    "smollm-135m",
    "qwen2.5-32b",
    "internlm2-20b",
    "xlstm-125m",
    "zamba2-2.7b",
    "granite-moe-1b-a400m",
    "mixtral-8x7b",
    "whisper-tiny",
)

_MODULE_FOR_ARCH = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULE_FOR_ARCH:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_MODULE_FOR_ARCH)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR_ARCH[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR_ARCH[arch_id]}")
    return mod.SMOKE_CONFIG


def all_cells():
    """Yield every (arch, shape) dry-run cell, with skip annotations."""
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape in SHAPES.values():
            skip = None
            if shape.name == "long_500k" and not cfg.supports_long_decode:
                skip = "pure full-attention arch: no sub-quadratic 512k decode path"
            yield arch_id, shape, skip


def scaled(cfg: ModelConfig, **overrides) -> ModelConfig:
    return dataclasses.replace(cfg, **overrides)


def active_param_fraction(cfg: ModelConfig, n_total: int) -> float:
    """Fraction of params active per token (MoE: only top-k experts)."""
    if cfg.num_experts == 0:
        return 1.0
    expert_params = 3 * cfg.d_model * cfg.d_ff * cfg.num_experts \
        * cfg.num_layers
    inactive = expert_params * (1.0 - cfg.top_k / cfg.num_experts)
    return max(0.0, (n_total - inactive)) / n_total

"""Mixtral-8x7B — 8-expert top-2 MoE with sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import LOCAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=(LOCAL_ATTN,),
    sliding_window=4096,
    num_experts=8,
    top_k=2,
)

SMOKE_CONFIG = ModelConfig(
    name="mixtral-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    block_pattern=(LOCAL_ATTN,),
    sliding_window=16,
    num_experts=4,
    top_k=2,
)

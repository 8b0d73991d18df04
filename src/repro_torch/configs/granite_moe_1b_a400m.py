"""Granite-3.0-1B-A400M — MoE, 32 experts top-8, small expert d_ff.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    block_pattern=(ATTN,),
    num_experts=32,
    top_k=8,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    block_pattern=(ATTN,),
    num_experts=8,
    top_k=2,
    tie_embeddings=True,
)

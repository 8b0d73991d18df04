"""Qwen2.5-32B — dense GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    block_pattern=(ATTN,),
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2.5-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    block_pattern=(ATTN,),
    qkv_bias=True,
)

"""Zamba2-2.7B — Mamba2 backbone with a single weight-tied (shared)
global attention block interleaved every 6th layer.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import MAMBA2, SHARED_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,     # shared block is MHA
    d_ff=10240,
    vocab_size=32000,
    block_pattern=(MAMBA2,) * 5 + (SHARED_ATTN,),
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    block_pattern=(MAMBA2,) * 5 + (SHARED_ATTN,),
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=16,
)

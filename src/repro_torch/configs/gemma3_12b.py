"""Gemma-3-12B — 5:1 local:global attention, 1024-token sliding window,
256k vocab, head_dim=256. [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ATTN, LOCAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    block_pattern=(LOCAL_ATTN,) * 5 + (ATTN,),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    notes="5 sliding-window layers per global layer; 128k-context family",
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    block_pattern=(LOCAL_ATTN,) * 5 + (ATTN,),
    sliding_window=16,
    tie_embeddings=True,
)

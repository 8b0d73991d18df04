"""Chameleon-34B — early-fusion VLM; VQ image tokens live in the text
vocabulary, so the backbone is a plain dense GQA decoder.
[arXiv:2405.09818; unverified]"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    block_pattern=(ATTN,),
    frontend="vq_tokens",
    notes="early-fusion: image VQ codes are ordinary token ids",
)

SMOKE_CONFIG = ModelConfig(
    name="chameleon-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=176,
    vocab_size=512,
    block_pattern=(ATTN,),
    frontend="vq_tokens",
)

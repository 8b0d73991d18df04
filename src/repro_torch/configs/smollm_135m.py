"""SmolLM-135M — llama-architecture small dense model.
[hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    block_pattern=(ATTN,),
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="smollm-smoke",
    family="dense",
    num_layers=3,
    d_model=48,
    num_heads=3,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    block_pattern=(ATTN,),
    tie_embeddings=True,
)

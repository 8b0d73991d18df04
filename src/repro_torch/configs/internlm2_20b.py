"""InternLM2-20B — dense GQA. [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    block_pattern=(ATTN,),
)

SMOKE_CONFIG = ModelConfig(
    name="internlm2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    block_pattern=(ATTN,),
)

"""xLSTM-125M — mLSTM (matrix memory, chunked-parallel) + sLSTM (scalar
memory, sequential) blocks at a 3:1 ratio. d_ff=0: the blocks carry
their own projections. [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=(MLSTM, MLSTM, MLSTM, SLSTM),
    ssm_expand=2,
    ssm_head_dim=96,     # (expand*d_model)/ (4*expand)… heads=4 over d_inner
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    block_pattern=(MLSTM, MLSTM, MLSTM, SLSTM),
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
    tie_embeddings=True,
)

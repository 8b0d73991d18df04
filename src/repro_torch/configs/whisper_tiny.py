"""Whisper-tiny — encoder-decoder; conv audio frontend is a STUB
(``input_specs`` supplies precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,            # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    block_pattern=(ATTN,),
    is_encoder_decoder=True,
    encoder_layers=4,
    encoder_seq=1500,
    frontend="audio_stub",
    rope_theta=0.0,          # whisper: sinusoidal/learned positions, no RoPE
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    block_pattern=(ATTN,),
    is_encoder_decoder=True,
    encoder_layers=2,
    encoder_seq=32,
    frontend="audio_stub",
    rope_theta=0.0,
    tie_embeddings=True,
)

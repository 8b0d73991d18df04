from repro_torch.models.lm import (
    init_caches,
    lm_decode_step,
    lm_forward,
    lm_loss,
    lm_prefill,
    lm_specs,
    padded_vocab,
)

__all__ = [
    "init_caches",
    "lm_decode_step",
    "lm_forward",
    "lm_loss",
    "lm_prefill",
    "lm_specs",
    "padded_vocab",
]

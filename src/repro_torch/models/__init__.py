from repro_torch.models.lm import (
    lm_forward,
    lm_specs,
    padded_vocab,
)

__all__ = [
    "lm_forward",
    "lm_specs",
    "padded_vocab",
]

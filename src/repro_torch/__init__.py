"""PyTorch/CUDA port of the utility-aware load shedder.

The package mirrors the layout of the JAX reference package ``repro``:
each module's reference is the file at the same relative path there,
save ``metrics.py``, whose reference is ``repro/serve/metrics.py`` (it
sits at the top so that ``core/`` and ``serve/`` both hold registries).
It imports torch and numpy only. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.
"""

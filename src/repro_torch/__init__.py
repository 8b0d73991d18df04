"""PyTorch/CUDA port of the utility-aware load shedder.

The package mirrors the layout of the JAX reference package ``repro``:
each module's reference is the file at the same relative path there. It
imports torch and numpy only. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.
"""

"""Flash attention (GQA, causal, sliding window) — the hand-written CUDA
kernel and its wrapper.

``flash_attention`` replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py::flash_attention`` with its
signature (``interpret=`` dropped) and asserts. For a CUDA tensor it
launches ``csrc/flash.cu`` (CUDA C++ for ``sm_90a``, built by
``repro_torch.kernels.build`` at first use and loaded with ``ctypes``) or
raises: float32 inputs run its CUDA-core kernel, bfloat16 inputs the
tensor-core kernel of ``csrc/flash_mma.cuh`` (``mma.sync`` products fed
by ``cp.async``, whose 16-byte copies need aligned views:
``check_cp_async_alignment``). For a CPU tensor, and only then, it runs
the plain PyTorch version ``ref.attention_ref``. ``block_q``/``block_k`` are the
reference's tiling contract (sequence lengths must be multiples of
them); the CUDA kernel picks its own tiles per head dim and masks ragged
edges itself. One difference from the reference kernel is deliberate: a
query row with no visible key (q rows before key 0 when ``Sq > Sk``)
gives 0, as ``attention_ref`` does, where the TPU kernel returns the
mean of the first live K tile's values.

``flash_attention.launches`` counts the calls that launched the kernel
(one device launch each, on the current stream).
"""
from __future__ import annotations

import ctypes
import re
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention.ref import attention_ref

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


class _FlashParams(ctypes.Structure):
    """Mirrors ``struct FlashParams`` in csrc/flash.cu."""
    _fields_ = [
        ("B", ctypes.c_int), ("Hq", ctypes.c_int), ("Hkv", ctypes.c_int),
        ("Sq", ctypes.c_int), ("Sk", ctypes.c_int), ("d", ctypes.c_int),
        ("causal", ctypes.c_int), ("has_window", ctypes.c_int),
        ("window", ctypes.c_int), ("scale", ctypes.c_float),
        *[(f"{t}_s{a}", ctypes.c_longlong) for t in "qkvo" for a in "bhs"],
        ("bf16", ctypes.c_int),
    ]


def _lib() -> ctypes.CDLL:
    lib = kbuild.build()["flash"]
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.POINTER(_FlashParams)] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return lib


_MMA_ENTRY = re.compile(r"flash_mma_bf16ILi(\d+)ELi(\d+)E")


def mma_kernel_usage(log: str) -> Dict[int, dict]:
    """Registers and spill bytes of the bf16 tensor-core kernel per head
    dim (with its K tile), from the build's ``ptxas -v`` output."""
    out = {}
    for name, use in kbuild.ptxas_usage(log).items():
        if m := _MMA_ENTRY.search(name):
            out[int(m.group(1))] = dict(block_k=int(m.group(2)), **use)
    return out


def _check(q, k, v) -> None:
    B, Hq, Sq, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPES:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")


CP_ASYNC_BYTES = 16     # one cp.async copy of the bf16 kernel


def check_cp_async_alignment(**tensors) -> None:
    """The bf16 kernel copies rows of 8 elements with 16-byte
    ``cp.async``: each tensor's base must be 16-byte aligned and its
    batch, head and seq strides multiples of 8 elements (a dimension of
    size 1 is never stepped over). Raises ``ValueError`` naming the tensor
    and the stride; a misaligned view is not copied behind the caller's
    back."""
    for name, t in tensors.items():
        if t.data_ptr() % CP_ASYNC_BYTES:
            raise ValueError(f"{name}'s data pointer is not "
                             f"{CP_ASYNC_BYTES}-byte aligned: the bf16 kernel "
                             f"loads it with {CP_ASYNC_BYTES}-byte cp.async")
        per = CP_ASYNC_BYTES // t.element_size()
        for axis, n, st in zip(("batch", "head", "seq"), t.shape[:3],
                               t.stride()[:3]):
            if n > 1 and st % per:
                raise ValueError(f"{name}'s {axis} stride {st} is not a "
                                 f"multiple of {per} elements: the bf16 "
                                 f"kernel loads it with {CP_ASYNC_BYTES}-byte "
                                 f"cp.async")


def pack_params(q, k, v, out, *, causal: bool, window: Optional[int],
                scale: float) -> _FlashParams:
    """The kernel's parameters: shapes, mask, scale and the element
    strides (batch, head, seq) of q, k, v and out as they are."""
    B, Hq, Sq, d = q.shape
    p = _FlashParams(B=B, Hq=Hq, Hkv=k.shape[1], Sq=Sq, Sk=k.shape[2], d=d,
                     causal=int(bool(causal)),
                     has_window=int(window is not None),
                     window=int(window or 0), scale=float(scale),
                     bf16=int(q.dtype == torch.bfloat16))
    for name, t in (("q", q), ("k", k), ("v", v), ("o", out)):
        for axis, a in zip("bhs", t.stride()[:3]):
            setattr(p, f"{name}_s{axis}", a)
    return p


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K):
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Sk, d); Hq % Hkv == 0.

    Sq and Sk must be multiples of the block sizes (pad outside). The
    window applies with ``causal`` only, as in the reference. Returns
    (B, Hq, Sq, d) in q's dtype. Float32: products, softmax and sums in
    float32. Bfloat16 on the card: products on the tensor cores with
    float32 accumulation, softmax and sums in float32, the probabilities
    rounded to bfloat16 before the product with v (as the reference
    model's attention does); the views must meet
    ``check_cp_async_alignment``.
    """
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0 and Sq % block_q == 0 and Sk % block_k == 0, \
        (Hq, Hkv, Sq, Sk, block_q, block_k)
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    _check(q, k, v)
    if q.dtype == torch.bfloat16:
        check_cp_async_alignment(q=q, k=k, v=v)
    out = torch.empty((B, Hq, Sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    p = pack_params(q, k, v, out, causal=causal, window=window,
                    scale=scale)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(ctypes.byref(p), q.data_ptr(),
                                     k.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"CUDA flash attention launch failed: cudaError "
                           f"{err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def visible_pairs(Sq: int, Sk: int, causal: bool = True,
                  window: Optional[int] = None) -> int:
    """Number of (query, key) pairs the mask lets through: the work that
    attention on these shapes needs (each pair is 2 d multiply-adds)."""
    if not causal:
        return Sq * Sk
    qpos = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.clip(qpos + 1, 0, Sk)                 # keys 0..qpos
    lo = np.zeros_like(hi) if window is None else \
        np.clip(qpos - window + 1, 0, Sk)         # keys past the window
    return int(np.maximum(hi - lo, 0).sum())


def attention_ops(B: int, Hq: int, Sq: int, Sk: int, d: int,
                  causal: bool = True, window: Optional[int] = None) -> int:
    """Floating-point operations of the two products (scores and the
    probability-weighted values) over the visible pairs."""
    return 4 * B * Hq * d * visible_pairs(Sq, Sk, causal, window)


def attention_bytes(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, d: int,
                    elem: int) -> int:
    """Least bytes one call moves: q, k and v read once, out written once."""
    return int((2 * B * Hq * Sq + 2 * B * Hkv * Sk) * d * elem)


# Kernel vs plain-version tolerance, atol and rtol, per input dtype: the
# reference's own Pallas-vs-oracle tolerance (tests/test_kernels_flash.py).
TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}


__all__ = ["flash_attention", "visible_pairs", "attention_ops",
           "attention_bytes", "check_cp_async_alignment", "pack_params",
           "mma_kernel_usage", "TOL", "HEAD_DIMS", "DEFAULT_BLOCK_Q",
           "DEFAULT_BLOCK_K"]

"""Flash attention (GQA, causal, sliding window) — the hand-written CUDA
kernel and its wrapper.

``flash_attention`` replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py::flash_attention`` with its
signature (``interpret=`` dropped) and asserts. For a CUDA tensor it
launches ``csrc/flash.cu`` (CUDA C++ for ``sm_90a``, built by
``repro_torch.kernels.build`` at first use and loaded with ``ctypes``) or
raises: float32 inputs run its CUDA-core kernel (register micro-tiles,
``cp.async`` staging, split-KV on short grids: ``flash_plan``), bfloat16
inputs the tensor-core kernel of ``csrc/flash_mma.cuh`` (``mma.sync``
products fed by ``cp.async``). Both kernels copy rows with 16-byte
``cp.async``, so the views must be 16-byte aligned
(``check_cp_async_alignment``). For a CPU tensor, and only then, it runs
the plain PyTorch version ``ref.attention_ref``. ``block_q``/``block_k`` are the
reference's tiling contract (sequence lengths must be multiples of
them); the CUDA kernels pick their own tiles per head dim and mask ragged
edges themselves. One difference from the reference kernel is deliberate: a
query row with no visible key (q rows before key 0 when ``Sq > Sk``)
gives 0, as ``attention_ref`` does, where the TPU kernel returns the
mean of the first live K tile's values.

``flash_attention.launches`` counts the calls that launched a kernel
(one device launch each, on the current stream, split-KV included).
"""
from __future__ import annotations

import ctypes
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.scratch import device_index, tickets

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
        ("n_split", ctypes.c_int), ("partials", ctypes.c_void_p),
        ("tickets", ctypes.c_void_p),
    ]


def _lib() -> ctypes.CDLL:
    lib = kbuild.build()["flash"]
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.POINTER(_FlashParams)] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    occ = lib.flash_f32_resident_blocks
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    return lib


# The float32 kernel's tiles per head dim, as flash.cu's Tiles<HD> gives
# them: (column lanes CG, rows TR and score columns TC a thread, blocks an
# SM its launch bounds promise); 256 threads, so a block takes
# 256 / CG * TR query rows and K tiles of CG * TC keys.
F32_THREADS = 256
F32_TILES = {32: (8, 4, 4, 2), 64: (16, 8, 4, 2), 128: (16, 4, 2, 2),
             256: (16, 4, 4, 1)}
FLASH_SPLIT_WAVES = 2   # split K when a call has fewer q tiles x heads x
MAX_SPLIT = 16          # batch than this many resident grids; at most this


def f32_tiles(d: int) -> Tuple[int, int]:
    """(query rows of a block, keys of a K tile) of the float32 kernel."""
    cg, tr, tc, _ = F32_TILES[d]
    return F32_THREADS // cg * tr, cg * tc


@dataclass(frozen=True)
class FlashPlan:
    """How one float32 call splits its work over blocks (the block map of
    ``flash_kernel`` in csrc/flash.cu).

    The grid has ``n_qtiles * n_split * Hq * B`` blocks, ranked q tile
    first and the heaviest (last) q tile first, then batch, head and split
    (``block``). Q tile ``qt`` sees the K tiles ``k_tiles(qt)`` that its
    causal / window mask leaves; split ``s`` of it takes the contiguous
    share ``split_tiles(qt, s)``. The plan depends on the shapes and the
    card's resident blocks alone."""
    B: int
    Hq: int
    Sq: int
    Sk: int
    d: int
    causal: bool
    window: Optional[int]
    block_q: int
    block_k: int
    n_split: int

    @property
    def n_qtiles(self) -> int:
        return -(-self.Sq // self.block_q)

    @property
    def tiles(self) -> int:
        """(q tile, head, batch) items; each has a ticket when split."""
        return self.n_qtiles * self.Hq * self.B

    @property
    def grid(self) -> int:
        return self.tiles * self.n_split

    @property
    def partial_floats(self) -> int:
        """Float32 scratch of a split call: (m, l, acc) of every block."""
        if self.n_split == 1:
            return 0
        return self.grid * self.block_q * (self.d + 2)

    def k_tiles(self, qt: int) -> range:
        off = self.Sk - self.Sq
        q_first = qt * self.block_q + off
        q_last = min(qt * self.block_q + self.block_q, self.Sq) - 1 + off
        lo, hi = 0, -(-self.Sk // self.block_k) - 1
        if self.causal:
            hi = -1 if q_last < 0 else min(hi, q_last // self.block_k)
            if self.window is not None and q_first - self.window + 1 > 0:
                lo = (q_first - self.window + 1) // self.block_k
        return range(lo, max(hi + 1, lo))

    def split_tiles(self, qt: int, s: int) -> range:
        t = self.k_tiles(qt)
        n, lo = len(t), t.start
        return range(lo + s * n // self.n_split,
                     lo + (s + 1) * n // self.n_split)

    def block(self, x: int) -> Tuple[int, int, int, int]:
        """(q tile, split, head, batch) of block ``x``."""
        per_tile = self.n_split * self.Hq * self.B
        qt = self.n_qtiles - 1 - x // per_tile
        rank = x % per_tile
        item = rank // self.n_split
        return qt, rank % self.n_split, item % self.Hq, item // self.Hq


def flash_plan(B: int, Hq: int, Sq: int, Sk: int, d: int, causal: bool,
               window: Optional[int], resident: int) -> FlashPlan:
    """The float32 kernel's plan on a card that holds ``resident`` of its
    blocks at once: one block a (q tile, head, batch), or, when those are
    fewer than ``FLASH_SPLIT_WAVES`` resident grids, ``n_split`` blocks
    each (enough for that many grids, at most ``MAX_SPLIT`` and at most
    the most K tiles a q tile sees)."""
    if min(B, Hq, Sq, resident) < 1 or Sk < 0 or d not in F32_TILES:
        raise ValueError(f"flash_plan needs B, Hq, Sq, resident >= 1 and "
                         f"d in {tuple(F32_TILES)}, got "
                         f"{(B, Hq, Sq, Sk, d, resident)}")
    bq, bk = f32_tiles(d)
    plan = FlashPlan(B, Hq, Sq, Sk, d, bool(causal),
                     window if causal else None, bq, bk, 1)
    want = FLASH_SPLIT_WAVES * resident
    if plan.tiles >= want:
        return plan
    most = max(len(plan.k_tiles(qt)) for qt in range(plan.n_qtiles))
    n_split = max(1, min(-(-want // plan.tiles), most, MAX_SPLIT))
    return FlashPlan(B, Hq, Sq, Sk, d, plan.causal, plan.window, bq, bk,
                     n_split)


_RESIDENT: Dict[Tuple[int, int], int] = {}


def resident_blocks(device, d: int) -> int:
    """Blocks of the float32 kernel for head dim ``d`` resident on
    ``device`` at once (occupancy x SMs), asked of the CUDA runtime once
    per process."""
    key = (device_index(device), d)
    if key not in _RESIDENT:
        out = ctypes.c_int(0)
        err = _lib().flash_f32_resident_blocks(key[0], d, ctypes.byref(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"flash kernel occupancy query failed: "
                               f"cudaError {err}, {out.value} blocks")
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


_MMA_ENTRY = re.compile(r"flash_mma_bf16ILi(\d+)ELi(\d+)E")
_F32_ENTRY = re.compile(r"flash_kernelILi(\d+)EE")


def mma_kernel_usage(log: str) -> Dict[int, dict]:
    """Registers and spill bytes of the bf16 tensor-core kernel per head
    dim (with its K tile), from the build's ``ptxas -v`` output."""
    out = {}
    for name, use in kbuild.ptxas_usage(log).items():
        if m := _MMA_ENTRY.search(name):
            out[int(m.group(1))] = dict(block_k=int(m.group(2)), **use)
    return out


def f32_kernel_usage(log: str) -> Dict[int, dict]:
    """Registers and spill bytes of the float32 CUDA-core kernel per head
    dim (with its tiles), from the build's ``ptxas -v`` output."""
    out = {}
    for name, use in kbuild.ptxas_usage(log).items():
        if m := _F32_ENTRY.search(name):
            d = int(m.group(1))
            bq, bk = f32_tiles(d)
            out[d] = dict(block_q=bq, block_k=bk, **use)
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


CP_ASYNC_BYTES = 16     # one cp.async copy of either kernel


def check_cp_async_alignment(**tensors) -> None:
    """Both kernels copy rows with 16-byte ``cp.async`` (8 bf16 or 4
    float32 elements a copy): each tensor's base must be 16-byte aligned
    and its batch, head and seq strides multiples of 16 bytes' worth of
    elements (a dimension of size 1 is never stepped over). Raises
    ``ValueError`` naming the tensor and the stride; a misaligned view is
    not copied behind the caller's back."""
    for name, t in tensors.items():
        if t.data_ptr() % CP_ASYNC_BYTES:
            raise ValueError(f"{name}'s data pointer is not "
                             f"{CP_ASYNC_BYTES}-byte aligned: the kernel "
                             f"loads it with {CP_ASYNC_BYTES}-byte cp.async")
        per = CP_ASYNC_BYTES // t.element_size()
        for axis, n, st in zip(("batch", "head", "seq"), t.shape[:3],
                               t.stride()[:3]):
            if n > 1 and st % per:
                raise ValueError(f"{name}'s {axis} stride {st} is not a "
                                 f"multiple of {per} elements: the kernel "
                                 f"loads it with {CP_ASYNC_BYTES}-byte "
                                 f"cp.async")


def pack_params(q, k, v, out, *, causal: bool, window: Optional[int],
                scale: float, n_split: int = 1, partials: int = 0,
                tickets: int = 0) -> _FlashParams:
    """The kernel's parameters: shapes, mask, scale, the element strides
    (batch, head, seq) of q, k, v and out as they are, and the float32
    kernel's split count with its scratch pointers (0 when unsplit)."""
    B, Hq, Sq, d = q.shape
    p = _FlashParams(B=B, Hq=Hq, Hkv=k.shape[1], Sq=Sq, Sk=k.shape[2], d=d,
                     causal=int(bool(causal)),
                     has_window=int(window is not None),
                     window=int(window or 0), scale=float(scale),
                     bf16=int(q.dtype == torch.bfloat16),
                     n_split=int(n_split), partials=partials or None,
                     tickets=tickets or None)
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
    model's attention does). On the card the views must meet
    ``check_cp_async_alignment``; a float32 call on few q tiles splits
    its keys over more blocks (``flash_plan``), still in one launch.
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
    check_cp_async_alignment(q=q, k=k, v=v)
    dev = q.device
    out = torch.empty((B, Hq, Sq, d), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):     # the launch runs on q's device
        stream = torch.cuda.current_stream(dev).cuda_stream
        split = {}
        if q.dtype == torch.float32:
            plan = flash_plan(B, Hq, Sq, Sk, d, causal, window,
                              resident_blocks(dev, d))
            if plan.n_split > 1:
                partials = torch.empty(plan.partial_floats,
                                       dtype=torch.float32, device=dev)
                split = dict(n_split=plan.n_split,
                             partials=partials.data_ptr(),
                             tickets=tickets(dev, stream,
                                             plan.tiles).data_ptr())
        p = pack_params(q, k, v, out, causal=causal, window=window,
                        scale=scale, **split)
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
           "mma_kernel_usage", "f32_kernel_usage", "flash_plan", "FlashPlan",
           "f32_tiles", "resident_blocks", "TOL", "HEAD_DIMS",
           "DEFAULT_BLOCK_Q", "DEFAULT_BLOCK_K"]

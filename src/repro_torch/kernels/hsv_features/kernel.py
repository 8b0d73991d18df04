"""Camera-side HSV kernels — the hand-written CUDA kernels and their
wrappers.

``ingest_batch`` replaces the Pallas TPU kernel
``src/repro/kernels/hsv_features/kernel.py::ingest_batch`` with the same
signature and return tuple (``interpret=`` dropped); ``hsv_hist`` (and
its batched form ``hsv_hist_batch``) replaces ``kernel.py::hsv_hist``.
For a CUDA tensor each launches its kernel from ``csrc/`` (CUDA C++ for
``sm_90a``, ``ingest.cu`` and ``hist.cu`` sharing the per-pixel helpers
of ``hsv_common.cuh``, each built with ``nvcc`` at first use into
``build/`` at the repository root and loaded with ``ctypes``) or raises;
for a CPU tensor, and only then, it runs the plain PyTorch version from
``ref.py``. See the notes at the top of the CUDA sources for what bounds
each kernel and how its design answers that.

``ingest_batch.launches`` and ``hsv_hist_batch.launches`` count the
calls that launched each kernel (one ingest call is ``2*T + 2`` device
launches; one histogram call is three with a bool mask, two with float
weights; all on the current stream).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

from repro_torch.core.utility import B_S, B_V
from repro_torch.kernels.hsv_features.ref import (
    hsv_hist_ref,
    ingest_batch_ref,
)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
# one shared library per source; each also compiles the shared header
LIBRARIES = {"ingest": "ingest.cu", "hist": "hist.cu"}
HEADERS = ("hsv_common.cuh",)
MAX_COLORS = 4
MAX_RANGES = 2
MAX_COUNTERS = 256
TILE = 4096           # pixels per block of the frame launch


class _Params(ctypes.Structure):
    """Mirrors ``struct IngestParams`` in csrc/ingest.cu."""
    _fields_ = [
        ("C", ctypes.c_int), ("T", ctypes.c_int), ("N", ctypes.c_int),
        ("nc", ctypes.c_int), ("bs", ctypes.c_int), ("bv", ctypes.c_int),
        ("n_ranges", ctypes.c_int * MAX_COLORS),
        ("hue_lo", ctypes.c_float * (MAX_COLORS * MAX_RANGES)),
        ("hue_hi", ctypes.c_float * (MAX_COLORS * MAX_RANGES)),
        ("sscale", ctypes.c_float), ("vscale", ctypes.c_float),
        ("alpha", ctypes.c_float), ("one_minus_alpha", ctypes.c_float),
        ("threshold", ctypes.c_float),
        ("use_fg", ctypes.c_int), ("bg_valid", ctypes.c_int),
        ("op_and", ctypes.c_int), ("width", ctypes.c_int),
        ("tile", ctypes.c_int),
    ]


class _HistParams(ctypes.Structure):
    """Mirrors ``struct HistParams`` in csrc/hist.cu."""
    _fields_ = [
        ("T", ctypes.c_int), ("N", ctypes.c_int),
        ("nc", ctypes.c_int), ("bs", ctypes.c_int), ("bv", ctypes.c_int),
        ("n_ranges", ctypes.c_int * MAX_COLORS),
        ("hue_lo", ctypes.c_float * (MAX_COLORS * MAX_RANGES)),
        ("hue_hi", ctypes.c_float * (MAX_COLORS * MAX_RANGES)),
        ("sscale", ctypes.c_float), ("vscale", ctypes.c_float),
        ("tile", ctypes.c_int), ("float_weights", ctypes.c_int),
    ]


class BUILD:
    """The loaded libraries, built once per process at first use."""
    libs: Dict[str, ctypes.CDLL] = {}
    seconds: float = 0.0
    log: str = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path(name: str) -> Path:
    """Where library ``name`` is built: keyed by a hash of every file it
    compiles (its source and the shared headers) and the flags, so an
    edited header never reuses a stale library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (LIBRARIES[name], *HEADERS):
        h.update(f.encode() + b"\0" + (CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library: one ``nvcc`` per
    source, all started together. Each ``.so`` is written under a
    temporary name and moved into place, so concurrent builds never see a
    partial file."""
    if BUILD.libs:
        return BUILD.libs
    t0 = time.perf_counter()
    paths = {name: library_path(name) for name in LIBRARIES}
    procs = {}
    for name, so in paths.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{so.stem}.{os.getpid()}.so"
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / LIBRARIES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"== {LIBRARIES[name]}\n{out}")
        if proc.returncode != 0:
            failed.append(LIBRARIES[name])
        else:
            os.replace(tmp, paths[name])
    BUILD.log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD.log}")
    libs = {name: ctypes.CDLL(str(so)) for name, so in paths.items()}
    fn = libs["ingest"].ingest_batch_launch
    fn.argtypes = [ctypes.POINTER(_Params)] + [ctypes.c_void_p] * 17
    fn.restype = ctypes.c_int
    fn = libs["hist"].hsv_hist_launch
    fn.argtypes = [ctypes.POINTER(_HistParams)] + [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    BUILD.seconds = time.perf_counter() - t0
    BUILD.libs = libs
    return libs


def _hue_fields(p, hue_ranges) -> None:
    """Fill a params struct's per-color hue ranges."""
    nc = len(hue_ranges)
    if not 1 <= nc <= MAX_COLORS:
        raise ValueError(f"the CUDA kernels take 1..{MAX_COLORS} colors, "
                         f"got {nc}")
    for k, ranges in enumerate(hue_ranges):
        if not 1 <= len(ranges) <= MAX_RANGES:
            raise ValueError(f"color {k} has {len(ranges)} hue ranges; the "
                             f"kernels take 1..{MAX_RANGES}")
        p.n_ranges[k] = len(ranges)
        for q, (lo, hi) in enumerate(ranges):
            p.hue_lo[k * MAX_RANGES + q] = lo
            p.hue_hi[k * MAX_RANGES + q] = hi


def _check_counters(nc: int, bs: int, bv: int) -> None:
    if nc * bs * bv > MAX_COUNTERS:
        raise ValueError(f"nc*bs*bv = {nc * bs * bv} counters exceed the "
                         f"kernels' {MAX_COUNTERS}")


def _params(C, T, N, hue_ranges, bs, bv, alpha, threshold, use_fg, bg_valid,
            op, width) -> _Params:
    nc = len(hue_ranges)
    _check_counters(nc, bs, bv)
    if op not in ("or", "and"):
        raise ValueError(f"unknown composition op {op!r}")
    p = _Params(C=C, T=T, N=N, nc=nc, bs=bs, bv=bv,
                sscale=bs / 256.0, vscale=bv / 256.0, alpha=alpha,
                one_minus_alpha=1.0 - alpha, threshold=threshold,
                use_fg=int(bool(use_fg)), bg_valid=int(bool(bg_valid)),
                op_and=int(op == "and"), width=int(width), tile=TILE)
    _hue_fields(p, hue_ranges)
    return p


def _check(name, t, shape, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on the CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ingest_batch(rgb, bg0, gain0, M_pos, norm, hue_ranges,
                 bs: int = B_S, bv: int = B_V, *, alpha: float = 0.05,
                 threshold: float = 18.0, use_fg: bool = True,
                 bg_valid: bool = True, op: str = "or", width: int = 0):
    """Fused batched ingest for a whole camera array.

    rgb:   (T, N, 3) float32 RGB in [0, 255] (frames flattened to
           pixels), or (C, T, N, 3) for a C-camera array
    bg0:   (N,) / (C, N) float32 — per-camera background Value-channel
           state (ignored when ``bg_valid=False``: frame 0 then seeds it)
    gain0: () / (C,) float32 — illumination gain state (a scalar
           broadcasts to every camera)
    M_pos: (nc, bs*bv) trained utility matrices; norm: (nc,)

    Returns (counts (T, nc, bs*bv), totals (T, nc), fg_total (T,),
    utility (T,), bg (N,), gain ()) — each with a leading camera lane iff
    the input had one; ``width > 0`` (the frame's pixel-row stride)
    appends the per-frame foreground bounding box (T, 4) int32, all -1
    for frames without foreground.
    """
    if rgb.device.type == "cpu":
        return ingest_batch_ref(
            rgb, bg0, gain0, M_pos, norm, hue_ranges, bs, bv, alpha=alpha,
            threshold=threshold, use_fg=use_fg, bg_valid=bg_valid, op=op,
            width=width)
    if rgb.device.type != "cuda":
        raise ValueError(f"ingest_batch runs on cuda or cpu, got {rgb.device}")
    has_cams = rgb.ndim == 4
    if not has_cams:
        rgb, bg0 = rgb[None], bg0[None]
    C, T, N = rgb.shape[0], rgb.shape[1], rgb.shape[2]
    if T < 1 or N < 1:
        raise ValueError(f"empty ingest batch {tuple(rgb.shape)}")
    dev = rgb.device
    nc, nb = len(hue_ranges), bs * bv
    gain0 = torch.as_tensor(gain0, dtype=torch.float32, device=dev)
    gain0 = gain0.reshape(-1).expand(C).contiguous()
    _check("rgb", rgb, (C, T, N, 3))
    _check("bg0", bg0, (C, N))
    _check("M_pos", M_pos, (nc, nb))
    _check("norm", norm, (nc,))
    params = _params(C, T, N, hue_ranges, bs, bv, alpha, threshold, use_fg,
                     bg_valid, op, width)
    lib = build()["ingest"]

    f32, i32 = torch.float32, torch.int32
    counts = torch.empty((C, T, nc, nb), dtype=f32, device=dev)
    totals = torch.empty((C, T, nc), dtype=f32, device=dev)
    fgtot = torch.empty((C, T), dtype=f32, device=dev)
    util = torch.empty((C, T), dtype=f32, device=dev)
    bg = torch.empty((C, N), dtype=f32, device=dev)
    gain = torch.empty((C,), dtype=f32, device=dev)
    bbox = torch.empty((C, T, 4), dtype=i32, device=dev)
    counts_i = torch.empty((C, T, nc, nb), dtype=i32, device=dev)
    totals_i = torch.empty((C, T, nc), dtype=i32, device=dev)
    fgtot_i = torch.empty((C, T), dtype=i32, device=dev)
    ntiles = (N + TILE - 1) // TILE
    partials = torch.empty((C, ntiles, 2), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ingest_batch_launch(
        ctypes.byref(params), rgb.data_ptr(), bg0.data_ptr(),
        gain0.data_ptr(), M_pos.data_ptr(), norm.data_ptr(),
        counts.data_ptr(), totals.data_ptr(), fgtot.data_ptr(),
        util.data_ptr(), bg.data_ptr(), gain.data_ptr(), bbox.data_ptr(),
        counts_i.data_ptr(), totals_i.data_ptr(), fgtot_i.data_ptr(),
        partials.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"CUDA ingest kernel launch failed: cudaError {err}")
    ingest_batch.launches += 1
    out = [counts, totals, fgtot, util, bg, gain]
    if width:
        out.append(bbox)
    if has_cams:
        return tuple(out)
    return tuple(o[0] for o in out)


ingest_batch.launches = 0


def hsv_hist_batch(rgb, fg, hue_ranges, bs: int = B_S, bv: int = B_V):
    """Per-frame histograms with a precomputed foreground mask, for a
    batch of frames in one kernel call.

    rgb: (T, N, 3) float32 RGB in [0, 255] (frames flattened to pixels);
    fg: (T, N) bool mask (counted in int32: exact) or float32 weights
    (summed in a fixed order: deterministic, within rounding of the plain
    version). Returns (counts (T, nc, bs*bv), totals (T, nc),
    fg_total (T,)), float32.
    """
    if rgb.device.type == "cpu":
        return hsv_hist_ref(rgb, fg, hue_ranges, bs, bv)
    if rgb.device.type != "cuda":
        raise ValueError(f"hsv_hist runs on cuda or cpu, got {rgb.device}")
    if rgb.ndim != 3 or rgb.shape[0] < 1 or rgb.shape[1] < 1:
        raise ValueError(f"expected (T, N, 3) frames, got {tuple(rgb.shape)}")
    T, N = rgb.shape[0], rgb.shape[1]
    if fg.dtype not in (torch.bool, torch.float32):
        raise ValueError(f"fg must be a bool mask or float32 weights, got "
                         f"{fg.dtype}")
    _check("rgb", rgb, (T, N, 3))
    _check("fg", fg, (T, N), fg.dtype)
    if fg.device != rgb.device:
        raise ValueError(f"fg on {fg.device}, rgb on {rgb.device}")
    nc, nb = len(hue_ranges), bs * bv
    _check_counters(nc, bs, bv)
    float_weights = fg.dtype == torch.float32
    p = _HistParams(T=T, N=N, nc=nc, bs=bs, bv=bv, sscale=bs / 256.0,
                    vscale=bv / 256.0, tile=TILE,
                    float_weights=int(float_weights))
    _hue_fields(p, hue_ranges)
    lib = build()["hist"]

    dev = rgb.device
    counts = torch.empty((T, nc, nb), dtype=torch.float32, device=dev)
    totals = torch.empty((T, nc), dtype=torch.float32, device=dev)
    fgtot = torch.empty((T,), dtype=torch.float32, device=dev)
    nctr = nc * nb + nc + 1
    if float_weights:
        ntiles = (N + TILE - 1) // TILE
        acc = None
        partials = torch.empty((T, ntiles, nctr), dtype=torch.float32,
                               device=dev)
        weights = fg
    else:
        acc = torch.empty((T, nctr), dtype=torch.int32, device=dev)
        partials = None
        weights = fg.view(torch.uint8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.hsv_hist_launch(
        ctypes.byref(p), rgb.data_ptr(), weights.data_ptr(),
        counts.data_ptr(), totals.data_ptr(), fgtot.data_ptr(),
        None if acc is None else acc.data_ptr(),
        None if partials is None else partials.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"CUDA hsv_hist kernel launch failed: cudaError "
                           f"{err}")
    hsv_hist_batch.launches += 1
    return counts, totals, fgtot


hsv_hist_batch.launches = 0


def hsv_hist(rgb, fg, hue_ranges, bs: int = B_S, bv: int = B_V):
    """One frame: rgb (N, 3) float32, fg (N,) bool or float32. Returns
    (counts (nc, bs*bv), totals (nc,), fg_total ()) — the reference's
    signature without ``interpret=``. On the card it is one
    ``hsv_hist_batch`` call (and counts as one of its launches)."""
    counts, totals, fgtot = hsv_hist_batch(rgb[None], fg[None], hue_ranges,
                                           bs, bv)
    return counts[0], totals[0], fgtot[0]


def bytes_moved(C: int, T: int, N: int, nc: int, nb: int, bg_valid: bool,
                width: int) -> int:
    """Least bytes one call must move: each input read once, each output
    written once (RGB, background in and out, the small per-frame outputs)."""
    f = 4
    inp = C * T * N * 3 * f + (C * N * f if bg_valid else 0) + C * f \
        + nc * nb * f + nc * f
    out = (C * T * nc * nb + C * T * nc + 2 * C * T + C * N + C) * f
    if width:
        out += C * T * 4 * 4
    return int(inp + out)


# Kernel-vs-plain tolerance. The float outputs meet the reference's own
# kernel-vs-oracle tolerance. The gain's frame sums are taken in another
# order than the plain version's, so a pixel whose |v/gain - base| lies
# within rounding of the threshold can flip between foreground and
# background. Such flips are rare and independent, so the integer outputs
# may differ in at most FLIP_FRACTION of the pixels (counted in count
# units, each flipped pixel being up to 2*nc + 1 of them) and in at most
# FRAME_FRACTION of the frames (at least one); a slip that touches every
# frame fails. The utility is held in every frame, at ATOL/RTOL plus what
# that frame's differing counts can move it by (see ``_util_slack``); the
# bounding box is exact in every frame whose counts agree.
ATOL, RTOL = 1e-4, 1e-5
FLIP_FRACTION = 1e-5
FRAME_FRACTION = 0.05


def _util_slack(dc, dn, w_totals, M_pos, norm):
    """Largest change of each frame's utility that its differing counts
    allow. For one color, with counts c summing to n, pf = c / max(n, 1)
    moves in L1 by at most (|dc|_1 + |dn|) / max(n, 1), so pf . M moves by
    at most that times max|M|; the max / min over colors is 1-Lipschitz."""
    scale = (M_pos.double().abs().amax(dim=-1)
             / torch.clamp_min(norm.double(), 1e-9))            # (nc,)
    per_color = (dc + dn) / torch.clamp_min(w_totals.double(), 1.0) * scale
    return per_color.amax(dim=-1)                              # (C, T)


def compare_with_plain(got, want, M_pos, norm) -> dict:
    """Hold kernel outputs ``got`` to the plain version's ``want`` (both
    camera-lane tuples from ``ingest_batch``/``ingest_batch_ref`` on the
    same inputs; ``M_pos``/``norm`` are the utility constants of that
    call). Returns the per-output max abs errors and the differing count
    units and frames; raises AssertionError on a breach of the tolerance
    above."""
    counts, totals, fgtot, util, bg, gain = got[:6]
    w_counts, w_totals, w_fgtot, w_util, w_bg, w_gain = want[:6]
    C, T, N = counts.shape[0], counts.shape[1], bg.shape[1]

    def err(a, b):
        return (a.double() - b.double()).abs()

    dc = err(counts, w_counts).sum(dim=-1)             # (C, T, nc)
    dn = err(totals, w_totals)                         # (C, T, nc)
    units = dc.sum(dim=-1) + dn.sum(dim=-1) + err(fgtot, w_fgtot)
    same = units == 0                                  # (C, T)
    report = {name: float(err(a, b).max()) for name, a, b in (
        ("counts", counts, w_counts), ("totals", totals, w_totals),
        ("fgtot", fgtot, w_fgtot), ("util", util, w_util), ("bg", bg, w_bg),
        ("gain", gain, w_gain))}
    report["count_units_differing"] = int(units.sum())
    report["frames_differing"] = int((~same).sum())
    report["max_abs_err"] = max(report["util"], report["bg"], report["gain"])
    allowed_units = int(FLIP_FRACTION * C * T * N)
    allowed_frames = max(1, int(FRAME_FRACTION * C * T))
    problems = []
    if report["count_units_differing"] > allowed_units:
        problems.append(f"{report['count_units_differing']} count units "
                        f"differ, more than {allowed_units}")
    if report["frames_differing"] > allowed_frames:
        problems.append(f"counts differ in {report['frames_differing']} "
                        f"frames, more than {allowed_frames}")
    for name, a, b in (("bg", bg, w_bg), ("gain", gain, w_gain)):
        if not torch.allclose(a, b, atol=ATOL, rtol=RTOL):
            problems.append(f"{name} off by {float(err(a, b).max())}")
    util_tol = (ATOL + RTOL * w_util.double().abs()
                + _util_slack(dc, dn, w_totals, M_pos, norm))
    if bool((err(util, w_util) > util_tol).any()):
        problems.append(f"util off by {report['util']} past its per-frame "
                        "bound")
    if len(got) > 6:
        bad = (got[6] != want[6]).any(dim=-1) & same
        if bool(bad.any()):
            problems.append(f"bbox differs in {int(bad.sum())} frames whose "
                            "counts agree")
    if problems:
        raise AssertionError("CUDA ingest kernel vs plain version: "
                             + "; ".join(problems) + f" ({report})")
    return report


# Histogram tolerance, kernel vs plain version. With a bool mask the
# counts are int32 sums: exact. Float weights are summed in another order
# than the plain version's (which on the card is scatter-add atomics in
# no fixed order): each output may differ by HIST_FLOAT_RTOL times the
# frame's sum of |weights| (float32 rounding of sums of up to ~1e6 terms),
# and by nothing for 0/1 weights below 2**24 pixels.
HIST_FLOAT_RTOL = 1e-4


def compare_hist_with_plain(got, want, fg) -> dict:
    """Hold ``hsv_hist_batch`` outputs ``got`` to the plain version's
    ``want`` on the same inputs (``fg`` the (T, N) mask or weights).
    Returns the max abs error and the differing count units; raises
    AssertionError on a breach of the tolerance above."""
    def err(a, b):
        return (a.double() - b.double()).abs()

    names = ("counts", "totals", "fgtot")
    report = {n: float(err(a, b).max()) for n, a, b in zip(names, got, want)}
    report["max_abs_err"] = max(report[n] for n in names)
    report["count_units_differing"] = float(sum(
        err(a, b).sum() for a, b in zip(got, want)))
    if fg.dtype == torch.bool:
        tol = torch.zeros(fg.shape[0], dtype=torch.float64, device=fg.device)
    else:
        tol = HIST_FLOAT_RTOL * torch.clamp_min(
            fg.double().abs().sum(dim=-1), 1.0)
    problems = []
    for n, a, b in zip(names, got, want):
        d = err(a, b).reshape(a.shape[0], -1).amax(dim=-1)
        if bool((d > tol).any()):
            problems.append(f"{n} off by {float(d.max())}")
    if problems:
        raise AssertionError("CUDA hsv_hist kernel vs plain version: "
                             + "; ".join(problems) + f" ({report})")
    return report


def hist_bytes_moved(T: int, N: int, nc: int, nb: int,
                     weight_bytes: int) -> int:
    """Least bytes one histogram call must move: RGB and the weights read
    once, the float32 outputs written once."""
    return int(T * N * (12 + weight_bytes) + T * (nc * nb + nc + 1) * 4)


# Float32 operations per pixel of the histogram kernel: HSV 12, joint bin
# 4, hue ranges ~4. Histogram updates are integer, not counted.
HIST_OPS_PER_PIXEL = 20


# Float32 operations per pixel per frame, counted from the kernel body:
# HSV 12 (max/min 4, sub 1, sat div+mul 2, hue div+add/mod+mul ~4, compares
# 1), background 7 (clip 0, div 1, sub+abs+compare 3, EMA 3), joint bin 4,
# hue ranges and sums ~6. Histogram updates are integer, not counted.
OPS_PER_PIXEL = 29


__all__ = ["ingest_batch", "hsv_hist", "hsv_hist_batch", "build",
           "bytes_moved", "hist_bytes_moved", "compare_with_plain",
           "compare_hist_with_plain", "OPS_PER_PIXEL", "HIST_OPS_PER_PIXEL",
           "TILE"]

"""Camera-side HSV kernels — the hand-written CUDA kernels and their
wrappers.

``ingest_batch`` replaces the Pallas TPU kernel
``src/repro/kernels/hsv_features/kernel.py::ingest_batch`` with the same
signature and return tuple (``interpret=`` dropped); ``hsv_hist`` (and
its batched form ``hsv_hist_batch``) replaces ``kernel.py::hsv_hist``.
For a CUDA tensor each launches its kernel from ``csrc/`` (CUDA C++ for
``sm_90a``, ``ingest.cu`` and ``hist.cu`` sharing the per-pixel helpers
of ``hsv_common.cuh``, each built by ``repro_torch.kernels.build`` at
first use and loaded with ``ctypes``) or raises;
for a CPU tensor, and only then, it runs the plain PyTorch version from
``ref.py``. See the notes at the top of the CUDA sources for what bounds
each kernel and how its design answers that.

``ingest.cu`` is one persistent cooperative launch a call
(``DEVICE_LAUNCHES_PER_CALL``): a grid of at most the blocks resident on
the card walks (camera, pixel tile) items (``work_plan``), frame by frame
with a grid barrier between frames for the lagged gain. RGB is streamed
once through shared memory; the background lane carries an L2
evict-last policy between frames.

``hist.cu`` is one launch a call (``HIST_DEVICE_LAUNCHES_PER_CALL``)
for either weight type: ``hist_plan`` gives each frame a few blocks that
share its pixel chunks; each thread reads its pixels' weights first and
the RGB of the non-zero ones only (``hist_bytes_read`` counts those
bytes); the frame's last block, found by a ticket, sums the blocks'
partials in block order.

``ingest_batch.launches`` and ``hsv_hist_batch.launches`` count the
calls that launched each kernel (one device launch a call each, on the
current stream).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.utility import B_S, B_V
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.hsv_features.ref import (
    hsv_hist_ref,
    ingest_batch_ref,
)
from repro_torch.kernels.scratch import device_index, tickets

MAX_COLORS = 4
MAX_RANGES = 2
MAX_COUNTERS = 256
HIST_CHUNK = 1024     # pixels a histogram block takes at a time (CHUNK)
HIST_WAVES = 4        # histogram blocks a call, in resident grids
INGEST_THREADS = 256  # threads a block of the ingest kernel (THREADS)
MIN_TILE = 4 * INGEST_THREADS   # least pixels of an ingest work item
DEVICE_LAUNCHES_PER_CALL = 1    # device launches of one ingest_batch call
HIST_DEVICE_LAUNCHES_PER_CALL = 1   # ... of one hsv_hist_batch call


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
        ("blocks_per_frame", ctypes.c_int), ("float_weights", ctypes.c_int),
    ]


def _lib(name: str) -> ctypes.CDLL:
    """The built library ``name`` ("ingest" or "hist") with its launch
    function's argument types set."""
    lib = kbuild.build()[name]
    if name == "ingest":
        fn = lib.ingest_batch_launch
        fn.argtypes = ([ctypes.POINTER(_Params), ctypes.c_int]
                       + [ctypes.c_void_p] * 15)
    else:
        fn = lib.hsv_hist_launch
        fn.argtypes = [ctypes.POINTER(_HistParams)] + [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    occupancy = getattr(lib, f"{name}_resident_blocks")
    occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    occupancy.restype = ctypes.c_int
    return lib


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


@dataclass(frozen=True)
class WorkPlan:
    """How one ingest call splits its pixels over the cooperative grid.

    A work item is one camera's pixel tile: item ``it`` is camera
    ``it // ntiles``, pixels ``[j * tile, min((j + 1) * tile, N))`` with
    ``j = it % ntiles``. Block ``b`` takes items ``b, b + grid, ...`` on
    every frame (the loop of ``ingest_kernel`` in csrc/ingest.cu), so each
    thread meets the same pixels, and the same background, frame after
    frame."""
    cameras: int
    pixels: int
    tile: int          # pixels per item, a multiple of 4
    ntiles: int        # items per camera
    grid: int          # blocks launched: <= resident, <= items

    def items(self, block: int) -> List[Tuple[int, int]]:
        """The (camera, tile) items of ``block``, in the kernel's order."""
        return [divmod(it, self.ntiles)
                for it in range(block, self.cameras * self.ntiles, self.grid)]


def work_plan(C: int, N: int, resident: int,
              plan_cameras: Optional[int] = None) -> WorkPlan:
    """The plan for C cameras of N pixels on a card that holds
    ``resident`` blocks of the kernel at once: about ``resident / C``
    tiles a camera (one item a block), none under ``MIN_TILE`` pixels, so
    a small call launches few blocks; more cameras than resident blocks
    give each block several items. With ``plan_cameras`` the tiles are
    cut as for that many cameras (a shard of a larger array), and only
    the grid follows C."""
    P = C if plan_cameras is None else int(plan_cameras)
    if min(C, N, resident, P) < 1:
        raise ValueError(f"work_plan needs C, N, resident, plan_cameras "
                         f">= 1, got {(C, N, resident, P)}")
    per_cam = max(1, resident // P)
    tile = max(MIN_TILE, -(-N // per_cam))
    tile += -tile % 4
    ntiles = -(-N // tile)
    return WorkPlan(C, N, tile, ntiles, min(C * ntiles, resident))


_RESIDENT: Dict[Tuple[str, int], int] = {}


def resident_blocks(device, name: str = "ingest") -> int:
    """Blocks of kernel library ``name``'s kernel ("ingest" or "hist")
    resident on ``device`` at once (occupancy x SMs), asked of the CUDA
    runtime once per process."""
    key = (name, device_index(device))
    if key not in _RESIDENT:
        out = ctypes.c_int(0)
        err = getattr(_lib(name), f"{name}_resident_blocks")(
            key[1], ctypes.byref(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"{name} kernel occupancy query failed: "
                               f"cudaError {err}, {out.value} blocks")
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


@dataclass(frozen=True)
class HistPlan:
    """How one histogram call splits its pixels over blocks.

    Frame ``t`` gets blocks ``t * G .. t * G + G - 1`` (``G =
    blocks_per_frame``); block ``g`` of a frame takes the frame's
    ``HIST_CHUNK``-pixel chunks ``g, g + G, ...`` (``chunks``), thread
    ``x`` pixels ``4x .. 4x + 3`` of each (the loop of ``hist_kernel`` in
    csrc/hist.cu). The plan, and so the order of every float sum, depends
    on the shapes and the card's resident blocks alone."""
    frames: int
    pixels: int
    nchunks: int           # chunks a frame
    blocks_per_frame: int

    def chunks(self, g: int) -> range:
        return range(g, self.nchunks, self.blocks_per_frame)

    def pixels_of(self, g: int, thread: int) -> List[int]:
        """The pixels of one thread of block ``g`` of any frame, in order."""
        q = 4 * thread
        return [i for c in self.chunks(g)
                for i in range(c * HIST_CHUNK + q, c * HIST_CHUNK + q + 4)
                if i < self.pixels]


def hist_plan(T: int, N: int, resident: int) -> HistPlan:
    """About ``HIST_WAVES`` resident grids of blocks over all T frames,
    at least one block a frame and at most one a chunk."""
    if min(T, N, resident) < 1:
        raise ValueError(f"hist_plan needs T, N, resident >= 1, got "
                         f"{(T, N, resident)}")
    nchunks = -(-N // HIST_CHUNK)
    per_frame = HIST_WAVES * resident // T
    return HistPlan(T, N, nchunks, max(1, min(per_frame, nchunks)))


def _params(C, T, N, hue_ranges, bs, bv, alpha, threshold, use_fg, bg_valid,
            op, width, tile) -> _Params:
    nc = len(hue_ranges)
    _check_counters(nc, bs, bv)
    if op not in ("or", "and"):
        raise ValueError(f"unknown composition op {op!r}")
    p = _Params(C=C, T=T, N=N, nc=nc, bs=bs, bv=bv,
                sscale=bs / 256.0, vscale=bv / 256.0, alpha=alpha,
                one_minus_alpha=1.0 - alpha, threshold=threshold,
                use_fg=int(bool(use_fg)), bg_valid=int(bool(bg_valid)),
                op_and=int(op == "and"), width=int(width), tile=tile)
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
                 bg_valid: bool = True, op: str = "or", width: int = 0,
                 plan_cameras: Optional[int] = None):
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

    ``plan_cameras`` (default C) is the camera count the work plan
    (``work_plan``) is made for: the tile, and so the grouping of each
    camera's gain sums, depends on it. A shard of a camera array passes
    the whole array's count, and its cameras' outputs are then bit for
    bit those of the unsharded call. The plain version has no plan.
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
    plan = work_plan(C, N, resident_blocks(dev), plan_cameras)
    params = _params(C, T, N, hue_ranges, bs, bv, alpha, threshold, use_fg,
                     bg_valid, op, width, plan.tile)
    lib = _lib("ingest")

    # three allocations: the float outputs (bg first, so that it is 16-byte
    # aligned as the next call's bg0), the int32 bbox and accumulators
    # (zeroed by the kernel), the double gain partials
    f = torch.empty(C * N + C * T * (nc * nb + nc + 2) + C,
                    dtype=torch.float32, device=dev)
    bg, counts, totals, fgtot, util, gain = f.split(
        [C * N, C * T * nc * nb, C * T * nc, C * T, C * T, C])
    bg, counts, totals = bg.view(C, N), counts.view(C, T, nc, nb), \
        totals.view(C, T, nc)
    fgtot, util = fgtot.view(C, T), util.view(C, T)
    ints = torch.empty(C * T * (4 + nc * nb + 1), dtype=torch.int32,
                       device=dev)
    bbox, acc = ints.split([C * T * 4, C * T * (nc * nb + 1)])
    bbox = bbox.view(C, T, 4)
    partials = torch.empty((C, T, plan.ntiles, 2), dtype=torch.float64,
                           device=dev)
    with torch.cuda.device(dev):     # the launch runs on rgb's device
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ingest_batch_launch(
            ctypes.byref(params), plan.grid, rgb.data_ptr(), bg0.data_ptr(),
            gain0.data_ptr(), M_pos.data_ptr(), norm.data_ptr(),
            counts.data_ptr(), totals.data_ptr(), fgtot.data_ptr(),
            util.data_ptr(), bg.data_ptr(), gain.data_ptr(), bbox.data_ptr(),
            acc.data_ptr(), partials.data_ptr(), stream)
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
    dev = rgb.device
    G = hist_plan(T, N, resident_blocks(dev, "hist")).blocks_per_frame
    p = _HistParams(T=T, N=N, nc=nc, bs=bs, bv=bv, sscale=bs / 256.0,
                    vscale=bv / 256.0, blocks_per_frame=G,
                    float_weights=int(fg.dtype == torch.float32))
    _hue_fields(p, hue_ranges)
    lib = _lib("hist")

    # one allocation for the outputs; the blocks' partials (int32 counts or
    # float32 sums, written before they are read) beside it
    out = torch.empty(T * (nc * nb + nc + 1), dtype=torch.float32,
                      device=dev)
    counts, totals, fgtot = out.split([T * nc * nb, T * nc, T])
    partials = torch.empty(T * G * (nc * nb + 1), dtype=torch.int32,
                           device=dev)
    weights = fg if fg.dtype == torch.float32 else fg.view(torch.uint8)
    with torch.cuda.device(dev):     # the launch runs on rgb's device
        stream = torch.cuda.current_stream(dev).cuda_stream
        frame_tickets = tickets(dev, stream, T)   # one a frame
        err = lib.hsv_hist_launch(
            ctypes.byref(p), rgb.data_ptr(), weights.data_ptr(),
            counts.data_ptr(), totals.data_ptr(), fgtot.data_ptr(),
            partials.data_ptr(), frame_tickets.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"CUDA hsv_hist kernel launch failed: cudaError "
                           f"{err}")
    hsv_hist_batch.launches += 1
    return counts.view(T, nc, nb), totals.view(T, nc), fgtot


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
    """Bytes one histogram call moves with every pixel read: RGB and the
    weights read once, the float32 outputs written once (the dense bound;
    ``hist_bytes_read`` is what a call's weights need)."""
    return int(T * N * (12 + weight_bytes) + T * (nc * nb + nc + 1) * 4)


SECTOR = 32           # bytes of a DRAM sector, what a load fetches at least


def hist_bytes_read(fg, nc: int, nb: int, rgb_offset: int = 0) -> int:
    """Least bytes one histogram call must move for these weights: every
    weight read once, every 32-byte sector of RGB that holds a pixel with
    a non-zero weight (NaN counts as non-zero; -0.0 as zero) read once,
    the float32 outputs written once. ``fg`` is the (T, N) mask or
    weights; ``rgb_offset`` the RGB's address modulo 32 (``rgb.data_ptr()
    % 32``), which places the sectors. Only the sectors' bytes inside the
    RGB tensor count, so a dense mask gives ``hist_bytes_moved``."""
    T, N = fg.shape
    off = int(rgb_offset) % SECTOR
    end = off + 12 * T * N                       # past the last RGB byte
    idx = torch.nonzero(fg.reshape(-1) != 0).reshape(-1).to(torch.int64)
    touched = torch.zeros(-(-end // SECTOR), dtype=torch.bool,
                          device=fg.device)
    start = off + 12 * idx                       # each pixel's first byte
    touched[start // SECTOR] = True
    touched[(start + 11) // SECTOR] = True
    n = int(touched.sum())
    # the first and last sectors lie partly outside the tensor
    n_bytes = SECTOR * n
    if bool(touched[0]):
        n_bytes -= off
    if bool(touched[-1]):
        n_bytes -= touched.numel() * SECTOR - end
    return int(T * N * fg.element_size() + n_bytes
               + T * (nc * nb + nc + 1) * 4)


# Float32 operations per pixel of the histogram kernel: HSV 12, joint bin
# 4, hue ranges ~4. Histogram updates are integer, not counted.
HIST_OPS_PER_PIXEL = 20


# Float32 operations per pixel per frame, counted from the kernel body:
# HSV 12 (max/min 4, sub 1, sat div+mul 2, hue div+add/mod+mul ~4, compares
# 1), background 7 (clip 0, div 1, sub+abs+compare 3, EMA 3), joint bin 4,
# hue ranges and sums ~6. Histogram updates are integer, not counted.
OPS_PER_PIXEL = 29


__all__ = ["ingest_batch", "hsv_hist", "hsv_hist_batch",
           "bytes_moved", "hist_bytes_moved", "compare_with_plain",
           "compare_hist_with_plain", "OPS_PER_PIXEL", "HIST_OPS_PER_PIXEL",
           "DEVICE_LAUNCHES_PER_CALL", "HIST_DEVICE_LAUNCHES_PER_CALL",
           "HistPlan", "hist_plan", "hist_bytes_read", "WorkPlan",
           "work_plan", "resident_blocks"]

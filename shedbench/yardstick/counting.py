"""Least work of one fused-ingest call, counted from shapes.

Frozen from ``bytes_moved`` and ``OPS_PER_PIXEL`` in
``src/repro_torch/kernels/hsv_features/kernel.py`` at commit b67978d, with
one change: the frames are counted as the uint8 pixels the caller hands
over (one byte a channel), not as the float32 copy the program makes of
them. So the bound is that of the work the frames require, whatever
implements it, and no implementation can read above 100 % of it.
"""
from __future__ import annotations

# Float32 operations per pixel per frame, counted from the kernel body at
# that commit: HSV 12, background 7, joint bin 4, hue ranges and sums 6.
# Histogram updates are integer and not counted.
OPS_PER_PIXEL = 29


def ingest_bytes(C: int, T: int, N: int, nc: int, nb: int, width: int = 0,
                 frame_bytes: int = 1) -> int:
    """Each input read once and each output written once: the frames
    (``frame_bytes`` a channel), the background lane read and written
    once a call, the gains, the utility model, and the per-frame outputs
    (counts, colour totals, foreground totals, utilities, and with a
    width the bounding boxes)."""
    f = 4
    inp = C * T * N * 3 * frame_bytes + C * N * f + C * f + nc * nb * f + nc * f
    out = (C * T * nc * nb + C * T * nc + 2 * C * T + C * N + C) * f
    if width:
        out += C * T * 4 * 4
    return int(inp + out)


def ingest_ops(C: int, T: int, N: int) -> int:
    return OPS_PER_PIXEL * C * T * N


def least_seconds(nbytes: int, ops: int, bytes_per_s: float,
                  ops_per_s: float):
    """(seconds, what bounds them): the larger of the byte and op times."""
    tb, to = nbytes / bytes_per_s, ops / ops_per_s
    return (tb, "bytes") if tb >= to else (to, "operations")

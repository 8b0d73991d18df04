"""The traffic's clip library, rendered on the host: one seeded scene a
camera. This module imports NumPy and the frozen generator alone, so that
the worker processes that render a large library start quickly."""
from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from yardstick.traffic import combined_label, generate_scenario

# a library of at least this many frames is rendered by worker processes
PARALLEL_FRAMES = 2048


def render_clip(cfg, traffic, c: int):
    """Camera ``c``'s clip of the library, (L, h, w, 3) uint8, and its
    (L,) labels: a scene drawn from ``library_seed`` and ``c``."""
    h, w = traffic["render"]
    colors = tuple(cfg["query"]["colors"])
    sc = generate_scenario(np.random.SeedSequence(
                               [traffic["library_seed"], 1, c]),
                           num_frames=traffic["clip_frames"], height=h,
                           width=w, vehicle_rate=traffic["vehicle_rate"],
                           confuser_rate=traffic["confuser_rate"],
                           target_colors=colors)
    return sc.frames_rgb(), combined_label(sc, colors, cfg["query"]["op"])


def render_clips(cfg, traffic, workers: int = 0):
    """(C, L, h, w, 3) uint8 clips and (C, L) labels of the traffic's clip
    library, at the traffic's render size. Each clip depends on its camera
    alone, so ``workers`` processes (by default one a core, up to 8, for a
    library of ``PARALLEL_FRAMES`` or more; else none) render the same
    library; they have all ended when this returns."""
    C = traffic["cameras"]
    if not workers:
        big = C * traffic["clip_frames"] >= PARALLEL_FRAMES
        workers = min(8, len(os.sched_getaffinity(0))) if big else 1
    cams = range(C)
    if workers > 1:
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            out = list(ex.map(render_clip, [cfg] * C, [traffic] * C, cams,
                              chunksize=-(-C // workers)))
    else:
        out = [render_clip(cfg, traffic, c) for c in cams]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])

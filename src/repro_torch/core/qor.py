"""Quality-of-Result metrics (paper §II-B, Eq. 2–3)."""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Set

import numpy as np


def per_object_qor(frame_objects: Sequence[Iterable[int]],
                   kept: Sequence[bool]) -> Dict[int, float]:
    """Eq. 2 for every target object.

    frame_objects[i] = ids of target objects present in frame i;
    kept[i] = True if the Load Shedder sent frame i downstream.
    """
    total: Dict[int, int] = {}
    sent: Dict[int, int] = {}
    for objs, k in zip(frame_objects, kept):
        for o in objs:
            total[o] = total.get(o, 0) + 1
            if k:
                sent[o] = sent.get(o, 0) + 1
    return {o: sent.get(o, 0) / total[o] for o in total}


def overall_qor(frame_objects: Sequence[Iterable[int]],
                kept: Sequence[bool]) -> float:
    """Eq. 3: mean per-object QoR over all target objects (1.0 if none)."""
    per = per_object_qor(frame_objects, kept)
    if not per:
        return 1.0
    return float(np.mean(list(per.values())))


def drop_rate(kept: Sequence[bool]) -> float:
    kept = np.asarray(kept, bool)
    if kept.size == 0:
        return 0.0
    return float(1.0 - kept.mean())

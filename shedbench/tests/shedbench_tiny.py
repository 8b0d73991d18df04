"""A cell of the benchmark cut down to a size that a CPU test holds:
2 cameras, 2 frames a step, 24x32 frames, and a window that warms up,
traces and checks in a few steps."""
import copy
import dataclasses
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from shedharness import window  # noqa: E402
from shedharness.spec import load_cell  # noqa: E402

window.WARMUP_STEPS = 2
window.TRACE_STEPS = (2, 3)
window.CHECK_EVERY_STEPS = 2
window.CHECK_MAX = 4


def tiny(name: str):
    spec = load_cell(ROOT, name)
    cfg, tr = copy.deepcopy(spec.config), copy.deepcopy(spec.traffic)
    tr.update(cameras=2, frames_per_step=2, render=[12, 16], upsample=2,
              clip_frames=4)
    cfg["frame_shape"] = [24, 32]
    return dataclasses.replace(spec, config=cfg, traffic=tr)

"""One run of one cell: inputs, program, window, metrics, check, and the
result line."""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .check import check, passed
from .inputs import make_inputs
from .program import open_program
from .tracing import Trace, read_trace
from .window import Window, drive


@dataclass
class Record:
    """What a metric's reader reads."""
    window: Window
    trace: Optional[Trace]
    shapes: Dict[str, int]


def shapes_of(cfg, traffic) -> Dict[str, int]:
    H, W = cfg["frame_shape"]
    q = cfg["query"]
    return {"C": traffic["cameras"], "T": traffic["frames_per_step"],
            "N": H * W, "nc": len(q["colors"]), "nb": q["bs"] * q["bv"],
            "width": W if cfg.get("cascade") else 0}


def run_cell(spec, *, seed: int, seconds: float, trace: bool, device,
             t_origin: float, make_program: Optional[Callable] = None,
             sample_gap: Optional[int] = None) -> Tuple[Dict[str, Any], List[str]]:
    """Returns (the result line's object, the lines for standard error).
    ``make_program(cfg, inputs, cameras, device)`` stands in another
    program for the session (the control and the planted faults)."""
    cfg, traffic = spec.config, spec.traffic
    dev = torch.device(device)
    marks = [("start", time.perf_counter())]
    inputs = make_inputs(cfg, traffic, seed, dev)
    marks.append(("inputs", time.perf_counter()))
    session = (make_program or open_program)(cfg, inputs, traffic["cameras"],
                                             dev)
    marks.append(("session", time.perf_counter()))
    win = drive(session, inputs, traffic, seed=seed, seconds=seconds,
                trace=trace, t_origin=t_origin, device=dev,
                sample_gap=sample_gap)
    tr = read_trace(win.profile) if win.profile is not None else None
    win.profile = None
    rec = Record(window=win, trace=tr, shapes=shapes_of(cfg, traffic))
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = m.read(rec)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    cuda = dev.type == "cuda"
    info = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": spec.chips, "memory_peak_bytes": win.raw_peak}
    if trace:
        info["busy_s"] = tr.busy_s if tr else 0.0
        info["window_s"] = tr.window_s if tr else 0.0
    # the program's state goes before the reference runs
    del session
    gc.collect()
    numbers = check(win, inputs, cfg, traffic, dev)
    ok = passed(numbers) and win.failed == 0
    out = {"correct": ok, "attempted": win.frames, "failed": win.failed,
           "metrics": metrics, "device": info}
    if trace and tr is not None:
        out["breakdown"] = tr.breakdown()
    out["check"] = numbers
    marks.append(("warm-up", t_origin + win.setup_s))
    setup = ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b) in
                      zip([("origin", t_origin)] + marks[:-1], marks))
    lines = [f"shedbench {spec.name}: set-up {setup}; {win.steps} steps, "
             f"{win.frames} frames in {win.window_s:.3f} s, "
             f"{len(win.samples)} checked, correct={ok}"]
    if tr is not None and win.plain_iter_s:
        lines.append(f"device stretch: {tr.steps} steps in {tr.window_s:.4f} s, "
                     f"{1e3 * tr.window_s / tr.steps:.3f} ms a step; "
                     f"untraced {1e3 * win.plain_iter_s:.3f} ms a step")
    lines += [f"check {k} {n['value']!r} limit {n['rule']} {n['limit']!r}"
              for k, n in numbers.items()]
    return out, lines

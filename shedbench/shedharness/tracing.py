"""The traced stretches of a ``--trace 1`` run, read back from
``torch.profiler``'s Chrome trace.

The device stretch records device activity alone (kernels, copies,
memsets), so that its recording does not slow the host; its length is
taken on the host clock around its iterations. The host stretch records
host operations too, each iteration under a ``shedbench.step``
annotation; it only names what the host was doing in each idle gap of the
device.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STEP = "shedbench.step"


def start_profiler(host: bool):
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host or not torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CPU)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def read_events(prof) -> List[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    return events.get("traceEvents", events) if isinstance(events, dict) else events


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _device(events) -> List[Tuple[str, float, float]]:
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") in DEVICE_CATS and "dur" in e]


@dataclass
class Trace:
    steps: int                                 # iterations of the stretch
    window_s: float                            # its host-clock length
    device: List[Tuple[str, float, float]]     # (name, start, end), us
    idle: Dict[str, float] = field(default_factory=dict)   # s a step

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in _union((a, b) for _, a, b in
                                            self.device)) * 1e-6

    def device_seconds(self, match=None) -> float:
        return sum(b - a for n, a, b in self.device
                   if match is None or match(n)) * 1e-6

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """Seconds a step: the device operations that took most time, and
        the device's idle time by what the host was doing."""
        ops: Dict[str, float] = {}
        for n, a, b in self.device:
            ops[n] = ops.get(n, 0.0) + (b - a) * 1e-6 / self.steps
        rank = lambda d: [[k[:160], v] for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(self.idle)}


def idle_by_host(events) -> Dict[str, float]:
    """Seconds a step of the device's idle gaps inside the annotated
    iterations, each named by the innermost host event running at its
    middle."""
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == STEP]
    if not steps:
        return {}
    t0, t1 = min(a for a, _ in steps), max(b for _, b in steps)
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") in HOST_CATS and "dur" in e))
    starts = [h[0] for h in host]
    gaps, t = [], t0
    for a, b in _union((a, b) for _, a, b in _device(events)):
        if a > t:
            gaps.append((t, min(a, t1)))
        t = max(t, b)
    if t1 > t:
        gaps.append((t, t1))
    out: Dict[str, float] = {}
    for a, b in gaps:
        if b <= a:
            continue
        m = 0.5 * (a + b)
        name = "host outside any event"
        i = bisect.bisect_right(starts, m) - 1
        for j in range(i, max(-1, i - 2000), -1):
            if host[j][0] <= m <= host[j][1]:
                name = host[j][2]
                name = "host Python between calls" if name == STEP else name
                break
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6 / len(steps)
    return out


def read_trace(profile) -> Optional[Trace]:
    """The traced stretches (``Window.profile``), or None without a
    device stretch."""
    dev = (profile or {}).get("device")
    if not dev or "t1" not in dev or not dev["steps"]:
        return None
    tr = Trace(steps=dev["steps"], window_s=dev["t1"] - dev["t0"],
               device=_device(dev["events"]))
    host = profile.get("host")
    if host and "t1" in host:
        tr.idle = idle_by_host(host["events"])
    return tr

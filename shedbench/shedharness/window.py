"""Set-up's warm-up and the measured window: the closed loop of
``report_backend_latency`` -> ``step(frames)`` -> ``next_frames``.

Each iteration hands the program the next step batch of the pool (already
on the device), feeds the control loop one seeded backend latency, times
``step`` alone on the host clock (``step`` returns host decisions, so it
ends in a sync), and pops what the backend takes until the next batch.
The next batch goes in when the iteration ends.

At a seeded sample of the window's steps the harness copies the session's
state before the iteration, after ``step`` and after ``next_frames``; the
check replays those steps with the reference once the window has closed.
The copies are made between steps, outside the timed call, and their
bytes are left out of the program's memory peak.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from yardstick.reference import ControlPlane

from .tracing import read_events, start_profiler

# How a run is warmed up, traced and checked; the same for every cell.
WARMUP_STEPS = 4             # set-up's steps, which warm every shape
TRACE_STEPS = (16, 24)       # device stretch: from this window step, this many
TRACE_HOST_STEPS = 8         # then the host stretch: this many steps
CHECK_EVERY_STEPS = 250      # mean gap between checked steps
CHECK_MAX = 12               # checked steps at most

SMALL_LEAVES = ControlPlane.LEAVES + ("gain", "cdf_counts", "s2_counts",
                                      "q_util", "q_seq")


def snapshot(session, with_bg: bool) -> Dict[str, torch.Tensor]:
    st = session.state
    out = {n: getattr(st, n).clone() for n in SMALL_LEAVES}
    if with_bg:
        out["bg"] = st.bg.clone()
    return out


def nbytes(snap: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in snap.values())


@dataclass
class Sample:
    """One checked step: its inputs and what the program made of them."""
    step: int                 # index among all steps (warm-up first)
    batch: int                # index into the pool
    latency: float
    pre: Dict[str, torch.Tensor]
    result: Any
    sent: List[Any]
    post: Dict[str, torch.Tensor] = None
    pop: Dict[str, torch.Tensor] = None


@dataclass
class Window:
    setup_s: float
    steps: int
    step_s: List[float]
    window_s: float
    frames: int
    memory_peak: Optional[int]        # the program's own, bytes
    raw_peak: Optional[int]           # the process's, bytes
    samples: List[Sample]
    pushed: List[np.ndarray]          # pushed_seq of every step
    start: Dict[str, np.ndarray]      # the session's state when opened
    spans: Dict[str, List[float]] = field(default_factory=dict)
    profile: Any = None
    failed: int = 0                   # frames given no decision code
    plain_iter_s: Optional[float] = None   # mean iteration outside the stretches


class SpanScorer:
    """Wraps the session's stage-2 scorer: a host-clock span around each
    ``score`` call, ended by a sync, while ``active``."""

    def __init__(self, inner, log: List[float]):
        self.inner, self.log, self.active = inner, log, False

    def score(self, frames, bboxes):
        if not self.active:
            return self.inner.score(frames, bboxes)
        t0 = time.perf_counter()
        out = self.inner.score(frames, bboxes)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.log.append(time.perf_counter() - t0)
        return out


def sample_steps(seed: int, first: int, gap: int, count: int) -> List[int]:
    """``count`` window steps from ``first`` on: the first, then seeded
    gaps of 1 + a geometric draw of mean ``gap``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    out = [first]
    while len(out) < count:
        out.append(out[-1] + int(rng.geometric(1.0 / gap)))
    return out


def drive(session, inputs, traffic, *, seed: int, seconds: float,
          trace: bool, t_origin: float, device,
          sample_gap: Optional[int] = None) -> Window:
    """Warm up, then run the window for ``seconds``.

    With ``trace``, two stretches of the window are profiled, each
    trace read back as soon as its profiler stops: first ``TRACE_STEPS[1]``
    steps from step ``TRACE_STEPS[0]`` with device activity alone, timed
    on the host clock from its first iteration to the end of the device's
    work in its last (the profiler's start and stop fall outside), then
    ``TRACE_HOST_STEPS`` steps with host operations too, each iteration
    under a ``shedbench.step`` annotation, whose recording slows the host
    and which serve only to name what the host did in the device's idle
    gaps. The scorer span is on outside both stretches.
    ``Window.plain_iter_s`` is the mean iteration outside the stretches
    and the checked steps, beside which the device stretch's own reads
    what its recording costs."""
    C, T = traffic["cameras"], traffic["frames_per_step"]
    lat_lo, lat_hi = traffic["backend_latency_s"]
    k_send = traffic["send_per_step"]
    warm = WARMUP_STEPS
    p0, pn = TRACE_STEPS
    ph = TRACE_HOST_STEPS
    cuda = torch.device(device).type == "cuda"
    pool = inputs.pool
    # the backend latencies: one set fixed by the traffic, in an order
    # drawn from the seed
    lats = np.random.default_rng(np.random.SeedSequence(
        [traffic["library_seed"], 2])).uniform(lat_lo, lat_hi,
                                                traffic["latency_draws"])
    lats = lats[np.random.default_rng(np.random.SeedSequence(
        [seed, 2])).permutation(lats.size)]
    start = {n: t.cpu().numpy() for n, t in snapshot(session, False).items()}
    spans: Dict[str, List[float]] = {}
    scorer = None
    if trace and getattr(session, "cascade", None) is not None:
        scorer = SpanScorer(session.cascade.scorer, spans.setdefault("scorer", []))
        session.cascade.scorer = scorer
    held = [inputs.pool_bytes]
    bad = [0]
    pushed: List[np.ndarray] = []

    def iteration(k: int, snap: bool):
        """One closed-loop iteration. Returns (step seconds, the program's
        own memory peak during ``step`` or None, the Sample or None)."""
        batch = k % len(pool)
        pre = snapshot(session, True) if snap else None
        held_now = held[0] + (nbytes(pre) if snap else 0)
        lat = float(lats[k % lats.size])
        session.report_backend_latency(lat)
        ids = np.arange(C * T, dtype=np.int64).reshape(C, T) + k * C * T
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res = session.step(frames=pool[batch], tick=bool(traffic["tick"]),
                           items=ids)
        dt = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device) - held_now
                if cuda else None)
        pushed.append(np.asarray(res.pushed_seq))
        d = np.asarray(res.decisions)
        bad[0] += int(((d < 0) | (d > 3)).sum())
        s = None
        if snap:
            s = Sample(step=k, batch=batch, latency=lat, pre=pre, result=res,
                       sent=None, post=snapshot(session, True))
        sent = session.next_frames(k_send)
        if snap:
            s.sent = list(sent)
            s.pop = snapshot(session, False)
            held[0] += nbytes(s.pre) + nbytes(s.post) + nbytes(s.pop)
        return dt, peak, s

    for k in range(warm):
        iteration(k, snap=k == 0)      # warms the harness's copies too
    held[0] = inputs.pool_bytes
    bad[0] = 0
    if trace:                          # the profiler's own start-up
        for host in (False, True):
            start_profiler(host).__exit__(None, None, None)
    gc.collect()
    gc.freeze()         # set-up's objects stay out of the window's collections
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_origin
    raw_peak = torch.cuda.max_memory_allocated(device) if cuda else None

    want = set(sample_steps(seed, warm, sample_gap or CHECK_EVERY_STEPS,
                            CHECK_MAX))
    step_s: List[float] = []
    samples: List[Sample] = []
    prog_peak = 0
    profile = {}
    prof = None
    if scorer is not None:
        scorer.active = True
    plain = [0.0, 0]                  # seconds and count of plain iterations
    k = warm
    t_start = time.perf_counter()
    t_end = t_start + seconds
    while time.perf_counter() < t_end:
        t_iter = time.perf_counter()
        i = k - warm
        stretch = None
        if trace and p0 <= i < p0 + pn:
            stretch = "device"
        elif trace and p0 + pn <= i < p0 + pn + ph:
            stretch = "host"
        if stretch and i in (p0, p0 + pn):
            if scorer is not None:
                scorer.active = False
            prof = start_profiler(stretch == "host")
            profile[stretch] = {"profile": prof, "steps": 0,
                                "t0": time.perf_counter()}
        if stretch == "host":
            with torch.profiler.record_function("shedbench.step"):
                dt, peak, s = iteration(k, snap=False)
        elif stretch == "device":
            dt, peak, s = iteration(k, snap=False)
        if stretch:
            profile[stretch]["steps"] += 1
        else:
            dt, peak, s = iteration(k, snap=k in want)
            if s is not None:
                samples.append(s)
            else:
                plain[0] += time.perf_counter() - t_iter
                plain[1] += 1
            if peak is not None:
                prog_peak = max(prog_peak, peak)
        if cuda:
            raw_peak = max(raw_peak, torch.cuda.max_memory_allocated(device))
        step_s.append(dt)
        k += 1
        if stretch and i in (p0 + pn - 1, p0 + pn + ph - 1):
            # the stretch ends with the device's work, before the profiler
            # stops and flushes
            if cuda:
                torch.cuda.synchronize(device)
            profile[stretch]["t1"] = time.perf_counter()
            prof.__exit__(None, None, None)
            # read back before any other profiler session runs
            profile[stretch]["events"] = read_events(prof)
            del profile[stretch]["profile"]
            prof = None
            if scorer is not None:
                scorer.active = True
    if cuda:
        torch.cuda.synchronize(device)
    t_close = time.perf_counter()
    window_s = t_close - t_start
    gc.unfreeze()
    if prof is not None:            # the window closed inside a stretch
        profile[stretch]["t1"] = t_close
        prof.__exit__(None, None, None)
        profile[stretch]["events"] = read_events(prof)
        del profile[stretch]["profile"]
    return Window(setup_s=setup_s, steps=len(step_s), step_s=step_s,
                  window_s=window_s, frames=len(step_s) * C * T,
                  memory_peak=prog_peak if cuda else None, raw_peak=raw_peak,
                  samples=samples, pushed=pushed, start=start, spans=spans,
                  profile=profile or None, failed=bad[0],
                  plain_iter_s=plain[0] / plain[1] if plain[1] else None)

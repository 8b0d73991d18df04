"""Discrete-event simulation of the full pipeline (paper Fig. 8).

Camera(s) -> [net] -> Load Shedder (admission + utility queue) -> [net]
-> Backend Query Executor (token backpressure, filter stage + DNN stage)
-> Metrics Collector -> Control Loop.

The shedder is anything with the shared serving surface —
``offer``/``next_frame``/``tick``, ``report_backend_latency`` /
``report_ingress_fps``, ``latency_bound``, ``expected_proc`` — i.e. a
multi-camera ``repro_torch.core.session.ShedSession`` (the standard entry:
``open_session(query, num_cameras, ...)``) or a bare single-camera
``LoadShedder``. With ``batch_arrivals=True`` simultaneous arrivals are
coalesced through the shedder's vectorized ``offer_batch`` (one array
dispatch per arrival tick) when it has one. Admission decisions and
shedder state are identical to sequential offers; transmission timing
within a coalesced tick can differ when a backend token is free
mid-tick — sequential mode sends the first arrival before the second
is even offered, batched mode offers the whole tick and then sends its
best frame (closer to the paper's best-first transmission intent).

The backend is pluggable: a latency model (deterministic, matching the
paper's filter-vs-DNN split) or a real model step. Deterministic
given seeds, so control-loop experiments are reproducible.

Latencies here are **synthetic**: ``BackendProfile`` *draws* each
frame's processing time from a seeded model (or ``backend_fn`` computes
it), and the control loop is fed those draws. The streaming service
(``repro_torch.serve.service``) is the complement: the same session surface
driven by wall-clock arrivals with **measured** backend latencies
closing the Eq. 16 loop. Use the simulator for fast, exactly
repeatable control-loop studies; use the service to validate against
real backend timing.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.control import LatencyInputs
from repro_torch.core.session import ShedSession
from repro_torch.core.shedder import LoadShedder
from repro_torch.data.pipeline import FrameRecord


@dataclass
class BackendProfile:
    """Per-frame processing latency model (paper §V-C query).

    Frames without a large target-colored blob exit at the filter stage
    (cheap); frames with one run the DNN detector (expensive).
    """
    filter_latency: float = 0.004
    dnn_latency: float = 0.150
    jitter: float = 0.05       # multiplicative noise

    def latency(self, frame: FrameRecord, rng: np.random.Generator) -> float:
        base = self.dnn_latency if frame.busy else self.filter_latency
        return float(base * (1.0 + self.jitter * rng.standard_normal()))


@dataclass
class ProcessedFrame:
    frame: FrameRecord
    t_sent: float
    t_done: float

    @property
    def e2e(self) -> float:
        return self.t_done - self.frame.t_gen


@dataclass
class SimResult:
    processed: List[ProcessedFrame]
    offered: List[FrameRecord]
    kept_mask: List[bool]
    violations: int
    stats: dict
    trace: List[dict]              # periodic control-loop snapshots

    def e2e_latencies(self):
        return np.asarray([p.e2e for p in self.processed])


class PipelineSimulator:
    def __init__(self, shedder: Union[ShedSession, LoadShedder],
                 backend: BackendProfile = BackendProfile(),
                 tokens: int = 1,
                 latency_inputs: LatencyInputs = LatencyInputs(),
                 control_period: float = 0.5,
                 seed: int = 0,
                 backend_fn: Optional[Callable[[FrameRecord], float]] = None,
                 fps_window: float = 2.0,
                 batch_arrivals: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.shedder = shedder
        self.backend = backend
        self.backend_fn = backend_fn
        self.tokens = tokens
        self.li = latency_inputs
        self.control_period = control_period
        # sliding window (seconds) over which the observed ingress FPS
        # fed to the control loop is estimated
        self.fps_window = float(fps_window)
        # coalesce simultaneous arrivals (e.g. C cameras at a shared
        # frame tick) into ONE vectorized offer_batch dispatch; admission
        # decisions and shedder state are identical to sequential offers
        # (thresholds only move on control ticks) though transmission can
        # pick the tick's best frame instead of its first when a backend
        # token is free; shedders without offer_batch fall back
        self.batch_arrivals = bool(batch_arrivals)
        # the generator behind every synthetic BackendProfile latency
        # draw — pass rng= to share/control the stream explicitly,
        # else it is freshly seeded from seed= (never module-global
        # state, so runs are reproducible either way)
        self.rng = rng if rng is not None else np.random.default_rng(seed)

    def run(self, frames: Sequence[FrameRecord],
            utilities: Sequence[float]) -> SimResult:
        EVT_ARRIVE, EVT_DONE, EVT_CTRL = 0, 1, 2
        events = []  # (time, kind, seq, payload) — seq breaks heap ties
        seq = iter(range(1 << 62))

        def push(t, kind, payload):
            heapq.heappush(events, (t, kind, next(seq), payload))

        for f, u in zip(frames, utilities):
            t_arr = f.t_gen + self.li.proc_cam + self.li.net_cam_ls
            push(t_arr, EVT_ARRIVE, (f, float(u)))
        if not events:
            return SimResult([], [], [], 0, {}, [])
        t0 = events[0][0]
        push(t0 + self.control_period, EVT_CTRL, None)
        t_end_guard = max(f.t_gen for f in frames) + 120.0

        free_tokens = self.tokens
        processed: List[ProcessedFrame] = []
        kept_of = {}
        offered: List[FrameRecord] = []
        trace: List[dict] = []
        last_fps_win: List[float] = []

        lb = self.shedder.latency_bound

        def send_if_possible(now):
            nonlocal free_tokens
            while free_tokens > 0:
                item = self.shedder.next_frame()
                if item is None:
                    return
                f = item
                # expired frames cannot meet the bound; shed them here
                # rather than burning a backend token (Eq. 20 intent)
                exp_done = now + self.li.net_ls_q + self.shedder.expected_proc()
                if exp_done - f.t_gen > lb:
                    self.shedder.stats.dropped_queue += 1
                    self.shedder.stats.sent -= 1
                    continue
                free_tokens -= 1
                lat = (self.backend_fn(f) if self.backend_fn
                       else self.backend.latency(f, self.rng))
                t_done = now + self.li.net_ls_q + lat
                push(t_done, EVT_DONE, (f, now, lat))

        while events:
            now, kind, _, payload = heapq.heappop(events)
            if now > t_end_guard:
                break
            if kind == EVT_ARRIVE:
                batch = [payload]
                if self.batch_arrivals:
                    while (events and events[0][0] == now
                           and events[0][1] == EVT_ARRIVE):
                        batch.append(heapq.heappop(events)[3])
                fs = [f for f, _ in batch]
                us = [u for _, u in batch]
                offer_batch = (getattr(self.shedder, "offer_batch", None)
                               if len(batch) > 1 else None)
                if offer_batch is not None:
                    decisions = offer_batch(fs, us)
                else:
                    decisions = [self.shedder.offer(f, u)
                                 for f, u in zip(fs, us)]
                for f, decision in zip(fs, decisions):
                    offered.append(f)
                    kept_of[id(f)] = decision == "queued"
                    last_fps_win.append(now)
                send_if_possible(now)
            elif kind == EVT_DONE:
                f, t_sent, lat = payload
                free_tokens += 1
                processed.append(ProcessedFrame(f, t_sent, now))
                self.shedder.report_backend_latency(lat)
                send_if_possible(now)
            else:  # control tick
                cutoff = now - self.fps_window
                last_fps_win[:] = [t for t in last_fps_win if t >= cutoff]
                if last_fps_win:
                    self.shedder.report_ingress_fps(
                        len(last_fps_win) / self.fps_window)
                snap = self.shedder.tick()
                snap["t"] = now
                snap["proc_q"] = self.shedder.expected_proc()
                trace.append(snap)
                if any(e[1] == EVT_ARRIVE for e in events):
                    push(now + self.control_period, EVT_CTRL, None)

        # queue eviction after push means kept_of may overstate: frames
        # evicted later were not actually processed. Reconstruct kept from
        # processed set (what reached the backend).
        processed_ids = {id(p.frame) for p in processed}
        kept_mask = [id(f) in processed_ids for f in offered]
        lb = self.shedder.latency_bound
        violations = sum(1 for p in processed if p.e2e > lb)
        stats = {
            "offered": len(offered),
            "processed": len(processed),
            "violations": violations,
            "drop_rate": 1.0 - (len(processed) / max(1, len(offered))),
            "shedder": self.shedder.stats,
        }
        return SimResult(processed, offered, kept_mask, violations, stats, trace)

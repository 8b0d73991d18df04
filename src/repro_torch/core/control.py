"""Control loop (paper §IV-D): admission control + dynamic queue sizing.

Admission control (Eq. 18–19): the Metrics Collector reports the
backend's average per-frame processing latency proc_Q; supported
throughput ST = 1/proc_Q; target drop rate = max(0, 1 - ST/FPS); the
rate is converted to a utility threshold through the utility CDF
(threshold.py).

Dynamic queue sizing (Eq. 20): the expected E2E latency of the Nth
queued frame is (N+1)*proc_Q + net_cam_ls + net_ls_q + proc_cam; the
queue is resized to the largest N meeting the bound (>= 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


class EWMA:
    """Optionally asymmetric EWMA: overload must be detected fast (large
    alpha upward) while recovery can be smoothed (small alpha downward),
    otherwise the queue is sized from a stale cheap-filter latency during
    a load spike and the E2E bound is violated until convergence."""

    def __init__(self, alpha: float = 0.2, init: float = 0.0,
                 alpha_up: Optional[float] = None):
        self.alpha = alpha
        self.alpha_up = alpha if alpha_up is None else alpha_up
        self.value = init
        self._seen = False

    def update(self, x: float) -> float:
        x = float(x)
        if not self._seen:
            self.value, self._seen = x, True
        else:
            a = self.alpha_up if x > self.value else self.alpha
            self.value += a * (x - self.value)
        return self.value


@dataclass
class LatencyInputs:
    """Continuously monitored component latencies (seconds)."""
    net_cam_ls: float = 0.0
    net_ls_q: float = 0.0
    proc_cam: float = 0.0


class ControlLoop:
    def __init__(self, latency_bound: float, fps: float,
                 inputs: LatencyInputs = LatencyInputs(),
                 alpha: float = 0.2, min_proc: float = 1e-6):
        self.latency_bound = float(latency_bound)
        self.fps_nominal = float(fps)
        self.inputs = inputs
        self.proc_q = EWMA(alpha, alpha_up=0.6)
        self.fps_observed = EWMA(alpha, init=fps)
        self.min_proc = min_proc
        # degraded-mode floor under the Eq. 19 rate (serve/fault.py):
        # raised toward the drop rate implied by zero effective capacity
        # while the backend is unhealthy; 0.0 = normal regime (identity)
        self.rate_floor = 0.0

    def set_rate_floor(self, floor: float) -> None:
        if not 0.0 <= floor <= 1.0:
            raise ValueError(f"rate floor {floor} outside [0, 1]")
        self.rate_floor = float(floor)

    # -- metric feeds -------------------------------------------------------
    def report_backend_latency(self, proc_latency: float):
        self.proc_q.update(max(proc_latency, self.min_proc))

    def report_ingress_fps(self, fps: float):
        self.fps_observed.update(fps)

    # -- Eq. 18–19 ----------------------------------------------------------
    def supported_throughput(self) -> float:
        p = max(self.proc_q.value, self.min_proc)
        return 1.0 / p

    def target_drop_rate(self) -> float:
        fps = max(self.fps_observed.value, 1e-9)
        st = self.supported_throughput()
        return max(max(0.0, 1.0 - st / fps), self.rate_floor)

    # -- Eq. 20 -------------------------------------------------------------
    def queue_size(self) -> int:
        """Largest N with (N+1)*proc_Q + nets + proc_cam <= latency bound."""
        p = max(self.proc_q.value, self.min_proc)
        budget = (self.latency_bound - self.inputs.net_cam_ls
                  - self.inputs.net_ls_q - self.inputs.proc_cam)
        n = int(budget / p + 1e-9) - 1
        return max(1, n)

    def expected_e2e(self, queue_pos: int) -> float:
        p = max(self.proc_q.value, self.min_proc)
        return ((queue_pos + 1) * p + self.inputs.net_cam_ls
                + self.inputs.net_ls_q + self.inputs.proc_cam)

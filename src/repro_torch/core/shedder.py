"""The Load Shedder (paper §IV): utility scoring + two-layer shedding.

Layer 1 (admission control): drop frames whose utility is below the
dynamic threshold derived from the target drop rate (control.py +
threshold.py).

Layer 2 (dynamic queue): admitted frames enter a bounded utility-ordered
queue (shed_queue.py); the queue size tracks the E2E budget, and the
transmission layer sends the best queued frame whenever the backend
frees a token.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.core.control import ControlLoop
from repro_torch.core.shed_queue import UtilityQueue
from repro_torch.core.threshold import UtilityCDF
from repro_torch.core.utility import UtilityModel


@dataclass
class ShedderStats:
    offered: int = 0
    dropped_admission: int = 0
    dropped_queue: int = 0
    dropped_cascade: int = 0    # stage-2 sheds (sessions with cascade=)
    sent: int = 0

    @property
    def dropped(self) -> int:
        return (self.dropped_admission + self.dropped_queue
                + self.dropped_cascade)

    def drop_rate(self) -> float:
        return self.dropped / self.offered if self.offered else 0.0


class LoadShedder:
    """Single-camera shedder. Multi-camera arrays (and new code in
    general) use ``repro_torch.core.session.ShedSession``, which shares this
    class's serving surface (``offer``/``next_frame``/``tick`` plus the
    metric feeds below) so the pipeline simulator drives either."""

    def __init__(self, model: Optional[UtilityModel], cdf: UtilityCDF,
                 control: ControlLoop, queue_size: int = 8,
                 update_cdf_online: bool = True):
        self.model = model
        self.cdf = cdf
        self.control = control
        self.queue = UtilityQueue(queue_size)
        self.threshold = -float("inf")
        self.stats = ShedderStats()
        self.update_cdf_online = update_cdf_online

    # -- metric feeds (shared surface with ShedSession) ----------------------
    @property
    def latency_bound(self) -> float:
        return self.control.latency_bound

    def expected_proc(self) -> float:
        """Current backend per-frame latency estimate."""
        return self.control.proc_q.value

    def report_backend_latency(self, proc_latency: float):
        self.control.report_backend_latency(proc_latency)

    def report_ingress_fps(self, fps: float):
        self.control.report_ingress_fps(fps)

    def set_rate_floor(self, floor: float) -> None:
        """Degraded-mode floor under the Eq. 19 target drop rate
        (applied at the next tick); 0.0 restores the normal regime."""
        self.control.set_rate_floor(floor)

    # -- scoring ------------------------------------------------------------
    def utility_of(self, pf) -> float:
        assert self.model is not None, "no utility model configured"
        return float(self.model.score(pf))

    # -- data path ----------------------------------------------------------
    def offer(self, item: Any, utility: float) -> str:
        """Returns 'queued' | 'shed_admission' | 'shed_queue'."""
        self.stats.offered += 1
        if self.update_cdf_online:
            self.cdf.update(utility)
        if utility < self.threshold:
            self.stats.dropped_admission += 1
            return "shed_admission"
        evicted = self.queue.push(item, utility)
        if evicted is not None:
            self.stats.dropped_queue += 1
            if evicted is item:
                return "shed_queue"
        return "queued"

    def next_frame(self) -> Optional[Any]:
        """Transmission control: called when the backend frees a token."""
        item = self.queue.pop_best()
        if item is not None:
            self.stats.sent += 1
        return item

    # -- control path -------------------------------------------------------
    def tick(self):
        """Re-derive threshold (Eq. 17–19) and queue size (Eq. 20)."""
        r = self.control.target_drop_rate()
        self.threshold = self.cdf.threshold_for_drop_rate(r)
        dropped = self.queue.resize(self.control.queue_size())
        self.stats.dropped_queue += len(dropped)
        return {"target_drop_rate": r, "threshold": self.threshold,
                "queue_size": self.queue.max_size}

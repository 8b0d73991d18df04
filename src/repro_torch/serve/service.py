"""The streaming serve service: async ingest -> session -> send queue ->
sender -> backend, with per-stage metrics (paper Fig. 8 as a *service*,
not an offline array sweep).

Components, one per stage:

``IngestCoalescer``
    Accepts per-camera frame arrivals and windows them into one
    dispatch per flush. A window flushes when any camera accumulates
    ``max_batch`` frames or when ``max_wait`` elapses since the window
    opened (deadline flush — partially-filled windows still ship, so
    coalescing never adds more than ``max_wait`` to E2E latency).

``ServeService``
    The event-driven runtime tying the stages together. A flushed
    window dispatches to the session by the richest path available:
    a full rectangular window of raw frames goes through
    ``ShedSession.step(frames=...)`` (scoring + admission + queues in
    ONE fused dispatch); ragged or score-only windows go through
    ``offer_batch``; shedders without ``offer_batch`` (e.g. a bare
    ``LoadShedder``) fall back to sequential ``offer``. Admitted frames
    wait in the session's bounded utility queues (the backpressured
    send queue) until the ``SenderWorker`` drains them per backend
    token; every completion feeds the frame's *measured* latency into
    ``report_backend_latency``, closing the Eq. 16–20 control loop with
    real numbers. Control ticks re-derive thresholds/queue caps every
    ``control_period`` seconds from the observed ingress rate.

All time comes from an injectable :class:`~repro_torch.serve.clock.Clock` —
``WallClock`` (production default) or ``VirtualClock`` (deterministic
tests/benchmarks: identical decisions, timestamps and metrics on every
seeded run). The runtime is a single-threaded event loop over a time
heap (ARRIVE < DONE < FLUSH < CTRL at equal timestamps), so there is no
scheduler nondeterminism to control for.
"""
from __future__ import annotations

import heapq
import itertools
import queue as _queue
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.control import LatencyInputs
from repro_torch.serve.clock import Clock, VirtualClock, WallClock
from repro_torch.serve.fault import CLOSED, ResilienceConfig
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.transport import SenderWorker, SendOutcome

# event kinds — the tuple ordering makes same-instant processing
# deterministic: arrivals land in the window before its deadline fires,
# completions free tokens before control re-derives thresholds; sender
# wake-ups (retry-ready / breaker probe windows) come last so freed
# tokens and fresh thresholds are visible when the sender re-pumps
EVT_ARRIVE, EVT_DONE, EVT_FLUSH, EVT_CTRL, EVT_WAKE = 0, 1, 2, 3, 4


@dataclass(frozen=True)
class Arrival:
    """One frame reaching the service at time ``t``.

    ``record`` is the frame payload handed to the backend (anything;
    ``t_gen``/``busy`` attributes are used when present). ``utility``
    is the precomputed score (camera-side ingest); ``frame`` is the raw
    ``(H, W, 3)`` RGB array for in-dispatch scoring. At least one of
    the two must be present.
    """
    t: float
    cam: Any
    record: Any
    utility: Optional[float] = None
    frame: Optional[np.ndarray] = None


def arrivals_from_records(records: Sequence[Any],
                          utilities: Optional[Sequence[float]] = None,
                          latency_inputs: Optional[LatencyInputs] = None,
                          frames: Optional[Sequence[np.ndarray]] = None,
                          ) -> List[Arrival]:
    """FrameRecords -> timed arrivals (generation time plus the camera
    processing + camera->shedder network delays, exactly the
    ``PipelineSimulator`` arrival model, so service and simulator runs
    on one trace are comparable)."""
    li = latency_inputs or LatencyInputs()
    out = []
    for i, r in enumerate(records):
        u = (float(utilities[i]) if utilities is not None
             else (None if np.isnan(getattr(r, "utility", float("nan")))
                   else float(r.utility)))
        out.append(Arrival(
            t=r.t_gen + li.proc_cam + li.net_cam_ls, cam=r.cam_id, record=r,
            utility=u, frame=None if frames is None else frames[i]))
    out.sort(key=lambda a: a.t)
    return out


@dataclass
class _Entry:
    record: Any
    utility: Optional[float]
    frame: Optional[np.ndarray]


@dataclass
class CoalescedBatch:
    """One flushed ingest window: per-camera-lane entry lists."""
    per_cam: List[List[_Entry]]
    opened_at: float
    count: int

    @property
    def rectangular(self) -> bool:
        """Every lane populated with the same number of frames."""
        n = len(self.per_cam[0])
        return n > 0 and all(len(l) == n for l in self.per_cam)

    @property
    def has_frames(self) -> bool:
        return all(e.frame is not None for l in self.per_cam for e in l)


class IngestCoalescer:
    """Windows per-camera arrivals into batched dispatches.

    ``add`` returns True when the window just became full (any lane hit
    ``max_batch``) and should flush immediately; otherwise the service
    flushes it at the ``max_wait`` deadline scheduled when the window
    opened.
    """

    def __init__(self, num_cameras: int, *, max_batch: int = 8,
                 max_wait: float = 0.05,
                 metrics: Optional[MetricsRegistry] = None) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.num_cameras = int(num_cameras)
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.pending: List[List[_Entry]] = [[] for _ in range(num_cameras)]
        self.count = 0
        self.opened_at: Optional[float] = None

    def add(self, lane: int, record: Any, utility: Optional[float],
            frame: Optional[np.ndarray], now: float) -> bool:
        if self.count == 0:
            self.opened_at = now
        self.pending[lane].append(_Entry(record, utility, frame))
        self.count += 1
        self.metrics.gauge("coalescer.depth").set(self.count)
        return len(self.pending[lane]) >= self.max_batch

    def flush(self, now: float) -> Optional[CoalescedBatch]:
        if self.count == 0:
            return None
        m = self.metrics
        m.histogram("coalescer.batch_frames").observe(self.count)
        m.histogram("coalescer.wait_s").observe(now - self.opened_at)
        batch = CoalescedBatch(self.pending, self.opened_at, self.count)
        self.pending = [[] for _ in range(self.num_cameras)]
        self.count = 0
        self.opened_at = None
        m.gauge("coalescer.depth").set(0)
        return batch


@dataclass(frozen=True)
class ServedFrame:
    """One frame that completed backend processing."""
    record: Any
    t_sent: float
    t_done: float
    backend_latency: float   # the measured per-frame latency (Eq. 16 q)
    e2e: float               # t_done - record.t_gen


@dataclass
class ServiceResult:
    processed: List[ServedFrame]
    offered: List[Any]
    kept_mask: List[bool]
    violations: int
    metrics: Dict[str, Any]          # MetricsRegistry.snapshot()
    trace: List[dict] = field(default_factory=list)

    def e2e_latencies(self) -> np.ndarray:
        return np.asarray([p.e2e for p in self.processed])


class ServeService:
    """The streaming load-shedding service fronting one camera array.

    ``run(arrivals)`` replays (virtual clock) or live-paces (wall
    clock) a timed arrival sequence through coalescer -> session ->
    send queue -> sender -> backend and returns a
    :class:`ServiceResult` whose stats line up field-for-field with
    ``PipelineSimulator`` results for A/B comparison.
    """

    def __init__(self, session: Any, backend: Any, *,
                 clock: Optional[Clock] = None,
                 tokens: int = 1,
                 max_batch: int = 8,
                 max_wait: float = 0.05,
                 control_period: float = 0.5,
                 fps_window: float = 2.0,
                 expire_in_queue: bool = True,
                 per_camera_latency: bool = False,
                 latency_inputs: Optional[LatencyInputs] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 metrics: Optional[MetricsRegistry] = None) -> None:
        self.session = session
        # feed each completion's measured latency into its own camera's
        # proc_q lane instead of broadcasting to all lanes — needs a
        # session whose report_backend_latency accepts ``cam=``
        self.per_camera_latency = bool(per_camera_latency)
        self.clock: Clock = clock if clock is not None else WallClock()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.num_cameras = int(getattr(session, "num_cameras", 1))
        self.control_period = float(control_period)
        self.fps_window = float(fps_window)
        self.tokens = int(tokens)
        self.li = latency_inputs or getattr(
            session, "latency_inputs", None) or LatencyInputs()
        self.coalescer = IngestCoalescer(
            self.num_cameras, max_batch=max_batch, max_wait=max_wait,
            metrics=self.metrics)
        self.resilience = resilience
        self.sender = SenderWorker(
            session, backend, tokens=tokens, latency_inputs=self.li,
            expire_in_queue=expire_in_queue, metrics=self.metrics,
            retry=resilience.retry if resilience else None,
            breaker=resilience.breaker if resilience else None,
            send_deadline=resilience.send_deadline if resilience else None)
        self._seq = itertools.count()
        self._heap: List[Tuple[float, int, int, Any]] = []
        self._epoch = 0
        # live push API: foreign threads submit() here; the event loop
        # transfers to the heap between events
        self._ingress: "_queue.SimpleQueue[Arrival]" = _queue.SimpleQueue()
        self._stopped = False
        self._t_start: Optional[float] = None
        self._stats0 = (0, 0, 0, 0, 0)
        self._ctrl_scheduled = False
        self._pending_wake: Optional[float] = None
        self._rate_floor = 0.0
        self._degraded_time = 0.0
        self._arrival_times: List[float] = []
        self._offered: List[Any] = []
        self._processed: List[ServedFrame] = []
        self._trace: List[dict] = []

    # -- lane mapping --------------------------------------------------------

    def _lane(self, cam: Any) -> int:
        lane_fn = getattr(self.session, "lane", None)
        if lane_fn is not None:
            return lane_fn(cam)
        return 0                       # single-queue shedder (LoadShedder)

    # -- event plumbing ------------------------------------------------------

    def _push(self, t: float, kind: int, payload: Any) -> None:
        heapq.heappush(self._heap, (t, kind, next(self._seq), payload))

    # -- stages --------------------------------------------------------------

    def _on_arrive(self, now: float, a: Arrival) -> None:
        self.metrics.counter("ingest.arrivals").inc()
        self._arrival_times.append(now)
        if not self._ctrl_scheduled:
            # the control chain parked itself when the loop went idle
            # (replay runs never hit this mid-run) — re-arm it
            self._push(now + self.control_period, EVT_CTRL, None)
            self._ctrl_scheduled = True
        was_empty = self.coalescer.count == 0
        full = self.coalescer.add(
            self._lane(a.cam), a.record, a.utility, a.frame, now)
        if was_empty:
            self._epoch += 1
            self._push(now + self.coalescer.max_wait, EVT_FLUSH, self._epoch)
        if full:
            self._flush(now)

    def _flush(self, now: float) -> None:
        batch = self.coalescer.flush(now)
        self._epoch += 1               # invalidate any pending deadline
        if batch is not None:
            self._dispatch(batch)
            self._pump(now)

    def _dispatch(self, batch: CoalescedBatch) -> None:
        """Hand one coalesced window to the shedder by the richest
        available path: fused step > offer_batch > sequential offer."""
        m, sess = self.metrics, self.session
        d0 = sess.stats.dropped_admission
        q0 = sess.stats.dropped_queue
        c0 = getattr(sess.stats, "dropped_cascade", 0)
        if (batch.rectangular and batch.has_frames
                and getattr(sess, "step", None) is not None
                and getattr(sess, "model", None) is not None):
            frames = np.stack([np.stack([e.frame for e in l])
                               for l in batch.per_cam])
            items = [[e.record for e in l] for l in batch.per_cam]
            res = sess.step(frames=frames, items=items, tick=False)
            m.counter("dispatch.fused").inc()
            s2 = getattr(res, "s2_scores", None)
            if s2 is not None:
                from repro_torch.core.session import SHED_ADMISSION
                # stage-2 score distribution over the color-gate
                # survivors (cascade sheds included) — the scorer's
                # health view; stage-1 sheds never reached the scorer
                dec = np.asarray(res.decisions)
                h = m.histogram("cascade.s2_score")
                for v in s2[(dec >= 0) & (dec != SHED_ADMISSION)].tolist():
                    h.observe(float(v))
        else:
            recs, utils, lanes = [], [], []
            for li, entries in enumerate(batch.per_cam):
                for e in entries:
                    if e.utility is None:
                        raise ValueError(
                            "arrival without a utility can only be served "
                            "through the fused path (rectangular window of "
                            "raw frames + a trained model)")
                    recs.append(e.record)
                    utils.append(e.utility)
                    lanes.append(li)
            offer_batch = getattr(sess, "offer_batch", None)
            # the coalescer already bucketed by Arrival.cam — pass its
            # lanes through rather than re-deriving from record.cam_id,
            # so a stream resubmitted under a new camera id (churn)
            # lands on the new id's lane
            if offer_batch is not None and len(recs) > 1:
                offer_batch(recs, utils, cams=lanes)
                m.counter("dispatch.batched").inc()
            elif getattr(sess, "lane", None) is not None:
                for r, u, c in zip(recs, utils, lanes):
                    sess.offer(r, u, cam=c)
                m.counter("dispatch.sequential").inc(len(recs))
            else:                      # single-queue LoadShedder surface
                for r, u in zip(recs, utils):
                    sess.offer(r, u)
                m.counter("dispatch.sequential").inc(len(recs))
        for lane in batch.per_cam:
            for e in lane:
                self._offered.append(e.record)
        m.counter("ingest.offered").inc(batch.count)
        m.counter("shed.admission").inc(sess.stats.dropped_admission - d0)
        m.counter("shed.queue").inc(sess.stats.dropped_queue - q0)
        dc = getattr(sess.stats, "dropped_cascade", 0) - c0
        if dc:
            m.counter("shed.cascade").inc(dc)
        self._observe_queue_depth()

    def _pump(self, now: float) -> None:
        for o in self.sender.pump(now):
            self._push(o.t_done, EVT_DONE, o)
        wake = self.sender.next_wakeup(now)
        if wake is not None and (self._pending_wake is None
                                 or wake < self._pending_wake):
            self._pending_wake = wake
            self._push(wake, EVT_WAKE, None)

    def _on_done(self, now: float, o: SendOutcome) -> None:
        if not o.ok:
            # failed send: complete() records the frame's fate (retry
            # schedule or transport shed) along with the token return
            self.sender.complete(o, now)
            self.metrics.counter("backend.failed").inc()
            self._pump(now)
            return
        self.sender.complete(o, now)
        t_gen = getattr(o.item, "t_gen", o.t_sent)
        e2e = now - t_gen
        self._processed.append(ServedFrame(o.item, o.t_sent, now,
                                           o.latency, e2e))
        m = self.metrics
        m.counter("backend.done").inc()
        m.histogram("e2e.latency_s").observe(e2e)
        if e2e > self.session.latency_bound:
            m.counter("e2e.violations").inc()
        # the loop-closing feed: the MEASURED latency, not a model
        cam = getattr(o.item, "cam_id", None)
        if self.per_camera_latency and cam is not None:
            self.session.report_backend_latency(o.latency,
                                                cam=self._lane(cam))
        else:
            self.session.report_backend_latency(o.latency)
        self._pump(now)

    def _update_degraded(self, now: float) -> None:
        """Degraded-regime controller: ramp a rate floor under the
        Eq. 19 targets while the breaker is not CLOSED or the measured
        backend latency alone blows the E2E budget; ramp back down
        (asymmetric, oscillation-free) once half-open probes succeed.
        A floor of exactly 0.0 never touches the session, so the
        zero-fault path stays bit-identical."""
        cfg = self.resilience.degraded
        br = self.sender.breaker
        unhealthy = br is not None and br.state != CLOSED
        if not unhealthy and cfg.on_latency:
            exp = (self.session.expected_proc() + self.li.net_ls_q
                   + self.li.net_cam_ls + self.li.proc_cam)
            unhealthy = exp > (self.session.latency_bound
                               * cfg.latency_factor)
        target = cfg.max_drop if unhealthy else 0.0
        f = self._rate_floor
        f += (cfg.ramp_up if target > f else cfg.ramp_down) * (target - f)
        if target == 0.0 and f < cfg.snap_eps:
            f = 0.0
        if f != self._rate_floor or f > 0.0:
            set_floor = getattr(self.session, "set_rate_floor", None)
            if set_floor is not None:
                set_floor(f)
        self._rate_floor = f
        if f > 0.0:
            self._degraded_time += self.control_period
        m = self.metrics
        m.gauge("control.rate_floor").set(f)
        m.gauge("control.degraded").set(1.0 if f > 0.0 else 0.0)

    def _on_control(self, now: float) -> None:
        cutoff = now - self.fps_window
        self._arrival_times[:] = [t for t in self._arrival_times
                                  if t >= cutoff]
        if self._arrival_times:
            self.session.report_ingress_fps(
                len(self._arrival_times) / self.fps_window)
        if self.resilience is not None:
            self._update_degraded(now)
        snap = self.session.tick()
        snap["t"] = now
        snap["proc_q"] = self.session.expected_proc()
        snap["queue_depth"] = self._observe_queue_depth()
        self._trace.append(snap)
        m = self.metrics
        m.gauge("control.target_drop_rate").set(snap["target_drop_rate"])
        th = snap["threshold"]
        if np.isfinite(th):
            m.gauge("control.threshold").set(th)
        pending = (self.coalescer.count > 0
                   or self.sender.free < self.sender.tokens
                   or self.sender.pending_retries > 0
                   or any(k != EVT_CTRL for _, k, _, _ in self._heap))
        if pending:
            self._push(now + self.control_period, EVT_CTRL, None)
        else:
            self._ctrl_scheduled = False

    def _observe_queue_depth(self) -> int:
        depths = getattr(self.session, "queue_depths", None)
        depth = (int(np.sum(depths())) if depths is not None
                 else len(self.session))
        self.metrics.gauge("queue.depth").set(depth)
        self.metrics.histogram("queue.depth").observe(depth)
        return depth

    # -- the runtime ---------------------------------------------------------

    def reset(self) -> None:
        """Clear per-run state so ``submit``/``drain``/``finalize`` can
        start a fresh run (``run`` calls this for you)."""
        self._heap = []
        self._seq = itertools.count()
        self._arrival_times = []
        self._offered = []
        self._processed = []
        self._trace = []
        self._epoch = 0
        self._stopped = False
        self._t_start = None
        self._ctrl_scheduled = False
        self._pending_wake = None
        self._degraded_time = 0.0
        self._stats0 = (self.session.stats.offered,
                        self.session.stats.dropped_admission,
                        self.session.stats.dropped_queue,
                        self.session.stats.sent,
                        getattr(self.session.stats, "dropped_cascade", 0))

    def submit(self, arrival: Arrival) -> None:
        """Enqueue one arrival into the (possibly running) event loop.

        Thread-safe: capture loops call this from foreign threads while
        ``drain(wait=True)`` runs the loop; the runtime transfers
        submissions onto the event heap between events. Before a drain
        starts, submissions simply stage the run's arrival list."""
        self._ingress.put(arrival)

    def stop(self) -> None:
        """Make a ``drain(wait=True)`` return once the heap empties
        instead of blocking for more submissions."""
        self._stopped = True

    def _transfer_ingress(self) -> None:
        while True:
            try:
                a = self._ingress.get_nowait()
            except _queue.Empty:
                return
            self._push(a.t, EVT_ARRIVE, a)

    def drain(self, *, wait: bool = False, poll: float = 0.05) -> None:
        """Run the event loop until the heap and ingress queue empty.

        ``wait=True`` keeps the loop alive when idle, blocking up to
        ``poll`` seconds at a time for live submissions until ``stop()``
        is called — the wall-clock serving mode."""
        self._transfer_ingress()
        while True:
            if not self._heap:
                if wait and not self._stopped:
                    try:
                        a = self._ingress.get(timeout=poll)
                    except _queue.Empty:
                        continue
                    self._push(a.t, EVT_ARRIVE, a)
                    self._transfer_ingress()
                    continue
                self._transfer_ingress()
                if not self._heap:
                    return
            t, kind, _, payload = heapq.heappop(self._heap)
            if self._t_start is None:
                # first event of the run: anchor the clock and schedule
                # the control chain (exactly the pre-refactor ordering —
                # the CTRL push follows every staged arrival push)
                self._t_start = t
                self.clock.sleep_until(t)
                self._push(t + self.control_period, EVT_CTRL, None)
                self._ctrl_scheduled = True
            self.clock.sleep_until(t)
            now = self.clock.now()
            if kind == EVT_ARRIVE:
                self._on_arrive(now, payload)
            elif kind == EVT_DONE:
                self._on_done(now, payload)
            elif kind == EVT_FLUSH:
                if payload == self._epoch:
                    self._flush(now)
            elif kind == EVT_CTRL:
                self._on_control(now)
            else:                       # EVT_WAKE
                self._pending_wake = None
                self._pump(now)
            self._transfer_ingress()

    def run(self, arrivals: Iterable[Arrival]) -> ServiceResult:
        """Replay a prepared arrival list: reset + submit + drain +
        finalize (the live push API is the same loop fed by foreign
        threads)."""
        self.reset()
        for a in arrivals:
            self.submit(a)
        self.drain()
        return self.finalize()

    def finalize(self) -> ServiceResult:
        if self._t_start is None:       # nothing ever arrived
            return ServiceResult([], [], [], 0, self.metrics.snapshot(), [])
        processed_ids = {id(p.record) for p in self._processed}
        kept_mask = [id(r) in processed_ids for r in self._offered]
        lb = self.session.latency_bound
        violations = sum(1 for p in self._processed if p.e2e > lb)
        m = self.metrics
        elapsed = max(self.clock.now() - self._t_start, 1e-9)
        n_off = len(self._offered)
        n_proc = len(self._processed)
        st = self.session.stats
        m.derived.update({
            "elapsed_s": elapsed,
            "ingest_fps": m.counter("ingest.arrivals").value / elapsed,
            "offered": n_off,
            "processed": n_proc,
            "shed_rate": 1.0 - n_proc / max(1, n_off),
            "shed_admission_rate":
                (st.dropped_admission - self._stats0[1]) / max(1, n_off),
            "shed_cascade_rate":
                (getattr(st, "dropped_cascade", 0) - self._stats0[4])
                / max(1, n_off),
            "violation_rate": violations / max(1, n_proc),
            "backend_utilization":
                m.counter("backend.busy_s").value / (elapsed * self.tokens),
        })
        if self.resilience is not None:
            m.derived["degraded_time_fraction"] = (
                self._degraded_time / elapsed)
            m.derived["transport_shed"] = (
                m.counter("sender.transport_shed").value)
        return ServiceResult(self._processed, self._offered, kept_mask,
                             violations, m.snapshot(), self._trace)


__all__ = ["Arrival", "CoalescedBatch", "IngestCoalescer", "ServeService",
           "ServiceResult", "ServedFrame", "arrivals_from_records",
           "EVT_ARRIVE", "EVT_DONE", "EVT_FLUSH", "EVT_CTRL", "EVT_WAKE"]

"""Backpressured transport: the sender worker and pluggable backends.

The paper's transmission control (§IV-D): admitted frames wait in the
session's bounded utility-ordered queues (the *send queue* — eviction
under overload IS the backpressure), and a sender drains ``next_frame``
one frame per free backend token. Each send produces a **measured**
per-frame latency that the service feeds back through
``report_backend_latency`` — the Eq. 17–20 control loop then runs on
real numbers, not the simulator's synthetic draws.

Backends implement ``process(item) -> latency_seconds``:

``MockBackend``
    Simulates the paper's filter-vs-DNN split (cheap exit for frames
    without a large target blob) with seeded jitter; it does *not*
    sleep — the returned latency is the simulated duration, and the
    service runtime realizes it as a completion event (virtual clock:
    instantly; wall clock: by waiting). Fully deterministic per seed.

``CallableBackend``
    Adapts a plain ``item -> latency`` callable — e.g. a model forward
    that blocks for real and returns its measured wall time.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, List, Optional, Protocol, Tuple, \
    runtime_checkable

import numpy as np

from repro_torch.core.control import LatencyInputs
from repro_torch.serve.fault import (
    BackendTimeout,
    BackendUnavailable,
    BreakerConfig,
    CircuitBreaker,
    CLOSED,
    OPEN,
    RetryPolicy,
)
from repro_torch.serve.metrics import MetricsRegistry

MIN_LATENCY = 1e-6
# token occupancy of a failure that surfaced with no timing information
# (an exception without ``fail_after`` and no send deadline configured)
FAIL_FAST_LATENCY = 1e-3


@runtime_checkable
class Backend(Protocol):
    """One backend slot: process a frame, return its latency (seconds).

    Non-blocking backends return a *simulated* duration; blocking
    backends do the work inline and return the *measured* duration.
    Either way the service schedules completion at ``t_sent + latency``
    (for a blocking backend that instant has already passed, so the
    completion fires immediately).
    """

    def process(self, item: Any) -> float: ...


class MockBackend:
    """Configurable-latency mock of the Backend Query Executor."""

    def __init__(self, filter_latency: float = 0.004,
                 dnn_latency: float = 0.150, jitter: float = 0.05,
                 seed: int = 0,
                 rng: Optional[np.random.Generator] = None) -> None:
        self.filter_latency = float(filter_latency)
        self.dnn_latency = float(dnn_latency)
        self.jitter = float(jitter)
        self.rng = rng if rng is not None else np.random.default_rng(seed)

    def process(self, item: Any) -> float:
        busy = bool(getattr(item, "busy", True))
        base = self.dnn_latency if busy else self.filter_latency
        noise = (self.jitter * self.rng.standard_normal()
                 if self.jitter else 0.0)
        return max(base * (1.0 + noise), MIN_LATENCY)


class CallableBackend:
    """Wrap an ``item -> latency_seconds`` callable as a Backend."""

    def __init__(self, fn: Callable[[Any], float]) -> None:
        self.fn = fn

    def process(self, item: Any) -> float:
        return max(float(self.fn(item)), MIN_LATENCY)


def as_backend(b: Any) -> Backend:
    if isinstance(b, Backend):
        return b
    if callable(b):
        return CallableBackend(b)
    raise TypeError(f"not a backend: {b!r}")


@dataclass(frozen=True)
class SendOutcome:
    """One frame handed to the backend this pump.

    ``ok=False`` marks a failed send: ``error`` is the failure kind
    ("timeout" / "unavailable" / "error"), ``latency`` is how long the
    send occupied its token before failing, and ``attempts`` counts
    *prior* attempts for this frame (0 on the first send). The runtime
    must hand failed outcomes back through ``SenderWorker.complete`` so
    the frame's fate (retry or transport shed) is recorded.
    """
    item: Any
    t_sent: float
    latency: float     # measured (blocking) or simulated (mock) seconds
    t_done: float      # t_sent + net_ls_q + latency
    ok: bool = True
    error: Optional[str] = None
    attempts: int = 0


class SenderWorker:
    """Drains the session's send queue toward the backend, one frame per
    free token (the paper's token backpressure).

    ``pump(now)`` pops best-first while tokens are free, sheds frames
    that can no longer meet the E2E bound (Eq. 20 intent — don't burn a
    token on a frame that already missed), runs the backend, and
    returns the batch of :class:`SendOutcome`s for the runtime to
    realize as completion events. ``complete()`` returns a token when a
    completion fires. Mirrors ``PipelineSimulator``'s send loop
    bookkeeping exactly (expired pops revert the ``sent`` count and
    count as queue drops) so service and simulator stats compare 1:1.

    Failure semantics (all opt-in, defaults preserve the happy-path
    behavior exactly): a ``send_deadline`` turns over-deadline simulated
    latencies into timeouts; a ``RetryPolicy`` re-queues failed frames
    with exponential backoff + jitter; a ``CircuitBreaker`` (or
    ``BreakerConfig``) stops sending to a dead backend and probes it
    half-open. Whatever is configured, a raising backend can never leak
    a token: ``pump`` converts any exception into a failed
    :class:`SendOutcome` whose completion returns the token through
    ``complete``. A frame whose retry budget or deadline is exhausted
    is *shed at the transport* with the same bookkeeping as an at-pop
    expiry (queue drop + ``sent`` revert), so QoR accounting stays
    exact under faults.
    """

    def __init__(self, session: Any, backend: Any, *, tokens: int = 1,
                 latency_inputs: Optional[LatencyInputs] = None,
                 expire_in_queue: bool = True,
                 metrics: Optional[MetricsRegistry] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Any = None,
                 send_deadline: Optional[float] = None) -> None:
        if tokens < 1:
            raise ValueError("tokens must be >= 1")
        self.session = session
        self.backend = as_backend(backend)
        self.tokens = int(tokens)
        self.free = int(tokens)
        self.li = latency_inputs or getattr(
            session, "latency_inputs", None) or LatencyInputs()
        self.expire_in_queue = bool(expire_in_queue)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.retry = retry
        if isinstance(breaker, BreakerConfig):
            breaker = CircuitBreaker(breaker, metrics=self.metrics)
        self.breaker: Optional[CircuitBreaker] = breaker
        self.send_deadline = (None if send_deadline is None
                              else float(send_deadline))
        self._rng = (np.random.default_rng(retry.seed)
                     if retry is not None else None)
        # frames awaiting a retry slot: (ready_at, tiebreak, item, attempts)
        self._retry_q: List[Tuple[float, int, Any, int]] = []
        self._retry_seq = itertools.count()
        # frames already popped by a batched refill, awaiting a token
        # this same pump (a refill fetches at most ``free`` frames and
        # every fetched frame consumes a pending slot before the loop
        # can exit, so the deque is empty between pumps)
        self._pending: Deque[Any] = deque()

    @property
    def pending_retries(self) -> int:
        return len(self._retry_q)

    def _expired(self, item: Any, now: float) -> bool:
        t_gen = getattr(item, "t_gen", None)
        if not self.expire_in_queue or t_gen is None:
            return False
        exp_done = now + self.li.net_ls_q + self.session.expected_proc()
        return exp_done - t_gen > self.session.latency_bound

    def _shed(self, counter: str) -> None:
        # same bookkeeping as the at-pop expiry below: the frame left
        # the queue via next_frame (sent += 1) but was never delivered
        self.session.stats.dropped_queue += 1
        self.session.stats.sent -= 1
        self.metrics.counter(counter).inc()

    def _queue_depth(self) -> int:
        sess = self.session
        if hasattr(type(sess), "__len__"):
            return len(sess)
        q = getattr(sess, "queue", None)      # bare LoadShedder surface
        return len(q) if q is not None else 0

    def _next_item(self, now: float,
                   want: int = 1) -> Tuple[Optional[Any], int]:
        """The next frame to send: a ready retry first (exactly the
        sequential loop's priority), else the pending batch, refilled
        with ONE ``next_frames(want)`` pop when the session supports
        batched transmission control (``want=1`` falls back to
        ``next_frame``, as do bare LoadShedder-like sessions)."""
        if self._retry_q and self._retry_q[0][0] <= now:
            _, _, item, attempts = heapq.heappop(self._retry_q)
            return item, attempts
        if not self._pending:
            nf = getattr(self.session, "next_frames", None)
            if nf is not None and want > 1:
                self._pending.extend(nf(want))
            else:
                item = self.session.next_frame()
                if item is not None:
                    self._pending.append(item)
        if self._pending:
            return self._pending.popleft(), 0
        return None, 0

    def pump(self, now: float) -> List[SendOutcome]:
        out: List[SendOutcome] = []
        m = self.metrics
        observe_time = getattr(self.backend, "observe_time", None)
        while self.free > 0:
            if self.breaker is not None and not self.breaker.can_send(now):
                break
            # refill all free tokens in one batched pop — but only when
            # the breaker (if any) is CLOSED; half-open probes send one
            # frame at a time by design
            batch = self.breaker is None or self.breaker.state == CLOSED
            item, attempts = self._next_item(now,
                                             self.free if batch else 1)
            if item is None:
                break
            if self._expired(item, now):
                # already doomed: a queue shed, not a send
                self._shed("sender.expired")
                continue
            if self.breaker is not None:
                self.breaker.on_send(now)
            if observe_time is not None:
                observe_time(now)
            self.free -= 1
            try:
                lat = max(float(self.backend.process(item)), MIN_LATENCY)
                if (self.send_deadline is not None
                        and lat > self.send_deadline):
                    raise BackendTimeout(
                        f"simulated latency {lat:.3f}s exceeds the "
                        f"{self.send_deadline:.3f}s send deadline",
                        fail_after=self.send_deadline)
            except Exception as e:  # noqa: BLE001 — any failure must
                # surface as a completion that returns the token
                elapsed = getattr(e, "fail_after", None)
                if elapsed is None:
                    elapsed = (self.send_deadline
                               if self.send_deadline is not None
                               else FAIL_FAST_LATENCY)
                kind = ("timeout" if isinstance(e, BackendTimeout)
                        else "unavailable"
                        if isinstance(e, BackendUnavailable) else "error")
                m.counter("sender.failures").inc()
                m.counter(f"sender.fail.{kind}").inc()
                out.append(SendOutcome(item, now, float(elapsed),
                                       now + float(elapsed), ok=False,
                                       error=kind, attempts=attempts))
                continue
            t_done = now + self.li.net_ls_q + lat
            out.append(SendOutcome(item, now, lat, t_done,
                                   attempts=attempts))
            m.counter("sender.sent").inc()
            m.counter("backend.busy_s").inc(lat)
            m.histogram("backend.latency_s").observe(lat)
        return out

    def complete(self, outcome: Optional[SendOutcome] = None,
                 now: Optional[float] = None) -> Optional[float]:
        """Return the token of one completed send.

        For a failed outcome, also record the frame's fate: schedule a
        retry (the retry-ready time is returned so the runtime can wake
        then) or shed it at the transport (returns None). Successful or
        legacy no-arg completions return None.
        """
        self.free += 1
        if self.free > self.tokens:
            raise RuntimeError("more completions than sends")
        if outcome is None:
            return None
        t = outcome.t_done if now is None else float(now)
        if outcome.ok:
            if self.breaker is not None:
                self.breaker.on_success(t)
            return None
        if self.breaker is not None:
            self.breaker.on_failure(t)
        if (self.retry is not None
                and outcome.attempts < self.retry.max_retries
                and not self._expired(outcome.item, t)):
            ready = t + self.retry.backoff(outcome.attempts, self._rng)
            heapq.heappush(self._retry_q, (ready, next(self._retry_seq),
                                           outcome.item,
                                           outcome.attempts + 1))
            self.metrics.counter("sender.retries").inc()
            return ready
        self._shed("sender.transport_shed")
        return None

    def next_wakeup(self, now: float) -> Optional[float]:
        """When the runtime should pump again absent other events:
        the breaker's probe window while OPEN with work waiting, or the
        earliest pending retry. None when a completion will re-pump
        anyway (no free token / probe in flight) or nothing waits."""
        if self.free <= 0:
            return None
        br = self.breaker
        if br is not None:
            if br.state == OPEN:
                if self._retry_q or self._queue_depth() > 0:
                    return br.open_until
                return None
            if br.probe_inflight:
                return None
        if self._retry_q:
            return max(self._retry_q[0][0], now)
        return None


__all__ = ["Backend", "CallableBackend", "MockBackend", "SendOutcome",
           "SenderWorker", "as_backend", "FAIL_FAST_LATENCY", "MIN_LATENCY"]

"""Failure semantics for the transport: fault injection, retries,
and the circuit breaker.

The ``Backend`` protocol's happy path is ``process(item) -> latency``;
real backends also time out, throw transient errors, spike, and go
dark. This module gives the serve plane a *deterministic* model of all
four so resilience is testable:

``FaultyBackend``
    Seeded fault-injecting wrapper around any backend. Each ``process``
    call draws a fixed number of uniforms (so fault *rates* don't
    perturb the draw sequence) and may raise ``BackendTimeout`` /
    ``BackendError``, multiply the inner latency by a spike factor, or
    — inside a configured outage window — raise
    ``BackendUnavailable``. Outage windows are keyed on *service time*:
    the sender calls ``observe_time(now)`` before each send, so a
    virtual-clock run reproduces the same outage hits every repeat.

``RetryPolicy``
    Bounded exponential backoff with multiplicative jitter. The delay
    for attempt ``a`` is ``min(base * factor**a, max) * (1 + jitter*u)``
    with ``u ~ U[0, 1)`` from the sender's seeded rng — never below the
    deterministic schedule, never above ``(1 + jitter) * backoff_max``.

``CircuitBreaker``
    CLOSED -> OPEN after ``failure_threshold`` consecutive failures;
    OPEN -> HALF_OPEN once ``reset_timeout`` has elapsed (a single
    probe send is allowed); the probe's outcome closes or re-opens the
    breaker. While OPEN, the sender stops burning tokens/retries on a
    dead backend — frames wait in the bounded session queue (whose
    eviction IS the backpressure) until the next probe window.

``ResilienceConfig`` bundles retry + breaker + per-send deadline +
degraded-mode knobs for ``ServeService(resilience=...)``. Degraded
mode (``DegradedConfig``) is the control-plane half: when the breaker
is not CLOSED or the measured backend latency blows the E2E budget,
the service ramps a *rate floor* under the Eq. 19 target drop rates —
sheding toward the drop rate implied by zero effective capacity — and
ramps it back down smoothly once half-open probes succeed. ``max_drop``
stays below 1.0 so a trickle of frames still queues for the probes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

import numpy as np


class BackendError(Exception):
    """A transient backend failure.

    ``fail_after`` is how long the send occupied its token before the
    failure surfaced (seconds); the sender uses it to time the failure
    completion event. ``None`` means "immediately" (the sender
    substitutes its deadline or a small default).
    """

    def __init__(self, msg: str = "backend error",
                 fail_after: Optional[float] = None) -> None:
        super().__init__(msg)
        self.fail_after = fail_after


class BackendTimeout(BackendError):
    """The send exceeded its deadline (injected, or a simulated latency
    past the sender's ``send_deadline``)."""


class BackendUnavailable(BackendError):
    """The backend is hard-down (outage window / connection refused)."""


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff + multiplicative jitter."""
    max_retries: int = 3
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    backoff_max: float = 2.0
    jitter: float = 0.1
    seed: int = 0

    def backoff(self, attempt: int,
                rng: Optional[np.random.Generator] = None) -> float:
        d = min(self.backoff_base * self.backoff_factor ** attempt,
                self.backoff_max)
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * float(rng.random())
        return d


CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclass(frozen=True)
class BreakerConfig:
    failure_threshold: int = 3       # consecutive failures to trip
    reset_timeout: float = 1.0       # seconds OPEN before a probe


class CircuitBreaker:
    """Half-open circuit breaker over the backend link.

    The sender asks ``can_send(now)`` before popping a frame (this is
    where OPEN lapses into HALF_OPEN), marks the probe with
    ``on_send(now)``, and reports each completion via ``on_success`` /
    ``on_failure``. State transitions land in the metrics registry's
    ``breaker.state`` state-gauge when one is attached.
    """

    def __init__(self, config: Optional[BreakerConfig] = None,
                 metrics: Any = None) -> None:
        self.config = config if config is not None else BreakerConfig()
        self.state = CLOSED
        self.failures = 0
        self.open_until = 0.0
        self.probe_inflight = False
        self.metrics = metrics
        if metrics is not None:
            metrics.state_gauge("breaker.state").set(CLOSED, count=False)

    def _transition(self, state: str, now: float) -> None:
        self.state = state
        if self.metrics is not None:
            self.metrics.state_gauge("breaker.state").set(state)

    def can_send(self, now: float) -> bool:
        if self.state == OPEN and now >= self.open_until:
            self.probe_inflight = False
            self._transition(HALF_OPEN, now)
        if self.state == CLOSED:
            return True
        return self.state == HALF_OPEN and not self.probe_inflight

    def on_send(self, now: float) -> None:
        if self.state == HALF_OPEN:
            self.probe_inflight = True

    def on_success(self, now: float) -> None:
        self.failures = 0
        if self.state == HALF_OPEN:
            self.probe_inflight = False
            self._transition(CLOSED, now)

    def on_failure(self, now: float) -> None:
        self.failures += 1
        if self.state == HALF_OPEN:
            self.probe_inflight = False
            self._open(now)
        elif (self.state == CLOSED
              and self.failures >= self.config.failure_threshold):
            self._open(now)

    def _open(self, now: float) -> None:
        self.open_until = now + self.config.reset_timeout
        self._transition(OPEN, now)


@dataclass(frozen=True)
class DegradedConfig:
    """Degraded-regime knobs for the service's control loop.

    ``max_drop`` is the rate floor the service ramps toward while
    unhealthy — deliberately < 1.0 so a trickle of frames still queues
    to feed half-open probes. ``ramp_up``/``ramp_down`` are the EWMA
    steps toward/away from the target (asymmetric like the latency
    EWMA: degrade fast, recover smoothly — no oscillation). A floor
    that decays below ``snap_eps`` snaps to exactly 0.0, restoring the
    bit-identical healthy path. ``on_latency`` also engages the regime
    when the measured backend latency alone blows
    ``latency_factor * latency_bound``.
    """
    max_drop: float = 0.95
    ramp_up: float = 0.5
    ramp_down: float = 0.3
    snap_eps: float = 1e-3
    on_latency: bool = True
    latency_factor: float = 1.0


@dataclass(frozen=True)
class ResilienceConfig:
    """Everything ``ServeService(resilience=...)`` switches on: sender
    retries + breaker + per-send deadline, and degraded-mode control.
    Any component set to ``None`` is disabled."""
    retry: Optional[RetryPolicy] = field(default_factory=RetryPolicy)
    breaker: Optional[BreakerConfig] = field(default_factory=BreakerConfig)
    send_deadline: Optional[float] = None
    degraded: DegradedConfig = field(default_factory=DegradedConfig)


class FaultyBackend:
    """Deterministic (seeded) fault-injecting wrapper around a backend.

    Per ``process`` call, in order: an outage-window check (service
    time inside any ``(start, duration)`` window raises
    ``BackendUnavailable``), then three uniform draws gating a
    transient ``BackendError``, an injected ``BackendTimeout``, and a
    latency spike (``inner latency * spike_factor``). Exactly three
    uniforms are drawn per non-outage call whatever the rates, so
    enabling one fault type never perturbs when the others fire.
    """

    def __init__(self, inner: Any, *, seed: int = 0,
                 error_rate: float = 0.0,
                 timeout_rate: float = 0.0,
                 spike_rate: float = 0.0,
                 spike_factor: float = 10.0,
                 error_latency: float = 0.002,
                 outages: Sequence[Tuple[float, float]] = ()) -> None:
        from repro_torch.serve.transport import as_backend
        self.inner = as_backend(inner)
        self.rng = np.random.default_rng(seed)
        self.error_rate = float(error_rate)
        self.timeout_rate = float(timeout_rate)
        self.spike_rate = float(spike_rate)
        self.spike_factor = float(spike_factor)
        self.error_latency = float(error_latency)
        self.outages = tuple((float(s), float(d)) for s, d in outages)
        self._now: Optional[float] = None

    def observe_time(self, now: float) -> None:
        """Service-time feed — the sender calls this before each send
        so outage windows key on deterministic event time, not wall
        time."""
        self._now = float(now)

    def in_outage(self, now: Optional[float] = None) -> bool:
        t = self._now if now is None else float(now)
        if t is None:
            return False
        return any(s <= t < s + d for s, d in self.outages)

    def process(self, item: Any) -> float:
        if self.in_outage():
            raise BackendUnavailable(
                f"backend outage at t={self._now:.3f}",
                fail_after=self.error_latency)
        u_err, u_to, u_spike = self.rng.random(3)
        if u_err < self.error_rate:
            raise BackendError("injected transient error",
                               fail_after=self.error_latency)
        if u_to < self.timeout_rate:
            raise BackendTimeout("injected timeout")
        lat = float(self.inner.process(item))
        if u_spike < self.spike_rate:
            lat *= self.spike_factor
        return lat


__all__ = [
    "BackendError", "BackendTimeout", "BackendUnavailable", "BreakerConfig",
    "CLOSED", "CircuitBreaker", "DegradedConfig", "FaultyBackend",
    "HALF_OPEN", "OPEN", "ResilienceConfig", "RetryPolicy",
]

"""Injectable clocks for the streaming serve service.

The service runtime (``repro_torch.serve.service``) never reads time
directly; every timestamp comes from a ``Clock``. Production uses
:class:`WallClock` (monotonic seconds, real ``time.sleep``); tests and
benchmarks use :class:`VirtualClock`, which makes ``sleep_until`` a
plain assignment — the whole service then runs as fast as the host can
process events while producing *identical* timestamps, admission
decisions and metrics on every run (the determinism contract tested in
``tests/test_service.py``).
"""
from __future__ import annotations

import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """Minimal time source: a monotonic ``now`` and a blocking wait."""

    def now(self) -> float: ...

    def sleep_until(self, t: float) -> None: ...


class WallClock:
    """Real time (the production default). ``now`` is monotonic seconds
    since the clock was created, so service timestamps start near 0 and
    line up with trace/replay timestamps."""

    def __init__(self) -> None:
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def sleep_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


class VirtualClock:
    """Discrete-event time: ``sleep_until`` jumps the clock forward.

    Time never moves backwards — sleeping until a past instant is a
    no-op (exactly how the wall clock behaves), so event handlers may
    schedule work "now" without care.
    """

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def sleep_until(self, t: float) -> None:
        if t > self._now:
            self._now = float(t)

    def advance(self, dt: float) -> float:
        """Manually move time forward ``dt`` seconds; returns ``now``."""
        if dt < 0:
            raise ValueError("time cannot move backwards")
        self._now += float(dt)
        return self._now


__all__ = ["Clock", "VirtualClock", "WallClock"]

"""Per-stage observability: the streaming serve service's metrics and
the shed session's spans and counters.

A small metrics registry: named ``Counter`` / ``Gauge`` / ``Histogram``
instruments that the service's stages (coalescer, session, send queue,
sender, backend) update inline, plus snapshot/export. Everything is
deterministic — histograms keep exact samples up to a bound (no
randomized reservoir), so a seeded virtual-clock service run produces
byte-identical snapshots across repeats.

Exports:
  * ``snapshot()``  — one nested dict (counters / gauges / histogram
    summaries / derived), JSON-ready;
  * ``to_json(path)`` / ``to_csv(path)`` — file exports (the CSV is
    flat ``name,kind,field,value`` rows for spreadsheet diffing);
  * ``report()``    — a human-readable final report.

Histogram summaries carry count/mean/min/max and p50/p95/p99 — the
end-to-end latency percentiles the paper's Eq. 16 latency bound is
judged against.

Spans: ``registry.span(name)`` is a context manager around a stretch of
host code. While ``registry.tracing`` is False (the default) it is one
shared no-op: no clock read, no profiler call. While it is True each span
is logged as ``Span(name, start_ns, end_ns, parent)`` on
``time.perf_counter_ns`` (``parent`` the name of the span open around
it, from a stack: one thread drives the spans of a registry), in a log
bounded like a histogram (the last ``SPAN_CAP`` spans), and, while a
profiler runs, is also a ``torch.profiler.record_function`` range, so it
lands in the trace beside the device's kernels and copies (the range is
opened only then: without a profiler it would only cost time).
``span_times`` gives each name's count, total and self time (the total
less what its child spans cover). ``snapshot()`` and the exports gain a
``spans`` section only once a span was logged, so a registry without
spans exports byte for byte as before.

The module imports nothing of the package, so every layer (the session
in ``core/`` as well as the service in ``serve/``) can hold a registry.
"""
from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import (Any, Deque, Dict, Iterable, List, NamedTuple, Optional,
                    Union)

import numpy as np
import torch

PCTS = (50.0, 95.0, 99.0)
SPAN_CAP = 100_000              # spans a registry's log retains

# the span's clock, and its profiler range with the test for a running
# profiler (module names, so a test can count the calls)
_clock = time.perf_counter_ns
_annotate = torch.profiler.record_function
_profiling = torch.autograd._profiler_enabled


class Counter:
    """Monotone accumulator (float increments allowed, e.g. busy-time)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def inc(self, n: Union[int, float] = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value, tracking the max ever seen."""

    __slots__ = ("name", "value", "max")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0
        self.max = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)
        if self.value > self.max:
            self.max = self.value


class StateGauge:
    """Categorical gauge: a current state string plus a per-state
    transition counter (how many times each state was *entered*) — the
    breaker's open/half-open/close churn in one instrument."""

    __slots__ = ("name", "value", "transitions")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = ""
        self.transitions: Dict[str, int] = {}

    def set(self, state: str, count: bool = True) -> None:
        state = str(state)
        if state != self.value and count:
            self.transitions[state] = self.transitions.get(state, 0) + 1
        self.value = state


class Histogram:
    """Exact-sample histogram with a bounded ring buffer.

    Up to ``cap`` samples are stored verbatim (percentiles are exact);
    past that, count/sum/min/max keep accumulating while the ring
    overwrites the oldest retained sample, so memory is bounded at
    ``cap`` floats no matter how long the run and percentiles cover the
    most recent ``cap`` observations — ``truncated`` plus ``window`` in
    the summary flag that sliding coverage. Deliberately *not* a
    randomized reservoir: determinism matters more here than whole-run
    tail fidelity on multi-hour runs.
    """

    __slots__ = ("name", "cap", "count", "total", "min", "max", "_vals",
                 "_pos")

    def __init__(self, name: str, cap: int = 100_000) -> None:
        self.name = name
        self.cap = int(cap)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._vals: List[float] = []
        self._pos = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._vals) < self.cap:
            self._vals.append(v)
        else:                       # ring-overwrite the oldest sample
            self._vals[self._pos] = v
            self._pos = (self._pos + 1) % self.cap

    def percentile(self, q: float) -> float:
        if not self._vals:
            return float("nan")
        return float(np.percentile(np.asarray(self._vals), q))

    def summary(self) -> Dict[str, Any]:
        if self.count == 0:
            return {"count": 0}
        out: Dict[str, Any] = {
            "count": self.count,
            "mean": self.total / self.count,
            "min": self.min,
            "max": self.max,
        }
        pv = np.percentile(np.asarray(self._vals), PCTS)
        for q, v in zip(PCTS, pv):
            out[f"p{q:g}"] = float(v)
        if self.count > len(self._vals):
            # percentiles cover the most recent `window` samples only
            out["truncated"] = True
            out["window"] = len(self._vals)
        return out


class Span(NamedTuple):
    """One logged span: ``perf_counter_ns`` bounds and the name of the
    span open around it (None at the top)."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]


class SpanTime(NamedTuple):
    """A span name's spans, summed: ``self_ns`` is ``total_ns`` less the
    time its child spans cover."""
    count: int
    total_ns: int
    self_ns: int


def span_times(spans: Iterable[Span]) -> Dict[str, SpanTime]:
    """Count, total and self time of each span name, sorted by name.
    Exact for every complete nesting (a name inside itself included);
    where the bounded log dropped a parent's oldest children, that
    parent's self time reads high."""
    count: Dict[str, int] = {}
    total: Dict[str, int] = {}
    child: Dict[str, int] = {}
    for s in spans:
        d = s.end_ns - s.start_ns
        count[s.name] = count.get(s.name, 0) + 1
        total[s.name] = total.get(s.name, 0) + d
        if s.parent is not None:
            child[s.parent] = child.get(s.parent, 0) + d
    return {n: SpanTime(count[n], total[n], total[n] - child.get(n, 0))
            for n in sorted(total)}


class _NoSpan:
    """The span while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("reg", "name", "parent", "rf", "t0")

    def __init__(self, reg: "MetricsRegistry", name: str) -> None:
        self.reg, self.name = reg, name

    def __enter__(self) -> None:
        stack = self.reg._stack
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.rf = _annotate(self.name) if _profiling() else None
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = _clock()

    def __exit__(self, *exc: Any) -> bool:
        t1 = _clock()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.reg._stack.pop()
        self.reg._spans.append(Span(self.name, self.t0, t1, self.parent))
        return False


class MetricsRegistry:
    """Get-or-create registry of named instruments + export surface, and
    the span log (on while ``tracing``)."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._states: Dict[str, StateGauge] = {}
        self.derived: Dict[str, Any] = {}
        self.tracing = False
        self._stack: List[str] = []
        self._spans: Deque[Span] = deque(maxlen=SPAN_CAP)

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, cap: int = 100_000) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name, cap)
        return h

    def state_gauge(self, name: str) -> StateGauge:
        s = self._states.get(name)
        if s is None:
            s = self._states[name] = StateGauge(name)
        return s

    # -- spans ---------------------------------------------------------------

    def span(self, name: str):
        """A context manager around the code it names: while ``tracing``
        logged, and annotated for a running profiler; else a no-op."""
        if not self.tracing:
            return _NO_SPAN
        return _OpenSpan(self, name)

    def spans(self) -> List[Span]:
        """The logged spans, oldest first (each logged as it ends, so a
        child comes before its parent)."""
        return list(self._spans)

    def clear_spans(self) -> None:
        self._spans.clear()

    # -- export --------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        snap = {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: {"value": g.value, "max": g.max}
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._hists.items())},
            "derived": dict(sorted(self.derived.items())),
        }
        if self._states:       # only present when a state gauge exists,
            # so pre-existing snapshots stay byte-identical
            snap["states"] = {
                k: {"value": s.value,
                    "transitions": dict(sorted(s.transitions.items()))}
                for k, s in sorted(self._states.items())}
        if self._spans:        # likewise only once a span was logged
            snap["spans"] = {
                k: {"count": t.count, "total_s": t.total_ns * 1e-9,
                    "self_s": t.self_ns * 1e-9}
                for k, t in span_times(self._spans).items()}
        return snap

    def to_json(self, path: Union[str, Path]) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.snapshot(), indent=2, sort_keys=True))
        return path

    def to_csv(self, path: Union[str, Path]) -> Path:
        """Flat ``name,kind,field,value`` rows (one row per scalar)."""
        rows = ["name,kind,field,value"]
        snap = self.snapshot()
        for k, v in snap["counters"].items():
            rows.append(f"{k},counter,value,{v!r}")
        for k, g in snap["gauges"].items():
            for f, v in g.items():
                rows.append(f"{k},gauge,{f},{v!r}")
        for k, h in snap["histograms"].items():
            for f, v in h.items():
                rows.append(f"{k},histogram,{f},{v!r}")
        for k, s in snap.get("states", {}).items():
            rows.append(f"{k},state,value,{s['value']}")
            for f, v in s["transitions"].items():
                rows.append(f"{k},state,enter_{f},{v!r}")
        for k, t in snap.get("spans", {}).items():
            for f, v in t.items():
                rows.append(f"{k},span,{f},{v!r}")
        for k, v in snap["derived"].items():
            rows.append(f"{k},derived,value,{v!r}")
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(rows) + "\n")
        return path

    def report(self, title: Optional[str] = None) -> str:
        """Human-readable final report (the launcher prints this)."""
        snap = self.snapshot()
        lines = [title or "service metrics", "-" * len(title or "service metrics")]
        if snap["derived"]:
            for k, v in snap["derived"].items():
                lines.append(f"{k:32s} {_fmt(v)}")
        for k, v in snap["counters"].items():
            lines.append(f"{k:32s} {_fmt(v)}")
        for k, g in snap["gauges"].items():
            lines.append(f"{k:32s} {_fmt(g['value'])} (max {_fmt(g['max'])})")
        for k, s in snap.get("states", {}).items():
            trans = " ".join(f"{f}x{v}" for f, v in s["transitions"].items())
            lines.append(f"{k:32s} {s['value']} ({trans})")
        for k, h in snap["histograms"].items():
            if h["count"] == 0:
                continue
            lines.append(
                f"{k:32s} n={h['count']} mean={_fmt(h['mean'])} "
                f"p50={_fmt(h['p50'])} p95={_fmt(h['p95'])} "
                f"p99={_fmt(h['p99'])} max={_fmt(h['max'])}")
        for k, t in snap.get("spans", {}).items():
            lines.append(f"{k:32s} n={t['count']} total={_fmt(t['total_s'])}s "
                         f"self={_fmt(t['self_s'])}s")
        return "\n".join(lines)


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "SPAN_CAP",
           "Span", "SpanTime", "StateGauge", "span_times"]

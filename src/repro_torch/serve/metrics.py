"""Per-stage observability for the streaming serve service.

A small, dependency-free metrics registry: named ``Counter`` /
``Gauge`` / ``Histogram`` instruments that the service's stages
(coalescer, session, send queue, sender, backend) update inline, plus
snapshot/export. Everything is deterministic — histograms keep exact
samples up to a bound (no randomized reservoir), so a seeded
virtual-clock service run produces byte-identical snapshots across
repeats.

Exports:
  * ``snapshot()``  — one nested dict (counters / gauges / histogram
    summaries / derived), JSON-ready;
  * ``to_json(path)`` / ``to_csv(path)`` — file exports (the CSV is
    flat ``name,kind,field,value`` rows for spreadsheet diffing);
  * ``report()``    — a human-readable final report.

Histogram summaries carry count/mean/min/max and p50/p95/p99 — the
end-to-end latency percentiles the paper's Eq. 16 latency bound is
judged against.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

PCTS = (50.0, 95.0, 99.0)


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


class MetricsRegistry:
    """Get-or-create registry of named instruments + export surface."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._states: Dict[str, StateGauge] = {}
        self.derived: Dict[str, Any] = {}

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
        return "\n".join(lines)


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "StateGauge"]

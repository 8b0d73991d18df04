#!/usr/bin/env python3
"""What the shed step's host does while the card waits, read from the
session's own spans and host-sync counter in a cell of ``shedbench``.

    python3 benchmarks_torch/shed_spans.py --workload shed_c128_t8 \\
        [--seed N] [--iters 200] [--out FILE]

Opens the cell's session on the card as ``shedbench/run.py`` does (the
cell's configuration, inputs made from ``--seed``, the closed loop of
``report_backend_latency`` -> ``step(frames)`` -> ``next_frames``),
warms it up, then runs:

1. ``--iters`` iterations with the session's tracing
   (``session.metrics.tracing``) on and off in turns (on, off, off, on,
   ...): the iteration's host-clock time each way, which is what the
   spans cost; a step's host syncs (the ``session.host_syncs`` counter);
   and, over the iterations with spans on, each span's total and self
   time a step (``sync_wait_ms`` is the summed ``shed.sync`` time,
   ``absorb_control_ms`` the self time of ``shed.absorb_control``);
2. a device stretch, tracing off, recording device activity alone: device
   operations and ``Memcpy DtoH`` copies a step, and the device's idle
   share;
3. two host stretches recording host operations too, tracing off and
   then on: the device's idle time a step by the innermost host event
   running in each gap (``shedharness.tracing.idle_by_host``, as the
   benchmark's traced run names it), so with spans on the gaps carry the
   program's span names; and in the second stretch the CUDA runtime
   calls' host time a step and each stream sync by the program span and
   the torch op it was made in.

Prints one JSON object and writes it to ``--out`` (default
``results/shed_spans_<workload>.json``). Exits non-zero without a card.

It uses only public names of ``shedharness``. Once the benchmark's traced
run reads the session's registry itself, this script repeats the harness
and is to be removed.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "shedbench"
WARMUP = 4
DEVICE_STEPS = 24
HOST_STEPS = 8


def _union(intervals):
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top(d, scale, n=24):
    return [[k, scale * v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _stream_syncs(events, step: str):
    """Each ``cudaStreamSynchronize`` of a host stretch by the innermost
    program span and the innermost torch op around it: [span, op, calls a
    step, ms a step], most time first."""
    def around(cats, e):
        best = None
        for h in events:
            if (h.get("cat") in cats and "dur" in h and h["name"] != step
                    and h["ts"] <= e["ts"]
                    and e["ts"] + e["dur"] <= h["ts"] + h["dur"]
                    and (best is None or h["ts"] >= best["ts"])):
                best = h
        return best["name"] if best else None

    by = {}
    for e in events:
        if e.get("name") == "cudaStreamSynchronize" and "dur" in e:
            key = (around(("user_annotation",), e), around(("cpu_op",), e))
            n, t = by.get(key, (0, 0.0))
            by[key] = (n + 1, t + e["dur"])
    return [[a, o, n / HOST_STEPS, 1e-3 * t / HOST_STEPS]
            for (a, o), (n, t) in sorted(by.items(), key=lambda kv: -kv[1][1])]


def _ms(values):
    return {"n": len(values), "mean": 1e3 * statistics.fmean(values),
            "median": 1e3 * statistics.median(values)}


def measure(spec, *, seed: int, iters: int, device) -> dict:
    """The three readings of the module's docstring for the cell ``spec``
    (a ``shedharness.spec.CellSpec``) on ``device``."""
    import torch

    from shedharness.inputs import make_inputs
    from shedharness.program import open_program
    from shedharness.tracing import (DEVICE_CATS, STEP, idle_by_host,
                                     read_events, start_profiler)

    from repro_torch.metrics import span_times

    cfg, traffic = spec.config, spec.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    C, T = traffic["cameras"], traffic["frames_per_step"]
    inputs = make_inputs(cfg, traffic, seed, dev)
    session = open_program(cfg, inputs, C, dev)
    reg = session.metrics
    syncs = reg.counter("session.host_syncs")
    lats = np.random.default_rng(seed).uniform(
        *traffic["backend_latency_s"], traffic["latency_draws"])
    k = 0

    def iteration():
        nonlocal k
        session.report_backend_latency(float(lats[k % lats.size]))
        ids = np.arange(C * T, dtype=np.int64).reshape(C, T) + k * C * T
        session.step(frames=inputs.pool[k % len(inputs.pool)],
                     tick=bool(traffic["tick"]), items=ids)
        session.next_frames(traffic["send_per_step"])
        k += 1

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    for _ in range(WARMUP):
        iteration()
    sync()

    # 1. spans on and off in turns
    times = {True: [], False: []}
    per_step = []
    reg.clear_spans()
    for j in range(iters):
        on = j % 4 in (0, 3)
        reg.tracing = on
        n0, t0 = syncs.value, time.perf_counter()
        iteration()
        times[on].append(time.perf_counter() - t0)
        per_step.append(syncs.value - n0)
    reg.tracing = False
    sync()
    n_on = len(times[True])
    span_ms = {n: {"total": t.total_ns * 1e-6 / n_on,
                   "self": t.self_ns * 1e-6 / n_on, "count": t.count / n_on}
               for n, t in span_times(reg.spans()).items()}
    reg.clear_spans()
    on, off = _ms(times[True]), _ms(times[False])

    # 2. the device stretch, tracing off
    prof = start_profiler(False)
    t0 = time.perf_counter()
    for _ in range(DEVICE_STEPS):
        iteration()
    sync()
    window_s = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    ops = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in
           read_events(prof) if e.get("cat") in DEVICE_CATS and "dur" in e]
    busy_s = sum(b - a for a, b in _union((a, b) for _, a, b in ops)) * 1e-6
    dtoh = {}
    for n, _, _ in ops:
        if n.startswith("Memcpy DtoH"):
            dtoh[n] = dtoh.get(n, 0) + 1 / DEVICE_STEPS

    # 3. the host stretches, tracing off and then on
    gaps = {}
    for tracing in (False, True):
        reg.tracing = tracing
        prof = start_profiler(True)
        for _ in range(HOST_STEPS):
            with torch.profiler.record_function(STEP):
                iteration()
        sync()
        prof.__exit__(None, None, None)
        reg.tracing = False
        events = read_events(prof)
        gaps["on" if tracing else "off"] = _top(idle_by_host(events), 1e3)
    # the CUDA runtime's calls in the last stretch: a call that blocks the
    # host shows as a long one; each stream sync by where it was made
    runtime = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "dur" in e:
            runtime[e["name"]] = runtime.get(e["name"], 0.0) + e["dur"]
    reg.clear_spans()

    def span(name, field):
        return span_ms.get(name, {}).get(field)

    return {
        "workload": spec.name, "seed": seed, "iters": iters,
        "host_syncs_per_step": statistics.fmean(per_step),
        "host_syncs_seen": sorted(set(per_step)),
        "sync_wait_ms": span("shed.sync", "total"),
        "absorb_control_ms": span("shed.absorb_control", "self"),
        "iter_ms_spans_on": on, "iter_ms_spans_off": off,
        "spans_cost_pct": {
            f: 100.0 * (on[f] / off[f] - 1.0) for f in ("mean", "median")},
        "spans_ms_a_step": span_ms,
        "device_stretch": {
            "steps": DEVICE_STEPS, "window_s": window_s, "busy_s": busy_s,
            "idle_share": 100.0 * (1.0 - busy_s / window_s),
            "ops_per_step": len(ops) / DEVICE_STEPS,
            "dtoh_per_step": sum(dtoh.values()), "dtoh_by_name": dtoh},
        "idle_gaps_ms_a_step": gaps,
        "cuda_runtime_ms_a_step": _top(runtime, 1e-3 / HOST_STEPS),
        "stream_syncs_a_step": _stream_syncs(events, STEP),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 33)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import torch

    from shedharness.spec import load_cell
    if not torch.cuda.is_available():
        print("shed_spans needs a CUDA card", file=sys.stderr)
        return 1
    out = measure(load_cell(ROOT, args.workload), seed=args.seed,
                  iters=args.iters, device="cuda")
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20).stdout.strip()
    path = Path(args.out or ROOT / "results" / f"shed_spans_{args.workload}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

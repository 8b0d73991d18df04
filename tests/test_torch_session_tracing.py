"""The shed session's spans and host-sync counter (``repro_torch.metrics``):
off, they cost no clock read and no profiler call; on, they are logged,
and under a running profiler annotated in its trace; they change no
decision, state leaf or statistic, nest as the step is built, and their
self times subtract their children; ``session.host_syncs`` counts one a
device read of the step path, and on the card every stream sync of a
step is one of them; a registry that logged no span exports exactly as
the reference's registry does."""
import collections
import copy
import dataclasses
import importlib.util
import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import metrics as tm
from repro_torch.cascade import Cascade, MLPScorer
from repro_torch.core import Query, open_session
from repro_torch.core.utility import train_utility_model
from repro_torch.data.synthetic import generate_scenario

ROOT = Path(__file__).resolve().parents[1]
C, T, H, W = 2, 4, 24, 32
STEPS = 4
KINDS = ("shed", "cascade")

# (name, parent) of the spans of one iteration: report, step(tick=True),
# next_frames
SHED_SPANS = collections.Counter({
    ("shed.report_latency", None): 1,
    ("shed.step", None): 1,
    ("shed.check_frames", "shed.step"): 1,
    ("shed.ingest", "shed.step"): 1,
    ("shed.sync", "shed.ingest"): 1,              # bg_valid
    ("shed.control", "shed.step"): 1,
    ("shed.absorb_control", "shed.step"): 1,
    ("shed.sync", "shed.absorb_control"): 6,      # its six outputs
    ("shed.next_frames", None): 1,
    ("shed.sync", "shed.next_frames"): 2,         # cams and seqs
})
CASCADE_SPANS = SHED_SPANS - collections.Counter(
    {("shed.control", "shed.step"): 1}) + collections.Counter({
        ("cascade.admit", "shed.step"): 1,
        ("cascade.survivors", "shed.step"): 1,
        ("shed.sync", "cascade.survivors"): 1,    # nonzero's count
        ("cascade.score", "shed.step"): 1,
        ("cascade.finish", "shed.step"): 1,
        ("shed.sync", "shed.step"): 1,            # the stage-2 scores
    })


def _frames():
    scs = [generate_scenario(s, num_frames=STEPS * T, height=H, width=W,
                             vehicle_rate=0.3) for s in range(C)]
    return np.stack([sc.frames_rgb() for sc in scs]).astype(np.float32)


FRAMES = _frames()


def _session(kind, device="cpu", **opts):
    rng = np.random.default_rng(4)
    q = Query.any_of("red", "yellow", latency_bound=1.0, fps=10.0)
    pfs = rng.dirichlet(np.ones(64), (40, 2)).reshape(40, 2, 8, 8)
    model = train_utility_model(pfs.astype(np.float32), rng.random(40) < 0.5,
                                q.colors, op="or")
    kw = {}
    if kind == "cascade":
        kw["cascade"] = Cascade(MLPScorer.init(2, roi_size=8, hidden=8,
                                               device=device), window=64)
    return open_session(q, C, device=device, model=model, frame_shape=(H, W),
                        queue_size=4, queue_capacity=12, **kw, **opts)


def _iteration(s, i, tick=True, frames=FRAMES):
    """The benchmark's closed loop: a latency report, a frames step,
    batched pops. Returns what the host got back."""
    s.report_backend_latency(0.05 + 0.02 * i)
    ids = np.arange(C * T).reshape(C, T) + i * C * T
    r = s.step(frames[:, i * T:(i + 1) * T], tick=tick, items=ids)
    return r, s.next_frames(3)


def _drive(s, steps=STEPS):
    return [_iteration(s, i) for i in range(steps)]


@pytest.mark.parametrize("kind", KINDS)
def test_spans_off_read_no_clock_and_call_no_profiler(kind, monkeypatch):
    calls = collections.Counter()
    clock, annotate = tm._clock, tm._annotate

    def counted_clock():
        calls["clock"] += 1
        return clock()

    def counted_annotate(name):
        calls["annotate"] += 1
        return annotate(name)

    monkeypatch.setattr(tm, "_clock", counted_clock)
    monkeypatch.setattr(tm, "_annotate", counted_annotate)
    s = _session(kind)
    assert s.metrics.tracing is False
    _drive(s, STEPS - 2)
    assert calls == {} and s.metrics.spans() == []
    assert "spans" not in s.metrics.snapshot()
    n = sum((CASCADE_SPANS if kind == "cascade" else SHED_SPANS).values())
    s.metrics.tracing = True
    _iteration(s, STEPS - 2)          # on, no profiler: logged alone
    assert len(s.metrics.spans()) == n
    assert calls == {"clock": 2 * n}
    s.metrics.clear_spans()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:                        # on, under a profiler: ranges too
        _iteration(s, STEPS - 1)
    assert calls == {"clock": 4 * n, "annotate": n}
    names = collections.Counter(
        e.name for e in prof.events() if e.name.startswith(("shed.",
                                                            "cascade.")))
    assert names == collections.Counter(x.name for x in s.metrics.spans())


def _same(a, b):
    for (ra, sa), (rb, sb) in zip(a, b):
        np.testing.assert_array_equal(ra.decisions, rb.decisions)
        np.testing.assert_array_equal(ra.pushed_seq, rb.pushed_seq)
        np.testing.assert_array_equal(ra.target_drop_rate,
                                      rb.target_drop_rate)
        if ra.s2_scores is None:
            assert rb.s2_scores is None
        else:
            np.testing.assert_array_equal(ra.s2_scores, rb.s2_scores)
        assert len(ra.evicted) == len(rb.evicted)
        for x, y in zip(ra.evicted, rb.evicted):
            np.testing.assert_array_equal(x, y)
        assert sa == sb


@pytest.mark.parametrize("kind", KINDS)
def test_spans_on_change_nothing(kind):
    off, on = _session(kind), _session(kind)
    on.metrics.tracing = True
    a, b = _drive(off), _drive(on)
    _same(a, b)
    assert on.metrics.spans() and not off.metrics.spans()
    da, db = off.state.as_dict(), on.state.as_dict()
    assert set(da) == set(db)
    for k in da:
        np.testing.assert_array_equal(db[k], da[k], err_msg=k)
    assert on.stats.__dict__ == off.stats.__dict__
    np.testing.assert_array_equal(on.queue_depths(), off.queue_depths())
    np.testing.assert_array_equal(on.per_camera_dropped,
                                  off.per_camera_dropped)
    assert sum(r.decisions.size for r, _ in b) == STEPS * C * T
    if kind == "cascade":
        assert on.stats.dropped_cascade + on.stats.dropped_admission > 0


@pytest.mark.parametrize("kind", KINDS)
def test_spans_nest_as_the_step_is_built(kind):
    s = _session(kind)
    _iteration(s, 0)
    s.metrics.tracing = True
    _iteration(s, 1)
    spans = s.metrics.spans()
    want = CASCADE_SPANS if kind == "cascade" else SHED_SPANS
    assert collections.Counter((x.name, x.parent) for x in spans) == want
    for x in spans:
        assert x.start_ns <= x.end_ns
        if x.parent is not None:      # inside an instance of its parent
            assert any(p.name == x.parent and p.start_ns <= x.start_ns
                       and x.end_ns <= p.end_ns for p in spans), x
    # logged as they end: the top-level spans in the order they ran
    assert [x.name for x in spans if x.parent is None] == [
        "shed.report_latency", "shed.step", "shed.next_frames"]
    times = tm.span_times(spans)
    step = times["shed.step"]
    kids = sum(x.end_ns - x.start_ns for x in spans
               if x.parent == "shed.step")
    assert step.count == 1 and step.self_ns == step.total_ns - kids
    assert times["shed.sync"].self_ns == times["shed.sync"].total_ns


def test_a_sharded_step_spans_its_one_launch_as_serve():
    """A camera-sharded session ingests and controls in one launch a
    shard: that is ``shed.serve``, and neither ``shed.ingest`` nor
    ``shed.control`` opens, so each name means the same work on both
    paths."""
    s = _session("shed", shard_cameras=True)
    assert s.mesh is not None and len(s.mesh.devices) == 1
    s.metrics.tracing = True
    _iteration(s, 0)
    got = collections.Counter((x.name, x.parent) for x in s.metrics.spans())
    # the fleet reads the shard's outputs inside ``shed.serve``, through
    # the session's counted read: bg_valid and the six outputs there, the
    # pop's one stacked candidate tensor a shard in ``shed.next_frames``
    want = SHED_SPANS - collections.Counter({
        ("shed.ingest", "shed.step"): 1, ("shed.control", "shed.step"): 1,
        ("shed.sync", "shed.ingest"): 1, ("shed.sync", "shed.absorb_control"): 6,
        ("shed.sync", "shed.next_frames"): 1}) + collections.Counter({
            ("shed.serve", "shed.step"): 1, ("shed.sync", "shed.serve"): 7})
    assert got == want
    assert s.metrics.counter("session.host_syncs").value == 8


def test_span_times_subtract_child_spans():
    S = tm.Span
    spans = [S("b", 10, 30, "a"), S("b", 40, 50, "a"), S("b", 70, 80, "c"),
             S("c", 60, 90, "a"), S("a", 0, 100, None),
             # a name inside itself: the outer keeps what the inner leaves
             S("r", 210, 230, "r"), S("r", 200, 260, None)]
    assert tm.span_times(spans) == {
        "a": tm.SpanTime(1, 100, 100 - 20 - 10 - 30),
        "b": tm.SpanTime(3, 40, 40),
        "c": tm.SpanTime(1, 30, 20),
        "r": tm.SpanTime(2, 80, 60),
    }
    assert list(tm.span_times(spans)) == ["a", "b", "c", "r"]


def test_registry_logs_nested_spans_on_its_clock(monkeypatch):
    ticks = iter(range(0, 1000, 10))
    monkeypatch.setattr(tm, "_clock", lambda: next(ticks))
    monkeypatch.setattr(tm, "SPAN_CAP", 3)
    reg = tm.MetricsRegistry()
    reg.tracing = True
    with reg.span("outer"):
        with reg.span("inner"):
            pass
        with reg.span("inner"):
            with reg.span("leaf"):
                pass
    assert reg.spans() == [                  # the cap keeps the last 3
        tm.Span("leaf", 40, 50, "inner"), tm.Span("inner", 30, 60, "outer"),
        tm.Span("outer", 0, 70, None)]
    with pytest.raises(KeyError):
        with reg.span("fails"):
            raise KeyError("x")
    assert reg.spans()[-1].name == "fails" and reg._stack == []
    reg.tracing = False
    with reg.span("off"):
        pass
    assert reg.spans()[-1].name == "fails"
    reg.clear_spans()
    assert reg.spans() == [] and "spans" not in reg.snapshot()


@pytest.mark.parametrize("kind", KINDS)
def test_host_syncs_count_one_a_device_read(kind):
    s = _session(kind)
    syncs = s.metrics.counter("session.host_syncs")
    per_step = {"shed": 7, "cascade": 9}[kind]   # see SHED_SPANS, CASCADE_SPANS

    def delta(fn):
        v = syncs.value
        fn()
        return syncs.value - v

    for tracing in (False, True):
        s.metrics.tracing = tracing
        i = 2 * tracing
        assert delta(lambda: s.report_backend_latency(0.05)) == 0
        batch = FRAMES[:, i * T:(i + 1) * T]
        assert delta(lambda: s.step(batch, tick=True)) == per_step
        assert delta(lambda: s.next_frames(3)) == 2
        batch = FRAMES[:, (i + 1) * T:(i + 2) * T]
        assert delta(lambda: s.step(batch, tick=False)) == per_step - 2
    names = [x.name for x in s.metrics.spans()]
    assert names.count("shed.sync") == 2 * per_step - 2 + 2


def _fill(reg):
    reg.counter("ingest.arrivals").inc(3)
    reg.counter("backend.busy_s").inc(0.25)
    reg.gauge("queue.depth").set(4)
    reg.gauge("queue.depth").set(2)
    for v in (0.1, 0.3, 0.2, 0.7):
        reg.histogram("e2e_latency").observe(v)
    reg.histogram("empty")
    reg.state_gauge("breaker.state").set("open")
    reg.state_gauge("breaker.state").set("closed")
    reg.derived["qor"] = 0.875
    return reg


def test_registry_without_spans_exports_as_the_reference(tmp_path):
    from repro.serve import metrics as jmetrics
    ref = _fill(jmetrics.MetricsRegistry())
    for tracing in (False, True):
        reg = _fill(tm.MetricsRegistry())
        reg.tracing = tracing        # on, but no span logged yet
        assert json.dumps(reg.snapshot()) == json.dumps(ref.snapshot())
        for ext in ("json", "csv"):
            a = getattr(reg, f"to_{ext}")(tmp_path / f"port.{ext}")
            b = getattr(ref, f"to_{ext}")(tmp_path / f"ref.{ext}")
            assert a.read_bytes() == b.read_bytes()
        assert reg.report("t") == ref.report("t")
    reg.tracing = True
    with reg.span("shed.step"):
        with reg.span("shed.sync"):
            pass
    snap = reg.snapshot()
    assert set(snap["spans"]) == {"shed.step", "shed.sync"}
    assert snap["spans"]["shed.step"]["count"] == 1
    assert (snap["spans"]["shed.step"]["self_s"]
            <= snap["spans"]["shed.step"]["total_s"])
    assert {k: v for k, v in snap.items() if k != "spans"} == ref.snapshot()
    csv = reg.to_csv(tmp_path / "spans.csv").read_text()
    assert "shed.sync,span,count,1\n" in csv
    assert "shed.step" in reg.report()


def test_registry_import_paths_and_its_module_stands_alone():
    import repro_torch.serve as tserve
    from repro_torch.serve import metrics as smetrics
    for name in ("Counter", "Gauge", "Histogram", "MetricsRegistry",
                 "StateGauge"):
        assert getattr(tserve, name) is getattr(tm, name)
        assert getattr(smetrics, name) is getattr(tm, name)
    code = ("import sys, repro_torch.metrics\n"
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['repro_torch', 'repro_torch.metrics']"


def test_the_session_owns_its_registry():
    s, other = _session("shed"), _session("shed")
    assert isinstance(s.metrics, tm.MetricsRegistry)
    assert other.metrics is not s.metrics
    _iteration(s, 0)
    assert s.metrics.snapshot()["counters"] == {"session.host_syncs": 9.0}
    assert other.metrics.snapshot()["counters"] == {"session.host_syncs": 0.0}
    from repro_torch.serve import ServeService, VirtualClock
    svc = ServeService(s, lambda frame: None, clock=VirtualClock())
    assert svc.metrics is not s.metrics
    assert "session.host_syncs" not in svc.metrics.snapshot()["counters"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_every_stream_sync_of_a_step_is_a_counted_read(kind):
    """On the card, with the frames on it as the benchmark keeps them,
    the synchronizing CUDA calls of an iteration are the reads that
    ``session.host_syncs`` counts, one for one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    frames = torch.as_tensor(FRAMES, device="cuda")
    s = _session(kind, "cuda")
    _iteration(s, 0, frames=frames)          # builds and warms the kernels
    torch.cuda.synchronize()
    syncs = s.metrics.counter("session.host_syncs")
    n0 = syncs.value
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _iteration(s, 1, frames=frames)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    warned = [w for w in caught if "synchroniz" in str(w.message)]
    assert syncs.value - n0 == {"shed": 9, "cascade": 11}[kind]
    assert len(warned) == syncs.value - n0, [
        f"{w.filename}:{w.lineno}" for w in warned]


def _shed_spans():
    sys.path[:0] = [str(ROOT / "shedbench")]
    path = ROOT / "benchmarks_torch" / "shed_spans.py"
    spec = importlib.util.spec_from_file_location("shed_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", ["shed_c128_t8", "cascade_c128_t8"])
def test_the_spans_script_reads_a_tiny_cell(cell, monkeypatch):
    """``benchmarks_torch/shed_spans.py``'s readings of a benchmark cell
    cut to a CPU test's size: the counter, the spans and their self
    times, and the device and host stretches."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    mod = _shed_spans()
    from shedharness.spec import load_cell
    spec = load_cell(ROOT, cell)
    cfg, tr = copy.deepcopy(spec.config), copy.deepcopy(spec.traffic)
    tr.update(cameras=2, frames_per_step=2, render=[12, 16], upsample=2,
              clip_frames=4)
    cfg["frame_shape"] = [24, 32]
    spec = dataclasses.replace(spec, config=cfg, traffic=tr)
    monkeypatch.setattr(mod, "DEVICE_STEPS", 2)
    monkeypatch.setattr(mod, "HOST_STEPS", 2)
    out = mod.measure(spec, seed=2**31 + 7, iters=8, device="cpu")
    assert out["host_syncs_seen"] == [out["host_syncs_per_step"]]
    assert out["host_syncs_per_step"] == {"shed_c128_t8": 9,
                                          "cascade_c128_t8": 11}[cell]
    assert out["sync_wait_ms"] > 0 and out["absorb_control_ms"] > 0
    spans = out["spans_ms_a_step"]
    assert spans["shed.step"]["count"] == 1
    assert spans["shed.sync"]["count"] == out["host_syncs_per_step"]
    assert spans["shed.step"]["self"] < spans["shed.step"]["total"]
    assert out["iter_ms_spans_on"]["n"] == out["iter_ms_spans_off"]["n"] == 4
    # no device here: each stretch is one gap, named by the host event at
    # its middle
    for k in ("off", "on"):
        assert len(out["idle_gaps_ms_a_step"][k]) == 1
    assert out["device_stretch"]["ops_per_step"] == 0

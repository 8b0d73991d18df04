"""The port's streaming service (``repro_torch.serve``) over the port's
session against the reference's service over its ``serve="host"``
session: identical utility arrivals must give the identical kept mask,
send/complete timeline, control trace and metrics snapshot — on the
zero-fault path and through an outage with retries, the circuit breaker
and the degraded-mode rate floor. On the port alone: raw frames through
the fused ``step(frames=...)`` dispatch keep exactly the frames that
their precomputed utilities keep through ``offer_batch``, and the
launcher runs end to end on the CPU."""
from __future__ import annotations

import json
from dataclasses import dataclass

import jax  # noqa: F401  (both packages in one process, as the tests run)
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.serve as tserve

FPS = 10.0


@dataclass(frozen=True)
class Rec:
    cam_id: int
    frame_idx: int
    t_gen: float
    busy: bool = False


def _arrivals(serve, C, n, seed=0):
    """n ticks of C synchronized cameras with seeded utilities; every
    fifth frame is busy (the mock backend's DNN stage)."""
    rng = np.random.default_rng(seed)
    return [serve.Arrival(t=i / FPS, cam=c, record=Rec(c, i, i / FPS,
                                                       busy=i % 5 == 0),
                          utility=float(rng.random()))
            for i in range(n) for c in range(C)]


def _sessions(C, seed=0, **kw):
    hist = np.random.default_rng(seed).random(512).astype(np.float32)
    q = dict(latency_bound=1.0, fps=FPS)
    j = jcore.open_session(jcore.Query.single("red", **q), C, serve="host",
                           train_utilities=hist, **kw)
    t = tcore.open_session(tcore.Query.single("red", **q), C, device="cpu",
                           train_utilities=hist, **kw)
    return j, t


def _timeline(res):
    return [(p.record.cam_id, p.record.frame_idx, p.t_sent, p.t_done,
             p.backend_latency) for p in res.processed]


def _run_both(C, n, backend, resilience=None, session_kw=None, **svc_kw):
    """``backend(serve)`` and ``resilience(serve)`` build fresh seeded
    objects from each package; returns (reference, port) results after
    holding them equal."""
    sj, st = _sessions(C, **(session_kw or {}))
    out = []
    for serve, sess in ((jserve, sj), (tserve, st)):
        kw = dict(clock=serve.VirtualClock(), max_batch=4, max_wait=0.05)
        kw.update(svc_kw)
        if resilience is not None:
            kw["resilience"] = resilience(serve)
        svc = serve.ServeService(sess, backend(serve), **kw)
        out.append((svc.run(_arrivals(serve, C, n)), sess))
    (rj, sj), (rt, st) = out
    assert rt.kept_mask == rj.kept_mask
    assert _timeline(rt) == _timeline(rj)
    assert json.dumps(rt.trace, sort_keys=True) == \
        json.dumps(rj.trace, sort_keys=True)
    assert json.dumps(rt.metrics, sort_keys=True) == \
        json.dumps(rj.metrics, sort_keys=True)
    assert st.stats.__dict__ == sj.stats.__dict__
    dj, dt = sj.state.as_dict(), st.state.as_dict()
    for leaf in ("threshold", "q_util", "q_seq", "queue_cap", "proc_q",
                 "fps_obs", "rate_floor", "cdf_buf", "cdf_counts"):
        np.testing.assert_array_equal(dt[leaf], dj[leaf], err_msg=leaf)
    return rj, rt


@pytest.mark.parametrize("C,per_camera_latency", [(1, False), (3, False),
                                                  (3, True)])
def test_zero_fault_service_matches_reference(C, per_camera_latency):
    _, rt = _run_both(C, 50, lambda s: s.MockBackend(seed=0),
                      per_camera_latency=per_camera_latency)
    c = rt.metrics["counters"]
    # one camera at 10 fps fills a 50 ms window with one frame: offer
    assert c["dispatch.batched" if C > 1 else "dispatch.sequential"] > 0
    assert "dispatch.fused" not in c


def test_zero_fault_resilience_matches_reference():
    """Resilience configured but no fault fires: the same as the
    reference, and the same as the plain service."""
    _, rt = _run_both(
        2, 60, lambda s: s.FaultyBackend(s.MockBackend(seed=0), seed=1),
        resilience=lambda s: s.ResilienceConfig())
    _, plain = _run_both(2, 60, lambda s: s.MockBackend(seed=0))
    assert rt.kept_mask == plain.kept_mask
    assert _timeline(rt) == _timeline(plain)
    assert rt.metrics["derived"]["degraded_time_fraction"] == 0.0


def test_outage_retry_breaker_and_floor_match_reference():
    """The reference's 10 %-of-runtime outage (test_fault.py): transport
    sheds, retries, a breaker that opens and re-closes and a degraded
    floor — every step identical on the port."""
    def backend(s):
        return s.FaultyBackend(
            s.MockBackend(filter_latency=0.08, dnn_latency=0.08, jitter=0.0),
            seed=0, outages=((2.0, 0.6),))

    def resilience(s):
        return s.ResilienceConfig(
            retry=s.RetryPolicy(max_retries=2, backoff_base=0.05,
                                backoff_max=0.2, jitter=0.1, seed=1),
            breaker=s.BreakerConfig(failure_threshold=3, reset_timeout=0.1))

    _, rt = _run_both(1, 60, backend, resilience=resilience)
    c = rt.metrics["counters"]
    assert c["sender.fail.unavailable"] > 0 and c["sender.retries"] > 0
    assert c["sender.transport_shed"] > 0
    assert rt.metrics["states"]["breaker.state"]["transitions"]["open"] >= 1
    assert rt.metrics["derived"]["degraded_time_fraction"] > 0.0


def test_latency_blowout_degraded_floor_matches_reference():
    """A backend slower than the budget engages the degraded floor
    through ``set_rate_floor`` on both sessions identically."""
    def backend(s):
        return s.MockBackend(filter_latency=3.0, dnn_latency=3.0, jitter=0.0)

    def resilience(s):
        return s.ResilienceConfig(degraded=s.DegradedConfig(max_drop=0.9,
                                                            ramp_up=0.5))

    _, rt = _run_both(2, 40, backend, resilience=resilience)
    assert rt.metrics["gauges"]["control.rate_floor"]["max"] > 0.4


class _NoBatch:
    """Proxy hiding ``offer_batch``/``step``: the service falls back to
    sequential ``offer`` calls."""

    def __init__(self, sess):
        self._sess = sess

    def __getattr__(self, name):
        if name in ("offer_batch", "step"):
            raise AttributeError(name)
        return getattr(self._sess, name)

    def __len__(self):
        return len(self._sess)


def test_sequential_offer_fallback_matches_batched():
    arrivals = _arrivals(tserve, 2, 60)
    _, sa = _sessions(2)
    _, sb = _sessions(2)
    kw = dict(clock=tserve.VirtualClock(), max_batch=4, max_wait=0.05)
    ra = tserve.ServeService(sa, tserve.MockBackend(seed=0), **kw).run(
        arrivals)
    kw["clock"] = tserve.VirtualClock()
    rb = tserve.ServeService(_NoBatch(sb), tserve.MockBackend(seed=0),
                             **kw).run(arrivals)
    assert ra.kept_mask == rb.kept_mask
    assert ra.metrics["counters"]["dispatch.batched"] > 0
    assert rb.metrics["counters"].get("dispatch.batched", 0) == 0
    assert rb.metrics["counters"]["dispatch.sequential"] == 120
    assert sa.stats.dropped_admission == sb.stats.dropped_admission


@pytest.mark.parametrize("cams", [1, 2])
def test_fused_step_matches_precomputed_utilities(cams):
    """Raw rectangular windows through ``step(frames=...)`` admit the
    same frames as their precomputed utilities through ``offer_batch``:
    the service scores windows of ``max_batch`` frames and
    ``camera_array_records`` chunks of 64, and the carried (bg, gain)
    lanes make the two scorings equal."""
    from repro_torch.data.pipeline import (
        camera_array_records,
        scenario_records,
    )
    from repro_torch.data.synthetic import generate_dataset

    h, w, T = 32, 48, 50
    scs = generate_dataset(range(cams + 2), num_frames=T, height=h, width=w)
    train, test = scs[:2], scs[2:]
    q = tcore.Query.single("red", latency_bound=1.0, fps=FPS)

    def fitted_session():
        s = tcore.open_session(q, num_cameras=cams, frame_shape=(h, w),
                               device="cpu")
        tr = [r for i, sc in enumerate(train)
              for r in scenario_records(sc, i, list(q.colors), fps=FPS,
                                        device="cpu")]
        s.fit(np.stack([r.pf for r in tr]), np.array([r.label for r in tr]))
        return s

    sess_f = fitted_session()
    streams = camera_array_records(test, list(q.colors), model=sess_f.model,
                                   fps=FPS, device="cpu")
    arr_fused, arr_util = [], []
    for c, stream in enumerate(streams):
        rgb = test[c].frames_rgb()
        for t, r in enumerate(stream):
            arr_fused.append(tserve.Arrival(t=r.t_gen, cam=r.cam_id,
                                            record=r, frame=rgb[t]))
            arr_util.append(tserve.Arrival(t=r.t_gen, cam=r.cam_id,
                                           record=r, utility=float(r.utility)))
    for a in (arr_fused, arr_util):
        a.sort(key=lambda x: x.t)

    def service(sess):
        return tserve.ServeService(sess, tserve.MockBackend(seed=0),
                                   clock=tserve.VirtualClock(), max_batch=4,
                                   max_wait=0.05)

    res_f = service(sess_f).run(arr_fused)
    assert res_f.metrics["counters"]["dispatch.fused"] > 0
    assert res_f.metrics["counters"].get("dispatch.batched", 0) == 0
    sess_u = fitted_session()
    res_u = service(sess_u).run(arr_util)
    assert "dispatch.fused" not in res_u.metrics["counters"]
    assert res_f.kept_mask == res_u.kept_mask
    assert _timeline(res_f) == _timeline(res_u)
    np.testing.assert_array_equal(sess_f.state.cdf_buf.numpy(),
                                  sess_u.state.cdf_buf.numpy())


def test_launcher_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve as launch
    out = tmp_path / "metrics.json"
    res = launch.main(["--cams", "2", "--frames", "40", "--device", "cpu",
                       "--metrics-out", str(out)])
    snap = json.loads(out.read_text())
    assert snap == res.metrics
    assert snap["derived"]["offered"] == 80
    assert snap["counters"]["dispatch.fused"] > 0
    assert out.with_suffix(".csv").exists()
    assert "QoR=" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch.main(["--real-backend", "--device", "cpu"])


def test_launcher_without_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    from repro_torch.launch import serve as launch
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--cams", "1", "--frames", "8",
                     "--metrics-out", str(tmp_path / "m.json")])

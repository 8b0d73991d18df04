"""Port's ShedSession (device="cpu") vs the reference's NumPy
``serve="host"`` session: the utilities path bit for bit, the frames path
through the plain ingest, and a state carried over from the reference."""
import jax  # noqa: F401  (both packages in one process, as the tests run)
import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.data.synthetic import combined_label, generate_scenario
from repro_torch.convert import model_from_numpy, state_from_numpy
from repro_torch.core.session import ADMIT, SHED_ADMISSION, SHED_QUEUE

C, T = 3, 6


def _pair(exact_tick, C=C, **kw):
    """A reference host session and a port CPU session, same options."""
    opts = dict(train_utilities=kw.pop("hist"), queue_size=3,
                queue_capacity=8, cdf_window=48, exact_tick=exact_tick, **kw)
    q = dict(latency_bound=1.0, fps=10.0)
    j = jcore.open_session(jcore.Query.any_of("red", "yellow", **q), C,
                           serve="host", **opts)
    t = tcore.open_session(tcore.Query.any_of("red", "yellow", **q), C,
                           device="cpu", **opts)
    return j, t


def _same_result(rj, rt, msg):
    np.testing.assert_array_equal(rt.decisions, rj.decisions, err_msg=msg)
    np.testing.assert_array_equal(rt.pushed_seq, rj.pushed_seq, err_msg=msg)
    assert len(rt.evicted) == len(rj.evicted)
    for a, b in zip(rt.evicted, rj.evicted):
        np.testing.assert_array_equal(a, b, err_msg=msg)
    if rj.target_drop_rate is None:
        assert rt.target_drop_rate is None
    else:
        np.testing.assert_array_equal(rt.target_drop_rate,
                                      rj.target_drop_rate, err_msg=msg)


def _same_state(j, t, msg, leaves=("threshold", "q_util", "q_seq",
                                   "q_next_seq", "cdf_buf", "cdf_len",
                                   "cdf_pos", "cdf_counts", "queue_cap",
                                   "proc_q", "fps_obs")):
    dj, dt = j.state.as_dict(), t.state.as_dict()
    for k in leaves:
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=f"{msg} {k}")
    np.testing.assert_array_equal(t.queue_depths(), j.queue_depths())
    assert t.stats.__dict__ == j.stats.__dict__, msg


def _drive(j, t, rng, steps, pool=None):
    """The same seeded trace through both: latency reports (shared and
    per camera), ingress rates, utility steps with and without a tick,
    and batched pops."""
    for i in range(steps):
        lat = float(rng.uniform(0.2, 2.0) / (C * 10.0))
        cam = int(rng.integers(0, C)) if i % 3 == 1 else None
        for s in (j, t):
            s.report_backend_latency(lat, cam=cam)
        if i % 4 == 2:
            fps, fcam = float(rng.uniform(5, 15)), (None if i % 8 == 2
                                                    else int(rng.integers(C)))
            for s in (j, t):
                s.report_ingress_fps(fps, cam=fcam)
        u = (rng.choice(pool, (C, T)) if pool is not None
             else rng.uniform(0, 1, (C, T))).astype(np.float32)
        tick = i % 5 != 3
        _same_result(j.step(utilities=u, tick=tick),
                     t.step(utilities=u, tick=tick), f"step {i}")
        _same_state(j, t, f"step {i}")
        if i % 2:
            k = int(rng.integers(1, 4))
            assert t.next_frames(k) == j.next_frames(k)
            assert t.next_frame() == j.next_frame()


@pytest.mark.parametrize("exact_tick", [False, True])
def test_utilities_trace_bit_identical(exact_tick, rng):
    hist = rng.uniform(0, 1, 80).astype(np.float32)
    j, t = _pair(exact_tick, hist=hist)
    _drive(j, t, rng, steps=14)
    assert t.tick() == j.tick()
    assert t.expected_proc() == j.expected_proc()
    # transmission: the same (cam, seq) pop sequence until both drain
    while len(j):
        assert t.next_frames(4) == j.next_frames(4)
    assert t.next_frames(4) == [] and len(t) == 0


def test_utilities_trace_subnormal_pool(rng):
    """The reference's recorded subnormal pool through the whole session
    (ring, admission, queues, ticks): still bit-identical."""
    pool = [np.float32(0.0), np.float32(1.401298464324817e-45)]
    j, t = _pair(True, hist=np.asarray(pool * 10, np.float32))
    _drive(j, t, rng, steps=8, pool=pool)


def test_decision_codes_and_items(rng):
    hist = rng.uniform(0, 1, 64).astype(np.float32)
    j, t = _pair(False, hist=hist)
    for s in (j, t):
        s.report_backend_latency(0.2)
        s.tick()
    u = rng.uniform(0, 1, (C, 10)).astype(np.float32)
    items = [[f"c{c}t{i}" for i in range(10)] for c in range(C)]
    dj = j.admit(u, items=items)
    dt = t.admit(u, items=items)
    np.testing.assert_array_equal(dt, dj)
    assert {ADMIT, SHED_ADMISSION, SHED_QUEUE} >= set(np.unique(dt).tolist())
    assert t.next_frames(50) == j.next_frames(50)


def _scenario_frames(Cn, n, H=24, W=40):
    scs = [generate_scenario(100 + c, num_frames=n, height=H, width=W)
           for c in range(Cn)]
    rgb = np.stack([sc.frames_rgb() for sc in scs]).astype(np.float32)
    labels = np.stack([combined_label(sc, ("red", "yellow"), "or")
                       for sc in scs])
    return rgb, labels


def test_frames_path_matches_reference(rng):
    """step(frames=...) through the port's plain ingest: its utilities
    are within 1e-4 of the reference's ingest, and replaying them into
    the reference host session gives bit-identical decisions."""
    Cn, Tn, nb = 2, 4, 4
    rgb, labels = _scenario_frames(Cn, 16 + Tn * nb)
    train = rgb[:, :16]
    # one trained model for both packages (train_utility_model is NumPy)
    js = jcore.open_session(jcore.Query.any_of("red", "yellow"), Cn,
                            serve="host")
    pf = js.ingest(train).pf.reshape(Cn * 16, 2, 8, 8)
    jm = jcore.train_utility_model(pf, labels[:, :16].reshape(-1),
                                   jcore.Query.any_of("red", "yellow").colors,
                                   "or")
    tm = model_from_numpy(("red", "yellow"), jm.M_pos, jm.M_neg, jm.norm,
                          jm.op)
    hist = rng.uniform(0, 1, 64).astype(np.float32)
    j, t = _pair(False, C=Cn, hist=hist)
    j.model = jm
    t.model = tm
    ji, ti = (jcore.open_session(jcore.Query.any_of("red", "yellow"), Cn,
                                 serve="host", model=jm),
              tcore.open_session(tcore.Query.any_of("red", "yellow"), Cn,
                                 device="cpu", model=tm))
    for b in range(nb):
        frames = rgb[:, 16 + b * Tn: 16 + (b + 1) * Tn]
        u_ref = ji.ingest(frames).utility
        u_ing = ti.ingest(frames).utility
        np.testing.assert_allclose(u_ing, u_ref, atol=1e-4)
        for s in (j, t):
            s.report_backend_latency(0.05)
        W = t.state.cdf_buf.shape[1]
        pos = t.state.cdf_pos.numpy().copy()
        rt = t.step(frames=frames)
        idx = (pos[:, None] + np.arange(Tn)[None]) % W
        u_step = np.take_along_axis(t.state.cdf_buf.numpy(), idx, axis=1)
        np.testing.assert_allclose(u_step, u_ref, atol=1e-4)
        np.testing.assert_array_equal(u_step, u_ing)
        rj = j.step(utilities=u_step)
        _same_result(rj, rt, f"batch {b}")
        _same_state(j, t, f"batch {b}")
        np.testing.assert_allclose(t.state.bg.numpy(),
                                   np.asarray(ji.state.bg), atol=1e-4)


def test_state_carry_over_continues_identically(rng):
    """state_from_numpy of a reference state (all 23 leaves) +
    model_from_numpy: the port continues exactly where the reference
    would."""
    hist = rng.uniform(0, 1, 80).astype(np.float32)
    j, _ = _pair(False, hist=hist)
    _, t = _pair(False, hist=hist)
    for i in range(5):
        j.report_backend_latency(float(rng.uniform(0.01, 0.08)))
        j.step(utilities=rng.uniform(0, 1, (C, T)).astype(np.float32))
    d = j.state.as_dict()
    assert len(d) == 23
    st = state_from_numpy(d, "cpu")
    for k, v in st.as_dict().items():
        np.testing.assert_array_equal(v, d[k], err_msg=k)
        assert v.dtype == d[k].dtype, k
    t.load_state(st)
    t.stats = jcore.ShedderStats(**j.stats.__dict__)
    # payloads are host objects a state carry-over does not move: the
    # port names carried entries (cam, seq), so the reference must too
    j._payloads = [{} for _ in range(C)]
    _drive(j, t, rng, steps=6)



def test_fresh_state_matches_reference_leaf_for_leaf():
    """All 23 leaves: same names, order, shapes, dtypes and values as the
    reference's fresh state, so states carry over one to one."""
    kw = dict(frame_shape=(6, 10), queue_size=5, queue_capacity=12,
              cdf_window=40, quantile_bins=64)
    j = jcore.open_session(jcore.Query.single("red", fps=7.5), 3,
                           serve="host", **kw)
    t = tcore.open_session(tcore.Query.single("red", fps=7.5), 3,
                           device="cpu", **kw)
    dj, dt = j.state.as_dict(), t.state.as_dict()
    assert list(dt) == list(dj) and len(dt) == 23
    for k in dj:
        assert dt[k].dtype == dj[k].dtype, k
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
    with pytest.raises(ValueError, match="lacks leaves"):
        state_from_numpy({k: v for k, v in dj.items() if k != "q_seq"}, "cpu")


def test_step_takes_tensor_frames_where_they_lie(rng):
    """A tensor already on the session's device is used as is (same
    result as the numpy form); one on another device is refused."""
    import torch
    Cn = 2
    rgb, _ = _scenario_frames(Cn, 8, H=12, W=16)
    tm = _port_model(rng)
    hist = rng.uniform(0, 1, 64).astype(np.float32)
    a, b = (tcore.open_session(tcore.Query.any_of("red", "yellow"), Cn,
                               device="cpu", model=tm, train_utilities=hist)
            for _ in range(2))
    for bt in range(2):
        frames = rgb[:, bt * 4:(bt + 1) * 4]
        ra = a.step(frames)
        rb = b.step(torch.from_numpy(np.ascontiguousarray(frames)))
        _same_result(ra, rb, f"batch {bt}")
    np.testing.assert_array_equal(a.state.bg.numpy(), b.state.bg.numpy())
    with pytest.raises(ValueError, match="frames on"):
        b.step(torch.zeros((Cn, 1, 12, 16, 3), device="meta"))


def _port_model(rng):
    M = rng.uniform(0, 1, (2, 8, 8)).astype(np.float32)
    norm = rng.uniform(0.3, 1.0, 2).astype(np.float32)
    return model_from_numpy(("red", "yellow"), M, np.zeros_like(M), norm,
                            "or")

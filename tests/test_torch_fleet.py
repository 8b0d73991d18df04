"""Camera-sharded fleet serving on the port (``repro_torch.core.fleet``),
on the CPU: shards of the CPU device (``fleet_mesh(S, device="cpu")``)
stand in for the reference tests' fake CPU devices.

Held bit for bit to the port's own unsharded session (decisions, every
gathered lane, pops, aggregates, checkpoints), to the JAX ``serve="host"``
session (which the unsharded port session equals), and to the
reference's own sharded session on a 1-device mesh without a seeded CDF
(the one case where it runs under the installed JAX; its device twin
reorders the queue lanes at every tick, so there the lanes compare as
per-camera multisets)."""
from __future__ import annotations

import json
from dataclasses import dataclass

import jax  # noqa: F401  (both packages in one process, as the tests run)
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
import repro_torch.serve as tserve
from repro_torch.core import fleet as fl
from repro_torch.kernels.hsv_features import kernel as hk
from repro_torch.train import checkpoint as tckpt

FPS = 10.0
SUBNORMAL = np.float32(1.401298464324817e-45)


@dataclass(frozen=True)
class Rec:
    cam_id: object
    frame_idx: int
    t_gen: float = 0.0
    busy: bool = False


def _query(core=tcore):
    return core.Query.any_of("red", "yellow", latency_bound=1.0, fps=FPS)


def _open(C, S=None, core=tcore, **kw):
    """A port CPU session, sharded over S CPU shards when S is given."""
    opts = dict(queue_size=3, queue_capacity=8, cdf_window=48, **kw)
    if core is jcore:
        return jcore.open_session(_query(jcore), C, serve="host", **opts)
    if S is not None:
        opts["mesh"] = fl.fleet_mesh(S, device="cpu")
    return tcore.open_session(_query(), C, device="cpu", **opts)


def _norm(x):
    """Comparable form of a session call's result."""
    if isinstance(x, dict):
        return json.dumps(x, sort_keys=True)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if hasattr(x, "decisions"):             # a StepResult of either package
        return (x.decisions.tolist(), x.pushed_seq.tolist(),
                [e.tolist() for e in x.evicted],
                None if x.target_drop_rate is None
                else x.target_drop_rate.tolist())
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return x


class Twin:
    """An unsharded and a sharded session; a call on the twin runs on
    both, must return the same, and must leave every lane, counter and
    queue depth the same."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def __getattr__(self, name):
        def call(*args, **kw):
            ra = getattr(self.a, name)(*args, **kw)
            rb = getattr(self.b, name)(*args, **kw)
            assert _norm(rb) == _norm(ra), (name, rb, ra)
            self.check(name)
            return rb
        return call

    def check(self, msg=""):
        same_state(self.a, self.b, msg)


def same_state(a, b, msg="", counters=True):
    """Every lane, the queue depths and the active set equal; with
    ``counters`` the host counters too (a restore does not carry them)."""
    da, db = a.state.as_dict(), b.state.as_dict()
    assert list(da) == list(db)
    for k in da:
        np.testing.assert_array_equal(db[k], da[k], err_msg=f"{msg} {k}")
        assert db[k].dtype == da[k].dtype, (msg, k)
    np.testing.assert_array_equal(b.queue_depths(), a.queue_depths())
    assert b.num_active == a.num_active
    # a restored session reads its floor back from the float32 lanes
    assert np.float32(b.rate_floor) == np.float32(a.rate_floor)
    if not counters:
        return
    assert b.stats.__dict__ == a.stats.__dict__, msg
    np.testing.assert_array_equal(b.per_camera_offered, a.per_camera_offered)
    np.testing.assert_array_equal(b.per_camera_dropped, a.per_camera_dropped)


# -- mesh and arguments ------------------------------------------------------

def test_fleet_mesh_and_camera_axis():
    m = fl.fleet_mesh(4, device="cpu")
    assert m.devices == (torch.device("cpu"),) * 4
    assert m.shape == {fl.CAMERA_AXIS: 4} and m.size == 4
    assert fl.mesh_axis_size(m, fl.CAMERA_AXIS) == 4
    assert fl.camera_axis(m, 12) == fl.CAMERA_AXIS
    with pytest.raises(ValueError, match="no axis divides"):
        fl.camera_axis(m, 10)
    assert fl.fleet_mesh(device="cpu").size == 1
    named = fl.fleet_mesh(2, "cams", device="cpu")
    assert named.shape == {"cams": 2}
    assert fl.camera_axis(named, 4) == "cams"
    assert tcore.open_session(_query(), 4, mesh=named).mesh is named
    with pytest.raises(ValueError):
        fl.fleet_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fl.fleet_mesh()
    else:
        with pytest.raises(ValueError, match="visible"):
            fl.fleet_mesh(torch.cuda.device_count() + 1)


def test_session_sharding_arguments():
    q = _query()
    s = tcore.open_session(q, 8, mesh=fl.fleet_mesh(4, device="cpu"))
    assert s.device == torch.device("cpu") and s.mesh.size == 4
    assert len(s._shards) == 4 and s._shards[0].num_cameras == 2
    s = tcore.open_session(q, 8, shard_cameras=True, device="cpu")
    assert s.mesh.size == 1 and s.mesh.devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="no axis divides"):
        tcore.open_session(q, 6, mesh=fl.fleet_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="serve='device'"):
        tcore.open_session(q, 8, shard_cameras=True, serve="host",
                           device="cpu")
    from repro_torch.cascade import CallableScorer, Cascade
    with pytest.raises(ValueError, match="cascade"):
        tcore.open_session(q, 8, mesh=fl.fleet_mesh(2, device="cpu"),
                           cascade=Cascade(CallableScorer(lambda f, b: None)))
    s = tcore.open_session(q, 8, fleet_aggregate=True, device="cpu")
    assert s.mesh is None and s.fleet_aggregate
    s.step(utilities=np.zeros((8, 2), np.float32))
    assert s.last_fleet_stats is None
    with pytest.raises(ValueError, match="camera-sharded"):
        s.fleet_stats()


def test_shard_and_gather_state_round_trip():
    st = _open(8, train_utilities=np.linspace(0, 1, 30)).state
    shards = fl.shard_state(st, fl.fleet_mesh(4, device="cpu"))
    assert [s.num_cameras for s in shards] == [2] * 4
    for s in shards:
        assert s.bg_valid.shape == () and s.cdf_buf.shape == (2, 48)
    back = fl.gather_state(shards)
    for k, v in st.as_dict().items():
        np.testing.assert_array_equal(back.as_dict()[k], v, err_msg=k)
    shards[0].q_seq[0, 0] = 7            # a copy: the source is untouched
    assert int(st.q_seq[0, 0]) == -1


# -- against the port's own unsharded session --------------------------------

def _churn_trace(tw, C, rng, steps=8):
    """Utility steps with and without ticks, latency and ingress reports
    shared and per camera, churn, a rate floor, coalesced offers, single
    offers and pops of every kind — each call held equal on the twin."""
    ids = [f"cam{c}" for c in range(C)]
    for c in ids:
        tw.lane(c)
    for i in range(steps):
        lat = float(rng.uniform(0.2, 2.0) / (C * FPS))
        tw.report_backend_latency(lat, cam=int(rng.integers(C)) if i % 3 == 1
                                  else None)
        if i % 4 == 2:
            tw.report_ingress_fps(float(rng.uniform(5, 15)),
                                  cam=None if i % 8 == 2
                                  else int(rng.integers(C)))
        u = rng.uniform(0, 1, (C, 5)).astype(np.float32)
        tw.step(utilities=u, tick=i % 5 != 3)
        if i == 2:
            tw.detach_camera(ids[1])
            tw.detach_camera(ids[C - 1])
        if i == 4:
            tw.attach_camera("new")
            tw.set_rate_floor(0.3)
        if i == 6:
            tw.set_rate_floor(0.0)
        items = [Rec(ids[(3 * j) % C] if (3 * j) % C not in (1, C - 1)
                     else ids[0], 100 * i + j) for j in range(7)]
        tw.offer_batch(items, rng.uniform(0, 1, 7).astype(np.float32))
        tw.offer(Rec(ids[2], 1000 + i), float(rng.uniform()))
        tw.next_frames(int(rng.integers(1, 6)))
        tw.next_frames(3, cams=[0, C // 2, C - 2])
        tw.next_frame()
        tw.next_frame(int(rng.integers(C)))
        tw.observed_drop_rate(int(rng.integers(C)))
        tw.expected_proc()
        tw.expected_proc(int(rng.integers(C)))
        tw.tick()
    while len(tw.a):
        tw.next_frames(4)


@pytest.mark.parametrize("C,S", [(16, 1), (16, 2), (16, 4), (16, 8),
                                 (24, 8)])
def test_sharded_trace_equals_unsharded(C, S):
    rng = np.random.default_rng(C * 10 + S)
    hist = rng.uniform(0, 1, 90).astype(np.float32)
    tw = Twin(_open(C, train_utilities=hist),
              _open(C, S, train_utilities=hist, fleet_aggregate=True))
    tw.check("open")
    _churn_trace(tw, C, rng)
    assert tw.b.last_fleet_stats is not None


@pytest.mark.parametrize("exact_tick", [False, True])
def test_sharded_trace_equals_jax_host_session(exact_tick):
    """The JAX ``serve="host"`` session, the unsharded port session and a
    4-shard port session, one trace: decisions, thresholds, queue lanes
    and pops of the sharded session equal the reference's."""
    C = 8
    rng = np.random.default_rng(3)
    hist = rng.uniform(0, 1, 70).astype(np.float32)
    kw = dict(train_utilities=hist, exact_tick=exact_tick)
    j = _open(C, core=jcore, **kw)
    t = _open(C, 4, **kw)
    for i in range(10):
        lat = float(rng.uniform(0.2, 2.0) / (C * FPS))
        for s in (j, t):
            s.report_backend_latency(lat, cam=1 if i % 3 == 1 else None)
        u = rng.uniform(0, 1, (C, 6)).astype(np.float32)
        tick = i % 4 != 1
        assert _norm(t.step(utilities=u, tick=tick)) == \
            _norm(j.step(utilities=u, tick=tick)), i
        dj, dt = j.state.as_dict(), t.state.as_dict()
        for k in ("threshold", "q_util", "q_seq", "q_next_seq", "cdf_buf",
                  "cdf_counts", "queue_cap", "proc_q"):
            np.testing.assert_array_equal(dt[k], dj[k], err_msg=f"{i} {k}")
        if i % 2:
            assert t.next_frames(3) == j.next_frames(3)
            assert t.next_frame(2) == j.next_frame(2)
            assert t.next_frames(2, cams=[5, 6]) == j.next_frames(2,
                                                                 cams=[5, 6])
    assert _norm(t.tick()) == _norm(j.tick())


def _multiset(util, seq):
    return [sorted((float(u), int(s)) for u, s in zip(ur, sr) if s >= 0)
            for ur, sr in zip(np.asarray(util), np.asarray(seq))]


def test_sharded_trace_equals_reference_mesh_session():
    """The reference's own sharded session on a 1-device mesh (no seeded
    CDF: its ``seed_cdf`` scatter is refused on sharded lanes by the
    installed JAX) against a 2-shard port session: decisions,
    thresholds, pops and the queue lanes as per-camera multisets (its
    device twin reorders the lanes at every tick). One latency report:
    the device twin's float32 EWMA may differ from the host twin's in the
    last bit, and the first report sets the lanes without an EWMA."""
    C = 8
    rng = np.random.default_rng(4)
    opts = dict(queue_size=3, queue_capacity=8, cdf_window=48)
    j = jcore.open_session(_query(jcore), C, shard_cameras=True,
                           fleet_aggregate=True, **opts)
    assert j.mesh is not None
    t = _open(C, 2, fleet_aggregate=True)
    for s in (j, t):
        s.report_backend_latency(0.03)
    for i in range(8):
        u = rng.uniform(0, 1, (C, 6)).astype(np.float32)
        tick = i % 3 != 1
        rj, rt = j.step(utilities=u, tick=tick), t.step(utilities=u,
                                                         tick=tick)
        np.testing.assert_array_equal(rt.decisions, rj.decisions)
        if tick:
            np.testing.assert_array_equal(rt.target_drop_rate,
                                          rj.target_drop_rate)
        np.testing.assert_array_equal(t.state.as_dict()["threshold"],
                                      np.asarray(j.state.threshold))
        assert _multiset(t.state.q_util, t.state.q_seq) == \
            _multiset(j.state.q_util, j.state.q_seq), i
        agg_j, agg_t = j.last_fleet_stats, t.last_fleet_stats
        assert {k: agg_t[k] for k in ("queue_depth", "cdf_fill", "offered",
                                      "admitted", "shed")} == \
            {k: agg_j[k] for k in ("queue_depth", "cdf_fill", "offered",
                                   "admitted", "shed")}
        if i % 2:
            assert t.next_frames(4) == j.next_frames(4)
            assert t.next_frames(2, cams=[3, 4]) == j.next_frames(
                2, cams=[3, 4])
    items = [Rec(c % C, 50 + c) for c in range(12)]
    cams = [c % C for c in range(12)]
    u = rng.uniform(0, 1, 12).astype(np.float32)
    assert t.offer_batch(items, u, cams=cams) == \
        j.offer_batch(items, u, cams=cams)
    for k, v in j.fleet_stats().items():
        np.testing.assert_allclose(t.fleet_stats()[k], v, rtol=1e-6)
    assert t.next_frames(40) == j.next_frames(40)


# -- frames at a small size ---------------------------------------------------

def test_sharded_frames_step_equals_unsharded(rng):
    """step(frames) at S=2 (the plain ingest on each shard's rows) equals
    the unsharded session: decisions, bg and gain lanes, every lane, the
    split-phase ingest and the pops."""
    from repro_torch.core.utility import UtilityModel
    C, T, H, W = 4, 3, 12, 20
    nc = 2
    model = UtilityModel(_query().colors,
                         rng.uniform(0, 1, (nc, 8, 8)).astype(np.float32),
                         rng.uniform(0, 1, (nc, 8, 8)).astype(np.float32),
                         rng.uniform(0.3, 1, nc).astype(np.float32), "or")
    hist = rng.uniform(0, 1, 40).astype(np.float32)
    a = _open(C, model=model, frame_shape=(H, W), train_utilities=hist)
    b = _open(C, 2, model=model, frame_shape=(H, W), train_utilities=hist)
    tw = Twin(a, b)
    base = rng.uniform(0, 255, (C, 1, H, W, 3)).astype(np.float32)
    for i in range(4):
        frames = np.clip(base + rng.normal(0, 30, (C, T, H, W, 3)), 0, 255
                         ).astype(np.float32)
        tw.report_backend_latency(0.02 + 0.01 * i)
        tw.step(frames if i % 2 else torch.from_numpy(frames), tick=True)
        assert bool(b._shards[0].bg_valid) and bool(b._shards[1].bg_valid)
        tw.next_frames(3)
    res_a = a.ingest(frames)
    res_b = b.ingest(frames)
    np.testing.assert_array_equal(res_b.pf, res_a.pf)
    np.testing.assert_array_equal(res_b.utility, res_a.utility)
    tw.check("ingest")
    st = b.ingest_state
    np.testing.assert_array_equal(st.bg.numpy(), a.ingest_state.bg.numpy())


# -- cross-shard pops ---------------------------------------------------------

@pytest.mark.parametrize("pool", ["signed_zeros", "subnormal", "uniform"])
def test_cross_shard_pops(pool):
    """The best k frames of the fleet all on one shard; ±0.0 ties and the
    subnormal pool ``[0.0, 1.4e-45]`` come through the cross-shard merge in
    the order ``pop_topk_dev`` gives the whole lanes."""
    C, S = 8, 4
    rng = np.random.default_rng(7)
    values = {"signed_zeros": np.float32([0.0, -0.0]),
              "subnormal": np.float32([0.0, SUBNORMAL]),
              "uniform": None}[pool]
    tw = Twin(_open(C), _open(C, S))
    for r in range(5):
        cams = [6, 7, 6, 7, 6] + list(rng.integers(0, C, 6))
        if values is None:
            u = rng.uniform(0, 1, len(cams)).astype(np.float32)
            u[:5] += 2.0                  # the best five on shard 3
        else:
            u = rng.choice(values, len(cams))
        tw.offer_batch([Rec(c, 10 * r + i) for i, c in enumerate(cams)], u,
                       cams=cams)
    tw.next_frames(4)
    tw.next_frame(7)
    tw.next_frames(3, cams=[0, 6])
    tw.next_frame()
    tw.next_frames(2, cams=[5])          # an empty or short pool
    while len(tw.a):
        tw.next_frames(3)
    assert tw.next_frames(2) == [] and tw.next_frame() is None


def test_pop_topk_matches_pop_topk_dev():
    """``fleet.pop_topk`` over shards of random lanes pops exactly what
    ``shed_queue.pop_topk_dev`` pops from the whole lanes."""
    from repro_torch.core import shed_queue as sq
    rng = np.random.default_rng(8)
    C, K = 8, 6
    for trial in range(6):
        util = rng.choice(np.float32([0.0, -0.0, SUBNORMAL, 0.5, 0.25,
                                      -1.0]), (C, K)).astype(np.float32)
        seq = rng.permutation(C * K).reshape(C, K).astype(np.int32)
        seq[rng.random((C, K)) < 0.3] = -1
        util[seq < 0] = -np.inf
        st = _open(C).state
        st.q_util, st.q_seq = torch.from_numpy(util), torch.from_numpy(seq)
        rows = rng.random(C) < 0.7 if trial % 2 else None
        k = int(rng.integers(1, C * K + 3))
        mesh = fl.fleet_mesh(4, device="cpu")
        shards, pc, ps = fl.pop_topk(fl.shard_state(st, mesh), mesh=mesh,
                                     k=k, rows=rows)
        u2, s2, qc, qs = sq.pop_topk_dev(
            st.q_util, st.q_seq, k,
            None if rows is None else torch.from_numpy(rows))
        n = min(k, C * K)
        np.testing.assert_array_equal(pc[:n], qc.numpy())
        np.testing.assert_array_equal(ps[:n], qs.numpy())
        assert (pc[n:] == -1).all() and (ps[n:] == -1).all()
        back = fl.gather_state(shards)
        np.testing.assert_array_equal(back.q_util.numpy(), u2.numpy())
        np.testing.assert_array_equal(back.q_seq.numpy(), s2.numpy())


# -- aggregates ---------------------------------------------------------------

def test_fleet_aggregates_match_numpy():
    C, S = 16, 4
    rng = np.random.default_rng(9)
    s = _open(C, S, fleet_aggregate=True,
              train_utilities=rng.uniform(0, 1, 30).astype(np.float32))
    assert s.last_fleet_stats is None
    for i in range(4):
        s.report_backend_latency(float(rng.uniform(0.005, 0.02)),
                                 cam=i % C)
        s.report_ingress_fps(float(rng.uniform(5, 15)), cam=(3 * i) % C)
        u = rng.uniform(0, 1, (C, 5)).astype(np.float32)
        res = s.step(utilities=u, tick=True)
        st = s.state.as_dict()
        fin = np.isfinite(st["threshold"])
        got = s.last_fleet_stats
        assert got["queue_depth"] == int((st["q_seq"] >= 0).sum())
        assert got["cdf_fill"] == int(st["cdf_len"].sum())
        assert got["offered"] == int((res.decisions >= 0).sum())
        assert got["admitted"] == int((res.decisions == 0).sum())
        assert got["shed"] == int((res.decisions > 0).sum())
        assert got["shed_rate"] == got["shed"] / got["offered"]
        np.testing.assert_allclose(got["proc_q_mean"], st["proc_q"].mean(),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["fps_obs_mean"],
                                   st["fps_obs"].mean(), rtol=1e-6)
        np.testing.assert_allclose(got["threshold_mean"],
                                   st["threshold"][fin].mean(), rtol=1e-6)
        fs = s.fleet_stats()
        assert "offered" not in fs
        assert {k: fs[k] for k in ("queue_depth", "cdf_fill")} == \
            {k: got[k] for k in ("queue_depth", "cdf_fill")}
    s.next_frames(5)
    assert s.fleet_stats()["queue_depth"] == int(
        (s.state.as_dict()["q_seq"] >= 0).sum())
    s.tick()
    assert "offered" not in s.last_fleet_stats
    s.offer_batch([Rec(0, 1), Rec(1, 2)], [0.9, 0.1], cams=[0, 1])
    assert s.last_fleet_stats["offered"] == 2


# -- checkpoints --------------------------------------------------------------

def test_restore_with_shardings(tmp_path, rng):
    mesh = fl.fleet_mesh(4, device="cpu")
    tree = {"lane": rng.normal(size=(8, 3)).astype(np.float32),
            "flag": np.array(True),
            "nested": {"rows": rng.integers(0, 9, (8,)).astype(np.int32)}}
    tckpt.save(tmp_path, 2, tree)
    out, step, _ = tckpt.restore(
        tmp_path, tree, device="cpu",
        shardings={"lane": mesh, "flag": None, "nested": {"rows": mesh}})
    assert step == 2
    assert isinstance(out["lane"], tuple) and len(out["lane"]) == 4
    np.testing.assert_array_equal(
        torch.cat(out["lane"]).numpy(), tree["lane"])
    np.testing.assert_array_equal(
        torch.cat(out["nested"]["rows"]).numpy(), tree["nested"]["rows"])
    assert out["nested"]["rows"][0].dtype == torch.int32
    assert isinstance(out["flag"], torch.Tensor) and bool(out["flag"])
    with pytest.raises(ValueError, match="cannot split"):
        tckpt.restore(tmp_path, tree, device="cpu",
                      shardings={"lane": fl.fleet_mesh(3, device="cpu")})


def _segment(sess, rng, log):
    """A stretch of serving after a checkpoint."""
    sess.attach_camera("late")
    for i in range(4):
        sess.report_backend_latency(float(rng.uniform(0.01, 0.03)))
        r = sess.step(utilities=rng.uniform(0, 1, (sess.num_cameras, 4))
                      .astype(np.float32), tick=i % 2 == 0)
        log.append(_norm(r))
        log.append(sess.next_frames(3))
        log.append(_norm(sess.tick()))
    log.append({k: v.tolist() for k, v in sess.state.as_dict().items()})
    return log


def _pre_checkpoint(sess, rng):
    for c in range(sess.num_cameras - 1):
        sess.lane(f"id{c}")
    for i in range(5):
        sess.report_backend_latency(float(rng.uniform(0.01, 0.05)),
                                    cam=i if i % 2 else None)
        sess.step(utilities=rng.uniform(0, 1, (sess.num_cameras, 4))
                  .astype(np.float32), tick=i % 2 == 0)
        if i == 2:
            sess.detach_camera("id3")
            sess.set_rate_floor(0.2)
        sess.next_frames(2)


def test_elastic_checkpoints_8_to_2_to_unsharded(tmp_path):
    C = 16
    hist = np.random.default_rng(1).uniform(0, 1, 50).astype(np.float32)
    live = _open(C, 8, train_utilities=hist)
    ref = _open(C, train_utilities=hist)
    for s in (live, ref):
        _pre_checkpoint(s, np.random.default_rng(2))
    same_state(ref, live, "pre")
    live.checkpoint(tmp_path / "s8", step=5)
    ref.checkpoint(tmp_path / "s1", step=5)
    assert ((tmp_path / "s8" / "0000000005.ckpt").read_bytes()
            == (tmp_path / "s1" / "0000000005.ckpt").read_bytes())
    two = _open(C, 2)
    assert two.restore(tmp_path / "s8")[0] == 5
    same_state(live, two, "8->2", counters=False)
    two.checkpoint(tmp_path / "s2", step=6)
    whole = _open(C)
    whole.restore(tmp_path / "s2")
    same_state(live, whole, "2->1", counters=False)
    logs = [_segment(s, np.random.default_rng(3), [])
            for s in (two, whole, ref)]
    assert logs[0] == logs[1]
    # the live/ref sessions keep their payloads; restored ones pop (cam,
    # seq) pairs: compare everything but the pops
    assert [x for i, x in enumerate(logs[2]) if i % 3 != 1] == \
        [x for i, x in enumerate(logs[0]) if i % 3 != 1]


def test_jax_checkpoint_restores_into_a_sharded_session(tmp_path):
    C = 8
    hist = np.random.default_rng(5).uniform(0, 1, 40).astype(np.float32)
    j = _open(C, core=jcore, train_utilities=hist)
    _pre_checkpoint(j, np.random.default_rng(6))
    j.checkpoint(tmp_path, step=3)
    t = _open(C, 4)
    step, meta = t.restore(tmp_path)
    assert step == 3 and t.num_active == C - 1
    back = _open(C, core=jcore)
    back.restore(tmp_path)
    a = _segment(back, np.random.default_rng(7), [])
    b = _segment(t, np.random.default_rng(7), [])
    assert b == a


# -- the service --------------------------------------------------------------

def test_service_over_a_sharded_session():
    """``ServeService`` over a 2-shard session: the same kept frames,
    timeline, counters and lanes as over the unsharded session."""
    C, n = 4, 40
    hist = np.random.default_rng(0).random(256).astype(np.float32)
    rng = np.random.default_rng(1)
    arrivals = [tserve.Arrival(t=i / FPS, cam=c,
                               record=Rec(c, i, i / FPS, busy=i % 5 == 0),
                               utility=float(rng.random()))
                for i in range(n) for c in range(C)]
    out = []
    for S in (None, 2):
        sess = _open(C, S, train_utilities=hist)
        svc = tserve.ServeService(sess, tserve.MockBackend(seed=0),
                                  clock=tserve.VirtualClock(), max_batch=4,
                                  max_wait=0.05, per_camera_latency=True)
        out.append((svc.run(arrivals), sess))
    (ra, sa), (rb, sb) = out
    assert rb.kept_mask == ra.kept_mask
    assert [(p.record.cam_id, p.record.frame_idx, p.t_sent, p.t_done)
            for p in rb.processed] == \
        [(p.record.cam_id, p.record.frame_idx, p.t_sent, p.t_done)
         for p in ra.processed]
    assert json.dumps(rb.metrics, sort_keys=True) == \
        json.dumps(ra.metrics, sort_keys=True)
    assert rb.metrics["counters"]["dispatch.batched"] > 0
    same_state(sa, sb, "service")


# -- the ingest work plan -------------------------------------------------------

@pytest.mark.parametrize("resident", [7, 132, 528, 2000])
@pytest.mark.parametrize("C,S,N", [(8, 2, 720 * 1280), (16, 4, 90 * 160),
                                   (16, 8, 4097), (1024, 8, 5000)])
def test_shard_work_plan_cuts_the_unsharded_tiles(resident, C, S, N):
    """A shard's call, planned for the whole array's camera count, cuts
    each camera's pixels into the unsharded call's tiles, so the kernel
    sums each camera's gain partials in the same groups and order; its
    own grid still covers every (camera, tile) item of the shard once."""
    whole = hk.work_plan(C, N, resident)
    shard = hk.work_plan(C // S, N, resident, plan_cameras=C)
    assert (shard.tile, shard.ntiles) == (whole.tile, whole.ntiles)
    assert shard.grid == min(C // S * shard.ntiles, resident)
    items = sorted(it for b in range(shard.grid) for it in shard.items(b))
    assert items == [(c, j) for c in range(C // S)
                     for j in range(shard.ntiles)]

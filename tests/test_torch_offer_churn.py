"""The port's frame-at-a-time serving surface — ``offer``/``offer_batch``,
camera churn (``lane``/``attach_camera``/``detach_camera``) and the
degraded-mode ``set_rate_floor`` — against the JAX reference's
``serve="host"`` session: every call gets the same arguments on both, and
decision codes, drained payloads, tick snapshots, thresholds, queue lanes
(``q_util``/``q_seq``), CDF rings and counters must be bit-identical.

The non-checkpoint cases of the reference's ``tests/test_churn.py`` and
``tests/test_fault.py::test_rate_floor_sheds_harder_on_session`` run here
on both sessions side by side."""
from __future__ import annotations

import json
from dataclasses import dataclass

import jax  # noqa: F401  (both packages in one process, as the tests run)
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.kernels.hsv_features.ops import IngestState

FPS = 10.0
LEAVES = ("bg", "bg_valid", "threshold", "q_util", "q_seq", "q_next_seq", "cdf_buf", "cdf_len",
          "cdf_pos", "cdf_counts", "queue_cap", "proc_q", "proc_seen",
          "fps_obs", "fps_seen", "active", "rate_floor", "gain", "s2_len",
          "s2_pos", "s2_threshold", "s2_counts")


@dataclass(frozen=True)
class Rec:
    cam_id: object
    frame_idx: int
    t_gen: float = 0.0
    busy: bool = False


class Pair:
    """A reference host session and a port CPU session, same options; a
    call on the pair runs on both and must return the same."""

    def __init__(self, C=2, **kw):
        q = dict(latency_bound=1.0, fps=FPS)
        self.j = jcore.open_session(jcore.Query.single("red", **q), C,
                                    serve="host", **kw)
        self.t = tcore.open_session(tcore.Query.single("red", **q), C,
                                    device="cpu", **kw)

    def __getattr__(self, name):
        def call(*a, **k):
            rj = getattr(self.j, name)(*a, **k)
            rt = getattr(self.t, name)(*a, **k)
            assert _norm(rt) == _norm(rj), (name, rt, rj)
            self.check(name)
            return rt
        return call

    def check(self, msg=""):
        dj, dt = self.j.state.as_dict(), self.t.state.as_dict()
        for k in LEAVES:
            np.testing.assert_array_equal(dt[k], dj[k], err_msg=f"{msg} {k}")
        np.testing.assert_array_equal(self.t.queue_depths(),
                                      self.j.queue_depths())
        assert self.t.stats.__dict__ == self.j.stats.__dict__, msg
        np.testing.assert_array_equal(self.t.per_camera_offered,
                                      self.j.per_camera_offered)
        np.testing.assert_array_equal(self.t.per_camera_dropped,
                                      self.j.per_camera_dropped)
        assert self.t.num_active == self.j.num_active
        assert self.t.rate_floor == self.j.rate_floor


def _norm(x):
    """Comparable form of a session call's result (tick snapshots as
    JSON, so -inf/+inf thresholds compare)."""
    if isinstance(x, dict):
        return json.dumps(x, sort_keys=True)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _feed(pair, cam_ids, utils, start=0):
    """Round-robin one utility stream across cameras; return codes."""
    return [pair.offer(Rec(cam_ids[i % len(cam_ids)], start + i), float(u))
            for i, u in enumerate(utils)]


# -- the reference's churn cases, on both sessions ---------------------------

def test_detach_drains_queue_and_masks_lane():
    p = Pair(C=3)
    _feed(p, ["a", "b", "c"], np.random.default_rng(0).random(30))
    depths = p.t.queue_depths()
    assert depths[1] > 0
    drained = p.detach_camera("b")
    assert len(drained) == depths[1]
    assert all(r.cam_id == "b" for r in drained)
    assert p.t.num_active == 2
    assert float(p.t.state.threshold[1]) == np.inf
    p.report_backend_latency(0.05)
    p.report_ingress_fps(30.0)
    snap = p.tick()
    assert snap["per_camera"]["threshold"][1] == np.inf
    assert p.offer(Rec("a", 99), 0.99) in ("queued", "shed_queue")


def test_attach_reuses_freed_lane_with_fresh_state():
    p = Pair(C=2)
    _feed(p, ["a", "b"], np.random.default_rng(1).random(20))
    p.detach_camera("b")
    assert p.attach_camera("c") == 1
    assert p.t.num_active == 2
    assert float(p.t.state.threshold[1]) == -np.inf
    assert int(p.t.state.cdf_len[1]) == 0
    assert p.offer(Rec("c", 0), 0.5) == "queued"


def test_churn_api_errors():
    s = tcore.open_session(tcore.Query.single("red"), 2, device="cpu")
    s.lane("a")
    s.lane("b")
    with pytest.raises(ValueError):
        s.attach_camera("a")               # duplicate id
    with pytest.raises(ValueError):
        s.detach_camera("nope")            # unknown id
    with pytest.raises(ValueError):
        s.lane("c")                        # no free lane
    s.detach_camera("a")
    assert s.attach_camera("c") == 0       # freed lane is claimable
    with pytest.raises(ValueError):
        s.set_rate_floor(1.5)


def test_churned_session_matches_fresh_session_on_survivors():
    """After detaching 'b' and attaching 'c' the port session equals a
    fresh port session that only saw 'a' and 'c' — and the reference
    does the same on every call."""
    rng = np.random.default_rng(7)
    pre, post = rng.random(40), rng.random(60)
    churned = Pair(C=2)
    _feed(churned, ["a", "b"], pre)
    churned.detach_camera("b")
    churned.attach_camera("c")
    fresh = Pair(C=2)
    for i, u in enumerate(pre):
        if i % 2 == 0:
            fresh.offer(Rec("a", i), float(u))
    assert fresh.lane("c") == 1

    outs = []
    for p in (churned, fresh):
        p.report_backend_latency(0.05)
        p.report_ingress_fps(30.0)
        snap1 = p.tick()
        codes = _feed(p, ["a", "c"], post)
        snap2 = p.tick()
        pops = []
        for _ in range(6):
            item = p.next_frame()
            pops.append(None if item is None
                        else (item.cam_id, item.frame_idx))
        outs.append((snap1, codes, snap2, pops, p.t.queue_depths().tolist()))
    assert outs[0] == outs[1]


def test_detach_attach_same_camera_equals_fresh_lane():
    p = Pair(C=2)
    _feed(p, ["a", "b"], np.random.default_rng(3).random(30))
    p.report_backend_latency(0.05)
    p.report_ingress_fps(30.0)
    p.tick()
    assert np.isfinite(float(p.t.state.threshold[1]))
    p.detach_camera("b")
    p.attach_camera("b")
    st = p.t.state
    assert float(st.threshold[1]) == -np.inf
    assert int(st.cdf_len[1]) == 0 and int(st.q_next_seq[1]) == 0
    assert bool(st.active[1])


def test_reset_lane_keeps_the_ring_contents_as_the_reference_does():
    """A reset lane restarts its ring at length 0 but keeps the old slot
    values (the reference writes lengths, not the buffer), and clears a
    frame-sized background row."""
    p = Pair(C=2, frame_shape=(4, 5), train_utilities=np.linspace(0, 1, 16))
    p.lane("x")
    p.lane("y")
    p.detach_camera("y")
    p.attach_camera("z")
    assert float(p.t.state.cdf_buf[1, 3]) == pytest.approx(0.2)


# -- degraded-mode floor (reference test_fault.py:365) -----------------------

def test_rate_floor_sheds_harder_on_session():
    rng = np.random.default_rng(0)
    p = Pair(C=2, train_utilities=rng.random(512).astype(np.float32))
    snap0 = p.tick()
    assert snap0["target_drop_rate"] == 0.0
    p.set_rate_floor(0.8)
    snap = p.tick()
    assert snap["target_drop_rate"] == pytest.approx(0.8, abs=1e-6)
    assert np.isfinite(snap["threshold"]) and snap["threshold"] > 0.5
    p.set_rate_floor(0.0)
    snap2 = p.tick()
    assert snap2["target_drop_rate"] == 0.0
    assert snap2["threshold"] == snap0["threshold"]


# -- a seeded fuzz over the whole surface ------------------------------------

@pytest.mark.parametrize("exact_tick", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_offer_churn_floor_fuzz_bit_identical(exact_tick, seed):
    """Random interleavings of offer, offer_batch (ragged, several frames
    per camera, explicit lanes), admit, ticks with and without a floor,
    latency/ingress feeds, pops and churn: identical on every call."""
    rng = np.random.default_rng(seed)
    C = 4
    p = Pair(C=C, queue_size=3, queue_capacity=6, cdf_window=40,
             exact_tick=exact_tick,
             train_utilities=rng.random(30).astype(np.float32))
    ids = ["c0", "c1", "c2", "c3"]
    for c in ids:
        p.attach_camera(c)
    detached, n = [], 0
    for i in range(120):
        op = rng.integers(0, 10)
        live = [c for c in ids if c not in detached]
        if op <= 2 and live:
            c = live[int(rng.integers(len(live)))]
            p.offer(Rec(c, n), float(rng.random()))
            n += 1
        elif op <= 4 and live:
            k = int(rng.integers(1, 7))
            cams = [live[int(rng.integers(len(live)))] for _ in range(k)]
            recs = [Rec(c, n + j) for j, c in enumerate(cams)]
            us = rng.random(k).astype(np.float32).tolist()
            if rng.random() < 0.5:
                p.offer_batch(recs, us)
            else:
                p.offer_batch(recs, us, cams=[p.t.lane(c) for c in cams])
            n += k
        elif op == 5:
            p.report_backend_latency(float(rng.uniform(0.01, 0.3)),
                                     cam=(None if rng.random() < 0.5
                                          else int(rng.integers(C))))
            p.report_ingress_fps(float(rng.uniform(5, 40)))
            p.tick()
        elif op == 6:
            p.set_rate_floor(float(rng.choice([0.0, 0.3, 0.9])))
        elif op == 7:
            k = int(rng.integers(1, 4))
            got = p.next_frames(k)
            assert len(got) <= k
        elif op == 8 and live and len(live) > 1 and rng.random() < 0.5:
            c = live[int(rng.integers(len(live)))]
            p.detach_camera(c)
            detached.append(c)
        elif op == 8 and detached:
            c = detached.pop(0)
            p.attach_camera(c)
        else:
            u = rng.random((C, 3)).astype(np.float32)
            np.testing.assert_array_equal(p.t.admit(u), p.j.admit(u))
            p.check("admit")
        for c in range(C):
            assert p.t.observed_drop_rate(c) == p.j.observed_drop_rate(c)


def test_offer_batch_equals_sequential_offers():
    """Coalesced arrivals decide and leave the state exactly as one
    ``offer`` per frame does (thresholds only move on ticks)."""
    rng = np.random.default_rng(5)
    recs = [Rec(int(c), i) for i, c in enumerate(rng.integers(0, 3, 40))]
    us = rng.random(40).astype(np.float32).tolist()
    seed = rng.random(64).astype(np.float32)
    a = tcore.open_session(tcore.Query.single("red"), 3, device="cpu",
                           train_utilities=seed, queue_size=4)
    b = tcore.open_session(tcore.Query.single("red"), 3, device="cpu",
                           train_utilities=seed, queue_size=4)
    for s in (a, b):
        s.report_backend_latency(0.1)
        s.tick()
    codes_b = b.offer_batch(recs, us)
    codes_a = [a.offer(r, u) for r, u in zip(recs, us)]
    assert codes_a == codes_b
    da, db = a.state.as_dict(), b.state.as_dict()
    for k in ("cdf_buf", "cdf_counts", "cdf_pos", "q_next_seq"):
        np.testing.assert_array_equal(da[k], db[k])
    # the same queued (seq, utility) entries; the slot layout differs
    # (a batch push re-sorts its lane, a single push fills a free slot)
    for c in range(3):
        def entries(d):
            live = d["q_seq"][c] >= 0
            return sorted(zip(d["q_seq"][c][live].tolist(),
                              d["q_util"][c][live].tolist()))
        assert entries(da) == entries(db)


def test_ingest_state_roundtrip():
    s = tcore.open_session(tcore.Query.single("red"), 2, device="cpu")
    bg = np.arange(10, dtype=np.float32).reshape(2, 5)
    s.set_ingest_state(IngestState(bg=bg, gain=np.array([1.5, 0.5],
                                                        np.float32)))
    st = s.ingest_state
    assert isinstance(st.bg, torch.Tensor) and st.num_cameras == 2
    np.testing.assert_array_equal(st.bg.numpy(), bg)
    np.testing.assert_array_equal(st.gain.numpy(), [1.5, 0.5])
    assert bool(s.state.bg_valid)
    s.set_ingest_state(None)
    assert not bool(s.state.bg_valid)
    with pytest.raises(ValueError):
        s.set_ingest_state(IngestState(bg=np.zeros((3, 5), np.float32),
                                       gain=np.ones(3, np.float32)))

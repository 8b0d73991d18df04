"""Port's semantic cascade vs the reference's (CPU): the scorer's pieces,
the MLP on carried and checkpointed weights, AdamW and the scorer's train
step, the fit, and the cascade session.

Mirrors ``tests/test_cascade.py``: cascade=None is single-stage (:57),
gate_fraction=1 reduces to it (:80), sharding and bad inputs are refused
(:104; sharding now raises ``NotImplementedError``), the stage-2
threshold converges (:119), the degraded floor bounds the combined rate
(:149), the s2 lanes round-trip through a checkpoint (:204), the scorer
round-trips (:236) and the fit learns (:246).

Tolerances: ROI crops, geometry and crop features 1e-6 absolute (the
crops are gathers, exact; the features go through cos/sin); scores 1e-5
absolute; optimizer steps 1e-5 relative to each leaf's largest entry.
Control decisions, queue seqs and thresholds are held bit for bit given
the same utilities and stage-2 scores."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.cascade import fit as jfit
from repro.cascade import scorer as jsc
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.cascade import fit as tfit
from repro_torch.cascade import scorer as tsc
from repro_torch.convert import model_from_numpy, scorer_params_from_numpy
from repro_torch.core.session import ADMIT, SHED_ADMISSION, SHED_CASCADE
from repro_torch.data.synthetic import generate_scenario
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep


def _frames_bboxes(rng, B=6, H=20, W=30):
    frames = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    r0 = rng.integers(0, H, B)
    c0 = rng.integers(0, W, B)
    bb = np.stack([r0, np.minimum(H - 1, r0 + rng.integers(0, H, B)),
                   c0, np.minimum(W - 1, c0 + rng.integers(0, W, B))],
                  -1).astype(np.int32)
    bb[0] = -1                                   # empty: the full frame
    bb[1] = [0, H - 1, 0, W - 1]
    bb[2] = [5, 5, 7, 7]                         # one pixel
    return frames, bb


@pytest.mark.parametrize("size", [4, 8, 16])
def test_extract_rois_and_geometry_match(size, rng):
    frames, bb = _frames_bboxes(rng)
    want = np.asarray(jsc.extract_rois(jnp.asarray(frames),
                                       jnp.asarray(bb), size))
    got = tsc.extract_rois(torch.from_numpy(frames), torch.from_numpy(bb),
                           size).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    geo_w = np.asarray(jsc.roi_geometry(jnp.asarray(bb), 20, 30))
    geo_g = tsc.roi_geometry(torch.from_numpy(bb), 20, 30).numpy()
    np.testing.assert_allclose(geo_g, geo_w, atol=1e-6, rtol=0)
    feat_w = np.asarray(jsc._crop_features(jnp.asarray(want)))
    feat_g = tsc._crop_features(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(feat_g, feat_w, atol=1e-6, rtol=0)


def test_extract_rois_shapes_and_fallback(rng):
    frames = rng.uniform(0, 255, (3, 20, 30, 3)).astype(np.float32)
    bboxes = np.array([[0, 19, 0, 29], [5, 5, 7, 7], [-1, -1, -1, -1]],
                      np.int32)
    rois = tsc.extract_rois(torch.from_numpy(frames),
                            torch.from_numpy(bboxes), 4).numpy()
    assert rois.shape == (3, 4, 4, 3)
    assert np.all(rois[1] == frames[1, 5, 7])
    full = tsc.extract_rois(torch.from_numpy(frames[2:3]),
                            torch.tensor([[0, 19, 0, 29]], dtype=torch.int32),
                            4).numpy()
    np.testing.assert_array_equal(rois[2], full[0])


def _ref_scorer(seed=3, roi_size=8, hidden=8):
    ref = jsc.MLPScorer.init(seed, roi_size=roi_size, hidden=hidden)
    params = scorer_params_from_numpy(
        {k: np.asarray(v) for k, v in ref.params.items()}, device="cpu")
    return ref, tsc.MLPScorer(params=params, roi_size=roi_size)


@pytest.mark.parametrize("roi_size,hidden", [(8, 8), (16, 32)])
def test_mlp_scores_on_carried_weights(roi_size, hidden, rng):
    ref, port = _ref_scorer(1, roi_size, hidden)
    frames, bb = _frames_bboxes(rng, B=7)
    want = ref.score(frames, bb)
    got = port.score(frames, bb)
    assert got.dtype == torch.float32 and got.shape == (7,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # a row's score does not depend on the batch it comes in
    np.testing.assert_allclose(port.score(frames[2:5], bb[2:5]).numpy(),
                               got[2:5].numpy(), atol=1e-6, rtol=0)
    assert port.score(frames[:0], bb[:0]).shape == (0,)


def test_scorer_checkpoints_cross_both_ways(tmp_path, rng):
    ref, port = _ref_scorer()
    frames, bb = _frames_bboxes(rng)
    ref.save(tmp_path / "ref", step=2)
    back = tsc.MLPScorer.from_checkpoint(tmp_path / "ref", roi_size=8,
                                         hidden=8, device="cpu")
    np.testing.assert_array_equal(back.score(frames, bb).numpy(),
                                  port.score(frames, bb).numpy())
    port.save(tmp_path / "port", step=5)
    jback = jsc.MLPScorer.from_checkpoint(tmp_path / "port", roi_size=8,
                                          hidden=8)
    np.testing.assert_array_equal(jback.score(frames, bb),
                                  ref.score(frames, bb))


def test_mlp_scorer_checkpoint_roundtrip(tmp_path, rng):
    scorer = tsc.MLPScorer.init(3, roi_size=8, hidden=4, device="cpu")
    assert tuple(scorer.params["w1"].shape) == (8 * 8 * 3 + tsc.N_GEO, 4)
    scorer.save(tmp_path / "sc", step=2)
    back = tsc.MLPScorer.from_checkpoint(tmp_path / "sc", roi_size=8,
                                         hidden=4, device="cpu")
    frames = rng.uniform(0, 255, (5, 24, 32, 3)).astype(np.float32)
    bbox = np.array([[2, 10, 3, 20]] * 5, np.int32)
    np.testing.assert_array_equal(scorer.score(frames, bbox).numpy(),
                                  back.score(frames, bbox).numpy())


def _rel_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("grad_clip,weight_decay", [(1.0, 0.0), (0.05, 0.1)])
def test_adamw_scorer_steps_match(grad_clip, weight_decay, rng):
    """20 steps on the same batches from carried weights: parameters,
    moments, step, grad norms and losses track the reference's."""
    ref, port = _ref_scorer(5)
    jo = jopt.AdamW(lr=jopt.constant_lr(3e-3), grad_clip=grad_clip,
                    weight_decay=weight_decay)
    to = topt.AdamW(lr=topt.constant_lr(3e-3), grad_clip=grad_clip,
                    weight_decay=weight_decay)
    jfn = jstep.make_scorer_train_step(jfit._bce_loss, jo)
    tfn = tstep.make_scorer_train_step(tfit._bce_loss, to)
    jp, js = ref.params, jo.init(ref.params)
    tp, ts = port.params, to.init(port.params)
    for i in range(20):
        x = rng.uniform(0, 255, (16, 8, 8, 3)).astype(np.float32)
        geo = rng.uniform(0, 1, (16, 4)).astype(np.float32)
        y = (rng.random(16) < 0.3).astype(np.float32)
        w = np.where(y > 0.5, 2.5, 1.0).astype(np.float32)
        jp, js, jm = jfn(jp, js, tuple(map(jnp.asarray, (x, geo, y, w))))
        tp, ts, tm = tfn(tp, ts, tuple(map(torch.from_numpy, (x, geo, y, w))))
        for k in ("loss", "grad_norm", "accuracy"):
            _rel_close(float(tm[k]), float(jm[k]))
        assert float(tm["lr"]) == float(jm["lr"])
    assert int(ts["step"]) == int(js["step"]) == 20
    assert ts["step"].dtype == torch.int32
    for k in ("w1", "b1", "w2", "b2"):
        _rel_close(tp[k].numpy(), jp[k])
        _rel_close(ts["m"][k].numpy(), js["m"][k])
        _rel_close(ts["v"][k].numpy(), js["v"][k])


def test_schedules_and_global_norm_match(rng):
    for step in (0, 1, 5, 10, 57, 100, 140):
        j = jopt.warmup_cosine(1e-3, 10, 120)(step)
        t = topt.warmup_cosine(1e-3, 10, 120)(torch.tensor(step))
        assert float(t) == pytest.approx(float(j), rel=1e-6)
        assert float(topt.constant_lr(2e-3)(torch.tensor(step))) == float(
            jopt.constant_lr(2e-3)(step))
    tree = {"a": rng.normal(size=(4, 5)).astype(np.float32),
            "b": (rng.normal(size=(3,)).astype(np.float32),)}
    j = jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree))
    t = topt.global_norm({"a": torch.from_numpy(tree["a"]),
                          "b": (torch.from_numpy(tree["b"][0]),)})
    assert float(t) == pytest.approx(float(j), rel=1e-6)


def _scenarios():
    return [generate_scenario(s, num_frames=40, height=32, width=48,
                              target_colors=("red",),
                              color_mix={"red": 1.0}, vehicle_rate=0.08)
            for s in range(2)]


def test_collect_examples_match():
    scs = _scenarios()
    want = jfit.collect_examples(scs, [jcore.RED], op="or", impl="jnp")
    got = tfit.collect_examples(scs, [tcore.RED], op="or", device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.float32
    assert int((got[1][:, 0] >= 0).sum()) > 0


def test_fit_scorer_learns_synthetic_labels(tmp_path):
    scs = _scenarios()
    scorer, metrics = tfit.fit_scorer(scs, [tcore.RED], op="or", roi_size=8,
                                      hidden=8, steps=60, seed=0,
                                      checkpoint_dir=tmp_path / "fit",
                                      device="cpu")
    assert metrics["examples"] == 80
    assert metrics["loss_final"] < metrics["loss_first"]
    back = tsc.MLPScorer.from_checkpoint(tmp_path / "fit", roi_size=8,
                                         hidden=8, device="cpu")
    fr = scs[0].frames_rgb().astype(np.float32)[:4]
    bb = np.full((4, 4), -1, np.int32)
    np.testing.assert_array_equal(scorer.score(fr, bb).numpy(),
                                  back.score(fr, bb).numpy())


def test_fit_scorer_sees_the_reference_batches(monkeypatch):
    """From the reference's initial parameters the port's fit draws the
    same batches and augmentation: the first loss and, after 30 steps,
    the parameters agree at 1e-5 relative."""
    scs = _scenarios()
    jinit = jsc.MLPScorer.init(0, roi_size=8, hidden=8)
    carried = scorer_params_from_numpy(
        {k: np.asarray(v) for k, v in jinit.params.items()}, device="cpu")
    monkeypatch.setattr(tsc.MLPScorer, "init", classmethod(
        lambda cls, seed=0, **kw: cls(params=dict(carried), roi_size=8)))
    jsc_, jm = jfit.fit_scorer(scs, [jcore.RED], op="or", roi_size=8,
                               hidden=8, steps=30, seed=0, impl="jnp")
    tsc_, tm = tfit.fit_scorer(scs, [tcore.RED], op="or", roi_size=8,
                               hidden=8, steps=30, seed=0, device="cpu")
    assert tm["examples"] == jm["examples"]
    assert tm["positives"] == jm["positives"]
    _rel_close(tm["loss_first"], jm["loss_first"])
    for k in ("w1", "b1", "w2", "b2"):
        _rel_close(tsc_.params[k].numpy(), jsc_.params[k])


# -- the cascade session ----------------------------------------------------

def _sess(core=tcore, C=2, cascade=None, **kw):
    opts = dict(device="cpu") if core is tcore else dict(serve="host")
    return core.ShedSession(
        core.Query.single(core.RED, latency_bound=1.0, fps=10.0), C,
        cascade=cascade, **opts, **kw)


def _casc(core=tcore, gate_fraction=0.5, window=64):
    mod = tsc if core is tcore else jsc
    return mod.Cascade(mod.CallableScorer(lambda f, b: None),
                       gate_fraction=gate_fraction, window=window)


def _warm(sess, p=0.2, fps=10.0):
    sess.report_backend_latency(p)
    for c in range(sess.num_cameras):
        sess.report_ingress_fps(fps, cam=c)
    sess.tick()


def _gate_shed(decisions) -> int:
    return int(((decisions == SHED_ADMISSION)
                | (decisions == SHED_CASCADE)).sum())


def _u(i, shape=(2, 8)):
    return np.random.default_rng(1000 + i).uniform(0, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("serve", [None, "host", "device"])
def test_no_cascade_sessions_are_single_stage(serve):
    """cascade=None: identical decisions run to run, untouched s2 lanes,
    no cascade keys in the snapshot; ``serve=`` changes nothing."""
    runs = []
    for _ in range(2):
        sess = _sess(serve=serve)
        _warm(sess)
        decs = [sess.step(utilities=_u(i), tick=(i % 3 == 0)).decisions
                for i in range(12)]
        runs.append(np.concatenate(decs, axis=1))
        assert int(sess.state.s2_len.sum()) == 0
        assert bool(torch.isinf(sess.state.s2_threshold).all())
        assert "s2_threshold" not in sess.tick()
    np.testing.assert_array_equal(runs[0], runs[1])
    plain = _sess()
    _warm(plain)
    np.testing.assert_array_equal(
        np.concatenate([plain.step(utilities=_u(i), tick=(i % 3 == 0))
                        .decisions for i in range(12)], axis=1), runs[0])


def test_gate_fraction_one_reduces_to_single_stage():
    plain = _sess()
    casc = _sess(cascade=_casc(gate_fraction=1.0))
    _warm(plain)
    _warm(casc)
    a_all, b_all = [], []
    for i in range(15):
        tick = i % 2 == 0
        a = plain.step(utilities=_u(i), tick=tick)
        b = casc.step(utilities=_u(i), s2_utilities=_u(i), tick=tick)
        a_all.append(a.decisions)
        b_all.append(b.decisions)
        np.testing.assert_array_equal(a.pushed_seq, b.pushed_seq)
    np.testing.assert_array_equal(np.concatenate(a_all, 1),
                                  np.concatenate(b_all, 1))
    assert casc.stats.dropped_cascade == 0


@pytest.mark.parametrize("kw", [dict(shard_cameras=True),
                                dict(mesh="two CPU shards"),
                                dict(fleet_aggregate=True)])
def test_sharding_is_refused_until_it_is_ported(kw):
    """Camera sharding is ported, but not with a cascade: as in the
    reference, ``cascade=`` with sharding raises ``ValueError``, and
    ``fleet_aggregate=True`` alone is stored and shards nothing."""
    from repro_torch.core.fleet import fleet_mesh
    if "mesh" in kw:
        kw = dict(mesh=fleet_mesh(2, device="cpu"))
    if "fleet_aggregate" in kw:
        for sess in (_sess(cascade=_casc(), **kw), _sess(**kw)):
            assert sess.mesh is None and sess.fleet_aggregate
        return
    with pytest.raises(ValueError, match="cascade"):
        _sess(cascade=_casc(), **kw)
    assert _sess(**kw).mesh is not None


def test_cascade_rejects_bad_inputs():
    sess = _sess()
    with pytest.raises(ValueError):
        sess.step(utilities=np.zeros((2, 4), np.float32),
                  s2_utilities=np.zeros((2, 4), np.float32))
    casc = _sess(cascade=_casc())
    with pytest.raises(ValueError):
        casc.step(np.zeros((2, 1, 4, 4, 3), np.float32),
                  s2_utilities=np.zeros((2, 1), np.float32))
    with pytest.raises(ValueError):
        _sess(serve="tpu")
    with pytest.raises(ValueError):
        _sess(s2_quantile_range=(1.0, 1.0))
    with pytest.raises(ValueError):
        tsc.Cascade(None, gate_fraction=1.5)
    with pytest.raises(ValueError):
        tsc.Cascade(None, window=0)
    # the reference's no-op keywords are accepted
    _sess(impl="jnp", interpret=True, serve="device", shard_cameras=False)


def test_stage2_threshold_converges_to_conditional_quantile():
    C, T = 2, 16
    sess = _sess(C=C, cascade=_casc(window=2048))
    _warm(sess, p=0.2)
    rng = np.random.default_rng(7)
    shed = off = 0
    for i in range(60):
        u = rng.uniform(0, 1, (C, T)).astype(np.float32)
        s2 = rng.uniform(0, 1, (C, T)).astype(np.float32)
        res = sess.step(utilities=u, s2_utilities=s2, tick=True)
        np.testing.assert_array_equal(res.s2_scores, s2)
        if i >= 20:
            off += res.decisions.size
            shed += _gate_shed(res.decisions)
    np.testing.assert_allclose(sess.state.threshold.numpy(), 0.375,
                               atol=0.06)
    np.testing.assert_allclose(sess.state.s2_threshold.numpy(), 0.6,
                               atol=0.08)
    assert abs(shed / off - 0.75) < 0.08
    assert sess.stats.dropped_cascade > 0
    snap = sess.tick()
    assert len(snap["per_camera"]["s2_threshold"]) == C
    assert snap["s2_threshold"] == pytest.approx(
        float(sess.state.s2_threshold.mean()))


def test_degraded_floor_bounds_combined_rate():
    C, T = 2, 16
    sess = _sess(C=C, cascade=_casc(window=1024))
    _warm(sess, p=0.04)
    sess.set_rate_floor(0.5)
    rng = np.random.default_rng(11)
    shed = off = 0
    for i in range(50):
        u = rng.uniform(0, 1, (C, T)).astype(np.float32)
        s2 = rng.uniform(0, 1, (C, T)).astype(np.float32)
        res = sess.step(utilities=u, s2_utilities=s2, tick=True)
        if i >= 20:
            off += res.decisions.size
            shed += _gate_shed(res.decisions)
    assert shed / off > 0.40
    assert sess.stats.dropped_admission > 0
    assert sess.stats.dropped_cascade > 0


def test_cascade_checkpoint_restore_roundtrip(tmp_path):
    mk = lambda: _sess(cascade=_casc(window=128))
    live = mk()
    _warm(live, p=0.2)
    rng = np.random.default_rng(5)
    seg1 = [(rng.uniform(0, 1, (2, 8)).astype(np.float32),
             rng.uniform(0, 1, (2, 8)).astype(np.float32))
            for _ in range(10)]
    seg2 = [(rng.uniform(0, 1, (2, 8)).astype(np.float32),
             rng.uniform(0, 1, (2, 8)).astype(np.float32))
            for _ in range(10)]
    for u, s2 in seg1:
        live.step(utilities=u, s2_utilities=s2, tick=True)
    live.checkpoint(tmp_path / "ck", step=1)
    resumed = mk()
    resumed.restore(tmp_path / "ck")
    for k in ("s2_buf", "s2_threshold", "s2_counts", "s2_len", "s2_pos"):
        assert torch.equal(getattr(live.state, k),
                           getattr(resumed.state, k)), k
    assert int(resumed.state.s2_len.sum()) > 0
    for u, s2 in seg2:
        a = live.step(utilities=u, s2_utilities=s2, tick=True)
        b = resumed.step(utilities=u, s2_utilities=s2, tick=True)
        np.testing.assert_array_equal(a.decisions, b.decisions)
        np.testing.assert_array_equal(a.pushed_seq, b.pushed_seq)


@pytest.mark.parametrize("exact_tick", [False, True])
@pytest.mark.parametrize("gate_fraction", [0.4, 0.7])
def test_cascade_trace_matches_reference_host_twin(exact_tick,
                                                   gate_fraction):
    """The same utilities and stage-2 scores through a JAX ``serve="host"``
    cascade session and the port's: bit-identical decisions, queue seqs,
    evictions, rates, thresholds, s2 thresholds and every state lane over
    20 ticked steps (with varying latencies, a rate floor and pops)."""
    C, T = 3, 8
    j = _sess(jcore, C, cascade=_casc(jcore, gate_fraction, 256),
              exact_tick=exact_tick, queue_size=4, queue_capacity=12)
    t = _sess(tcore, C, cascade=_casc(tcore, gate_fraction, 256),
              exact_tick=exact_tick, queue_size=4, queue_capacity=12)
    rng = np.random.default_rng(9)
    for i in range(20):
        lat = float(rng.uniform(0.05, 0.4))
        for s in (j, t):
            s.report_backend_latency(lat, cam=i % C if i % 4 == 1 else None)
            if i == 12:
                s.set_rate_floor(0.6)
        u = rng.uniform(0, 1, (C, T)).astype(np.float32)
        s2 = rng.uniform(0, 1, (C, T)).astype(np.float32)
        a = j.step(utilities=u, s2_utilities=s2, tick=True)
        b = t.step(utilities=u, s2_utilities=s2, tick=True)
        np.testing.assert_array_equal(b.decisions, a.decisions)
        np.testing.assert_array_equal(b.pushed_seq, a.pushed_seq)
        np.testing.assert_array_equal(b.target_drop_rate, a.target_drop_rate)
        np.testing.assert_array_equal(b.s2_scores, a.s2_scores)
        for x, y in zip(b.evicted, a.evicted):
            np.testing.assert_array_equal(x, y)
        dj, dt = j.state.as_dict(), t.state.as_dict()
        for k in dj:
            np.testing.assert_array_equal(dt[k], dj[k], err_msg=f"{i} {k}")
        if i % 3 == 2:
            assert t.next_frames(4) == j.next_frames(4)
    assert t.stats.__dict__ == j.stats.__dict__
    assert t.stats.dropped_cascade > 0 and t.stats.dropped_admission > 0
    assert t.tick() == j.tick()


def _frames_cascade_vs_reference(direct: bool):
    """Four ticked ``step(frames)`` calls of a port cascade session and
    the reference's on the same frames: scores at 1e-5, decisions, seqs,
    stats and the s2 threshold exactly. ``direct``: the port's
    ``MLPScorer`` crops the survivors from the step's batch; else a
    ``CallableScorer`` spy over it gets their gathered frames."""
    C, T, H, W = 2, 6, 24, 32
    scs = [generate_scenario(s, num_frames=4 * T, height=H, width=W,
                             vehicle_rate=0.3) for s in range(C)]
    frames = np.stack([sc.frames_rgb() for sc in scs]).astype(np.float32)
    rng = np.random.default_rng(4)
    pfs = rng.dirichlet(np.ones(64), (40, 2)).reshape(40, 2, 8, 8)
    jm = jcore.train_utility_model(pfs.astype(np.float32),
                                   rng.random(40) < 0.5,
                                   [jcore.RED, jcore.YELLOW], op="or")
    tm = model_from_numpy(["red", "yellow"], jm.M_pos, jm.M_neg, jm.norm,
                          jm.op)
    ref, port = _ref_scorer(2)
    calls = []

    def spy(f, b):
        calls.append((tuple(f.shape), b.clone()))
        return port.score(f, b)

    q = dict(latency_bound=1.0, fps=10.0)
    js = jcore.ShedSession(jcore.Query.any_of("red", "yellow", **q), C,
                           serve="host", model=jm, frame_shape=(H, W),
                           cascade=jsc.Cascade(ref, window=64))
    scorer = port if direct else tsc.CallableScorer(spy)
    ts = tcore.ShedSession(tcore.Query.any_of("red", "yellow", **q), C,
                           device="cpu", model=tm, frame_shape=(H, W),
                           cascade=tsc.Cascade(scorer, window=64))
    for s in (js, ts):
        s.report_backend_latency(0.15)
    for i in range(4):
        batch = frames[:, i * T:(i + 1) * T]
        a = js.step(batch, tick=True)
        b = ts.step(batch, tick=True)
        np.testing.assert_allclose(b.s2_scores, a.s2_scores, atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(b.decisions, a.decisions)
        np.testing.assert_array_equal(b.pushed_seq, a.pushed_seq)
        survivors = int((b.decisions != SHED_ADMISSION).sum())
        if direct:
            assert not calls
        else:
            assert len(calls) == i + 1
            assert calls[-1][0] == (survivors, H, W, 3)
    gathered = ts.metrics.counter("cascade.frames_gathered").value
    assert (gathered == 0) if direct else (gathered > 0)
    assert ts.stats.dropped_admission > 0 and ts.stats.dropped_cascade > 0
    assert (b.decisions == ADMIT).any()
    np.testing.assert_array_equal(ts.state.s2_threshold.numpy(),
                                  np.asarray(js.state.s2_threshold))


def test_frames_cascade_step_matches_reference():
    """``step(frames)`` on a cascade session: the fused ingest's bbox
    rider feeds ONE scorer call a step over the color gate's survivors;
    scores agree with the reference's at 1e-5 and decisions exactly. A
    spy scorer sees the survivors' whole (B, H, W, 3) frames."""
    _frames_cascade_vs_reference(direct=False)


def test_frames_cascade_step_crops_in_place_like_the_reference():
    """The same with the port's ``MLPScorer`` given to the session
    itself, as a deployment runs it: the ROIs cropped from the step's
    batch score as the reference's scorer does on the same frames, and
    no frame is gathered."""
    _frames_cascade_vs_reference(direct=True)


def _rows_case(case, rng, C=3, T=4, H=20, W=30):
    """A (C, T, H, W, 3) batch, a survivors' index (cams, ts) and their
    bboxes for one of the cases of the in-place crop."""
    if case == "t1":
        T = 1
    batch = torch.from_numpy(
        rng.uniform(0, 255, (C, T, H, W, 3)).astype(np.float32))
    B = 1 if case == "b1" else 6
    cams = torch.from_numpy(rng.integers(0, C, B))
    ts = torch.from_numpy(rng.integers(0, T, B))
    _, bb = _frames_bboxes(rng, B=max(B, 3), H=H, W=W)
    bb = bb[:B]
    if case == "empty":
        bb[:] = -1
    elif case == "edges":           # each frame edge, then the whole frame
        bb = np.array([[0, 7, 3, 12], [9, H - 1, 4, 20], [2, 11, 0, 5],
                       [6, 14, 17, W - 1], [0, H - 1, 0, W - 1],
                       [H - 1, H - 1, W - 1, W - 1]], np.int32)
    elif case == "one_pixel":
        bb[:] = [5, 5, 7, 7]
        bb[1] = [0, 0, W - 1, W - 1]
    elif case == "repeated_camera":
        cams = torch.tensor([1, 1, 1, 0, 1, 2])
        ts = torch.tensor([0, 2, 0, 1, 3, 3])
    return batch, cams, ts, torch.from_numpy(bb)


@pytest.mark.parametrize("case", ["empty", "edges", "one_pixel",
                                  "repeated_camera", "b1", "t1"])
def test_rows_crop_in_place_bit_for_bit(case, rng):
    """ROIs cropped from the (C, T, H, W, 3) batch by the survivors'
    index, and the scores on a ``FrameRows``, are bit for bit those on
    the gathered (B, H, W, 3) frames; the scorer gathers nothing."""
    batch, cams, ts, bb = _rows_case(case, rng)
    whole = batch[cams, ts]
    for size in (4, 16):
        got = tsc.extract_rois(batch, bb, size, rows=(cams, ts))
        assert got.dtype == torch.float32
        assert torch.equal(got, tsc.extract_rois(whole, bb, size))
    scorer = tsc.MLPScorer.init(6, roi_size=16, hidden=32, device="cpu")
    rows = tsc.FrameRows(batch, cams, ts)
    assert torch.equal(scorer.score(rows, bb), scorer.score(whole, bb))
    assert not rows.gathered
    assert torch.equal(rows.gather(), whole) and rows.gathered


def test_cascade_session_crops_in_place_like_a_gathering_scorer():
    """A cascade session on ``MLPScorer`` (crops from the step's batch)
    and one on the same scorer behind ``CallableScorer`` (the survivors'
    whole frames gathered) give bit-identical stage-2 scores, decisions
    and queue seqs; ``cascade.frames_gathered`` reads 0 on the first and
    the survivor count on the second."""
    from repro_torch.core.utility import train_utility_model
    C, T, H, W = 3, 6, 24, 32
    frames = np.stack([generate_scenario(s, num_frames=4 * T, height=H,
                                         width=W, vehicle_rate=0.3)
                       .frames_rgb() for s in range(C)]).astype(np.float32)
    rng = np.random.default_rng(5)
    pfs = rng.dirichlet(np.ones(64), (40, 2)).reshape(40, 2, 8, 8)
    model = train_utility_model(pfs.astype(np.float32), rng.random(40) < 0.5,
                                [tcore.RED, tcore.YELLOW], op="or")
    scorer = tsc.MLPScorer.init(2, roi_size=8, hidden=8, device="cpu")
    seen = []

    def whole(f, b):
        seen.append(tuple(f.shape))
        return scorer.score(f, b)

    q = tcore.Query.any_of("red", "yellow", latency_bound=1.0, fps=10.0)
    a, b = (tcore.ShedSession(q, C, device="cpu", model=model,
                              frame_shape=(H, W),
                              cascade=tsc.Cascade(s, window=64))
            for s in (scorer, tsc.CallableScorer(whole)))
    for s in (a, b):
        s.report_backend_latency(0.15)
    survivors = 0
    for i in range(4):
        batch = frames[:, i * T:(i + 1) * T]
        ra, rb = a.step(batch, tick=True), b.step(batch, tick=True)
        np.testing.assert_array_equal(ra.s2_scores, rb.s2_scores)
        np.testing.assert_array_equal(ra.decisions, rb.decisions)
        np.testing.assert_array_equal(ra.pushed_seq, rb.pushed_seq)
        n = int((rb.decisions != SHED_ADMISSION).sum())
        assert seen[-1] == (n, H, W, 3)
        survivors += n
        assert a.metrics.counter("cascade.frames_gathered").value == 0
        assert b.metrics.counter("cascade.frames_gathered").value == survivors
    assert len(seen) == 4 and survivors > 0
    assert b.stats.dropped_admission > 0 and b.stats.dropped_cascade > 0

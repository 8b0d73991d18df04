"""The port's video data pipeline (``repro_torch.data.pipeline``) against
the reference's ``repro.data.pipeline`` on the same seeded scenarios:
PFs, hue fractions and utilities within atol 1e-4 / rtol 1e-5 (the
reference's own kernel-vs-oracle tolerance: the gain's frame sums are
taken in another order), labels, objects and timestamps exact; chunked
ingest equals one long batch."""
import jax  # noqa: F401  (both packages in one process, as the tests run)
import numpy as np
import pytest

import repro.core as jcore
import repro.data.pipeline as jp
import repro_torch.data.pipeline as tp
from repro.data.synthetic import generate_dataset as j_generate_dataset
from repro_torch.convert import model_from_numpy
from repro_torch.core.colors import RED, YELLOW, rgb_to_hsv_np
from repro_torch.data.synthetic import generate_dataset

ATOL, RTOL = 1e-4, 1e-5
H, W, T = 24, 40, 40


def _scenes(n, seed=0):
    return generate_dataset(range(seed, seed + n), num_frames=T, height=H,
                            width=W)


def _models():
    """A trained reference model and the same model in the port."""
    jscs = j_generate_dataset(range(50, 52), num_frames=T, height=H,
                              width=W)
    jc = [jcore.RED, jcore.YELLOW]
    recs = [r for i, sc in enumerate(jscs)
            for r in jp.scenario_records(sc, i, jc, op="or")]
    jm = jcore.train_utility_model(np.stack([r.pf for r in recs]),
                                   np.array([r.label for r in recs]), jc,
                                   op="or")
    tm = model_from_numpy(["red", "yellow"], jm.M_pos, jm.M_neg, jm.norm,
                          jm.op)
    return jm, tm


def _same_records(tr, jr):
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        assert (a.cam_id, a.frame_idx, a.t_gen, a.label, a.objects,
                a.busy) == (b.cam_id, b.frame_idx, b.t_gen, b.label,
                            b.objects, b.busy)
        np.testing.assert_allclose(a.pf, b.pf, atol=ATOL, rtol=RTOL)
        if np.isnan(b.utility):
            assert np.isnan(a.utility)
        else:
            assert a.utility == pytest.approx(b.utility, abs=ATOL, rel=RTOL)


def test_scenario_records_match_reference():
    jm, tm = _models()
    sc = _scenes(1, seed=3)[0]
    jsc = j_generate_dataset([3], num_frames=T, height=H, width=W)[0]
    np.testing.assert_array_equal(sc.frames_rgb(), jsc.frames_rgb())
    for jmodel, tmodel in ((None, None), (jm, tm)):
        tr = tp.scenario_records(sc, 4, [RED, YELLOW], fps=10.0,
                                 model=tmodel, batch=16, device="cpu")
        jr = jp.scenario_records(jsc, 4, [jcore.RED, jcore.YELLOW],
                                 fps=10.0, model=jmodel, batch=16)
        _same_records(tr, jr)


def test_camera_array_records_match_reference():
    jm, tm = _models()
    scs = _scenes(3, seed=10)
    jscs = j_generate_dataset(range(10, 13), num_frames=T, height=H,
                              width=W)
    tr = tp.camera_array_records(scs, [RED, YELLOW], model=tm,
                                 cam_ids=[7, 8, 9], batch=16, device="cpu")
    jr = jp.camera_array_records(jscs, [jcore.RED, jcore.YELLOW], model=jm,
                                 cam_ids=[7, 8, 9], batch=16)
    for a, b in zip(tr, jr):
        _same_records(a, b)
    merged_t, merged_j = tp.interleave_streams(tr), jp.interleave_streams(jr)
    assert [(r.cam_id, r.frame_idx) for r in merged_t] == \
        [(r.cam_id, r.frame_idx) for r in merged_j]


@pytest.mark.parametrize("batch", [7, 16, 64])
def test_chunked_ingest_equals_one_batch(batch):
    """Carried (bg, gain) lanes make any chunking equal one long batch —
    exactly, on the same device — and equal the reference within
    tolerance; the returned state continues the stream."""
    _, tm = _models()
    rgb = _scenes(1, seed=5)[0].frames_rgb().astype(np.float32)
    colors = [RED, YELLOW]
    one = tp.ingest_stream(rgb, colors, tm, batch=T, device="cpu")
    chunked = tp.ingest_stream(rgb, colors, tm, batch=batch, device="cpu")
    for a, b in zip(one[:3], chunked[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(one[3].bg.numpy(), chunked[3].bg.numpy())
    half = T // 2
    first = tp.ingest_stream(rgb[:half], colors, tm, batch=batch,
                             device="cpu")
    second = tp.ingest_stream(rgb[half:], colors, tm, state=first[3],
                              batch=batch, device="cpu")
    np.testing.assert_array_equal(
        np.concatenate([first[2], second[2]]), one[2])
    jres = jp.ingest_stream(rgb, [jcore.RED, jcore.YELLOW], None,
                            batch=batch)
    tres = tp.ingest_stream(rgb, colors, None, batch=batch, device="cpu")
    np.testing.assert_allclose(tres[0], jres[0], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tres[1], jres[1], atol=ATOL, rtol=RTOL)
    assert tres[2] is None and jres[2] is None
    np.testing.assert_allclose(tres[3].bg.numpy(), np.asarray(jres[3].bg),
                               atol=ATOL, rtol=RTOL)


def test_features_from_hsv_match_reference(rng):
    rgb = _scenes(1, seed=2)[0].frames_rgb()[:9]
    hsv = rgb_to_hsv_np(rgb)
    fg = rng.random(hsv.shape[:3]) < 0.6
    colors = [RED, YELLOW]
    jc = [jcore.RED, jcore.YELLOW]
    for mask in (None, fg):
        got = tp.features_from_hsv(hsv, colors, mask, batch=4, device="cpu")
        want = jp.features_from_hsv(hsv, jc, mask, batch=4)
        assert got.shape == (9, 2, 8, 8)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_reference_impl_keywords_are_accepted_no_ops(rng):
    """The reference's ``impl=``/``interpret=`` keywords, accepted past
    ``open_session`` at every place the reference takes them, change
    nothing: each call gives what the call without them gives."""
    import torch

    import repro_torch.core as tcore
    from repro_torch.cascade import fit as tfit
    from repro_torch.kernels.hsv_features import ops

    noop = dict(impl="pallas", interpret=True)
    scs = _scenes(2)
    colors = [RED, YELLOW]
    frames = np.stack([sc.frames_rgb()[:6] for sc in scs]).astype(np.float32)

    def same(a, b):
        if isinstance(a, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (np.ndarray, torch.Tensor)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        elif hasattr(a, "__dict__"):
            same(vars(a), vars(b))
        else:
            assert a == b

    def twice(fn, *args, **kw):
        same(fn(*args, **kw), fn(*args, **kw, **noop))

    _, tm = _models()
    twice(tp.ingest_stream, frames[0], colors, tm, batch=4, device="cpu")
    twice(tp.camera_array_records, scs, colors, model=tm, batch=16,
          device="cpu")
    rgb = torch.as_tensor(frames)
    twice(ops.ingest_pipeline, rgb, colors, tm, with_bbox=True)
    M_pos, norm, op = ops.query_constants(tm, 2, 8, 8, "or", device="cpu")
    flat = rgb.reshape(2, 6, H * W, 3)
    kw = dict(hue_ranges=tuple(tuple(c.hue_ranges) for c in colors), bs=8,
              bv=8, alpha=0.05, threshold=18.0, use_fg=True, bg_valid=False,
              op=op)
    twice(ops.ingest_core, flat, torch.zeros(2, H * W), torch.ones(2),
          M_pos, norm, **kw)
    twice(tfit.collect_examples, scs, [RED], device="cpu")
    fit_kw = dict(op="or", roi_size=8, hidden=8, steps=3, batch_size=16,
                  device="cpu")
    a = tfit.fit_scorer(scs, [RED], **fit_kw)
    b = tfit.fit_scorer(scs, [RED], **fit_kw, **noop)
    same(a[0].params, b[0].params)
    same(a[1], b[1])

    q = tcore.Query.any_of("red", "yellow")
    sa, sb = (tcore.open_session(q, 2, model=tm, device="cpu",
                                 train_utilities=np.linspace(0, 1, 20))
              for _ in range(2))
    same(sa.ingest(frames[:, :3]), sb.ingest(frames[:, :3], **noop))
    same(sa.step(frames[:, 3:]), sb.step(frames[:, 3:], **noop))
    u = rng.uniform(0, 1, (2, 4)).astype(np.float32)
    same(sa.step(utilities=u), sb.step(utilities=u, **noop))

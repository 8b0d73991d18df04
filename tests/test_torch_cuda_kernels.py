"""The CUDA ``ingest_batch`` and ``hsv_hist`` kernels vs their plain
PyTorch versions on the card (``pytest -m cuda``), and the torch control
plane on the card vs its NumPy host twins and a CPU session. Each test
skips itself when no card is present, so every worker collects the same
tests.

``hsv_hist`` (``kernel.compare_hist_with_plain``): exact with a bool
mask (int32 counters) and with 0/1 float weights; fractional float
weights within ``kernel.HIST_FLOAT_RTOL`` times the frame's weight sum.

Tolerance (``kernel.compare_with_plain``): bg and gain at atol 1e-4 /
rtol 1e-5; utility at that tolerance in every frame, widened only by what
that frame's differing counts can move it; the bounding box exactly in
every frame whose integer outputs agree; integer outputs may differ in at
most 1e-5 of the pixels and 5 % of the frames, because the gain's frame
sums are taken in another order and a pixel within rounding of the
foreground threshold can flip."""
import numpy as np
import pytest
import torch

from repro_torch.core import Query, open_session
from repro_torch.core import shed_queue as sq
from repro_torch.core.colors import BLUE, GREEN, RED, YELLOW
from repro_torch.kernels.hsv_features import kernel, ref

pytestmark = pytest.mark.cuda

HR = tuple(tuple(c.hue_ranges) for c in (RED, YELLOW, BLUE, GREEN))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(seed, C, T, n, nc, dev):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    rgb = rng.uniform(0, 255, (C, T, n, 3))
    # a static scene with a moving patch, so foreground is sparse as in video
    rgb[:, :, :] = rgb[:, :1, :]
    rgb[:, :, : n // 7] = rng.uniform(0, 255, (C, T, n // 7, 3))
    bg0 = np.max(rgb[:, 0], axis=-1) + rng.normal(0, 5, (C, n))
    return (t(rgb), t(bg0), t(rng.uniform(0.7, 1.3, C)),
            t(rng.uniform(0, 1, (nc, 64))), t(rng.uniform(0.3, 1.0, nc)))


def _run(dev, C, T, n, nc, width=0, seed=0, **kw):
    rgb, bg0, gain0, M, norm = _inputs(seed, C, T, n, nc, dev)
    args = (rgb, bg0, gain0, M, norm, HR[:nc])
    before = kernel.ingest_batch.launches
    got = kernel.ingest_batch(*args, width=width, **kw)
    torch.cuda.synchronize()
    assert kernel.ingest_batch.launches == before + 1
    want = ref.ingest_batch_ref(*args, width=width, **kw)
    return kernel.compare_with_plain(got, want, M, norm)


@pytest.mark.parametrize("nc", [1, 2, 4])
@pytest.mark.parametrize("n", [257, 4096, 4196, 8209])
def test_kernel_small_ragged_tiles(nc, n):
    """Pixel counts on, under and past the 4096-pixel tile (ragged last
    tile masked in the kernel) with 1, 2 and 4 colors."""
    dev = _card()
    _run(dev, 2, 3, n, nc, seed=n + nc)


@pytest.mark.parametrize("bg_valid", [True, False])
@pytest.mark.parametrize("use_fg", [True, False])
@pytest.mark.parametrize("op", ["or", "and"])
def test_kernel_state_and_options(bg_valid, use_fg, op):
    dev = _card()
    _run(dev, 3, 4, 40 * 24, 2, width=40, bg_valid=bg_valid, use_fg=use_fg,
         op=op)


def test_kernel_scalar_gain_and_single_camera():
    """A scalar gain0 broadcasts to every lane; the single-camera form
    drops the camera axis."""
    dev = _card()
    rgb, bg0, _, M, norm = _inputs(1, 2, 3, 5000, 2, dev)
    got = kernel.ingest_batch(rgb, bg0, 1.25, M, norm, HR[:2])
    want = ref.ingest_batch_ref(rgb, bg0, 1.25, M, norm, HR[:2])
    kernel.compare_with_plain(got, want, M, norm)
    one = kernel.ingest_batch(rgb[0], bg0[0], 1.25, M, norm, HR[:2])
    for a, b in zip(one, got):
        torch.testing.assert_close(a, b[0], rtol=0, atol=0)


def test_kernel_full_width():
    """The main path's shape: 8 cameras x 8 frames of 720x1280, with the
    bounding box."""
    dev = _card()
    rep = _run(dev, 8, 8, 720 * 1280, 2, width=1280, seed=7)
    assert rep["max_abs_err"] <= kernel.ATOL


def test_kernel_rejects_bad_inputs():
    dev = _card()
    rgb, bg0, gain0, M, norm = _inputs(2, 1, 2, 300, 1, dev)
    with pytest.raises(ValueError):
        kernel.ingest_batch(rgb.double(), bg0, gain0, M, norm, HR[:1])
    with pytest.raises(ValueError):
        kernel.ingest_batch(rgb, bg0[:, :10], gain0, M, norm, HR[:1])
    with pytest.raises(ValueError):
        kernel.ingest_batch(rgb, bg0, gain0, M, norm, HR[:1] * 5)


def _hist(dev, T, n, nc, weights, seed=0, bs=8, bv=8):
    rng = np.random.default_rng(seed)
    rgb = torch.as_tensor(rng.uniform(0, 255, (T, n, 3)).astype(np.float32),
                          device=dev)
    if weights == "bool":
        fg = torch.as_tensor(rng.random((T, n)) < 0.6, device=dev)
    elif weights == "binary":
        fg = torch.as_tensor((rng.random((T, n)) < 0.6).astype(np.float32),
                             device=dev)
    else:
        fg = torch.as_tensor(rng.random((T, n)).astype(np.float32),
                             device=dev)
    before = kernel.hsv_hist_batch.launches
    got = kernel.hsv_hist_batch(rgb, fg, HR[:nc], bs, bv)
    torch.cuda.synchronize()
    assert kernel.hsv_hist_batch.launches == before + 1
    want = ref.hsv_hist_ref(rgb, fg, HR[:nc], bs, bv)
    rep = kernel.compare_hist_with_plain(got, want, fg)
    if weights != "fractional":
        assert rep["count_units_differing"] == 0
    return rep


@pytest.mark.parametrize("weights", ["bool", "binary", "fractional"])
@pytest.mark.parametrize("nc", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [17, 4096, 4097, 3 * 4096 + 100])
def test_hist_ragged_colors_and_weights(weights, nc, n):
    """Pixel counts under, on and past the 4096-pixel tile, every
    supported color count, bool masks and float weights."""
    dev = _card()
    _hist(dev, 3, n, nc, weights, seed=n + nc)


@pytest.mark.parametrize("bs,bv", [(4, 4), (16, 16)])
def test_hist_bin_sizes(bs, bv):
    dev = _card()
    _hist(dev, 2, 5000, 1, "bool", bs=bs, bv=bv)


@pytest.mark.parametrize("weights", ["bool", "fractional"])
def test_hist_full_width(weights):
    """The hist phase's shape: 64 frames of 720x1280, two colors."""
    dev = _card()
    _hist(dev, 64, 720 * 1280, 2, weights, seed=3)


def test_hist_single_frame_and_deterministic_float_sums():
    dev = _card()
    rng = np.random.default_rng(4)
    rgb = torch.as_tensor(rng.uniform(0, 255, (9000, 3)).astype(np.float32),
                          device=dev)
    w = torch.as_tensor(rng.random(9000).astype(np.float32), device=dev)
    one = kernel.hsv_hist(rgb, w, HR[:2])
    again = kernel.hsv_hist(rgb, w, HR[:2])
    assert [tuple(o.shape) for o in one] == [(2, 64), (2,), ()]
    for a, b in zip(one, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_hist_rejects_bad_inputs():
    dev = _card()
    rgb = torch.zeros((2, 300, 3), device=dev)
    fg = torch.ones((2, 300), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        kernel.hsv_hist_batch(rgb.double(), fg, HR[:1])
    with pytest.raises(ValueError):
        kernel.hsv_hist_batch(rgb, fg[:, :10], HR[:1])
    with pytest.raises(ValueError):
        kernel.hsv_hist_batch(rgb, fg.to(torch.int32), HR[:1])
    with pytest.raises(ValueError):
        kernel.hsv_hist_batch(rgb, fg, HR[:1] * 5)
    with pytest.raises(ValueError):
        kernel.hsv_hist_batch(rgb, fg, HR[:2], 16, 16)   # 512 counters
    with pytest.raises(ValueError):
        kernel.hsv_hist_batch(rgb, fg.cpu(), HR[:1])


@pytest.mark.parametrize("subnormal", [False, True])
def test_queue_lanes_on_card_match_host_twin(subnormal):
    """Mixed batch/single pushes, resizes and pops: CUDA lanes stay bit
    for bit with the NumPy host twins — with the subnormal pool
    ``[0.0, 1.4e-45]`` too (no flush to zero on the card's path)."""
    dev = _card()
    rng = np.random.default_rng(5 + subnormal)
    C, K, T = 3, 6, 5
    pool = ([np.float32(0.0), np.float32(1.401298464324817e-45)] if subnormal
            else [0.1, 0.2, 0.5, 0.5, 0.9])
    cap = rng.integers(1, K + 1, C).astype(np.int32)
    hu, hs, hn = sq.make_lanes_host(C, K)
    du, ds, dn = sq.make_lanes(C, K, device=dev)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    for _ in range(60):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            u = rng.choice(pool, (C, T)).astype(np.float32)
            admit = rng.random((C, T)) < 0.8
            du, ds, dn, dp, des, deb = sq.push_batch_dev(
                du, ds, dn, t(u), t(admit), t(cap))
            hn, hp, hes, heb = sq.push_batch_host(hu, hs, hn, u, admit, cap)
            for a, b in ((dp, hp), (des, hes), (deb, heb)):
                np.testing.assert_array_equal(a.cpu().numpy(), b)
        elif kind == 1:
            u = rng.choice(pool, C).astype(np.float32)
            do = rng.random(C) < 0.7
            du, ds, dn, dp, des, _ = sq.push_one_dev(du, ds, dn, t(u), t(do),
                                                     t(cap))
            hn, hp, hes, _ = sq.push_one_host(hu, hs, hn, u, do, cap)
            np.testing.assert_array_equal(des.cpu().numpy(), hes)
        elif kind == 2:
            cap = rng.integers(1, K + 1, C).astype(np.int32)
            du, ds, des = sq.resize_dev(du, ds, t(cap))
            np.testing.assert_array_equal(des.cpu().numpy(),
                                          sq.resize_host(hu, hs, cap))
        else:
            k = int(rng.integers(1, 5))
            du, ds, dc, dq = sq.pop_topk_dev(du, ds, k)
            hc, hq = sq.pop_topk_host(hu, hs, k)
            np.testing.assert_array_equal(dc.cpu().numpy(), hc)
            np.testing.assert_array_equal(dq.cpu().numpy(), hq)
        np.testing.assert_array_equal(du.cpu().numpy(), hu)
        np.testing.assert_array_equal(ds.cpu().numpy(), hs)
        np.testing.assert_array_equal(dn.cpu().numpy(), hn)


@pytest.mark.parametrize("exact_tick", [False, True])
def test_session_control_on_card_matches_cpu(exact_tick):
    """A seeded utilities trace through a card session and a CPU
    session: decisions, evictions, rates, state lanes and pops equal."""
    dev = _card()
    rng = np.random.default_rng(9)
    C, T = 4, 12
    hist = rng.uniform(0, 1, 300).astype(np.float32)
    q = Query.any_of("red", "yellow")
    a, b = (open_session(q, C, device=d, train_utilities=hist,
                         cdf_window=256, queue_capacity=16,
                         exact_tick=exact_tick) for d in (dev, "cpu"))
    for i in range(12):
        lat = float(rng.uniform(0.01, 0.05))
        cam = int(rng.integers(C)) if i % 3 == 1 else None
        u = rng.uniform(0, 1, (C, T)).astype(np.float32)
        for s in (a, b):
            s.report_backend_latency(lat, cam=cam)
        ra, rb = a.step(utilities=u), b.step(utilities=u)
        np.testing.assert_array_equal(ra.decisions, rb.decisions)
        np.testing.assert_array_equal(ra.pushed_seq, rb.pushed_seq)
        np.testing.assert_array_equal(ra.target_drop_rate, rb.target_drop_rate)
        for x, y in zip(ra.evicted, rb.evicted):
            np.testing.assert_array_equal(x, y)
        assert a.next_frames(7) == b.next_frames(7)
    da, db = a.state.as_dict(), b.state.as_dict()
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)

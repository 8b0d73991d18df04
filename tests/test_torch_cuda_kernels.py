"""The CUDA ``ingest_batch``, ``hsv_hist`` and ``flash_attention``
kernels vs their plain PyTorch versions on the card (``pytest -m cuda``),
and the torch control plane on the card vs its NumPy host twins and a CPU
session. Each test skips itself when no card is present, so every worker
collects the same tests.

``flash_attention``: against ``attention_ref`` on the card at the
reference's Pallas-vs-oracle tolerance, atol = rtol = 2e-6 for float32
and 2e-2 for bfloat16 (``kernel.TOL``); rows with no visible key exactly
0. The bfloat16 tensor-core kernel also at its own edges: GQA groups,
a few queries at the tail of ragged keys, windows narrower than a tile
and wider than the keys, key counts one off a tile multiple, bit-identical
repeats and the refusal of views its cp.async cannot load.

``hsv_hist`` (``kernel.compare_hist_with_plain``): exact with a bool
mask (int32 counters), with 0/1 float weights and with dyadic k/8
weights (their sums are exact in float32); other fractional float
weights within ``kernel.HIST_FLOAT_RTOL`` times the frame's weight sum.
Also at the kernel's own edges: one device launch a call, empty, full
and isolated-pixel masks, zero weights over NaN and inf RGB (skipped
pixels add nothing), -0.0 weights, unaligned frames and views (scalar
loads, bit-identical to an aligned copy), and calls on two streams at
once (each stream has its own frame tickets).

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
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention.ops import flash_attention_bsnh
from repro_torch.kernels.flash_attention.ref import attention_ref
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


def test_kernel_more_cameras_than_resident_blocks():
    """More cameras than the card holds blocks of the kernel at once:
    each block owns several (camera, tile) items on every frame."""
    dev = _card()
    C = kernel.resident_blocks(dev) + 37
    plan = kernel.work_plan(C, 300, kernel.resident_blocks(dev))
    assert plan.grid < C * plan.ntiles
    assert max(len(plan.items(b)) for b in range(plan.grid)) >= 2
    _run(dev, C, 3, 300, 2, seed=11)


@pytest.mark.parametrize("T", [1, 16])
def test_kernel_one_and_sixteen_frames(T):
    """No barrier between frames at T=1; sixteen at T=16."""
    dev = _card()
    _run(dev, 3, T, 5000, 2, width=50, seed=T)


@pytest.mark.parametrize("n", [1, 4097, 8210, 720 * 1280 + 3])
def test_kernel_ragged_pixel_counts(n):
    """N not a multiple of 4: frames whose rows stay 16-byte aligned take
    the 16-byte staged copies and a scalar tail of N % 4 pixels, the
    others scalar loads throughout."""
    dev = _card()
    _run(dev, 3, 3, n, 2, seed=n)


def test_kernel_unaligned_rgb_view_takes_scalar_loads():
    """An rgb view 4 bytes past a 16-byte boundary is accepted (not
    rejected): every tile then takes the scalar loads. A thread meets the
    same pixels in the same order on either path, so the outputs equal an
    aligned copy's bit for bit, and meet the plain version."""
    dev = _card()
    rgb, bg0, gain0, M, norm = _inputs(12, 2, 3, 4096, 2, dev)
    flat = torch.empty(rgb.numel() + 1, device=dev)
    shifted = flat[1:].view(rgb.shape)
    shifted.copy_(rgb)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    args = (bg0, gain0, M, norm, HR[:2])
    got = kernel.ingest_batch(shifted, *args, width=64)
    aligned = kernel.ingest_batch(rgb, *args, width=64)
    want = ref.ingest_batch_ref(rgb, *args, width=64)
    kernel.compare_with_plain(got, want, M, norm)
    for x, y in zip(got, aligned):
        assert torch.equal(x, y)


def test_kernel_repeats_bit_identical():
    """The gain is reduced in one fixed order and the counters are exact:
    two calls on the same inputs agree bit for bit, the gain included."""
    dev = _card()
    rgb, bg0, gain0, M, norm = _inputs(13, 8, 8, 720 * 1280, 2, dev)
    args = (rgb, bg0, gain0, M, norm, HR[:2])
    a = kernel.ingest_batch(*args, width=1280)
    b = kernel.ingest_batch(*args, width=1280)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_one_device_launch_a_call():
    """A profiled call shows exactly one device kernel, the ingest
    kernel. The profiler now and then delivers no device event for a
    whole session; such a session is tried again, up to three in all."""
    from torch.profiler import ProfilerActivity, profile
    dev = _card()
    rgb, bg0, gain0, M, norm = _inputs(14, 4, 8, 40000, 2, dev)
    args = (rgb, bg0, gain0, M, norm, HR[:2])
    kernel.ingest_batch(*args)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            kernel.ingest_batch(*args)
            torch.cuda.synchronize()
        events = [(e.key, e.count) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and (e.self_device_time_total or 0) > 0]
        if events:
            break
    assert len(events) == 1 and events[0][1] == 1, events
    assert "ingest_kernel" in events[0][0]
    assert kernel.DEVICE_LAUNCHES_PER_CALL == 1


def _hist(dev, T, n, nc, weights, seed=0, bs=8, bv=8):
    rng = np.random.default_rng(seed)
    rgb = torch.as_tensor(rng.uniform(0, 255, (T, n, 3)).astype(np.float32),
                          device=dev)
    if weights == "bool":
        fg = torch.as_tensor(rng.random((T, n)) < 0.6, device=dev)
    elif weights == "binary":
        fg = torch.as_tensor((rng.random((T, n)) < 0.6).astype(np.float32),
                             device=dev)
    elif weights == "dyadic":
        w = rng.integers(1, 9, (T, n)) / 8.0 * (rng.random((T, n)) < 0.6)
        fg = torch.as_tensor(w.astype(np.float32), device=dev)
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


@pytest.mark.parametrize("weights", ["bool", "binary", "fractional",
                                     "dyadic"])
@pytest.mark.parametrize("nc", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [17, 4096, 4097, 3 * 4096 + 100])
def test_hist_ragged_colors_and_weights(weights, nc, n):
    """Pixel counts under, on and past the 4096-pixel tile, every
    supported color count, bool masks and float weights. Dyadic weights
    k/8 sum exactly in float32 in any order, so they are held exactly: a
    lane's weight misplaced in the warp combine would show there."""
    dev = _card()
    _hist(dev, 3, n, nc, weights, seed=n + nc)


@pytest.mark.parametrize("bs,bv", [(4, 4), (16, 16)])
def test_hist_bin_sizes(bs, bv):
    dev = _card()
    _hist(dev, 2, 5000, 1, "bool", bs=bs, bv=bv)


@pytest.mark.parametrize("weights", ["bool", "fractional", "dyadic"])
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


def _device_events(fn, calls):
    """(kernel name, launches) of the device kernels of ``calls`` calls of
    ``fn`` in one ``torch.profiler`` window, after a warm-up call. After
    many earlier card tests in one process the profiler drops the first
    device launch of every window, so the window opens with a marker
    kernel (an in-place multiply) whose events are left out."""
    from torch.profiler import ProfilerActivity, profile
    marker = torch.ones(1024, device=torch.cuda.current_device())
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        marker.mul_(1.0)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and (e.self_device_time_total or 0) > 0
            and "elementwise" not in e.key]


@pytest.mark.parametrize("weights", ["bool", "fractional"])
def test_hist_one_device_launch_a_call(weights):
    """Three profiled calls show exactly one device kernel, the histogram
    kernel, launched three times: no memset, no second pass."""
    dev = _card()
    rng = np.random.default_rng(20)
    rgb = torch.as_tensor(rng.uniform(0, 255, (8, 40000, 3))
                          .astype(np.float32), device=dev)
    fg = rng.random((8, 40000))
    fg = torch.as_tensor(fg < 0.3 if weights == "bool"
                         else fg.astype(np.float32), device=dev)
    events = _device_events(lambda: kernel.hsv_hist_batch(rgb, fg, HR[:2]),
                            calls=3)
    assert len(events) == 1 and events[0][1] == 3, events
    assert "hist_kernel" in events[0][0]
    assert kernel.HIST_DEVICE_LAUNCHES_PER_CALL == 1


def _hist_case(dev, rgb, fg, nc=2):
    got = kernel.hsv_hist_batch(rgb, fg, HR[:nc])
    torch.cuda.synchronize()
    want = ref.hsv_hist_ref(rgb, fg, HR[:nc])
    rep = kernel.compare_hist_with_plain(got, want, fg)
    return got, want, rep


@pytest.mark.parametrize("weights", ["bool", "binary", "dyadic"])
@pytest.mark.parametrize("mask", ["empty", "full", "isolated", "blocks"])
def test_hist_sparse_and_dense_masks(mask, weights):
    """An all-zero mask (no RGB read: every output 0), an all-true mask,
    isolated single pixels (the worst sector efficiency: one pixel of a
    quad, of a warp) and 8x8-pixel blocks as the hist phase's mask has:
    exact against the plain version."""
    dev = _card()
    rng = np.random.default_rng(21)
    T, h, w = 5, 72, 128
    rgb = torch.as_tensor(rng.uniform(0, 255, (T, h * w, 3))
                          .astype(np.float32), device=dev)
    m = np.zeros((T, h, w), bool)
    if mask == "full":
        m[:] = True
    elif mask == "isolated":
        m.reshape(T, -1)[:, rng.choice(h * w, 40, replace=False)] = True
    elif mask == "blocks":
        m = np.repeat(np.repeat(rng.random((T, h // 8, w // 8)) < 0.1, 8,
                                axis=1), 8, axis=2)
    fg = torch.as_tensor(m.reshape(T, -1), device=dev)
    if weights == "binary":
        fg = fg.float()
    elif weights == "dyadic":
        fg = fg * torch.as_tensor(rng.integers(1, 9, (T, h * w)) / 8.0,
                                  dtype=torch.float32, device=dev)
    got, _, rep = _hist_case(dev, rgb, fg)
    assert rep["count_units_differing"] == 0
    if mask == "empty":
        assert all(not bool(o.any()) for o in got)


@pytest.mark.parametrize("weights", ["bool", "binary", "fractional"])
def test_hist_zero_weights_over_nan_and_inf_rgb(weights):
    """Pixels under a zero weight hold NaN and +-inf RGB: the kernel
    skips them, and the plain version, which multiplies each by its zero
    weight, adds nothing for them either."""
    dev = _card()
    rng = np.random.default_rng(22)
    T, n = 3, 9000
    rgb = rng.uniform(0, 255, (T, n, 3)).astype(np.float32)
    on = rng.random((T, n)) < 0.4
    bad = np.array([np.nan, np.inf, -np.inf], np.float32)
    rgb[~on] = bad[rng.integers(0, 3, (int((~on).sum()), 3))]
    w = (on if weights == "bool" else on.astype(np.float32)
         * (1.0 if weights == "binary" else rng.uniform(0.1, 1.0, (T, n))
            .astype(np.float32)))
    rgb_t = torch.as_tensor(rgb, device=dev)
    fg = torch.as_tensor(w, device=dev)
    got, want, rep = _hist_case(dev, rgb_t, fg)
    assert all(bool(torch.isfinite(o).all()) for o in got + want)
    if weights != "fractional":
        assert rep["count_units_differing"] == 0


def test_hist_negative_zero_weights():
    """-0.0 weights are skipped like +0.0: the sums start at +0.0, so the
    outputs equal those with +0.0 there bit for bit."""
    dev = _card()
    rng = np.random.default_rng(23)
    rgb = torch.as_tensor(rng.uniform(0, 255, (2, 5000, 3))
                          .astype(np.float32), device=dev)
    w = rng.random((2, 5000)).astype(np.float32)
    w[w < 0.5] = 0.0
    neg = np.where(w == 0.0, np.float32(-0.0), w)
    assert np.signbit(neg).sum() > 0
    a = kernel.hsv_hist_batch(rgb, torch.as_tensor(w, device=dev), HR[:2])
    b = kernel.hsv_hist_batch(rgb, torch.as_tensor(neg, device=dev), HR[:2])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    kernel.compare_hist_with_plain(
        b, ref.hsv_hist_ref(rgb, torch.as_tensor(neg, device=dev), HR[:2]),
        torch.as_tensor(neg, device=dev))


@pytest.mark.parametrize("weights", ["bool", "fractional"])
@pytest.mark.parametrize("n", [1, 3, 4097, 720 * 1280 + 3])
def test_hist_pixel_counts_not_multiple_of_four(n, weights):
    """N % 4 != 0: frame 0 is 16-byte aligned (vector loads and a scalar
    last quad), the frames after it are not (scalar loads throughout)."""
    dev = _card()
    _hist(dev, 3, n, 2, weights, seed=n)


@pytest.mark.parametrize("weights", ["bool", "fractional"])
def test_hist_unaligned_views_take_scalar_loads(weights):
    """RGB and weights as views 4 bytes (one element) past a 16-byte
    boundary take scalar loads with the same pixel-to-thread map, so the
    outputs equal an aligned copy's bit for bit."""
    dev = _card()
    rng = np.random.default_rng(24)
    rgb = torch.as_tensor(rng.uniform(0, 255, (3, 8192, 3))
                          .astype(np.float32), device=dev)
    w = rng.random((3, 8192))
    fg = torch.as_tensor(w < 0.5 if weights == "bool"
                         else w.astype(np.float32), device=dev)
    flat = torch.empty(rgb.numel() + 1, device=dev)
    rgb_s = flat[1:].view(rgb.shape)
    rgb_s.copy_(rgb)
    fflat = torch.empty(fg.numel() + 1, dtype=fg.dtype, device=dev)
    fg_s = fflat[1:].view(fg.shape)
    fg_s.copy_(fg)
    assert rgb_s.data_ptr() % 16 == 4
    assert fg_s.data_ptr() % (4 * fg.element_size()) != 0
    got = kernel.hsv_hist_batch(rgb_s, fg_s, HR[:2])
    aligned = kernel.hsv_hist_batch(rgb, fg, HR[:2])
    kernel.compare_hist_with_plain(got, ref.hsv_hist_ref(rgb, fg, HR[:2]),
                                   fg)
    for x, y in zip(got, aligned):
        assert torch.equal(x, y)


def test_hist_concurrent_calls_on_two_streams():
    """Calls on two streams at once, each many frames deep, use their own
    frame tickets: every call meets the plain version, and a stream's
    repeats are bit-identical."""
    dev = _card()
    rng = np.random.default_rng(25)
    rgb = [torch.as_tensor(rng.uniform(0, 255, (32, 50000, 3))
                           .astype(np.float32), device=dev)
           for _ in range(2)]
    fg = [torch.as_tensor(rng.random((32, 50000)).astype(np.float32),
                          device=dev),
          torch.as_tensor(rng.random((32, 50000)) < 0.3, device=dev)]
    want = [ref.hsv_hist_ref(r, f, HR[:2]) for r, f in zip(rgb, fg)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(4):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(kernel.hsv_hist_batch(rgb[i], fg[i], HR[:2]))
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            kernel.compare_hist_with_plain(got, want[i], fg[i])
            for x, y in zip(got, outs[i][0]):
                assert torch.equal(x, y)


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


def _traffic(C, F, H, W, seed=0):
    """(C, F, H, W, 3) float32 frames of seeded synthetic traffic scenes."""
    from repro_torch.data.synthetic import generate_scenario
    return np.stack([generate_scenario(seed + c, num_frames=F, height=H,
                                       width=W, vehicle_rate=0.3).frames_rgb()
                     for c in range(C)]).astype(np.float32)


@pytest.mark.parametrize("bg_valid", [False, True])
def test_bbox_instantiation_on_cascade_frames(bg_valid):
    """The cascade step's ingest (``width > 0``) on traffic frames: the
    bboxes and utilities equal to the plain version's (within
    ``compare_with_plain``), with foreground in most frames."""
    dev = _card()
    C, T, H, W = 4, 8, 96, 160
    frames = torch.as_tensor(_traffic(C, 2 * T, H, W), device=dev)
    rgb = frames[:, T:].reshape(C, T, H * W, 3).contiguous()
    bg0 = frames[:, T - 1].amax(dim=-1).reshape(C, H * W).contiguous()
    rng = np.random.default_rng(3)
    M = torch.as_tensor(rng.uniform(0, 1, (2, 64)).astype(np.float32),
                        device=dev)
    norm = torch.as_tensor(rng.uniform(0.3, 1, 2).astype(np.float32),
                           device=dev)
    args = (rgb, bg0, torch.ones(C, device=dev), M, norm, HR[:2])
    got = kernel.ingest_batch(*args, width=W, bg_valid=bg_valid)
    want = ref.ingest_batch_ref(*args, width=W, bg_valid=bg_valid)
    rep = kernel.compare_with_plain(got, want, M, norm)
    assert rep["frames_differing"] == 0
    assert torch.equal(got[6], want[6])
    assert int((got[6][..., 0] >= 0).sum()) > C * T // 2


def test_cascade_step_on_card_matches_cpu_replay():
    """Ticked ``step(frames)`` calls of a card cascade session against a
    CPU cascade session given the card's utilities and stage-2 scores:
    decisions, queue seqs, evictions, rates, thresholds, s2 thresholds
    and pops bit-identical; the card scorer within 1e-5 of the CPU's on
    the same survivors."""
    from repro_torch.cascade import Cascade, CallableScorer, MLPScorer
    from repro_torch.convert import state_from_numpy
    from repro_torch.core.utility import train_utility_model
    dev = _card()
    C, T, H, W = 4, 6, 96, 160
    frames = _traffic(C, 5 * T, H, W, seed=10)
    rng = np.random.default_rng(8)
    pfs = rng.dirichlet(np.ones(64), (60, 2)).reshape(60, 2, 8, 8)
    model = train_utility_model(pfs.astype(np.float32), rng.random(60) < 0.5,
                                [RED, YELLOW], op="or")
    scorer = MLPScorer.init(4, device=dev)
    cpu_scorer = MLPScorer(params={k: v.cpu() for k, v in
                                   scorer.params.items()})
    seen = []

    def spy(f, b):
        seen.append((f.cpu(), b.cpu()))
        return scorer.score(f, b)

    q = Query.any_of("red", "yellow")
    card = open_session(q, C, device=dev, model=model, frame_shape=(H, W),
                        cascade=Cascade(CallableScorer(spy), window=128))
    cpu = open_session(q, C, device="cpu", model=model, frame_shape=(H, W),
                       cascade=Cascade(cpu_scorer, window=128))
    cpu.load_state(state_from_numpy(card.state.as_dict(), "cpu"))
    Wc = card.state.cdf_buf.shape[1]
    shed = np.zeros(4, np.int64)
    for i in range(5):
        lat = float(rng.uniform(0.03, 0.08))
        for s in (card, cpu):
            s.report_backend_latency(lat)
        pos = card.state.cdf_pos.cpu().numpy()
        a = card.step(frames[:, i * T:(i + 1) * T], tick=True)
        idx = (pos[:, None] + np.arange(T)[None, :]) % Wc
        util = np.take_along_axis(card.state.cdf_buf.cpu().numpy(), idx, 1)
        b = cpu.step(utilities=util, s2_utilities=a.s2_scores, tick=True)
        np.testing.assert_array_equal(a.decisions, b.decisions)
        np.testing.assert_array_equal(a.pushed_seq, b.pushed_seq)
        np.testing.assert_array_equal(a.target_drop_rate, b.target_drop_rate)
        for x, y in zip(a.evicted, b.evicted):
            np.testing.assert_array_equal(x, y)
        da, db = card.state.as_dict(), cpu.state.as_dict()
        for k in set(da) - {"bg", "gain", "bg_valid"}:   # ingest lanes
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
        assert card.next_frames(5) == cpu.next_frames(5)
        if seen:
            f, bb = seen.pop()
            np.testing.assert_allclose(
                scorer.score(f.to(dev), bb.to(dev)).cpu().numpy(),
                cpu_scorer.score(f, bb).numpy(), atol=1e-5, rtol=0)
        shed += np.bincount(a.decisions.reshape(-1), minlength=4)
    assert shed[1] > 0 and shed[3] > 0      # both gates shed


def test_cascade_step_crops_survivors_without_gathering_their_frames():
    """At 720p, with a gate that lets every frame through, a cascade
    step's memory peak exceeds a single-stage step's on the same frames
    by less than one float32 frame: the scorer crops the survivors from
    the step's batch, and ``cascade.frames_gathered`` reads 0."""
    from repro_torch.cascade import Cascade, MLPScorer
    from repro_torch.core.session import SHED_ADMISSION
    from repro_torch.core.utility import train_utility_model
    dev = _card()
    C, T, H, W, up = 8, 4, 90, 160, 8
    frames = torch.as_tensor(_traffic(C, 3 * T, H, W, seed=40),
                             device=dev).to(torch.uint8)
    frames = frames.repeat_interleave(up, 2).repeat_interleave(up, 3)
    frame_bytes = H * up * W * up * 3 * 4
    rng = np.random.default_rng(31)
    pfs = rng.dirichlet(np.ones(64), (60, 2)).reshape(60, 2, 8, 8)
    model = train_utility_model(pfs.astype(np.float32), rng.random(60) < 0.5,
                                [RED, YELLOW], op="or")
    q = Query.any_of("red", "yellow")
    kw = dict(device=dev, model=model, frame_shape=(H * up, W * up))
    casc = open_session(q, C, cascade=Cascade(MLPScorer.init(7, device=dev),
                                              window=128), **kw)
    shed = open_session(q, C, **kw)
    peaks = {}
    for i in range(3):
        batch = frames[:, i * T:(i + 1) * T].contiguous()
        for name, s in (("cascade", casc), ("shed", shed)):
            s.report_backend_latency(0.001)
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            res = s.step(batch, tick=True)
            torch.cuda.synchronize(dev)
            peaks[name] = torch.cuda.max_memory_allocated(dev) - base
            if name == "cascade":
                survivors = int((res.decisions != SHED_ADMISSION).sum())
    assert survivors >= C * T // 2
    assert casc.metrics.counter("cascade.frames_gathered").value == 0
    assert peaks["cascade"] - peaks["shed"] < frame_bytes, (peaks, survivors)


def _sharded_frames_vs_unsharded(dev, mesh):
    """Ticked ``step(frames)`` calls of a session on ``mesh`` against the
    unsharded session on ``dev`` with the same frames: decisions, every
    lane (``bg`` and ``gain`` included) and pops bit-identical, one
    ingest launch a shard a step. The frames are large enough that a
    shard planned for its own cameras would cut other tiles than the
    whole array's call."""
    from repro_torch.core.utility import train_utility_model
    C, T, H, W, up = 8, 4, 96, 160, 3
    S = mesh.size
    frames = torch.as_tensor(_traffic(C, 4 * T, H, W, seed=20), device=dev)
    frames = frames.repeat_interleave(up, 2).repeat_interleave(up, 3)
    N = H * W * up * up
    res = kernel.resident_blocks(dev)
    assert kernel.work_plan(C // S, N, res).tile != \
        kernel.work_plan(C, N, res).tile
    rng = np.random.default_rng(21)
    pfs = rng.dirichlet(np.ones(64), (60, 2)).reshape(60, 2, 8, 8)
    model = train_utility_model(pfs.astype(np.float32), rng.random(60) < 0.5,
                                [RED, YELLOW], op="or")
    q = Query.any_of("red", "yellow")
    hist = rng.uniform(0, 1, 200).astype(np.float32)
    a, b = (open_session(q, C, device=dev, model=model,
                         frame_shape=(H * up, W * up), train_utilities=hist,
                         **kw)
            for kw in ({}, dict(mesh=mesh)))
    for i in range(4):
        batch = frames[:, i * T:(i + 1) * T].contiguous()
        for s in (a, b):
            s.report_backend_latency(float(0.01 + 0.01 * i))
        ra = a.step(batch, tick=True)
        before = kernel.ingest_batch.launches
        rb = b.step(batch, tick=True)
        assert kernel.ingest_batch.launches == before + S
        np.testing.assert_array_equal(ra.decisions, rb.decisions)
        np.testing.assert_array_equal(ra.pushed_seq, rb.pushed_seq)
        np.testing.assert_array_equal(ra.target_drop_rate, rb.target_drop_rate)
        da, db = a.state.as_dict(), b.state.as_dict()
        for k in da:
            np.testing.assert_array_equal(da[k], db[k], err_msg=f"{i} {k}")
        assert a.next_frames(6) == b.next_frames(6)


def test_sharded_frames_step_on_card_matches_unsharded():
    """Two shards of one card (``fleet_mesh(2, device=card)``)."""
    from repro_torch.core.fleet import fleet_mesh
    dev = _card()
    _sharded_frames_vs_unsharded(dev, fleet_mesh(2, device=dev))


def test_sharded_frames_step_on_distinct_cards_matches_unsharded():
    """One shard a card over every visible card (``fleet_mesh()``, up to
    four), the batch on the first: each shard's rows go to its card and
    its ingest launches there (``torch.cuda.device`` guard)."""
    from repro_torch.core.fleet import fleet_mesh
    _card()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    mesh = fleet_mesh(4 if n >= 4 else 2)
    assert len(set(mesh.devices)) == mesh.size
    _sharded_frames_vs_unsharded(mesh.devices[0], mesh)


FLASH_CASES = [
    # B, Hq, Hkv, Sq, Sk, d, causal, window  (tests/test_kernels_flash.py)
    (2, 4, 2, 256, 256, 64, True, None),
    (1, 4, 4, 128, 256, 32, True, None),        # q at cache tail
    (1, 8, 2, 256, 256, 64, True, 128),         # sliding window
    (2, 2, 2, 128, 128, 64, False, None),       # bidirectional
    (1, 2, 1, 512, 512, 128, True, 64),
    (1, 16, 4, 128, 128, 64, True, None),       # wide GQA group
]


def _qkv(dev, B, Hq, Hkv, Sq, Sk, d, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev).to(dtype)
    return t((B, Hq, Sq, d)), t((B, Hkv, Sk, d)), t((B, Hkv, Sk, d))


def _flash_vs_ref(q, k, v, **kw):
    block = {x: kw.pop(x) for x in ("block_q", "block_k") if x in kw}
    before = fkernel.flash_attention.launches
    got = fkernel.flash_attention(q, k, v, **kw, **block)
    torch.cuda.synchronize()
    assert fkernel.flash_attention.launches == before + 1
    want = attention_ref(q, k, v, **kw)
    tol = fkernel.TOL[q.dtype]
    assert got.dtype == q.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    return got, want


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_reference_cases(case, dtype):
    dev = _card()
    B, Hq, Hkv, Sq, Sk, d, causal, window = case
    q, k, v = _qkv(dev, B, Hq, Hkv, Sq, Sk, d, dtype)
    _flash_vs_ref(q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 50),
                                           (False, None)])
def test_flash_head_dims_and_ragged_tiles(d, dtype, causal, window):
    """Every supported head dim; lengths that are no multiple of the
    kernel's tiles (200 queries, 328 keys: q at the cache tail)."""
    dev = _card()
    q, k, v = _qkv(dev, 2, 6, 2, 200, 328, d, dtype, seed=d)
    _flash_vs_ref(q, k, v, causal=causal, window=window, block_q=8,
                  block_k=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_rows_before_the_first_key_are_zero(dtype):
    """Sq > Sk (block_q=128, block_k=64, Sq=256, Sk=192): rows 0..63 see
    no key and give exactly 0, like attention_ref (the reference's Pallas
    kernel gives the mean of v[0:64] there)."""
    dev = _card()
    q, k, v = _qkv(dev, 1, 2, 2, 256, 192, 64, dtype)
    got, _ = _flash_vs_ref(q, k, v, causal=True, block_q=128, block_k=64)
    assert not got[:, :, :64].any()
    assert got[:, :, 64:].abs().amax() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [200, 256])
def test_flash_bsnh_padding_and_strided_views(dtype, S):
    """The model layout: padded (S=200) and unpadded (S=256, the (B, S,
    H, d) tensors reach the kernel as strided views, no copy)."""
    dev = _card()
    rng = np.random.default_rng(S)

    def t(h):
        return torch.as_tensor(rng.standard_normal((2, S, h, 64)).astype(
            np.float32), device=dev).to(dtype)
    q, k, v = t(4), t(2), t(2)
    got = flash_attention_bsnh(q, k, v, causal=True)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=True).transpose(1, 2)
    tol = fkernel.TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_rejects_bad_inputs():
    dev = _card()
    q, k, v = _qkv(dev, 1, 2, 1, 64, 64, 64, torch.float32)
    with pytest.raises(ValueError):
        fkernel.flash_attention(q.half(), k.half(), v.half(), block_q=64,
                                block_k=64)
    with pytest.raises(ValueError):
        fkernel.flash_attention(q, k.bfloat16(), v, block_q=64, block_k=64)
    with pytest.raises(ValueError):
        fkernel.flash_attention(q[..., :48], k[..., :48], v[..., :48],
                                block_q=64, block_k=64)
    with pytest.raises(ValueError):
        fkernel.flash_attention(q, k.cpu(), v.cpu(), block_q=64, block_k=64)


@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (9, 3), (8, 1)])
def test_flash_bf16_gqa_groups(Hq, Hkv):
    """Groups of 1, 3 and 8 query heads on one KV head."""
    dev = _card()
    q, k, v = _qkv(dev, 2, Hq, Hkv, 192, 192, 64, torch.bfloat16,
                   seed=Hq * Hkv)
    _flash_vs_ref(q, k, v, causal=True, window=None, block_q=64,
                  block_k=64)


@pytest.mark.parametrize("Sq", [1, 17])
@pytest.mark.parametrize("window", [None, 100])
def test_flash_bf16_queries_at_the_tail_of_ragged_keys(Sq, window):
    """1 and 17 queries at the tail of 1000 keys: ragged in both, the
    last K tile cut by Sk and the single q tile mostly zero-filled."""
    dev = _card()
    q, k, v = _qkv(dev, 2, 6, 2, Sq, 1000, 64, torch.bfloat16, seed=Sq)
    _flash_vs_ref(q, k, v, causal=True, window=window, block_q=1,
                  block_k=8)


@pytest.mark.parametrize("window", [16, 1100])
def test_flash_bf16_window_narrower_than_a_tile_and_wider_than_the_keys(
        window):
    dev = _card()
    q, k, v = _qkv(dev, 1, 4, 2, 1000, 1000, 128, torch.bfloat16,
                   seed=window)
    got, want = _flash_vs_ref(q, k, v, causal=True, window=window,
                              block_q=8, block_k=8)
    if window > 1000:           # as wide as no window at all
        full = fkernel.flash_attention(q, k, v, causal=True, block_q=8,
                                       block_k=8)
        assert torch.equal(got, full)


@pytest.mark.parametrize("d", fkernel.HEAD_DIMS)
@pytest.mark.parametrize("S", [191, 193])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_head_dims_one_off_a_tile(d, S, causal):
    """Every head dim at 64 n - 1 and 64 n + 1 keys (and queries)."""
    dev = _card()
    q, k, v = _qkv(dev, 1, 4, 2, S, S, d, torch.bfloat16, seed=d + S)
    _flash_vs_ref(q, k, v, causal=causal, window=None, block_q=1,
                  block_k=1)


def test_flash_bf16_repeats_bit_identical():
    dev = _card()
    q, k, v = _qkv(dev, 2, 8, 2, 1000, 1000, 128, torch.bfloat16, seed=7)
    kw = dict(causal=True, window=300, block_q=8, block_k=8)
    a = fkernel.flash_attention(q, k, v, **kw)
    b = fkernel.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_flash_bf16_rejects_views_cp_async_cannot_load():
    """A view one element off a 16-byte boundary, or with a seq stride
    that is no multiple of 8 elements, raises before any launch."""
    dev = _card()
    q, k, v = _qkv(dev, 1, 2, 1, 64, 64, 64, torch.bfloat16)
    flat = torch.zeros(q.numel() + 8, dtype=q.dtype, device=dev)
    shifted = flat[1:1 + q.numel()].view(q.shape)
    shifted.copy_(q)
    odd = torch.zeros((1, 1, 64, 65), dtype=q.dtype, device=dev)[..., :64]
    odd.copy_(k)
    before = fkernel.flash_attention.launches
    with pytest.raises(ValueError, match="q's data pointer"):
        fkernel.flash_attention(shifted, k, v, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="k's seq stride 65"):
        fkernel.flash_attention(q, odd, v, block_q=64, block_k=64)
    assert fkernel.flash_attention.launches == before


def _f32_plan(q, k, causal, window):
    B, Hq, Sq, d = q.shape
    return fkernel.flash_plan(B, Hq, Sq, k.shape[2], d, causal, window,
                              fkernel.resident_blocks(q.device, d))


@pytest.mark.parametrize("Sq", [1, 64, 512])
@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("d", [64, 256])
def test_flash_f32_split_kv_at_the_tail_of_long_keys(Sq, window, d):
    """1, 64 and 512 queries at the tail of 4096 keys: too few q tiles to
    fill the card, so the keys are split over several blocks whose
    partials the q tile's last block combines."""
    dev = _card()
    q, k, v = _qkv(dev, 2, 6, 2, Sq, 4096, d, torch.float32, seed=Sq + d)
    assert _f32_plan(q, k, True, window).n_split > 1
    _flash_vs_ref(q, k, v, causal=True, window=window, block_q=1,
                  block_k=8)


@pytest.mark.parametrize("d", fkernel.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_q_tiles_under_one_wave(d, causal):
    """200 queries on 1000 keys, 4 heads on one KV head: fewer q tiles x
    heads than one resident grid, causal and bidirectional."""
    dev = _card()
    q, k, v = _qkv(dev, 1, 4, 1, 200, 1000, d, torch.float32, seed=d)
    plan = _f32_plan(q, k, causal, None)
    assert plan.tiles < fkernel.resident_blocks(dev, d)
    assert plan.n_split > 1
    _flash_vs_ref(q, k, v, causal=causal, window=None, block_q=8,
                  block_k=8)


@pytest.mark.parametrize("B,Sq,window", [(4, 2048, None), (2, 512, 300),
                                          (2, 1, None)])
def test_flash_f32_repeats_bit_identical(B, Sq, window):
    """Unsplit (smollm's 4 x 2048, 9/3 heads) and split calls: the splits
    are combined in split order, so two calls give the same bits."""
    dev = _card()
    q, k, v = _qkv(dev, B, 9, 3, Sq, 2048, 64, torch.float32, seed=Sq)
    kw = dict(causal=True, window=window, block_q=1, block_k=8)
    assert (_f32_plan(q, k, True, window).n_split > 1) == (Sq < 2048)
    a = fkernel.flash_attention(q, k, v, **kw)
    b = fkernel.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    torch.testing.assert_close(a, attention_ref(q, k, v, causal=True,
                                                window=window),
                               atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("Sq", [2048, 64])
def test_flash_f32_one_device_launch_a_call(Sq):
    """Three profiled calls show one device kernel, the float32 kernel,
    launched three times, split-KV (64 queries) included."""
    dev = _card()
    q, k, v = _qkv(dev, 2, 8, 2, Sq, 2048, 64, torch.float32, seed=3)
    events = _device_events(
        lambda: fkernel.flash_attention(q, k, v, block_q=64, block_k=64),
        calls=3)
    assert len(events) == 1 and events[0][1] == 3, events
    assert "flash_kernel" in events[0][0]


def test_flash_f32_rejects_views_cp_async_cannot_load():
    """A float32 view one element off a 16-byte boundary, or with a seq
    stride that is no multiple of 4 elements, raises before any launch."""
    dev = _card()
    q, k, v = _qkv(dev, 1, 2, 1, 64, 64, 64, torch.float32)
    flat = torch.zeros(q.numel() + 4, dtype=q.dtype, device=dev)
    shifted = flat[1:1 + q.numel()].view(q.shape)
    shifted.copy_(q)
    odd = torch.zeros((1, 1, 64, 66), dtype=q.dtype, device=dev)[..., :64]
    odd.copy_(v)
    before = fkernel.flash_attention.launches
    with pytest.raises(ValueError, match="q's data pointer"):
        fkernel.flash_attention(shifted, k, v, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="v's seq stride 66"):
        fkernel.flash_attention(q, k, odd, block_q=64, block_k=64)
    assert fkernel.flash_attention.launches == before


def test_flash_f32_kernels_do_not_spill():
    """ptxas: every float32 instantiation keeps its micro-tiles in
    registers (no spill), within its launch bounds."""
    from repro_torch.kernels import build as kbuild
    _card()
    kbuild.build()
    usage = fkernel.f32_kernel_usage(kbuild.BUILD.log)
    assert sorted(usage) == list(fkernel.HEAD_DIMS), usage
    for d, u in usage.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0, (d, u)
        per_sm = fkernel.F32_TILES[d][3]
        assert u["registers"] <= 65536 // (fkernel.F32_THREADS * per_sm)


def test_flash_f32_split_calls_on_two_streams():
    """Split calls on two streams at once take tickets from two scratches:
    each call meets the plain version and a stream's repeats are
    bit-identical."""
    dev = _card()
    qkv = [_qkv(dev, 2, 8, 2, 64, 4096, 64, torch.float32, seed=s)
           for s in (30, 31)]
    assert all(_f32_plan(q, k, True, None).n_split > 1 for q, k, _ in qkv)
    want = [attention_ref(q, k, v, causal=True) for q, k, v in qkv]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(4):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(fkernel.flash_attention(
                    *qkv[i], block_q=64, block_k=64))
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            torch.testing.assert_close(got, want[i], atol=2e-6, rtol=2e-6)
            assert torch.equal(got, outs[i][0])


def test_hist_and_flash_share_a_streams_tickets():
    """The histogram kernel and the split flash kernel take their tickets
    from one scratch a stream; each leaves them zero for the other."""
    from repro_torch.kernels import scratch
    dev = _card()
    rng = np.random.default_rng(32)
    rgb = torch.as_tensor(rng.uniform(0, 255, (16, 50000, 3))
                          .astype(np.float32), device=dev)
    fg = torch.as_tensor(rng.random((16, 50000)).astype(np.float32),
                         device=dev)
    q, k, v = _qkv(dev, 2, 8, 2, 1, 4096, 64, torch.float32, seed=32)
    want_h = ref.hsv_hist_ref(rgb, fg, HR[:2])
    want_f = attention_ref(q, k, v, causal=True)
    for _ in range(3):
        got_h = kernel.hsv_hist_batch(rgb, fg, HR[:2])
        got_f = fkernel.flash_attention(q, k, v, block_q=1, block_k=8)
        kernel.compare_hist_with_plain(got_h, want_h, fg)
        torch.testing.assert_close(got_f, want_f, atol=2e-6, rtol=2e-6)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert not scratch.tickets(dev, stream, 1).any()

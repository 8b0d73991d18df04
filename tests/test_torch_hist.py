"""The port's staged histogram entry point (``hsv_hist_ref``,
``kernel.hsv_hist``/``hsv_hist_batch`` on the CPU, ``ops.frame_pf``/
``batch_pf``) against the JAX reference's Pallas ``hsv_hist`` in
interpret mode and its ``hsv_hist_ref``, on the same seeded inputs.

Tolerances: with a bool mask (or 0/1 float weights) counts, totals and
foreground totals are exact; with fractional float weights each output is
within ``kernel.HIST_FLOAT_RTOL`` times the frame's sum of weights (float
sums in another order); pf and hue fractions within atol 1e-6."""
import jax  # noqa: F401  (both packages in one process, as the tests run)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernel module needs it first)
from repro.kernels.hsv_features.kernel import BLOCK, hsv_hist as j_hist
from repro.kernels.hsv_features.ops import batch_pf as j_batch_pf
from repro.kernels.hsv_features.ops import frame_pf as j_frame_pf
from repro.kernels.hsv_features.ref import hsv_hist_ref as j_hist_ref
from repro_torch.core.colors import BLUE, RED, YELLOW
from repro_torch.kernels.hsv_features import kernel, ref
from repro_torch.kernels.hsv_features.ops import batch_pf, frame_pf

HUE_SETS = [
    (tuple(RED.hue_ranges),),
    (tuple(RED.hue_ranges), tuple(YELLOW.hue_ranges)),
    (tuple(RED.hue_ranges), tuple(YELLOW.hue_ranges), tuple(BLUE.hue_ranges)),
]


def _exact(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _close(got, want, fg):
    tol = kernel.HIST_FLOAT_RTOL * max(float(np.abs(fg).sum()), 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("n", [17, 256, BLOCK, BLOCK + 1, 3 * BLOCK + 100])
@pytest.mark.parametrize("hue_ranges", HUE_SETS)
def test_hist_matches_reference_bool_mask(n, hue_ranges, rng):
    """Ragged pixel counts (the reference pads to its 4096-pixel block)
    and 1-3 colors: exact against the Pallas kernel and its oracle."""
    rgb = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    fg = rng.random(n) < 0.7
    got = kernel.hsv_hist(torch.as_tensor(rgb), torch.as_tensor(fg),
                          hue_ranges)
    _exact(got, j_hist(jnp.asarray(rgb), jnp.asarray(fg), hue_ranges,
                       interpret=True))
    _exact(got, j_hist_ref(jnp.asarray(rgb), jnp.asarray(fg), hue_ranges))
    assert [tuple(g.shape) for g in got] == [
        (len(hue_ranges), 64), (len(hue_ranges),), ()]


@pytest.mark.parametrize("bs,bv", [(8, 8), (4, 4), (16, 16)])
def test_hist_bin_sizes(bs, bv, rng):
    rgb = rng.uniform(0, 255, (1000, 3)).astype(np.float32)
    fg = np.ones(1000, bool)
    hr = (tuple(RED.hue_ranges),)
    got = ref.hsv_hist_ref(torch.as_tensor(rgb), torch.as_tensor(fg), hr,
                           bs, bv)
    _exact(got, j_hist(jnp.asarray(rgb), jnp.asarray(fg), hr, bs=bs, bv=bv,
                       interpret=True))


@pytest.mark.parametrize("weights", ["binary", "fractional"])
@pytest.mark.parametrize("n", [300, BLOCK + 7])
def test_hist_float_weights(weights, n, rng):
    """The reference also takes a float weight (``fg.astype(float32)``):
    0/1 floats count exactly, fractional weights sum within rounding."""
    rgb = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    fg = (rng.random(n) < 0.5 if weights == "binary"
          else rng.random(n)).astype(np.float32)
    hr = HUE_SETS[1]
    got = kernel.hsv_hist(torch.as_tensor(rgb), torch.as_tensor(fg), hr)
    want = j_hist(jnp.asarray(rgb), jnp.asarray(fg), hr, interpret=True)
    if weights == "binary":
        _exact(got, want)
    else:
        _close(got, want, fg)
        _close(got, j_hist_ref(jnp.asarray(rgb), jnp.asarray(fg), hr), fg)


def test_hist_batch_equals_per_frame(rng):
    """The batched form is the per-frame function on every frame."""
    T, n = 5, 777
    rgb = torch.as_tensor(rng.uniform(0, 255, (T, n, 3)).astype(np.float32))
    fg = torch.as_tensor(rng.random((T, n)) < 0.4)
    hr = HUE_SETS[2]
    counts, totals, fgtot = kernel.hsv_hist_batch(rgb, fg, hr)
    assert counts.shape == (T, 3, 64) and fgtot.shape == (T,)
    for t in range(T):
        _exact((counts[t], totals[t], fgtot[t]),
               kernel.hsv_hist(rgb[t], fg[t], hr))


@pytest.mark.parametrize("colors", [(RED,), (RED, YELLOW)])
def test_frame_pf_and_batch_pf_match_reference(colors, rng):
    """pf and hue fractions at atol 1e-6 (their divisions are the same;
    the counts under them are exact)."""
    import repro.core.colors as jcolors
    jc = [getattr(jcolors, c.name.upper()) for c in colors]
    T, h, w = 4, 24, 40
    rgb = rng.uniform(0, 255, (T, h, w, 3)).astype(np.float32)
    fg = rng.random((T, h, w)) < 0.8
    pf, hf = batch_pf(rgb, fg, colors, device="cpu")
    jpf, jhf = j_batch_pf(jnp.asarray(rgb), jnp.asarray(fg), jc,
                          interpret=True)
    assert pf.shape == (T, len(colors), 8, 8) and hf.shape == (T, len(colors))
    np.testing.assert_allclose(pf.numpy(), np.asarray(jpf), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jhf), rtol=0,
                               atol=1e-6)
    pf0, hf0 = frame_pf(torch.as_tensor(rgb[0]), torch.as_tensor(fg[0]),
                        colors)
    jpf0, jhf0 = j_frame_pf(jnp.asarray(rgb[0]), jnp.asarray(fg[0]), jc,
                            interpret=True)
    np.testing.assert_allclose(pf0.numpy(), np.asarray(jpf0), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(hf0.numpy(), np.asarray(jhf0), rtol=0,
                               atol=1e-6)


def test_batch_pf_makes_one_call_and_counts_no_cpu_launch(rng, monkeypatch):
    """batch_pf scores all T frames in one histogram call; on the CPU
    that call runs the plain version and launches no kernel."""
    calls = []
    real = kernel.hsv_hist_batch

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    import repro_torch.kernels.hsv_features.ops as ops
    monkeypatch.setattr(ops, "hsv_hist_batch", spy)
    before = kernel.hsv_hist_batch.launches
    rgb = rng.uniform(0, 255, (6, 8, 8, 3)).astype(np.float32)
    ops.batch_pf(rgb, rng.random((6, 8, 8)) < 0.5, (RED,), device="cpu")
    assert calls == [(6, 64, 3)]
    assert kernel.hsv_hist_batch.launches == before


def test_hist_rejects_other_devices():
    rgb = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernel.hsv_hist_batch(rgb, torch.zeros((1, 8), dtype=torch.bool,
                                               device="meta"), HUE_SETS[0])


def _sectors_brute(fg, off):
    """Bytes of the RGB sectors under non-zero weights, one pixel at a
    time: each pixel's 12 bytes at ``off + 12 * (t * N + i)``, every
    32-byte sector they touch, clipped to the tensor."""
    T, N = fg.shape
    end = off + 12 * T * N
    touched = set()
    for flat in np.flatnonzero(fg.reshape(-1) != 0):
        a = off + 12 * int(flat)
        touched.update(range(a // 32, (a + 11) // 32 + 1))
    return sum(min((s + 1) * 32, end) - max(s * 32, off) for s in touched)


def _block_mask(rng, T, h, w, share):
    small = rng.random((T, h // 8, w // 8)) < share
    return np.repeat(np.repeat(small, 8, axis=1), 8, axis=2).reshape(T, -1)


@pytest.mark.parametrize("offset_floats", [0, 1, 3, 5])
@pytest.mark.parametrize("mask", ["empty", "full", "random", "isolated",
                                  "blocks"])
@pytest.mark.parametrize("dtype", [torch.bool, torch.float32])
def test_hist_bytes_read_counts_touched_sectors(mask, offset_floats, dtype,
                                                rng):
    """``hist_bytes_read`` against a brute-force count of the RGB sectors
    under non-zero weights, for aligned and offset RGB views: the weights
    read whole, the sectors clipped to the tensor, the outputs written
    once; a dense mask gives ``hist_bytes_moved``."""
    T, h, w, nc, nb = 3, 16, 40, 2, 64
    N = h * w
    if mask == "empty":
        m = np.zeros((T, N), bool)
    elif mask == "full":
        m = np.ones((T, N), bool)
    elif mask == "random":
        m = rng.random((T, N)) < 0.3
    elif mask == "isolated":
        m = np.zeros((T, N), bool)
        m.reshape(-1)[rng.choice(T * N, 7, replace=False)] = True
    else:
        m = _block_mask(rng, T, h, w, 0.2)
    fg = torch.as_tensor(m) if dtype == torch.bool else torch.as_tensor(
        m * rng.uniform(0.1, 1.0, m.shape).astype(np.float32))
    base = torch.zeros(T * N * 3 + 8)
    rgb = base[offset_floats:offset_floats + T * N * 3].view(T, N, 3)
    off = rgb.data_ptr() % 32
    got = kernel.hist_bytes_read(fg, nc, nb, off)
    want = (T * N * fg.element_size() + _sectors_brute(m, off)
            + T * (nc * nb + nc + 1) * 4)
    assert got == want
    dense = kernel.hist_bytes_moved(T, N, nc, nb, fg.element_size())
    assert got <= dense
    if mask == "full":
        assert got == dense
    if mask == "empty":
        assert got == T * N * fg.element_size() + T * (nc * nb + nc + 1) * 4


def test_hist_bytes_read_phase_mask_and_special_weights(rng):
    """The hist phase's mask shape (8x8-pixel blocks of 720x1280 frames,
    96-byte runs a row, sector-aligned): each run's 3 sectors and no
    more. NaN weights count as non-zero, -0.0 as zero, as the kernel
    skips them."""
    T, h, w = 2, 720, 1280
    m = _block_mask(rng, T, h, w, 0.057)
    fg = torch.as_tensor(m)
    runs = int(m.sum()) // 8
    assert kernel.hist_bytes_read(fg, 2, 64) == (
        T * h * w + runs * 96 + T * 131 * 4)
    x = np.zeros((1, 64), np.float32)
    x[0, 8], x[0, 40] = np.nan, -0.0      # pixel 8: bytes 96..107
    assert kernel.hist_bytes_read(torch.as_tensor(x), 1, 4) == (
        64 * 4 + 32 + (4 + 1 + 1) * 4)


@pytest.mark.parametrize("T,N,resident", [
    (1, 1, 528), (1, 1023, 528), (3, 4097, 528), (64, 720 * 1280, 528),
    (64, 720 * 1280, 1056), (5, 3 * 1024 + 5, 2), (700, 5000, 528),
    (2, 100000, 1)])
def test_hist_plan_covers_every_pixel_once(T, N, resident):
    """The partition ``hist_kernel`` walks (block g of a frame takes
    chunks g, g + G, ...; thread x the quad 4x .. 4x + 3 of each) covers
    every pixel of a frame exactly once, at most ``HIST_WAVES`` resident
    grids of blocks (or one block a frame), no block without a chunk."""
    plan = kernel.hist_plan(T, N, resident)
    G = plan.blocks_per_frame
    assert plan.frames == T and plan.nchunks == -(-N // kernel.HIST_CHUNK)
    assert 1 <= G <= plan.nchunks
    assert T * G <= max(T, kernel.HIST_WAVES * resident + T)
    assert all(len(plan.chunks(g)) >= 1 for g in range(G))
    seen = np.zeros(N, np.int64)
    threads = kernel.HIST_CHUNK // 4
    for g in range(G):
        for c in plan.chunks(g):
            q = np.arange(c * kernel.HIST_CHUNK,
                          min((c + 1) * kernel.HIST_CHUNK, N))
            np.add.at(seen, q, 1)
    assert (seen == 1).all()
    # one thread's pixels, as the kernel visits them
    if N <= 5000:
        every = sorted(i for g in range(G) for x in range(threads)
                       for i in plan.pixels_of(g, x))
        assert every == list(range(N))


def test_hist_plan_rejects_empty_shapes():
    with pytest.raises(ValueError):
        kernel.hist_plan(0, 10, 528)


@pytest.mark.parametrize("weights", ["bool", "binary", "fractional"])
def test_plain_hist_ignores_rgb_under_zero_weights(weights, rng):
    """The exactness that skipping relies on: with NaN and +-inf RGB
    under every zero weight, the plain version gives the same counts,
    totals and foreground total, bit for bit, as with finite RGB there."""
    T, n = 3, 2000
    rgb = rng.uniform(0, 255, (T, n, 3)).astype(np.float32)
    on = rng.random((T, n)) < 0.5
    w = (on if weights == "bool" else on.astype(np.float32)
         * (1.0 if weights == "binary"
            else rng.uniform(0.1, 1.0, (T, n)).astype(np.float32)))
    bad = rgb.copy()
    vals = np.array([np.nan, np.inf, -np.inf], np.float32)
    bad[~on] = vals[rng.integers(0, 3, (int((~on).sum()), 3))]
    hr = HUE_SETS[2]
    a = ref.hsv_hist_ref(torch.as_tensor(rgb), torch.as_tensor(w), hr)
    b = ref.hsv_hist_ref(torch.as_tensor(bad), torch.as_tensor(w), hr)
    for x, y in zip(a, b):
        assert torch.equal(x, y)

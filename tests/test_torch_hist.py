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

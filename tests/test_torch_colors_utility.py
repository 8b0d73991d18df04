"""Port vs reference: HSV conversion, hue masks, the joint bin index, the
PF matrix and batched utility scoring (CPU, seeded numpy inputs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import colors as jcolors
from repro.core import utility as jutil
from repro_torch.core import colors as tcolors
from repro_torch.core import utility as tutil


def _rgb(rng, shape):
    """Uniform RGB plus exact ties (r == g, g == b, gray) and zeros, which
    exercise every branch of the hue formula and the floor-mod."""
    rgb = rng.uniform(0, 255, shape).astype(np.float32)
    flat = rgb.reshape(-1, 3)
    n = flat.shape[0]
    flat[: n // 8, 1] = flat[: n // 8, 0]
    flat[n // 8: n // 4, 2] = flat[n // 8: n // 4, 1]
    flat[n // 4: n // 4 + 5] = 0.0
    flat[n // 4 + 5: n // 4 + 10] = 77.0
    return rgb


def test_rgb_to_hsv_exact(rng):
    rgb = _rgb(rng, (5, 17, 23, 3))
    want = np.asarray(jcolors.rgb_to_hsv_jnp(jnp.asarray(rgb)))
    got = tcolors.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got, want)


def test_floor_mod_takes_the_divisor_sign():
    """Hue floor-mod parity hazard: JAX's ``x % 6`` is fmod then +6 for a
    non-zero negative remainder; a plain fmod keeps the dividend's sign."""
    x = np.array([-1e-8, -3.5, -6.0, 7.0, -0.0, 5.9999995, -12.25],
                 np.float32)
    want = np.asarray(jnp.asarray(x) % 6.0)
    got = tcolors.floor_mod6(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["red", "yellow", "blue", "green"])
def test_hue_mask_exact(name, rng):
    h = rng.uniform(0, 180, (300,)).astype(np.float32)
    h[:20] = np.array([0, 10, 170, 180, 20, 35, 100, 130, 40, 80,
                       9.999999, 19.999998, 34.999996, 129.99998, 79.99999,
                       169.99998, 99.99999, 39.999996, 0.0, 179.99998],
                      np.float32)
    want = np.asarray(jcolors.hue_mask(jnp.asarray(h), jcolors.COLORS[name]))
    got = tcolors.hue_mask(torch.from_numpy(h), tcolors.COLORS[name]).numpy()
    np.testing.assert_array_equal(got, want)


def test_joint_bin_index_truncates_then_clips(rng):
    """float32 -> int32 truncation toward zero, then clip (utility.py:34)."""
    s = rng.uniform(-3, 300, (500,)).astype(np.float32)
    v = rng.uniform(-3, 300, (500,)).astype(np.float32)
    s[:6] = [31.999998, 32.0, 255.99998, 256.0, -0.5, 0.0]
    for bs, bv in ((8, 8), (4, 16), (5, 3)):
        want = np.asarray(jutil.joint_bin_index(jnp.asarray(s), jnp.asarray(v),
                                                bs, bv))
        got = tutil.joint_bin_index(torch.from_numpy(s), torch.from_numpy(v),
                                    bs, bv).numpy()
        np.testing.assert_array_equal(got, want)


def test_pixel_fraction_matrix_memory_lean_parity(rng):
    """The inputs of tests/test_ingest_fused.py:124 through both packages."""
    hsv = rng.uniform(0, 255, (3, 16, 24, 3)).astype(np.float32)
    hsv[..., 0] *= np.float32(180.0 / 255.0)
    fg = rng.random((3, 16, 24)) < 0.7
    for name in ("red", "yellow"):
        want = np.asarray(jutil.pixel_fraction_matrix(
            jnp.asarray(hsv), jcolors.COLORS[name], jnp.asarray(fg)))
        got = tutil.pixel_fraction_matrix(
            torch.from_numpy(hsv), tcolors.COLORS[name],
            torch.from_numpy(fg)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    # without a foreground mask too
    want = np.asarray(jutil.pixel_fraction_matrix(jnp.asarray(hsv),
                                                  jcolors.RED))
    got = tutil.pixel_fraction_matrix(torch.from_numpy(hsv),
                                      tcolors.RED).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("op", ["single", "or", "and"])
def test_batch_utilities_and_score(op, rng):
    """Batched scoring at atol 1e-6: the 64-bin sums are taken in another
    order than XLA's."""
    nc = 1 if op == "single" else 3
    names = ["red", "yellow", "blue"][:nc]
    pfs = rng.random((40, nc, 8, 8)).astype(np.float32)
    pfs /= pfs.sum(axis=(-2, -1), keepdims=True)
    labels = rng.random(40) < 0.4
    jm = jutil.train_utility_model(pfs, labels,
                                   [jcolors.COLORS[n] for n in names], op)
    tm = tutil.train_utility_model(pfs, labels,
                                   [tcolors.COLORS[n] for n in names], op)
    for a in ("M_pos", "M_neg", "norm"):
        np.testing.assert_array_equal(getattr(tm, a), getattr(jm, a))
    assert tm.op == jm.op
    want = jutil.batch_utilities(jm, pfs)
    got = tutil.batch_utilities(tm, pfs, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(tm.score(torch.from_numpy(pfs)).numpy(),
                               np.asarray(jm.score(jnp.asarray(pfs))),
                               atol=1e-6)


@pytest.mark.parametrize("with_fg", [False, True])
@pytest.mark.parametrize("name", ["red", "yellow", "blue", "green"])
def test_hue_fraction_matches_reference(name, with_fg, rng):
    rgb = _rgb(rng, (3, 11, 17, 3))
    hsv = jcolors.rgb_to_hsv_jnp(jnp.asarray(rgb))
    fg = rng.random((3, 11, 17)) < 0.4 if with_fg else None
    if with_fg:
        fg[1] = False                      # a frame without foreground
    want = np.asarray(jutil.hue_fraction(
        hsv, jcolors.COLORS[name], None if fg is None else jnp.asarray(fg)))
    got = tutil.hue_fraction(
        tcolors.rgb_to_hsv(torch.from_numpy(rgb)), tcolors.COLORS[name],
        None if fg is None else torch.from_numpy(fg)).numpy()
    assert got.dtype == np.float32 and got.shape == (3,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("with_fg", [False, True])
def test_frame_features_match_reference(with_fg, rng):
    rgb = _rgb(rng, (2, 3, 13, 19, 3))
    fg = rng.random((2, 3, 13, 19)) < 0.5 if with_fg else None
    names = ["red", "yellow", "green"]
    want = np.asarray(jutil.frame_features(
        jnp.asarray(rgb), [jcolors.COLORS[n] for n in names],
        None if fg is None else jnp.asarray(fg)))
    got = tutil.frame_features(
        torch.from_numpy(rgb), [tcolors.COLORS[n] for n in names],
        None if fg is None else torch.from_numpy(fg)).numpy()
    assert got.shape == (2, 3, 3, 8, 8)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    import repro_torch.core as tcore
    assert tcore.hue_fraction is tutil.hue_fraction
    assert tcore.frame_features is tutil.frame_features

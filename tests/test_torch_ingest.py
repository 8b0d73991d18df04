"""Port's plain ingest vs the reference: ``ingest_batch_ref`` (jnp) and the
Pallas ``ingest_batch`` in interpret mode, at the reference's own
kernel-vs-oracle tolerance (atol 1e-4 / rtol 1e-5,
tests/test_ingest_fused.py:43), with the bounding box exact.

The tolerance covers the frame sums of the gain recurrence, which torch
and XLA take in different orders; counts, totals and foreground totals
are integers and come out equal here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.colors import BLUE, RED, YELLOW
from repro.core.utility import UtilityModel as JModel
from repro.kernels.hsv_features import kernel as jkernel
from repro.kernels.hsv_features import ops as jops
from repro.kernels.hsv_features import ref as jref
from repro_torch.convert import model_from_numpy
from repro_torch.data.background import EMABackground
from repro_torch.kernels.hsv_features import kernel as tkernel
from repro_torch.kernels.hsv_features import ops as tops
from repro_torch.kernels.hsv_features import ref as tref

NAMES = ("counts", "totals", "fgtot", "util", "bg", "gain", "bbox")
HR2 = (tuple(RED.hue_ranges), tuple(YELLOW.hue_ranges))
HR3 = HR2 + (tuple(BLUE.hue_ranges),)

# one compiled program per shape instead of op-by-op dispatch
_jref = jax.jit(jref.ingest_batch_ref, static_argnames=(
    "hue_ranges", "bs", "bv", "alpha", "threshold", "use_fg", "bg_valid",
    "op", "width"))


def _close(got, want, label=""):
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        if name == "bbox":
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {name}")
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-5,
                                       err_msg=f"{label} {name}")


def _inputs(rng, lead, n, nc, bg_lead=None):
    rgb = rng.uniform(0, 255, (*lead, n, 3)).astype(np.float32)
    bg0 = rng.uniform(0, 255, (*(bg_lead or lead[:-1]), n)).astype(np.float32)
    M = rng.uniform(0, 1, (nc, 64)).astype(np.float32)
    norm = rng.uniform(0.3, 1.0, nc).astype(np.float32)
    return rgb, bg0, M, norm


def _both(rgb, bg0, gain0, M, norm, hr, **kw):
    want = _jref(jnp.asarray(rgb), jnp.asarray(bg0), jnp.asarray(gain0),
                 jnp.asarray(M), jnp.asarray(norm), hue_ranges=hr, **kw)
    got = tkernel.ingest_batch(torch.from_numpy(rgb), torch.from_numpy(bg0),
                               torch.as_tensor(gain0), torch.from_numpy(M),
                               torch.from_numpy(norm), hr, **kw)
    return got, want


@pytest.mark.parametrize("T", [1, 3, 8])
@pytest.mark.parametrize("n", [257, 4096, 4196, 8209])
def test_ingest_matches_reference_oracle(T, n, rng):
    """Frame counts x pixel counts around the reference's 4096 tile."""
    rgb, bg0, M, norm = _inputs(rng, (T,), n, 2)
    got, want = _both(rgb, bg0, np.float32(1.1), M, norm, HR2)
    _close(got, want, f"T={T} n={n}")


@pytest.mark.parametrize("bg_valid", [False, True])
@pytest.mark.parametrize("use_fg", [True, False])
def test_ingest_fg_and_fresh_state(bg_valid, use_fg, rng):
    """bg_valid=False: frame 0 seeds the background with its own Value."""
    rgb, bg0, M, norm = _inputs(rng, (4,), 900, 1)
    hr = (tuple(RED.hue_ranges),)
    got, want = _both(rgb, bg0, np.float32(1.0), M, norm, hr, use_fg=use_fg,
                      bg_valid=bg_valid)
    _close(got, want, f"bg_valid={bg_valid} use_fg={use_fg}")


@pytest.mark.parametrize("op", ["or", "and"])
@pytest.mark.parametrize("scalar_gain", [True, False])
def test_ingest_camera_lanes_ops_and_bbox(op, scalar_gain, rng):
    """C=3 camera lanes, 3 colors, OR/AND, a scalar or per-camera gain0
    (a scalar broadcasts to every lane), and the bbox rider with empty
    frames (a black frame has no foreground)."""
    C, T, H, W = 3, 4, 12, 20
    rgb, bg0, M, norm = _inputs(rng, (C, T), H * W, 3, bg_lead=(C,))
    rgb[1, 2] = 0.0
    bg0[1] = 0.0
    gain0 = (np.float32(0.9) if scalar_gain
             else rng.uniform(0.5, 1.5, C).astype(np.float32))
    got, want = _both(rgb, bg0, gain0, M, norm, HR3, op=op, width=W)
    _close(got, want, f"op={op}")
    assert (np.asarray(got[6])[1, 2] == -1).all()


def test_ingest_matches_pallas_interpret(rng):
    """The Pallas kernel itself (interpret mode), on two tiny cases."""
    C, T, n = 2, 2, 300
    rgb, bg0, M, norm = _inputs(rng, (C, T), n, 2, bg_lead=(C,))
    for kw in (dict(width=20), dict(bg_valid=False, op="and")):
        want = jkernel.ingest_batch(
            jnp.asarray(rgb), jnp.asarray(bg0), jnp.asarray([1.2, 0.8]),
            jnp.asarray(M), jnp.asarray(norm), HR2, interpret=True, **kw)
        got = tkernel.ingest_batch(
            torch.from_numpy(rgb), torch.from_numpy(bg0),
            torch.tensor([1.2, 0.8]), torch.from_numpy(M),
            torch.from_numpy(norm), HR2, **kw)
        _close(got, want, str(kw))


def _models(rng, colors, op="or"):
    nc = len(colors)
    M = rng.uniform(0, 1, (nc, 8, 8)).astype(np.float32)
    norm = rng.uniform(0.3, 1.0, nc).astype(np.float32)
    jm = JModel(tuple(colors), M, np.zeros_like(M), norm, op)
    return jm, model_from_numpy(colors, M, np.zeros_like(M), norm, op)


@pytest.mark.parametrize("op", ["or", "and"])
def test_ingest_pipeline_matches_reference(op, rng):
    """pf / hf / util / state / bbox of the pipeline; a conflicting
    caller op never overrides the model's."""
    jm, tm = _models(rng, [RED, YELLOW, BLUE], op)
    rgb = rng.uniform(0, 255, (2, 5, 12, 16, 3)).astype(np.float32)
    want = jops.ingest_pipeline(rgb, jm.colors, jm, impl="jnp",
                                with_bbox=True, op="and")
    got = tops.ingest_pipeline(rgb, tm.colors, tm, with_bbox=True, op="and",
                               device="cpu")
    for a, b in zip((*got[:3], got[3].bg, got[3].gain, got[4]),
                    (*want[:3], want[3].bg, want[3].gain, want[4])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4,
                                   rtol=1e-5)


def test_ingest_state_carry_across_batches(rng):
    """Chunked ingest with carried (bg, gain) == one long batch
    (tests/test_ingest_fused.py:90), and == the reference's pf."""
    _, tm = _models(rng, [RED])
    rgb = rng.uniform(0, 255, (10, 30, 50, 3)).astype(np.float32)
    p_all, _, u_all, _ = tops.ingest_pipeline(rgb, tm.colors, tm,
                                              device="cpu")
    state, chunks, utils = None, [], []
    for i in range(0, 10, 4):        # uneven final chunk on purpose
        p, _, u, state = tops.ingest_pipeline(rgb[i:i + 4], tm.colors, tm,
                                              state=state, device="cpu")
        chunks.append(p.numpy())
        utils.append(u.numpy())
    np.testing.assert_allclose(np.concatenate(chunks), p_all.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(np.concatenate(utils), u_all.numpy(),
                               atol=1e-4)
    assert isinstance(state, tops.IngestState)
    assert tuple(state.bg.shape) == (30 * 50,)
    want, _, _, _ = jops.ingest_pipeline(rgb, [RED], impl="jnp")
    np.testing.assert_allclose(p_all.numpy(), np.asarray(want), atol=1e-4)


def test_ema_background_matches_host_model(rng):
    """The port's frame loop == its copied host EMABackground mirror."""
    frames = rng.uniform(0, 255, (6, 12, 20, 3)).astype(np.float32)
    host = EMABackground()
    host_fg = np.stack([host(f) for f in frames])
    v = torch.from_numpy(frames[..., 2].reshape(6, -1).copy())
    fg, bg, gain = tref.ema_background_scan(v, torch.zeros(240), 1.0,
                                            bg_valid=False)
    np.testing.assert_array_equal(fg.numpy().reshape(6, 12, 20), host_fg)
    np.testing.assert_allclose(bg.numpy().reshape(12, 20), host.state[0],
                               rtol=1e-5)
    assert host.state[1] == pytest.approx(float(gain), rel=1e-5)


def test_cpu_tensor_takes_the_plain_version(rng):
    """The wrapper runs the plain version only because the tensor lies on
    the CPU; the launch counter stays put."""
    rgb, bg0, M, norm = _inputs(rng, (2,), 64, 1)
    before = tkernel.ingest_batch.launches
    got = tkernel.ingest_batch(torch.from_numpy(rgb), torch.from_numpy(bg0),
                               1.0, torch.from_numpy(M),
                               torch.from_numpy(norm), (tuple(RED.hue_ranges),))
    want = tref.ingest_batch_ref(torch.from_numpy(rgb), torch.from_numpy(bg0),
                                 1.0, torch.from_numpy(M),
                                 torch.from_numpy(norm),
                                 (tuple(RED.hue_ranges),))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tkernel.ingest_batch.launches == before


def test_compare_with_plain_tolerance(rng):
    """The kernel-vs-plain check used on the card: equal outputs pass; a
    float error past atol, too many differing count units or frames, a
    utility past its frame's bound, or a bbox difference in a frame whose
    counts agree each raise."""
    C, Tn, W, N = 2, 3, 10, 100
    rgb = torch.from_numpy(rng.uniform(0, 255, (C, Tn, N, 3))
                           .astype(np.float32))
    bg0 = torch.from_numpy(rng.uniform(0, 255, (C, N)).astype(np.float32))
    M, norm = torch.ones(2, 64), torch.ones(2)
    args = (rgb, bg0, 1.0, M, norm, HR2)
    want = tref.ingest_batch_ref(*args, width=W)

    def check(got):
        return tkernel.compare_with_plain(got, want, M, norm)

    def edit(i, fn):
        got = [w.clone() for w in want]
        fn(got[i])
        return got

    rep = check(want)
    assert rep["max_abs_err"] == 0 and rep["count_units_differing"] == 0
    with pytest.raises(AssertionError, match="bg"):
        check(edit(4, lambda t: t.add_(1e-3)))
    with pytest.raises(AssertionError, match="count units"):
        check(edit(0, lambda t: t[0, 0, 0, 0].add_(1)))
    with pytest.raises(AssertionError, match="bbox"):
        check(edit(6, lambda t: t[1, 2, 0].add_(1)))
    with pytest.raises(AssertionError, match="util"):
        check(edit(3, lambda t: t[0, 1].add_(1e-3)))

    # a flip in one frame of a larger batch: within both caps, and the
    # utility of that frame may move by what the flip allows, no further
    Cb, Tb, Nb = 4, 25, 6000
    rgb = torch.from_numpy(rng.uniform(0, 255, (Cb, Tb, Nb, 3))
                           .astype(np.float32))
    bg0 = torch.from_numpy(rng.uniform(0, 255, (Cb, Nb)).astype(np.float32))
    args = (rgb, bg0, 1.0, M, norm, HR2)
    want = tref.ingest_batch_ref(*args)
    n = float(want[1][2, 7].min().clamp_min(1))

    def flip(got, du):
        got[0][2, 7, :, 5] += 1
        got[1][2, 7] += 1
        got[2][2, 7] += 1
        got[3][2, 7] += du
        return got

    rep = check(flip([w.clone() for w in want], 1.9 / n))
    assert rep["frames_differing"] == 1 and rep["count_units_differing"] == 5
    with pytest.raises(AssertionError, match="util"):
        check(flip([w.clone() for w in want], 2.1 / n + 1e-3))
    # the same slip in every frame trips the frame cap
    slip = [w.clone() for w in want]
    slip[2] += 1
    with pytest.raises(AssertionError, match="frames"):
        check(slip)

"""The port's KV caches, prefill and one-token decode
(``repro_torch.models``: ``init_caches``, ``lm_prefill``,
``lm_decode_step``; ``train.step``'s prefill and decode steps) against
the reference's, on the seven attention configs' smoke sizes: the same
weights (the reference's ``materialize(lm_specs(cfg), key)`` carried by
``convert.lm_params_from_numpy``), the same numpy-seeded tokens, and the
port's decode started from the reference's own prefilled cache
(``convert.lm_caches_from_numpy``).

Tolerances:
- float32 configs (the cache is bf16 whatever the config's dtype):
  logits at atol = rtol = 1e-4 (measured: at most 9.5e-7 after prefill,
  2.1e-7 a decode step); cache ``pos`` exact; k/v within one bf16 ulp of
  the reference's value (measured: at most 1 ulp after prefill — a float32
  key summed in another order rounds to the other neighbour — and
  bit-identical after the decode steps).
- bf16 (the configs' own dtype), in bf16 ulps at the tensor's scale
  (``ulp = 2**(floor(log2(max|x|)) - 7)``) as in ``test_torch_lm.py``:
  against the reference compiled with XLA's excess precision off, at most
  4 ulps and 0.5 ulp on average (measured: at most 0.5 and 0.03, most
  configs bit-identical); jitted as it runs, at most 16 and 1.5 (measured:
  at most 5.75 and 0.87) — for the dense configs only: in granite's MoE
  blocks the fused float32 chains flip a router near-tie, which moves the
  first logits by 24.6 ulps (mean 3.3).
- int8 caches: the reference jitted as it runs keeps the dequantized
  keys and values in float32 (XLA fuses ``q * scale`` into the float32
  score product), though its code rounds them to bf16 as the port does;
  compiled with excess precision off it rounds them, and the port's
  decode logits match it at 1e-4 (measured: 2.1e-7) with every int8
  entry and scale equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.attention as jattn
import repro.models.lm as jlm
import repro.sharding.api as japi
import repro.train.step as jstep
import repro_torch.configs as tconfigs
import repro_torch.models.attention as tattn
import repro_torch.models.lm as tlm
import repro_torch.train.step as tstep
from repro_torch.convert import lm_caches_from_numpy, lm_params_from_numpy

ARCHS = ("smollm-135m", "gemma3-12b", "granite-moe-1b-a400m",
         "mixtral-8x7b", "qwen2.5-32b", "internlm2-20b", "chameleon-34b")
MOE = ("granite-moe-1b-a400m", "mixtral-8x7b")
# the reference's own decode-vs-forward bounds (tests/test_arch_smoke.py)
DECODE_TOL = {"granite-moe-1b-a400m": 0.35, "mixtral-8x7b": 0.35}
PREFILL, STEPS, MAX_SEQ = 20, 6, 32   # gemma3/mixtral smoke windows: 16
BF16_BOUNDS = [(False, 4.0, 0.5), (True, 16.0, 1.5)]
BF16_CASES = [(a, ep, mx, mn) for a in ARCHS for ep, mx, mn in BF16_BOUNDS
              if not (ep and a in MOE)]


def _params(arch, seed=0, **kw):
    """(reference cfg, port cfg, reference params, port params)."""
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    if kw:
        jc, tc = jconfigs.scaled(jc, **kw), tconfigs.scaled(tc, **kw)
    jp = japi.materialize(jlm.lm_specs(jc), jax.random.key(seed))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _tokens(cfg, B=2, S=PREFILL + STEPS, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np(x):
    return (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


def _jit(fn, *args, excess_precision=True):
    """The reference jitted as it runs, or compiled for these arguments
    with XLA's excess precision off (every op rounded to its dtype)."""
    f = jax.jit(fn)
    if excess_precision:
        return f
    return f.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _ref_prefill(jc, jp, toks, excess_precision=True):
    b = {"tokens": jnp.asarray(toks)}
    f = _jit(lambda p, b: jlm.lm_prefill(jc, p, b, max_seq=MAX_SEQ), jp, b,
             excess_precision=excess_precision)
    return f(jp, b)


def _ref_decoder(jc, jp, cache, toks, excess_precision=True):
    args = (jp, cache, jnp.asarray(toks[:, :1]), jnp.int32(PREFILL))
    return _jit(lambda p, c, t, pos: jlm.lm_decode_step(jc, p, c, t, pos),
                *args, excess_precision=excess_precision)


def _port_tokens(toks):
    return torch.as_tensor(toks).long()


def _assert_pos_and_kv_within_an_ulp(tcache, jcache):
    for tb, jb in zip(tcache["blocks"], jcache["blocks"], strict=True):
        assert sorted(tb) == sorted(jb)
        np.testing.assert_array_equal(tb["pos"].numpy(), np.asarray(jb["pos"]))
        for name in ("k", "v"):
            got, want = _np(tb[name]), _np(jb[name])
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                      2.0 ** -126))) - 7)
            assert (np.abs(got - want) <= ulp).all(), name


def _ulps(got, want):
    """(max, mean) |got - want| in bf16 ulps at want's scale."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want) / ulp
    return err.max(), err.mean()


# ---------------------------------------------------------------------------
# caches and quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,int8", [
    ("gemma3-12b", False), ("smollm-135m", False), ("gemma3-12b", True),
    ("smollm-135m", True), ("granite-moe-1b-a400m", False)])
def test_init_caches_match_reference(arch, int8):
    """Shapes, dtypes and ``pos`` of every leaf equal the reference's
    (stacked over the repetitions: k/v (reps, B, W, nkv, hd), pos
    (reps, W)); ``lm_caches_from_numpy`` carries the reference's
    caches over with their dtypes."""
    jc, tc = (jconfigs.scaled(jconfigs.get_smoke_config(arch),
                              opt_kv_int8=int8),
              tconfigs.scaled(tconfigs.get_smoke_config(arch),
                              opt_kv_int8=int8))
    want = jlm.init_caches(jc, 2, 64)
    got = tlm.init_caches(tc, 2, 64, device="cpu")
    assert got["cross_kv"] is None and want["cross_kv"] is None
    carried = lm_caches_from_numpy(jax.tree.map(np.asarray, want), "cpu")
    for tb, jb, cb in zip(got["blocks"], want["blocks"], carried["blocks"],
                          strict=True):
        assert sorted(tb) == sorted(jb) == sorted(cb)
        for name in tb:
            assert tuple(tb[name].shape) == jb[name].shape
            assert str(tb[name].dtype).split(".")[1] == str(jb[name].dtype)
            assert cb[name].dtype == tb[name].dtype
            np.testing.assert_array_equal(_np(tb[name]), _np(jb[name]))
            np.testing.assert_array_equal(_np(cb[name]), _np(jb[name]))
    local = got["blocks"][0]["k"].shape
    assert local[:3] == (tc.pattern_repeats, 2,
                         tc.sliding_window if arch == "gemma3-12b" else 64)


def test_init_caches_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_caches(tconfigs.get_smoke_config("smollm-135m"), 1, 8)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_kv_is_bit_identical(dtype, rng):
    """int8 values, bf16 scales and the dequantized bf16 keys equal the
    reference's bit for bit, ties of ``round`` (half to even) and an
    all-zero row included."""
    x = rng.standard_normal((2, 7, 3, 16)) * 3
    x[0, 0, 0] = 0.0
    x[1, 2, 1, :4] = [127.0 / 2, -127.0 / 2, 0.5, -1.5]   # halves
    x[1, 2, 1, 4:] = 0.25
    jx = jnp.asarray(x, jnp.float32).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, jnp.dtype(dtype).name))
    jq, js = jattn._quantize_kv(jx)
    tq, ts = tattn._quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))
    jd, td = jattn._dequantize_kv(jq, js), tattn._dequantize_kv(tq, ts)
    np.testing.assert_array_equal(td.view(torch.int16).numpy(),
                                  np.asarray(jd).view(np.int16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_decode_cross_matches_reference(dtype, rng):
    """``cross=True`` attends to every slot of a given (encoder) cache and
    writes nothing. The output is bf16 in both dtypes (the cache's dtype
    takes over at the probabilities, as in the reference): bit for bit
    in a float32 config, within one bf16 ulp at the output's scale in a
    bf16 one; the cache untouched."""
    cfg = dict(num_layers=1, d_model=32, num_heads=4, num_kv_heads=2,
               head_dim=8, d_ff=64, vocab_size=256, dtype=dtype)
    jc = jconfigs.ModelConfig(name="narrow", family="dense", **cfg)
    tc = tconfigs.ModelConfig(name="narrow", family="dense", **cfg)
    jp = japi.materialize(jattn.attention_specs(jc, cross=True),
                          jax.random.key(2))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jx = jnp.asarray(rng.standard_normal((2, 1, 32)),
                     jnp.float32).astype(dtype)
    jk, jv = (jnp.asarray(rng.standard_normal((2, 12, 2, 8)),
                          jnp.bfloat16) for _ in range(2))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    tcache = {"k": torch.from_numpy(np.array(jk.astype(jnp.float32))).to(
        torch.bfloat16), "v": torch.from_numpy(np.array(
            jv.astype(jnp.float32))).to(torch.bfloat16)}
    before = {n: t.clone() for n, t in tcache.items()}
    want, _ = jattn.attend_decode(jp, jc, jx, {"k": jk, "v": jv}, 5,
                                  cross=True)
    got, same = tattn.attend_decode(tp, tc, tx, tcache, 5, cross=True)
    assert same is tcache and all(torch.equal(tcache[n], before[n])
                                  for n in tcache)
    assert str(got.dtype).split(".")[1] == str(want.dtype) == "bfloat16"
    err = _ulps(_np(got), _np(want))
    assert err[0] <= (0.0 if dtype == "float32" else 1.0), err


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_float32_matches_reference(arch):
    jc, tc, jp, tp = _params(arch, dtype="float32")
    toks = _tokens(jc)[:, :PREFILL]
    jcache, jfirst = _ref_prefill(jc, jp, toks)
    tcache, tfirst = tlm.lm_prefill(tc, tp, {"tokens": _port_tokens(toks)},
                                    max_seq=MAX_SEQ)
    assert tfirst.shape == (2, tlm.padded_vocab(tc))
    np.testing.assert_allclose(_np(tfirst), _np(jfirst), atol=1e-4,
                               rtol=1e-4)
    _assert_pos_and_kv_within_an_ulp(tcache, jcache)


@pytest.mark.parametrize("arch,excess_precision,max_ulps,mean_ulps",
                         BF16_CASES)
def test_prefill_bfloat16_matches_reference(arch, excess_precision,
                                            max_ulps, mean_ulps):
    jc, tc, jp, tp = _params(arch)
    assert tc.dtype == "bfloat16"
    toks = _tokens(jc)[:, :PREFILL]
    jcache, jfirst = _ref_prefill(jc, jp, toks, excess_precision)
    tcache, tfirst = tlm.lm_prefill(tc, tp, {"tokens": _port_tokens(toks)},
                                    max_seq=MAX_SEQ)
    V = tc.vocab_size
    err = _ulps(_np(tfirst)[:, :V], _np(jfirst)[:, :V])
    assert err[0] <= max_ulps and err[1] <= mean_ulps, err
    for tb, jb in zip(tcache["blocks"], jcache["blocks"], strict=True):
        np.testing.assert_array_equal(tb["pos"].numpy(), np.asarray(jb["pos"]))
        for name in ("k", "v"):
            err = _ulps(_np(tb[name]), _np(jb[name]))
            assert err[0] <= max_ulps and err[1] <= mean_ulps, (name, err)


@pytest.mark.parametrize("arch", MOE)
def test_forward_with_cache_sums_the_moe_aux_loss(arch):
    """``lm_forward(want_cache=True, max_seq=)``: logits, caches and the
    aux loss summed over the MoE blocks, as the reference's."""
    jc, tc, jp, tp = _params(arch, dtype="float32")
    toks = _tokens(jc)[:, :PREFILL]
    f = jax.jit(lambda p, b: jlm.lm_forward(jc, p, b, want_cache=True,
                                            max_seq=MAX_SEQ))
    jl, jcache, jaux = f(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache, taux = tlm.lm_forward(tc, tp, {"tokens": _port_tokens(toks)},
                                      want_cache=True, max_seq=MAX_SEQ)
    assert float(jaux) > 0 and taux.dtype == torch.float32
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    _assert_pos_and_kv_within_an_ulp(tcache, jcache)


# ---------------------------------------------------------------------------
# decode from the reference's prefilled cache
# ---------------------------------------------------------------------------

def _decode_both(jc, tc, jp, tp, toks, excess_precision=True):
    """Prefill in the reference, carry its cache over, then STEPS
    teacher-forced decode steps in both. Yields (pos, port logits,
    reference logits, port cache, reference cache) a step."""
    jcache, _ = _ref_prefill(jc, jp, toks[:, :PREFILL], excess_precision)
    tcache = lm_caches_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    step = _ref_decoder(jc, jp, jcache, toks, excess_precision)
    for pos in range(PREFILL, PREFILL + STEPS):
        jcache, jl = step(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.int32(pos))
        out, tl = tlm.lm_decode_step(tc, tp, tcache,
                                     _port_tokens(toks[:, pos:pos + 1]), pos)
        assert out is tcache                      # updated in place
        yield pos, tl, jl, tcache, jcache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_float32_matches_reference(arch):
    jc, tc, jp, tp = _params(arch, dtype="float32")
    for _, tl, jl, tcache, jcache in _decode_both(jc, tc, jp, tp,
                                                  _tokens(jc)):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    _assert_pos_and_kv_within_an_ulp(tcache, jcache)


@pytest.mark.parametrize("arch,excess_precision,max_ulps,mean_ulps",
                         BF16_CASES)
def test_decode_bfloat16_matches_reference(arch, excess_precision, max_ulps,
                                           mean_ulps):
    jc, tc, jp, tp = _params(arch)
    V = tc.vocab_size
    for _, tl, jl, tcache, jcache in _decode_both(jc, tc, jp, tp,
                                                  _tokens(jc),
                                                  excess_precision):
        err = _ulps(_np(tl)[:, :V], _np(jl)[:, :V])
        assert err[0] <= max_ulps and err[1] <= mean_ulps, err
    for tb, jb in zip(tcache["blocks"], jcache["blocks"], strict=True):
        np.testing.assert_array_equal(tb["pos"].numpy(), np.asarray(jb["pos"]))
        for name in ("k", "v"):
            err = _ulps(_np(tb[name]), _np(jb[name]))
            assert err[0] <= max_ulps and err[1] <= mean_ulps, (name, err)


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-12b",
                                  "granite-moe-1b-a400m", "mixtral-8x7b"])
def test_decode_int8_cache_matches_reference(arch):
    jc, tc, jp, tp = _params(arch, dtype="float32", opt_kv_int8=True)
    for _, tl, jl, tcache, jcache in _decode_both(
            jc, tc, jp, tp, _tokens(jc), excess_precision=False):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    for tb, jb in zip(tcache["blocks"], jcache["blocks"], strict=True):
        assert tb["k"].dtype == torch.int8
        for name in ("pos", "k", "v"):
            np.testing.assert_array_equal(tb[name].numpy(),
                                          np.asarray(jb[name]))
        for name in ("k_scale", "v_scale"):
            np.testing.assert_array_equal(tb[name].view(torch.int16).numpy(),
                                          np.asarray(jb[name]).view(np.int16))


# ---------------------------------------------------------------------------
# the port alone: decode against its own full forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Prefill S-1 tokens + decode 1 == the full forward at the last
    position, at the reference's own bounds (MoE configs tolerate
    capacity-boundary differences)."""
    _, tc, _, tp = _params(arch)
    toks = _port_tokens(_tokens(tc, S=16))
    full, _, _ = tlm.lm_forward(tc, tp, {"tokens": toks})
    caches, first = tlm.lm_prefill(tc, tp, {"tokens": toks[:, :15]},
                                   max_seq=32)
    assert first.shape == (2, tlm.padded_vocab(tc))
    _, step = tlm.lm_decode_step(tc, tp, caches, toks[:, 15:16], 15)
    err = float((full[:, -1].float() - step.float()).abs().max())
    assert err <= DECODE_TOL.get(arch, 1e-3), err


@pytest.mark.parametrize("arch", ["gemma3-12b", "mixtral-8x7b"])
def test_sliding_window_ring_buffer_decode(arch):
    """Decode far past the window: the rings stay consistent with a full
    forward over the same tokens, and hold exactly the last W
    positions."""
    _, tc, _, tp = _params(arch)
    W = tc.sliding_window                       # smoke: 16
    T = W + 8
    toks = _port_tokens(_tokens(tc, B=1, S=T, seed=9))
    full, _, _ = tlm.lm_forward(tc, tp, {"tokens": toks})
    caches, _ = tlm.lm_prefill(tc, tp, {"tokens": toks[:, :4]}, max_seq=T)
    for pos in range(4, T):
        caches, logits = tlm.lm_decode_step(tc, tp, caches,
                                            toks[:, pos:pos + 1], pos)
    err = float((full[:, -1].float() - logits.float()).abs().max())
    assert err < 0.35, err
    ring = caches["blocks"][0]["pos"]           # the first local block
    assert sorted(ring[0].tolist()) == list(range(T - W, T))


def test_decode_past_a_global_cache_raises():
    """A global cache of max_seq slots takes positions 0..max_seq-1. The
    port raises past it; the reference's ``dynamic_update_slice`` clamps
    the write and silently overwrites the last slot instead."""
    jc, tc, jp, tp = _params("smollm-135m", dtype="float32")
    toks = _tokens(jc, B=1, S=8)
    tcache, _ = tlm.lm_prefill(tc, tp, {"tokens": _port_tokens(toks)},
                               max_seq=8)
    with pytest.raises(ValueError, match="position 12"):
        tlm.lm_decode_step(tc, tp, tcache, _port_tokens(toks[:, :1]), 12)
    with pytest.raises(ValueError, match="position 8"):
        tlm.lm_decode_step(tc, tp, tcache, _port_tokens(toks[:, :1]), 8)
    with pytest.raises(ValueError, match="prefill of 9 tokens"):
        tlm.lm_prefill(tc, tp, {"tokens": _port_tokens(_tokens(jc, 1, 9))},
                       max_seq=8)
    # the reference, for the record: slot 7 rewritten by position 12
    jcache, _ = jlm.lm_prefill(jc, jp, {"tokens": jnp.asarray(toks)},
                               max_seq=8)
    before = np.asarray(jcache["blocks"][0]["k"][:, :, 7])
    jnew, _ = jlm.lm_decode_step(jc, jp, jcache, jnp.asarray(toks[:, :1]),
                                 jnp.int32(12))
    assert not np.array_equal(np.asarray(jnew["blocks"][0]["k"][:, :, 7]),
                              before)
    np.testing.assert_array_equal(
        np.asarray(jnew["blocks"][0]["k"][:, :, :7]),
        np.asarray(jcache["blocks"][0]["k"][:, :, :7]))


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-12b",
                                  "granite-moe-1b-a400m"])
def test_step_functions_give_the_reference_greedy_tokens(arch):
    """``make_prefill_step``, then greedy ``make_decode_step``s feeding
    their own tokens back: the same (B, 1) int32 tokens as the
    reference's steps. The port decodes from the reference's prefilled
    cache, which its own prefill holds within a bf16 ulp: one key on the
    other side of a rounding moves these logits by ~1e-3 (gemma3), past
    the top-2 gap of a near-tie."""
    jc, tc, jp, tp = _params(arch, dtype="float32")
    toks = _tokens(jc)[:, :PREFILL]
    jpre = jax.jit(jstep.make_prefill_step(jc, MAX_SEQ))
    jdec = jax.jit(jstep.make_decode_step(jc))
    tpre = tstep.make_prefill_step(tc, MAX_SEQ)
    tdec = tstep.make_decode_step(tc)
    jcache, jl = jpre(jp, {"tokens": jnp.asarray(toks)})
    tcache, tl = tpre(tp, {"tokens": _port_tokens(toks)})
    _assert_pos_and_kv_within_an_ulp(tcache, jcache)
    tcache = lm_caches_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl, dim=-1).to(torch.int32)[:, None]
    for pos in range(PREFILL, PREFILL + STEPS):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jcache, jt, _ = jdec(jp, jcache, jt, jnp.int32(pos))
        out, tt, _ = tdec(tp, tcache, tt, pos)
        assert out is tcache
        assert tt.dtype == torch.int32 and tt.shape == (2, 1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))

"""The port's encoder-decoder path (whisper-tiny's smoke config: 2 encoder
and 2 decoder layers, 32 stub audio frames) against the reference's:
``encode``, ``_cross_kv``, ``lm_forward`` with ``audio_embed``,
``lm_prefill`` (its ``cross_kv`` included) and ``lm_decode_step`` from the
reference's own prefilled caches (``convert.lm_caches_from_numpy`` carries
``cross_kv`` over), on the same weights (``convert.lm_params_from_numpy``,
the ``encoder`` and ``cross`` trees included), numpy-seeded tokens and
audio embeddings (the reference's frontend is a stub too).

Tolerances:
- float32: encoder output, ``cross_kv`` and logits at atol = rtol = 1e-4
  (measured: at most 3.0e-6 on the encoder output, ``cross_kv`` equal
  from equal encoder outputs, 5.4e-7 on the logits, 2.1e-7 a decode
  step); the self-attention cache's bf16 k/v within one bf16 ulp of the
  value (measured: 2 values a float32 rounding on the other side).
- bf16 (the config's own dtype), in bf16 ulps at the tensor's scale
  (``ulp = 2**(floor(log2(max|x|)) - 7)``), against the reference
  compiled with XLA's excess precision off (every op rounded to its
  dtype, as the port does): at most 4 ulps and 0.5 on average
  (measured: at most 1.0 and 0.09 on the logits, decode steps
  bit-identical).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.lm as jlm
import repro.sharding.api as japi
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
import repro_torch.sharding.api as tapi
from repro_torch.convert import lm_caches_from_numpy, lm_params_from_numpy

ARCH = "whisper-tiny"
PREFILL, STEPS, MAX_SEQ = 12, 8, 32
DTYPES = ["float32", "bfloat16"]


def _params(seed=0, **kw):
    jc, tc = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    if kw:
        jc, tc = jconfigs.scaled(jc, **kw), tconfigs.scaled(tc, **kw)
    jp = japi.materialize(jlm.lm_specs(jc), jax.random.key(seed))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _batch(cfg, B=2, S=PREFILL + STEPS, seed=1):
    """(reference batch, port batch): tokens and float32 audio_embed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    audio = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    return ({"tokens": jnp.asarray(toks), "audio_embed": jnp.asarray(audio)},
            {"tokens": torch.as_tensor(toks).long(),
             "audio_embed": torch.from_numpy(audio)})


def _cut(b, S):
    return {**b, "tokens": b["tokens"][:, :S]}


def _np(x):
    return (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


def _jit(fn, *args, excess_precision=True):
    f = jax.jit(fn)
    if excess_precision:
        return f
    return f.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _held(got, want, bf16):
    got, want = _np(got), _np(want)
    if not bf16:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want) / ulp
    assert err.max() <= 4.0 and err.mean() <= 0.5, (err.max(), err.mean())


def _assert_caches(tcache, jcache, bf16):
    for tb, jb in zip(tcache["blocks"], jcache["blocks"], strict=True):
        assert sorted(tb) == sorted(jb) == ["k", "pos", "v"]
        np.testing.assert_array_equal(tb["pos"].numpy(), np.asarray(jb["pos"]))
        for name in ("k", "v"):
            got, want = _np(tb[name]), _np(jb[name])
            if bf16:
                _held(got, want, True)
            else:
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                    np.abs(want), 2.0 ** -126))) - 7)
                assert (np.abs(got - want) <= ulp).all(), name
    assert sorted(tcache["cross_kv"]) == sorted(jcache["cross_kv"])
    for name, want in jcache["cross_kv"].items():
        got = tcache["cross_kv"][name]
        assert str(got.dtype).split(".")[1] == str(want.dtype)
        assert tuple(got.shape) == want.shape
        _held(got, want, bf16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_and_cross_kv_match_reference(dtype):
    """The encoder output (B, T, d) and the stacked cross K/V (num_layers,
    B, T, nkv, hd), both in the config's dtype."""
    jc, tc, jp, tp = _params(dtype=dtype)
    jb, tb = _batch(jc)
    f = _jit(lambda p, a: jlm.encode(jc, p, a), jp, jb["audio_embed"],
             excess_precision=dtype == "float32")
    jenc = f(jp, jb["audio_embed"])
    tenc = tlm.encode(tc, tp, tb["audio_embed"])
    assert str(tenc.dtype).split(".")[1] == str(jenc.dtype) == dtype
    _held(tenc, jenc, dtype == "bfloat16")
    g = _jit(lambda c, e: jlm._cross_kv(jc, c, e), jp["cross"], jenc,
             excess_precision=dtype == "float32")
    jkv = g(jp["cross"], jenc)
    tkv = tlm._cross_kv(tc, tp["cross"], lm_caches_from_numpy(
        {"e": np.asarray(jenc)}, "cpu")["e"])
    for name in ("k", "v"):
        assert tuple(tkv[name].shape) == jkv[name].shape == (
            tc.num_layers, 2, tc.encoder_seq, tc.num_kv_heads,
            tc.resolved_head_dim)
        _held(tkv[name], jkv[name], dtype == "bfloat16")


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype):
    jc, tc, jp, tp = _params(dtype=dtype)
    jb, tb = _batch(jc)
    f = _jit(lambda p, b: jlm.lm_forward(jc, p, b)[0], jp, jb,
             excess_precision=dtype == "float32")
    want = f(jp, jb)
    got, cache, aux = tlm.lm_forward(tc, tp, tb)
    assert cache is None and float(aux) == 0.0
    assert got.shape == want.shape == (2, PREFILL + STEPS,
                                       tlm.padded_vocab(tc))
    V = tc.vocab_size
    _held(got[..., :V], want[..., :V], dtype == "bfloat16")


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_reference(dtype):
    """Prefill (first logits, self-attention caches, ``cross_kv`` in the
    encoder output's dtype), then STEPS teacher-forced steps in both from
    the reference's caches, ``cross_kv`` carried over: each step's
    logits, the caches object and its tensors kept, ``cross_kv``
    untouched."""
    bf16 = dtype == "bfloat16"
    jc, tc, jp, tp = _params(dtype=dtype)
    jb, tb = _batch(jc)
    f = _jit(lambda p, b: jlm.lm_prefill(jc, p, b, max_seq=MAX_SEQ), jp,
             _cut(jb, PREFILL), excess_precision=not bf16)
    jcache, jfirst = f(jp, _cut(jb, PREFILL))
    tcache, tfirst = tlm.lm_prefill(tc, tp, _cut(tb, PREFILL),
                                    max_seq=MAX_SEQ)
    V = tc.vocab_size
    _held(tfirst[:, :V], jfirst[:, :V], bf16)
    _assert_caches(tcache, jcache, bf16)
    tcache = lm_caches_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    leaves = tapi.tree_leaves(tcache, torch.is_tensor)
    ptrs = [t.data_ptr() for t in leaves]
    cross = {n: t.clone() for n, t in tcache["cross_kv"].items()}
    toks = np.array(jb["tokens"])
    args = (jp, jcache, jnp.asarray(toks[:, :1]), jnp.int32(PREFILL))
    step = _jit(lambda p, c, t, pos: jlm.lm_decode_step(jc, p, c, t, pos),
                *args, excess_precision=not bf16)
    for pos in range(PREFILL, PREFILL + STEPS):
        jcache, jl = step(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.int32(pos))
        out, tl = tlm.lm_decode_step(
            tc, tp, tcache, torch.as_tensor(toks[:, pos:pos + 1]).long(), pos)
        assert out is tcache
        _held(tl[:, :V], jl[:, :V], bf16)
    assert [t.data_ptr() for t in tapi.tree_leaves(
        tcache, torch.is_tensor)] == ptrs
    assert all(torch.equal(tcache["cross_kv"][n], cross[n]) for n in cross)
    _assert_caches(tcache, jcache, bf16)


def test_decode_matches_full_forward():
    """Prefill S-1 tokens + decode 1 == the full forward at the last
    position, within the reference's own bound (1e-3)."""
    _, tc, _, tp = _params()
    _, tb = _batch(tc, S=16)
    full, _, _ = tlm.lm_forward(tc, tp, tb)
    caches, first = tlm.lm_prefill(tc, tp, _cut(tb, 15), max_seq=32)
    assert first.shape == (2, tlm.padded_vocab(tc))
    _, step = tlm.lm_decode_step(tc, tp, caches, tb["tokens"][:, 15:16], 15)
    err = float((full[:, -1].float() - step.float()).abs().max())
    assert err <= 1e-3, err


@pytest.mark.parametrize("encoder_seq", [None, 48])
def test_init_caches_match_reference(encoder_seq):
    """Shapes, dtypes and values of every leaf as the reference's:
    ``cross_kv`` bf16 zeros (num_layers, B, T, nkv, hd), T =
    ``encoder_seq`` or the config's."""
    jc, tc = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    want = jlm.init_caches(jc, 2, 64, encoder_seq=encoder_seq)
    got = tlm.init_caches(tc, 2, 64, encoder_seq=encoder_seq, device="cpu")
    carried = lm_caches_from_numpy(jax.tree.map(np.asarray, want), "cpu")
    T = encoder_seq or tc.encoder_seq
    for tree in (got, carried):
        for name in ("k", "v"):
            c = tree["cross_kv"][name]
            assert c.dtype == torch.bfloat16 and not c.any()
            assert tuple(c.shape) == want["cross_kv"][name].shape == (
                tc.num_layers, 2, T, tc.num_kv_heads, tc.resolved_head_dim)
        for tb, jb in zip(tree["blocks"], want["blocks"], strict=True):
            assert sorted(tb) == sorted(jb)
            for name in jb:
                assert tuple(tb[name].shape) == jb[name].shape
                assert str(tb[name].dtype).split(".")[1] == str(
                    jb[name].dtype)
                np.testing.assert_array_equal(_np(tb[name]), _np(jb[name]))


def test_params_carry_the_encoder_and_cross_trees():
    """``lm_params_from_numpy`` keeps the reference's nesting: the
    encoder's stacked blocks and final norm, one cross-attention per
    decoder layer (no biases), every leaf equal; the spec counts agree."""
    jc, tc, jp, tp = _params()
    assert sorted(tp) == sorted(jp) == ["blocks", "cross", "embed",
                                        "encoder", "final_norm"]
    assert sorted(tp["encoder"]) == ["blocks", "final_norm"]
    assert sorted(tp["cross"]) == ["cross", "norm_cross"]
    assert sorted(tp["cross"]["cross"]) == ["wk", "wo", "wq", "wv"]
    assert tp["encoder"]["blocks"]["attn"]["wq"].shape[0] == \
        tc.encoder_layers
    assert tp["cross"]["norm_cross"].shape[0] == tc.num_layers
    for jl, tl in zip(jax.tree.leaves(jp),
                      tapi.tree_leaves(tp, torch.is_tensor), strict=True):
        assert tuple(tl.shape) == jl.shape
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tapi.num_params(tlm.lm_specs(tc)) == japi.num_params(
        jlm.lm_specs(jc))


def test_forward_needs_audio_embed():
    _, tc, _, tp = _params()
    _, tb = _batch(tc)
    with pytest.raises(KeyError, match="audio_embed"):
        tlm.lm_forward(tc, tp, {"tokens": tb["tokens"]})


def test_sinusoidal_frequencies_are_the_same_on_every_device():
    """The frequencies are the float64 values rounded once to float32,
    computed on the host: no device's float32 ``exp`` enters them (on the
    card, one last bit of it moved whisper's encoder output by 7e-4 at
    1500 frames, twelve times the CPU's distance from float64)."""
    import math

    from repro_torch.models.common import sinusoidal_pos
    pos = np.arange(1500, dtype=np.int64)
    half = 192
    freqs = np.exp(-math.log(10000.0) * np.arange(half, dtype=np.float64)
                   / (half - 1)).astype(np.float32)
    ang = pos[:, None].astype(np.float32) * freqs
    got = sinusoidal_pos(torch.as_tensor(pos), 2 * half).numpy()
    np.testing.assert_allclose(got[:, :half], np.sin(ang), atol=2e-7)
    np.testing.assert_allclose(got[:, half:], np.cos(ang), atol=2e-7)

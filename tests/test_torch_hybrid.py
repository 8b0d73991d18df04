"""The port's recurrent and hybrid language models — xlstm-125m (mLSTM x3
+ sLSTM) and zamba2-2.7b (Mamba2 x5 + one weight-tied SHARED_ATTN block) —
against the reference's at their smoke sizes: ``lm_forward``,
``lm_prefill`` (caches leaf by leaf), and ``lm_decode_step`` started from
the reference's own prefilled cache (``convert.lm_caches_from_numpy``),
on the same weights (``convert.lm_params_from_numpy``) and numpy-seeded
tokens.

Mamba2's chunked form is ill-conditioned in float32: ``exp(la_i - la_j)``
subtracts cumulative log decays of magnitude ~500 (A down to -16, 16
steps a chunk), so a last-bit difference in ``dt`` (another summation
order of its projection) moves the output by ~1e-5 relative, and the
layers amplify it (measured: 2.7e-4 relative after 5 layers at 48
tokens, the reference against itself run op by op in float64 not
available). The tolerances follow what that leaves:

- float32: logits at atol = rtol = 1e-4 (measured over three seeds: at
  most 4.1e-5); recurrent state leaves within 2e-4 of the leaf's largest
  value (measured: at most 4.9e-5); the shared block's bf16 k/v within
  one bf16 ulp of the value or 5e-4 of the leaf's largest value
  (measured: 1.7e-4 of it, keys near 0 carrying the float32 error).
  A decode step of a float32 config still rounds the shared block's
  probabilities, output and ``wo`` product to bf16 (the reference's
  dtype flow), so one float32 last bit can flip a rounding: zamba2's
  decode logits are held at 2e-3 (measured: 5.2e-4 at the steps with a
  flip, at most 3.2e-6 at the others; the reference's own float32
  decode-vs-forward distance is ~1.5e-3), xlstm's at 1e-4 (measured:
  1.2e-6).
- bf16 (the configs' own dtype), in bf16 ulps at the tensor's scale
  (``ulp = 2**(floor(log2(max|x|)) - 7)``): against the reference
  compiled with XLA's excess precision off (every op rounded to its
  dtype, as the port does) at most 4 ulps and 0.5 on average (measured:
  at most 0.5 and 0.03; decode steps bit-identical but for xlstm's 0.5);
  state leaves (float32) within 1e-2 of the leaf's largest value
  (measured: 2.0e-3: bf16 projections rounded on either side feed them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.lm as jlm
import repro.sharding.api as japi
import repro.train.step as jstep
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
import repro_torch.sharding.api as tapi
import repro_torch.train.step as tstep
from repro_torch.convert import lm_caches_from_numpy, lm_params_from_numpy
from repro_torch.launch.serve import make_lm_backend

ARCHS = ("xlstm-125m", "zamba2-2.7b")
# the reference's own decode-vs-forward bounds (tests/test_arch_smoke.py)
DECODE_TOL = {"zamba2-2.7b": 0.25}
F32_DECODE_TOL = {"zamba2-2.7b": 2e-3}         # see the module docstring
PREFILL, STEPS, MAX_SEQ = 16, 8, 32            # smoke chunk: 16


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
    f = jax.jit(fn)
    if excess_precision:
        return f
    return f.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _ulps(got, want):
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want) / ulp
    return err.max(), err.mean()


def _held(got, want, bf16, tol=1e-4):
    """Logits (real vocabulary only): ``tol`` in float32, 4 ulps / 0.5 in
    bf16."""
    got, want = _np(got), _np(want)
    if not bf16:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        return
    err = _ulps(got, want)
    assert err[0] <= 4.0 and err[1] <= 0.5, err


def _assert_caches(tcache, jcache, bf16):
    assert tcache["cross_kv"] is None and jcache["cross_kv"] is None
    for tb, jb in zip(tcache["blocks"], jcache["blocks"], strict=True):
        assert sorted(tb) == sorted(jb)
        for name in jb:
            got, want = tb[name], _np(jb[name])
            assert tuple(got.shape) == want.shape
            assert str(got.dtype).split(".")[1] == str(jb[name].dtype)
            got = _np(got)
            if name == "pos":
                np.testing.assert_array_equal(got, want)
            elif name in ("k", "v"):           # the shared block's bf16 cache
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                    np.abs(want), 2.0 ** -126))) - 7)
                if bf16:
                    err = _ulps(got, want)
                    assert err[0] <= 4.0 and err[1] <= 0.5, (name, err)
                else:
                    tol = np.maximum(ulp, 5e-4 * np.abs(want).max())
                    d = np.abs(got - want)
                    assert (d <= tol).all(), (name, (d / np.abs(want).max())
                                              .max())
            else:
                scale = max(np.abs(want).max(), 1e-30)
                tol = 1e-2 if bf16 else 2e-4
                assert np.abs(got - want).max() <= tol * scale, (
                    name, np.abs(got - want).max() / scale)


def _ref_prefill(jc, jp, toks, excess_precision=True):
    b = {"tokens": jnp.asarray(toks)}
    return _jit(lambda p, b: jlm.lm_prefill(jc, p, b, max_seq=MAX_SEQ), jp,
                b, excess_precision=excess_precision)(jp, b)


def _port_tokens(toks):
    return torch.as_tensor(toks).long()


# ---------------------------------------------------------------------------
# forward and prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    jc, tc, jp, tp = _params(arch, dtype=dtype)
    toks = _tokens(jc, S=32)
    b = {"tokens": jnp.asarray(toks)}
    f = _jit(lambda p, b: jlm.lm_forward(jc, p, b)[0], jp, b,
             excess_precision=dtype == "float32")
    want = f(jp, b)
    got, cache, aux = tlm.lm_forward(tc, tp, {"tokens": _port_tokens(toks)})
    assert cache is None and float(aux) == 0.0
    assert got.shape == want.shape == (2, 32, tlm.padded_vocab(tc))
    V = tc.vocab_size
    _held(got[..., :V], want[..., :V], dtype == "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype):
    """First logits and every cache leaf: Mamba2 ``s``/``conv``, mLSTM
    ``C``/``n``/``m``, sLSTM ``c``/``n``/``h``/``m``, the shared block's
    ``k``/``v``/``pos``, stacked over the repetitions."""
    jc, tc, jp, tp = _params(arch, dtype=dtype)
    toks = _tokens(jc)[:, :PREFILL]
    jcache, jfirst = _ref_prefill(jc, jp, toks, dtype == "float32")
    tcache, tfirst = tlm.lm_prefill(tc, tp, {"tokens": _port_tokens(toks)},
                                    max_seq=MAX_SEQ)
    V = tc.vocab_size
    _held(tfirst[:, :V], jfirst[:, :V], dtype == "bfloat16")
    _assert_caches(tcache, jcache, dtype == "bfloat16")


def test_prefill_of_two_chunks_and_of_a_short_prompt():
    """Prefill lengths: 48 tokens (three chunks of 16) and 5 (one chunk
    of 5) match the reference; 20 (not a multiple of 16) is refused
    with ``ValueError`` (the reference asserts)."""
    jc, tc, jp, tp = _params("zamba2-2.7b", dtype="float32")
    toks = _tokens(jc, S=48)
    for S in (48, 5):
        jcache, jfirst = jlm.lm_prefill(jc, jp, {"tokens": jnp.asarray(
            toks[:, :S])}, max_seq=64)
        tcache, tfirst = tlm.lm_prefill(
            tc, tp, {"tokens": _port_tokens(toks[:, :S])}, max_seq=64)
        _held(tfirst, jfirst, False)
        _assert_caches(tcache, jcache, False)
    with pytest.raises(ValueError, match="not a multiple of the SSM chunk"):
        tlm.lm_prefill(tc, tp, {"tokens": _port_tokens(toks[:, :20])},
                       max_seq=64)


# ---------------------------------------------------------------------------
# decode from the reference's prefilled cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype):
    """STEPS teacher-forced steps in both from the reference's prefilled
    cache: each step's logits, then every cache leaf, and the caches
    object and its tensors are the ones the port was given."""
    bf16 = dtype == "bfloat16"
    jc, tc, jp, tp = _params(arch, dtype=dtype)
    toks = _tokens(jc)
    jcache, _ = _ref_prefill(jc, jp, toks[:, :PREFILL], not bf16)
    tcache = lm_caches_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    leaves = tapi.tree_leaves(tcache, torch.is_tensor)
    ptrs = [t.data_ptr() for t in leaves]
    args = (jp, jcache, jnp.asarray(toks[:, :1]), jnp.int32(PREFILL))
    step = _jit(lambda p, c, t, pos: jlm.lm_decode_step(jc, p, c, t, pos),
                *args, excess_precision=not bf16)
    V = tc.vocab_size
    for pos in range(PREFILL, PREFILL + STEPS):
        jcache, jl = step(jp, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.int32(pos))
        out, tl = tlm.lm_decode_step(tc, tp, tcache,
                                     _port_tokens(toks[:, pos:pos + 1]), pos)
        assert out is tcache                          # updated in place
        _held(tl[:, :V], jl[:, :V], bf16, F32_DECODE_TOL.get(arch, 1e-4))
    assert [t.data_ptr() for t in tapi.tree_leaves(
        tcache, torch.is_tensor)] == ptrs
    _assert_caches(tcache, jcache, bf16)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Prefill S-1 tokens + decode 1 == the full forward at the last
    position, at the reference's own bounds (zamba2: the chunked SSD
    prefill against the exact recurrence in bf16 through 6 layers)."""
    _, tc, _, tp = _params(arch)
    toks = _port_tokens(_tokens(tc, S=16))
    full, _, _ = tlm.lm_forward(tc, tp, {"tokens": toks})
    caches, first = tlm.lm_prefill(tc, tp, {"tokens": toks[:, :15]},
                                   max_seq=32)
    assert first.shape == (2, tlm.padded_vocab(tc))
    _, step = tlm.lm_decode_step(tc, tp, caches, toks[:, 15:16], 15)
    err = float((full[:, -1].float() - step.float()).abs().max())
    assert err <= DECODE_TOL.get(arch, 1e-3), err


def test_short_prompt_mamba2_decode_is_refused():
    """After a 2-token prompt the Mamba2 conv caches hold 2 inputs: the
    port's decode raises ``ValueError`` naming the cause, the reference's
    fails inside an einsum (ROADMAP Queue 3). An xlstm prompt of 2 tokens
    decodes."""
    jc, tc, jp, tp = _params("zamba2-2.7b", dtype="float32")
    toks = _tokens(jc, B=1, S=3)
    tcache, _ = tlm.lm_prefill(tc, tp, {"tokens": _port_tokens(toks[:, :2])},
                               max_seq=8)
    assert tcache["blocks"][0]["conv"].shape == (tc.pattern_repeats, 1, 2,
                                                 128)
    with pytest.raises(ValueError, match="fewer than 3 tokens"):
        tlm.lm_decode_step(tc, tp, tcache, _port_tokens(toks[:, 2:]), 2)
    jcache, _ = jlm.lm_prefill(jc, jp, {"tokens": jnp.asarray(toks[:, :2])},
                               max_seq=8)
    with pytest.raises(ValueError, match="label 'q'"):
        jlm.lm_decode_step(jc, jp, jcache, jnp.asarray(toks[:, 2:]),
                           jnp.int32(2))
    _, xc, _, xp = _params("xlstm-125m", dtype="float32")
    caches, _ = tlm.lm_prefill(xc, xp, {"tokens": _port_tokens(toks[:, :2])},
                               max_seq=8)
    _, logits = tlm.lm_decode_step(xc, xp, caches, _port_tokens(toks[:, 2:]),
                                   2)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the shared block, caches, step functions, backend
# ---------------------------------------------------------------------------

def test_shared_block_is_one_tree_with_a_cache_per_repetition():
    """zamba2: ``blocks[5]`` is ``{}``, ``params["shared"]`` holds the one
    unstacked attention + MLP tree (d_ff MLP included) that every
    repetition uses, and each repetition has its own KV cache."""
    jc, tc, jp, tp = _params("zamba2-2.7b", dtype="float32",
                             num_layers=12)
    assert tp["blocks"][5] == {} and jp["blocks"][5] == {}
    assert sorted(tp["shared"]) == ["attn", "mlp", "norm1", "norm2"]
    assert tuple(tp["shared"]["attn"]["wq"].shape) == (
        tc.d_model, tc.num_heads, tc.resolved_head_dim)
    assert tuple(tp["shared"]["mlp"]["gate"].shape) == (tc.d_model, tc.d_ff)
    want = japi.num_params(jlm.lm_specs(jc))
    assert sum(t.numel() for t in tapi.tree_leaves(
        tp, torch.is_tensor)) == want == tapi.num_params(tlm.lm_specs(tc))
    toks = _port_tokens(_tokens(tc, S=17))
    caches, _ = tlm.lm_prefill(tc, tp, {"tokens": toks[:, :16]}, max_seq=32)
    assert caches["blocks"][5]["k"].shape[0] == tc.pattern_repeats == 2
    assert not torch.equal(caches["blocks"][5]["k"][0],
                           caches["blocks"][5]["k"][1])
    # the one tree is what every repetition reads: with the shared wq
    # scaled the forward moves, and equals the reference's with the same
    # change (12 layers: 1e-3, measured 2.3e-4; the module docstring)
    before = tlm.lm_forward(tc, tp, {"tokens": toks[:, :16]})[0]
    tp["shared"]["attn"]["wq"].mul_(2.0)
    jp["shared"]["attn"]["wq"] = jp["shared"]["attn"]["wq"] * 2.0
    got = tlm.lm_forward(tc, tp, {"tokens": toks[:, :16]})[0]
    want = jax.jit(lambda p, t: jlm.lm_forward(jc, p, {"tokens": t})[0])(
        jp, jnp.asarray(toks[:, :16].numpy().astype(np.int32)))
    V = tc.vocab_size
    assert float((got - before)[..., :V].abs().max()) > 1e-2
    np.testing.assert_allclose(_np(got)[..., :V], _np(want)[..., :V],
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_reference(arch):
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    want = jlm.init_caches(jc, 2, 64)
    got = tlm.init_caches(tc, 2, 64, device="cpu")
    carried = lm_caches_from_numpy(jax.tree.map(np.asarray, want), "cpu")
    assert got["cross_kv"] is None and want["cross_kv"] is None
    for tb, jb, cb in zip(got["blocks"], want["blocks"], carried["blocks"],
                          strict=True):
        assert sorted(tb) == sorted(jb) == sorted(cb)
        for name in jb:
            assert tuple(tb[name].shape) == jb[name].shape
            assert str(tb[name].dtype).split(".")[1] == str(jb[name].dtype)
            assert cb[name].dtype == tb[name].dtype
            np.testing.assert_array_equal(_np(tb[name]), _np(jb[name]))


@pytest.mark.parametrize("arch", ARCHS)
def test_step_functions_give_the_reference_greedy_tokens(arch):
    """``make_prefill_step``, then greedy ``make_decode_step``s feeding
    their own tokens back from the reference's prefilled cache: the same
    (B, 1) int32 tokens as the reference's steps (float32)."""
    jc, tc, jp, tp = _params(arch, dtype="float32")
    toks = _tokens(jc)[:, :PREFILL]
    jcache, jl = jax.jit(jstep.make_prefill_step(jc, MAX_SEQ))(
        jp, {"tokens": jnp.asarray(toks)})
    _, tl = tstep.make_prefill_step(tc, MAX_SEQ)(
        tp, {"tokens": _port_tokens(toks)})
    jdec, tdec = jax.jit(jstep.make_decode_step(jc)), \
        tstep.make_decode_step(tc)
    tcache = lm_caches_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl, dim=-1).to(torch.int32)[:, None]
    for pos in range(PREFILL, PREFILL + STEPS):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jcache, jt, _ = jdec(jp, jcache, jt, jnp.int32(pos))
        out, tt, _ = tdec(tp, tcache, tt, pos)
        assert out is tcache and tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("arch", ARCHS)
def test_make_lm_backend_serves_the_recurrent_configs(arch):
    """``make_lm_backend(arch=)`` builds the smoke config and times one
    forward of 64 tokens (four chunks of 16) a busy frame."""
    backend = make_lm_backend(arch=arch, device="cpu")
    assert backend(type("F", (), {"busy": True})()) > 0.0

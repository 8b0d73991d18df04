"""The port's recurrent mixers (``repro_torch.models.ssm``: Mamba2/SSD,
mLSTM, sLSTM) against the reference's (``repro.models.ssm``) on the smoke
configs' widths: the same weights (the reference's ``materialize`` carried
by ``convert.lm_params_from_numpy``) and the same numpy-seeded inputs;
then the port's own chunked-vs-recurrent parity at the reference's
shapes and tolerances (``tests/test_ssm_parity.py``).

Tolerances:
- float32: outputs at atol = rtol = 1e-4 (measured: at most 1.3e-5 at
  |y| ~5, Mamba2's chunked form); states at rtol 1e-5 and atol 1e-5 of
  the leaf's largest value (measured: at most 2e-7 of it).
- bf16 outputs in bf16 ulps at the output's scale (``ulp = 2**(floor(
  log2(max|y|)) - 7)``): against the reference compiled with XLA's
  excess precision off (``xla_allow_excess_precision=False``, every op
  rounded to its declared dtype, as the port does) at most 1 ulp and 0.05
  on average (measured: at most 0.03); jitted as it runs, where XLA keeps
  fused bf16 chains in float32, at most 4 and 0.5 (measured: at most 1.0
  and 0.22). States are float32 in every config: held as in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.ssm as jssm
import repro.sharding.api as japi
import repro_torch.configs as tconfigs
import repro_torch.models.ssm as tssm
from repro_torch.convert import lm_caches_from_numpy, lm_params_from_numpy

MIXERS = {"mamba2": "zamba2-2.7b", "mlstm": "xlstm-125m",
          "slstm": "xlstm-125m"}
# (dtype, excess precision, max ulps, mean ulps); float32 in absolute terms
CASES = [("float32", True, None, None), ("bfloat16", False, 1.0, 0.05),
         ("bfloat16", True, 4.0, 0.5)]


def _cfgs(arch, **kw):
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    if kw:
        jc, tc = jconfigs.scaled(jc, **kw), tconfigs.scaled(tc, **kw)
    return jc, tc


def _mixer(kind, seed=0, **kw):
    """(reference cfg, port cfg, reference params, port params)."""
    jc, tc = _cfgs(MIXERS[kind], **kw)
    jp = japi.materialize(getattr(jssm, f"{kind}_specs")(jc),
                          jax.random.key(seed))
    return jc, tc, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _x(cfg, B, L, seed=0, dtype="float32"):
    """The same seeded input for both: (jax array, torch tensor)."""
    j = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (B, L, cfg.d_model)) * 0.5, jnp.float32).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _np(x):
    return (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


def _jit(fn, *args, excess_precision=True):
    f = jax.jit(fn)
    if excess_precision:
        return f
    return f.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _assert_out(got, want, max_ulps, mean_ulps):
    got, want = _np(got), _np(want)
    if max_ulps is None:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want) / ulp
    assert err.max() <= max_ulps and err.mean() <= mean_ulps, (
        err.max(), err.mean())


def _assert_state(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name], _np(want[name])
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)


def _roll(step, state, params, cfg, x):
    outs = []
    for t in range(x.shape[1]):
        y, state = step(params, cfg, x[:, t:t + 1], state)
        outs.append(y)
    return torch.cat(outs, dim=1), state


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,excess_precision,max_ulps,mean_ulps", CASES)
@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_train_and_step_match_reference(kind, dtype, excess_precision,
                                        max_ulps, mean_ulps):
    """``*_train(return_state=True)`` over 32 tokens (two chunks of 16),
    then one ``*_step`` from the reference's final state: outputs and
    every state leaf."""
    jc, tc, jp, tp = _mixer(kind, dtype=dtype)
    jx, tx = _x(jc, 2, 33, dtype=dtype)
    jtrain, ttrain = (getattr(m, f"{kind}_train") for m in (jssm, tssm))
    jstep, tstep = (getattr(m, f"{kind}_step") for m in (jssm, tssm))
    f = _jit(lambda p, x: jtrain(p, jc, x, return_state=True), jp,
             jx[:, :32], excess_precision=excess_precision)
    jy, jst = f(jp, jx[:, :32])
    ty, tst = ttrain(tp, tc, tx[:, :32], return_state=True)
    assert ty.dtype == tx.dtype and ty.shape == tx[:, :32].shape
    _assert_out(ty, jy, max_ulps, mean_ulps)
    _assert_state(tst, jst)
    g = _jit(lambda p, x, s: jstep(p, jc, x, s), jp, jx[:, 32:], jst,
             excess_precision=excess_precision)
    jy1, jst1 = g(jp, jx[:, 32:], jst)
    start = lm_caches_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    before = {k: v.clone() for k, v in start.items()}
    ty1, tst1 = tstep(tp, tc, tx[:, 32:], start)
    assert all(torch.equal(start[k], before[k]) for k in start)  # not written
    _assert_out(ty1, jy1, max_ulps, mean_ulps)
    _assert_state(tst1, jst1)


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_init_state_matches_reference(kind):
    jc, tc = _cfgs(MIXERS[kind])
    want = getattr(jssm, f"{kind}_init_state")(jc, 3)
    got = getattr(tssm, f"{kind}_init_state")(tc, 3, "cpu")
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape and not got[name].any()
        assert got[name].dtype == torch.float32 and str(w.dtype) == "float32"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    """Four shifted multiply-adds in the input's dtype: bit for bit
    against the reference compiled with excess precision off."""
    rng = np.random.default_rng(3)
    jx = jnp.asarray(rng.standard_normal((2, 20, 48)), jnp.float32).astype(
        dtype)
    jw = jnp.asarray(rng.standard_normal((4, 48)) * 0.5, jnp.float32).astype(
        dtype)
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (jx, jw))
    want = _jit(jssm._causal_conv, jx, jw, excess_precision=False)(jx, jw)
    got = tssm._causal_conv(tx, tw)
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 0.0
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_softplus_and_log_sigmoid_match_reference():
    """``logaddexp(x, 0)`` and its negation at -x, as ``jax.nn`` has them:
    within 3e-7 relative of the reference on 200k float32 values in
    [-40, 40] (measured: 2.6e-7; ``F.softplus``'s shortcut above 20 is
    9.5e-7 away in absolute terms)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(100_000) * 8,
                        np.linspace(-40, 40, 100_001)]).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(tssm.softplus(t).numpy(),
                               np.asarray(jax.jit(jax.nn.softplus)(x)),
                               rtol=3e-7, atol=0)
    np.testing.assert_allclose(tssm.log_sigmoid(t).numpy(),
                               np.asarray(jax.jit(jax.nn.log_sigmoid)(x)),
                               rtol=3e-7, atol=0)


def test_short_conv_cache_is_refused():
    """A Mamba2 prefill of fewer than 3 tokens leaves fewer than 3 inputs
    in the conv cache. The reference's next step fails inside an einsum;
    the port's raises ``ValueError`` naming the cause."""
    jc, tc, jp, tp = _mixer("mamba2")
    jx, tx = _x(jc, 1, 3)
    _, jst = jssm.mamba2_train(jp, jc, jx[:, :2], return_state=True)
    _, tst = tssm.mamba2_train(tp, tc, tx[:, :2], return_state=True)
    assert tst["conv"].shape == jst["conv"].shape == (1, 2, 128)
    with pytest.raises(ValueError, match="fewer than 3 tokens"):
        tssm.mamba2_step(tp, tc, tx[:, 2:], tst)
    with pytest.raises(ValueError, match="label 'q'"):
        jssm.mamba2_step(jp, jc, jx[:, 2:], jst)


@pytest.mark.parametrize("kind", ["mamba2", "mlstm"])
def test_sequence_must_be_a_multiple_of_the_chunk(kind):
    """Q = min(ssm_chunk, L) must divide L (smoke chunk 16): 20 tokens
    are refused with ``ValueError``, as the reference asserts."""
    jc, tc, jp, tp = _mixer(kind)
    _, tx = _x(tc, 1, 20)
    with pytest.raises(ValueError, match="multiple of the SSM chunk 16"):
        getattr(tssm, f"{kind}_train")(tp, tc, tx)
    jx, _ = _x(jc, 1, 20)
    with pytest.raises(AssertionError):
        getattr(jssm, f"{kind}_train")(jp, jc, jx)


# ---------------------------------------------------------------------------
# the port alone: chunked vs recurrent (tests/test_ssm_parity.py's shapes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,chunk", [(16, 16), (32, 8), (64, 16)])
def test_mamba2_chunked_equals_recurrent(L, chunk):
    _, tc, _, tp = _mixer("mamba2", ssm_chunk=chunk)
    _, x = _x(tc, 2, L, seed=L)
    y_chunk, fin = tssm.mamba2_train(tp, tc, x, return_state=True)
    y_step, fin_step = _roll(tssm.mamba2_step,
                             tssm.mamba2_init_state(tc, 2, "cpu"), tp, tc, x)
    np.testing.assert_allclose(y_chunk.numpy(), y_step.numpy(), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(fin["s"].numpy(), fin_step["s"].numpy(),
                               atol=2e-4, rtol=1e-3)
    # the last 3 projected inputs (a projection of L rows vs of one)
    np.testing.assert_allclose(fin["conv"].numpy(), fin_step["conv"].numpy(),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("L,chunk", [(16, 16), (32, 8)])
def test_mlstm_chunked_equals_recurrent(L, chunk):
    _, tc, _, tp = _mixer("mlstm", ssm_chunk=chunk)
    _, x = _x(tc, 2, L, seed=L)
    y_chunk = tssm.mlstm_train(tp, tc, x)
    y_step, _ = _roll(tssm.mlstm_step, tssm.mlstm_init_state(tc, 2, "cpu"),
                      tp, tc, x)
    np.testing.assert_allclose(y_chunk.numpy(), y_step.numpy(), atol=3e-4,
                               rtol=1e-3)


def test_slstm_scan_equals_step():
    _, tc, _, tp = _mixer("slstm")
    _, x = _x(tc, 2, 24)
    y_scan, fin = tssm.slstm_train(tp, tc, x, return_state=True)
    y_step, fin_step = _roll(tssm.slstm_step,
                             tssm.slstm_init_state(tc, 2, "cpu"), tp, tc, x)
    np.testing.assert_allclose(y_scan.numpy(), y_step.numpy(), atol=1e-5)
    np.testing.assert_allclose(fin["h"].numpy(), fin_step["h"].numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("B,L,seed", [(1, 8, 0), (2, 16, 1), (3, 32, 2),
                                      (2, 8, 3)])
def test_mamba2_state_continuation(B, L, seed):
    """Chunked prefill state + one exact step == the recurrent roll over
    L + 1 tokens (the reference's property, at fixed seeds)."""
    _, tc, _, tp = _mixer("mamba2", seed=1, ssm_chunk=8)
    _, x = _x(tc, B, L + 1, seed=seed)
    y_ref, _ = _roll(tssm.mamba2_step, tssm.mamba2_init_state(tc, B, "cpu"),
                     tp, tc, x)
    _, st = tssm.mamba2_train(tp, tc, x[:, :L], return_state=True)
    y_last, _ = tssm.mamba2_step(tp, tc, x[:, L:], st)
    np.testing.assert_allclose(y_ref[:, -1].numpy(), y_last[:, 0].numpy(),
                               atol=3e-4, rtol=1e-2)


def test_mamba2_decay_bounded():
    """SSM decays are in (0, 1]: the state cannot grow without input."""
    _, tc, _, tp = _mixer("mamba2")
    st = tssm.mamba2_init_state(tc, 2, "cpu")
    st["s"] = torch.ones_like(st["s"])
    _, st2 = tssm.mamba2_step(tp, tc, torch.zeros((2, 1, tc.d_model)), st)
    assert float(st2["s"].abs().max()) <= 1.0 + 1e-5


def test_mamba2_float32_error_grows_with_the_chunk():
    """The reference's chunked SSD subtracts cumulative log decays
    (``exp(la_i - la_j)``) that reach ~1e3 over a chunk of 256 with its
    init (``A`` down to -16, ``dt_bias`` 0): its float32 output drifts
    from the port run in float64 as the chunk grows (measured on 256
    tokens of one smoke-width layer: 1.6e-5 at chunk 16, 3.5e-4 at 256).
    Found porting item 10.3 (ROADMAP Queue 3); it is why zamba2's card
    checks hold float32 against float64, not at a fixed tolerance."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 256, 64)).astype(np.float32)
    err = {}
    for chunk in (16, 256):
        jc, tc, jp, tp = _mixer("mamba2", dtype="float32", ssm_chunk=chunk)
        want = tssm.mamba2_train(tp, tconfigs.scaled(tc, dtype="float64"),
                                 torch.from_numpy(x).double()).numpy()
        got = np.asarray(jax.jit(lambda p, x: jssm.mamba2_train(p, jc, x))(
            jp, jnp.asarray(x)))
        err[chunk] = np.abs(got - want).max()
    assert err[16] < 1e-4 and err[256] > 5 * err[16], err

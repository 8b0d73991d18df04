"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against
the reference's (``repro.models.moe``), jitted as it runs: the same
weights (the reference's ``materialize(moe_specs(cfg), key)`` carried
across by ``convert.lm_params_from_numpy``) and the same numpy-seeded
activations, in float32 and in bf16, for both dispatches.

Tolerances:
- routing: ``top_idx`` exact (ties included: the lower expert first, as
  ``lax.top_k`` gives it), ``top_w`` and ``aux`` within 1e-6;
  ``_positions_in_expert`` exact;
- outputs: within 1e-5 in float32 (measured: at most 1.8e-7); in bf16
  within one bf16 ulp at the output's scale (``ulp = 2**(floor(log2(
  max|y|)) - 7)``, as in ``test_torch_lm.py``; measured: exact but for
  one token's row in one case, 0.25 ulp off — an expert product summed
  in another order flips one bf16 rounding of its hidden row).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.lm as jlm
import repro.models.moe as jmoe
import repro.sharding.api as japi
import repro_torch.configs as tconfigs
import repro_torch.models.moe as tmoe
from repro_torch.convert import lm_params_from_numpy

IMPLS = ("scatter", "onehot")
DTYPES = ("float32", "bfloat16")


def _cfgs(dtype="float32", **kw):
    kw = dict(dict(num_experts=4, top_k=2, moe_capacity_factor=1.25), **kw)
    base = "mixtral-8x7b"
    return (jconfigs.scaled(jconfigs.get_smoke_config(base), dtype=dtype,
                            **kw),
            tconfigs.scaled(tconfigs.get_smoke_config(base), dtype=dtype,
                            **kw))


def _setup(dtype="float32", seed=0, B=2, S=24, **kw):
    jc, tc = _cfgs(dtype, **kw)
    jp = japi.materialize(jmoe.moe_specs(jc), jax.random.key(seed))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    xj = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (B, S, jc.d_model)), jnp.float32).astype(jc.dtype)
    return jc, tc, jp, tp, xj, _torch(xj)


def _torch(xj):
    """A JAX array as a torch tensor of the same dtype and values."""
    t = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    return t.to(getattr(torch, str(xj.dtype)))


def _np(x):
    return (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


def _assert_out_close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:   # one bf16 ulp at the output's scale
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp, np.abs(got - want).max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,k,cf", [(4, 2, 1.25), (8, 2, 0.5), (32, 8, 1.25)])
def test_route_matches_reference(E, k, cf, dtype):
    jc, tc, jp, tp, xj, xt = _setup(dtype, num_experts=E, top_k=k,
                                    moe_capacity_factor=cf)
    ji, jw, ja = jax.jit(lambda p, x: jmoe._route(p, jc, x))(jp, xj)
    ti, tw, ta = tmoe._route(tp, tc, xt)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tw.dtype == xt.dtype
    np.testing.assert_allclose(_np(tw), _np(jw), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(
        tmoe._positions_in_expert(ti, E).numpy(),
        np.asarray(jmoe._positions_in_expert(ji, E)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_route_ties_take_the_lower_expert(dtype):
    """Experts 1, 2 and 3 share a router column and expert 0 has its
    negation: every token ties three ways, and the top 2 are [1, 2] where
    the shared logit is positive, else [0, 1] — in both packages."""
    jc, tc, jp, tp, xj, xt = _setup(dtype)
    col = np.random.default_rng(4).standard_normal(jc.d_model) * 0.02
    router = np.stack([-col, col, col, col], axis=1).astype(np.float32)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.as_tensor(router))
    ji, jw, ja = jax.jit(lambda p, x: jmoe._route(p, jc, x))(jp, xj)
    ti, tw, ta = tmoe._route(tp, tc, xt)
    shared = np.asarray(jnp.einsum("bsd,d->bs", xj.astype(jnp.float32),
                                   jnp.asarray(col, jnp.float32)))
    want = np.where((shared > 0)[..., None], [1, 2], [0, 1])
    np.testing.assert_array_equal(np.asarray(ji)[np.abs(shared) > 1e-3],
                                  want[np.abs(shared) > 1e-3])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_np(tw), _np(jw), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed,E,k,cf", [(0, 4, 2, 2.0), (1, 8, 2, 1.25),
                                         (2, 32, 8, 1.25)])
def test_moe_apply_matches_reference(seed, E, k, cf, impl, dtype):
    jc, tc, jp, tp, xj, xt = _setup(dtype, seed, num_experts=E, top_k=k,
                                    moe_capacity_factor=cf)
    jy, ja = jax.jit(lambda p, x: jmoe.moe_apply(p, jc, x, impl=impl))(jp, xj)
    ty, ta = tmoe.moe_apply(tp, tc, xt, impl=impl)
    assert ty.dtype == xt.dtype and ty.shape == xt.shape
    _assert_out_close(ty, jy, dtype)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", IMPLS)
def test_dropped_tokens_share_the_last_slot_with_a_kept_one(impl, dtype):
    """Capacity 1 over 64 tokens: each expert keeps its first token in
    slot 0 = C - 1, and every dropped token adds zeros into that same
    slot. The kept tokens' outputs survive (an assignment would erase
    them) and equal the reference's; the dropped-only rows are zero."""
    jc, tc, jp, tp, xj, xt = _setup(dtype, 3, B=1, S=64,
                                    moe_capacity_factor=0.01)
    C = tmoe.capacity(tc, 64)
    assert C == jmoe.capacity(jc, 64) == 1
    ti, _, _ = tmoe._route(tp, tc, xt)
    pos = tmoe._positions_in_expert(ti, tc.num_experts)
    kept, dropped = pos < C, pos >= C
    for e in ti[kept].unique().tolist():            # a shared slot exists
        assert bool((ti[dropped] == e).any())
    jy, _ = jax.jit(lambda p, x: jmoe.moe_apply(p, jc, x, impl=impl))(jp, xj)
    ty, _ = tmoe.moe_apply(tp, tc, xt, impl=impl)
    _assert_out_close(ty, jy, dtype)
    any_kept = kept.any(dim=-1)[0]                  # (S,)
    assert bool((ty[0, any_kept].abs().sum(-1) > 0).all())
    assert not ty[0, ~any_kept].any()
    assert int((~any_kept).sum()) > 32


def test_scatter_equals_onehot_in_the_port(rng):
    _, tc, _, tp, _, _ = _setup()
    x = torch.as_tensor(rng.standard_normal((2, 16, tc.d_model)),
                        dtype=torch.float32)
    y1, a1 = tmoe.moe_scatter(tp, tc, x)
    y2, a2 = tmoe.moe_onehot(tp, tc, x)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5, rtol=1e-5)
    assert abs(float(a1) - float(a2)) <= 1e-6


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x7b"])
def test_moe_params_carry_over_and_specs_match(arch):
    """``lm_params_from_numpy`` carries an MoE block's ``router``/``gate``/
    ``up``/``down`` bit for bit, and the port's specs have the
    reference's shapes."""
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jp = japi.materialize(jlm.lm_specs(jc), jax.random.key(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for p_idx in range(len(jc.block_pattern)):
        jm, tm = jp["blocks"][p_idx]["moe"], tp["blocks"][p_idx]["moe"]
        assert sorted(tm) == ["down", "gate", "router", "up"] == sorted(jm)
        for name in tm:
            np.testing.assert_array_equal(tm[name].numpy(),
                                          np.asarray(jm[name]))
    js, ts = jmoe.moe_specs(jc), tmoe.moe_specs(tc)
    assert {k: (s.shape, s.axes, s.scale) for k, s in ts.items()} == \
        {k: (s.shape, s.axes, s.scale) for k, s in js.items()}

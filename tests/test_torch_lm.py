"""The port's language-model forward (``repro_torch.models``) against the
reference's (``repro.models``): the same weights (the reference's
``materialize(lm_specs(cfg), jax.random.key(0))`` carried across by
``convert.lm_params_from_numpy``) and the same numpy-seeded tokens.

Tolerances:
- float32 (``scaled(cfg, dtype="float32")``): atol = rtol = 1e-4 on the
  logits.
- bfloat16 (the configs' own dtype), in units of one bf16 ulp at the
  logits' scale (``ulp = 2**(floor(log2(max|logit|)) - 7)``, 2**-8 for
  these logits of magnitude ~0.6). The port rounds every operation to its
  declared dtype, as the code of both packages says. Compiled with XLA's
  excess precision off (``xla_allow_excess_precision=False``), the
  reference does the same, and the port must meet it within 4 ulps (max)
  and 0.5 ulp (mean): the rest is the summation order of the products
  (measured: smollm within 0.07 ulp, gemma3 within 3.25 ulps, over four
  seeds). Jitted as it runs by default, XLA keeps fused elementwise chains
  in float32 where the code rounds to bf16, which moves single values by a
  few ulps through the layers: there the bound is 16 ulps (max) and
  1.5 ulps (mean) (measured: at most 12.5 and 0.92 over four seeds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.attention as jattn
import repro.models.common as jcommon
import repro.models.lm as jlm
import repro.sharding.api as japi
import repro_torch.configs as tconfigs
import repro_torch.models.attention as tattn
import repro_torch.models.common as tcommon
import repro_torch.models.lm as tlm
import repro_torch.sharding.api as tapi
from repro_torch.convert import lm_params_from_numpy

FORWARD_ARCHS = ("smollm-135m", "gemma3-12b")


def _params(arch, dtype=None, seed=0):
    """(reference cfg, port cfg, reference params, port params)."""
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    if dtype is not None:
        jc = jconfigs.scaled(jc, dtype=dtype)
        tc = tconfigs.scaled(tc, dtype=dtype)
    jp = japi.materialize(jlm.lm_specs(jc), jax.random.key(seed))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _tokens(cfg, B=2, S=40, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _ref_logits(jc, jp, toks, excess_precision=True, **kw):
    f = jax.jit(lambda p, b: jlm.lm_forward(jc, p, b, **kw)[0])
    b = {"tokens": jnp.asarray(toks)}
    if not excess_precision:
        f = f.lower(jp, b).compile(
            compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(f(jp, b).astype(jnp.float32))


def _port_logits(tc, tp, toks, **kw):
    logits, cache, aux = tlm.lm_forward(
        tc, tp, {"tokens": torch.as_tensor(toks).long()}, **kw)
    assert cache is None and float(aux) == 0.0
    return logits.float().numpy()


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_float32_matches_reference(arch):
    jc, tc, jp, tp = _params(arch, "float32")
    toks = _tokens(jc)
    want = _ref_logits(jc, jp, toks)
    got = _port_logits(tc, tp, toks)
    assert got.shape == want.shape == (2, 40, tlm.padded_vocab(tc))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # padded vocab entries are masked in both
    assert (got[..., tc.vocab_size:] <= -1e29).all() or \
        tlm.padded_vocab(tc) == tc.vocab_size


@pytest.mark.parametrize("excess_precision,max_ulps,mean_ulps",
                         [(False, 4.0, 0.5), (True, 16.0, 1.5)])
@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_bfloat16_matches_reference(arch, excess_precision,
                                            max_ulps, mean_ulps):
    jc, tc, jp, tp = _params(arch)
    assert tc.dtype == "bfloat16"
    toks = _tokens(jc)
    want = _ref_logits(jc, jp, toks, excess_precision)[..., :jc.vocab_size]
    got = _port_logits(tc, tp, toks)[..., :tc.vocab_size]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want) / ulp
    assert err.max() <= max_ulps, (err.max(), err.mean())
    assert err.mean() <= mean_ulps, (err.max(), err.mean())


def test_last_logit_only_is_the_last_row():
    jc, tc, jp, tp = _params("smollm-135m", "float32")
    toks = _tokens(jc)
    full = _port_logits(tc, tp, toks)
    last = _port_logits(tc, tp, toks, last_logit_only=True)
    assert last.shape == (2, 1, full.shape[-1])
    np.testing.assert_allclose(last[:, 0], full[:, -1], atol=1e-6)
    np.testing.assert_allclose(
        last, _ref_logits(jc, jp, toks, last_logit_only=True), atol=1e-4,
        rtol=1e-4)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_bookkeeping_matches_reference(arch):
    """All ten configs: the analytic count, the padded vocabulary and the
    count of the parameter specs (attention, MoE, recurrent and shared
    blocks, the encoder and cross-attention trees) equal the
    reference's."""
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tc == tconfigs.ModelConfig(**{
        f: getattr(jc, f) for f in jc.__dataclass_fields__})
    assert tc.num_params() == jc.num_params()
    assert tlm.padded_vocab(tc) == jlm.padded_vocab(jc)
    assert tconfigs.get_smoke_config(arch).num_params() == \
        jconfigs.get_smoke_config(arch).num_params()
    assert tapi.num_params(tlm.lm_specs(tc)) == \
        japi.num_params(jlm.lm_specs(jc))


def _rng_t(rng, shape, dtype=torch.float32, scale=1.0):
    """The same seeded values for JAX and torch (bf16 rounded once)."""
    j = jnp.asarray(rng.standard_normal(shape) * scale,
                    jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(dtype)


def _np(x):
    return (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(x.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_and_mlp_match_reference(dtype, rng):
    jx, tx = _rng_t(rng, (2, 9, 48), dtype, 3.0)
    jw, tw = _rng_t(rng, (48,))
    tol = 1e-6 if dtype == torch.float32 else 0.0
    np.testing.assert_allclose(_np(tcommon.rmsnorm(tx, tw)),
                               _np(jcommon.rmsnorm(jx, jw)), atol=tol,
                               rtol=tol)
    jp = {k: _rng_t(rng, s, scale=0.2)[0] for k, s in
          (("gate", (48, 80)), ("up", (48, 80)), ("down", (80, 48)))}
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    # float32: products summed in another order; bf16 (eager reference,
    # every op rounded to bf16): the same bits
    tol = 1e-5 if dtype == torch.float32 else 0.0
    np.testing.assert_allclose(_np(tcommon.mlp(tp, tx)),
                               _np(jcommon.mlp(jp, jx)), atol=tol, rtol=tol)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0, 0.0])
def test_rope_matches_reference(theta, rng):
    np.testing.assert_array_equal(tcommon.rope_freqs(16, theta or 1.0),
                                  jcommon.rope_freqs(16, theta or 1.0))
    jx, tx = _rng_t(rng, (2, 50, 3, 16))
    pos = np.arange(50, dtype=np.int32) + 7
    got = tcommon.apply_rope(tx, torch.as_tensor(pos), theta)
    want = jcommon.apply_rope(jx, jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=1e-5)


def test_sinusoidal_positions_match_reference():
    pos = np.arange(30, dtype=np.int32)
    np.testing.assert_allclose(
        tcommon.sinusoidal_pos(torch.as_tensor(pos), 64).numpy(),
        np.asarray(jcommon.sinusoidal_pos(jnp.asarray(pos), 64)), atol=2e-5)


@pytest.mark.parametrize("S,window,causal", [
    (40, None, True), (40, 16, True), (40, None, False),
    (1100, None, True), (1100, 64, True)])        # 1100 > Q_CHUNK: 2 chunks
def test_attend_full_matches_reference(S, window, causal, rng):
    """Narrow width (d 32, 4/2 heads of 8, QKV bias) so that the q-chunked
    path (S > Q_CHUNK, chunks of 550) stays small."""
    cfg = dict(num_layers=1, d_model=32, num_heads=4, num_kv_heads=2,
               head_dim=8, d_ff=64, vocab_size=256, qkv_bias=True,
               dtype="float32")
    jc = jconfigs.ModelConfig(name="narrow", family="dense", **cfg)
    tc = tconfigs.ModelConfig(name="narrow", family="dense", **cfg)
    assert tattn._pick_chunk(S) == jattn._pick_chunk(S)
    jp = japi.materialize(jattn.attention_specs(jc), jax.random.key(3))
    jp = {k: v + 0.1 if k.startswith("b") else v for k, v in jp.items()}
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jx, tx = _rng_t(rng, (1, S, 32))
    pos = np.arange(S, dtype=np.int32)
    got, (tk, tv) = tattn.attend_full(tp, tc, tx, torch.as_tensor(pos),
                                      causal=causal, window=window)
    want, (jk, jv) = jattn.attend_full(jp, jc, jx, jnp.asarray(pos),
                                       causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(tk), _np(jk), atol=1e-5, rtol=1e-5)
    if not causal:            # cross-attention form: keys given outside
        jm, tm = _rng_t(rng, (1, 12, 2, 8))
        kv_pos = np.arange(12, dtype=np.int32)
        got, _ = tattn.attend_full(tp, tc, tx, torch.as_tensor(pos),
                                   causal=False, kv_override=(tm, tm),
                                   kv_positions=torch.as_tensor(kv_pos))
        want, _ = jattn.attend_full(jp, jc, jx, jnp.asarray(pos),
                                    causal=False, kv_override=(jm, jm),
                                    kv_positions=jnp.asarray(kv_pos))
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


def test_attention_probabilities_take_the_value_dtype():
    """bf16 attention rounds the float32 softmax to bf16 before the PV
    product, as the reference does: the same bits as the eager
    reference."""
    rng = np.random.default_rng(5)
    jq, tq = _rng_t(rng, (2, 24, 4, 16), torch.bfloat16)
    jk, tk = _rng_t(rng, (2, 24, 2, 16), torch.bfloat16)
    jv, tv = _rng_t(rng, (2, 24, 2, 16), torch.bfloat16)
    pos = np.arange(24)
    mask = (pos[None, :] <= pos[:, None])[None, None, None]
    got = tattn._gqa_scores_softmax_out(tq, tk, tv, torch.as_tensor(mask),
                                        0.25)
    want = jattn._gqa_scores_softmax_out(jq, jk, jv, jnp.asarray(mask), 0.25)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


def test_materialize_is_seeded_and_follows_the_init_rules():
    cfg = tconfigs.get_smoke_config("qwen2.5-32b")
    specs = tlm.lm_specs(cfg)
    a = tapi.materialize(specs, torch.Generator().manual_seed(7), "cpu")
    b = tapi.materialize(specs, torch.Generator().manual_seed(7), "cpu")
    la, lb = (tapi.tree_leaves(t, torch.is_tensor) for t in (a, b))
    assert len(la) == len(tapi.spec_leaves(specs))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    blk = a["blocks"][0]
    assert torch.equal(blk["norm1"], torch.ones_like(blk["norm1"]))
    assert not blk["attn"]["bq"].any()
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3
    wq = blk["attn"]["wq"]                  # fan-in is the last dim (hd)
    assert abs(float(wq.std()) - cfg.resolved_head_dim ** -0.5) < 0.02


def test_weights_without_device_need_a_card():
    """No device= means the card for ``materialize`` and
    ``lm_params_from_numpy``: without one they raise instead of placing
    the weights on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    specs = tlm.lm_specs(tconfigs.get_smoke_config("smollm-135m"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.materialize(specs, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.materialize(specs, torch.Generator().manual_seed(0), None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_numpy({"embed": np.zeros((4, 2), np.float32)})


def test_lm_params_from_numpy_keeps_the_nesting():
    jc, tc, jp, tp = _params("gemma3-12b")
    assert set(tp) == set(jp) and isinstance(tp["blocks"], tuple)
    assert len(tp["blocks"]) == len(tc.block_pattern) == 6
    for jl, tl in zip(jax.tree.leaves(jp),
                      tapi.tree_leaves(tp, torch.is_tensor)):
        assert tuple(tl.shape) == jl.shape
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))

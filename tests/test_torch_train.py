"""The port's training objective and step (``repro_torch.models.lm_loss``,
``repro_torch.train.step.make_train_step``) against the reference's on
the CPU: the same weights (the reference's ``materialize(lm_specs(cfg),
jax.random.key(0))`` carried across by ``convert.lm_params_from_numpy``,
the AdamW state the same way) and the same numpy-seeded batches.

Tolerances:
- float32 ``lm_loss`` (all ten smoke configs): the loss and aux loss
  within 1e-5; each gradient leaf within 1e-4 of that leaf's largest
  |reference gradient| (measured: at most 1.1e-5, gemma3). zamba2 within
  1e-3 (measured 2.6e-4): its chunked Mamba2 (SSD) form is
  ill-conditioned in float32, the reference's too (ROADMAP Queue 3).
  (bfloat16: ``test_torch_loss_bf16.py``.)
- One float32 AdamW step: metrics within 1e-5 (``lr``, ``tokens`` and
  ``step`` exact), ``m`` within 1e-4 and ``v`` within 2e-4 of the leaf's
  largest value (linear and quadratic in the gradient); each parameter
  within 0.1 x lr of the reference's (measured: 0.028 x lr smollm,
  0.019 x lr granite): AdamW scales every entry's step to about lr, so an
  entry whose gradient is at the rounding level moves by a rounding-sized
  fraction of lr.
- Five steps of smollm in float32: losses within 1e-4.
- ``remat="block"`` against ``"none"``: loss and gradients bit for bit
  (remat moves memory, not values).
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
from repro.data.pipeline import BigramStream as JBigram
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm_specs
from repro_torch.sharding.api import materialize, tree_leaves, tree_map
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

GRAD_TOL = {"zamba2-2.7b": 1e-3}


def _params(arch, dtype=None, **kw):
    """(reference cfg, port cfg, reference params, port params)."""
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    if dtype is not None or kw:
        jc = jconfigs.scaled(jc, **({"dtype": dtype} if dtype else {}), **kw)
        tc = tconfigs.scaled(tc, **({"dtype": dtype} if dtype else {}), **kw)
    jp = japi.materialize(jlm.lm_specs(jc), jax.random.key(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _batches(cfg, B=2, S=32, seed=1, mask=False):
    """(reference batch, port batch): numpy-seeded tokens, labels, the
    audio frames of an encoder-decoder config, an optional loss mask."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        b["audio_embed"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if mask:
        b["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def _rel(want, got):
    return max(float(np.abs(np.asarray(w) - g.numpy()).max())
               / max(float(np.abs(np.asarray(w)).max()), 1e-30)
               for w, g in zip(jax.tree_util.tree_leaves(want),
                               tree_leaves(got)))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_lm_loss_and_gradients_float32_match_reference(arch):
    jc, tc, jp, tp = _params(arch, "float32")
    jb, tb = _batches(jc)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(jc, p, jb), has_aux=True))(jp)
    (tl, tm), tg = tstep.value_and_grad(lambda p: tlm.lm_loss(tc, p, tb), tp)
    assert abs(float(jl) - float(tl)) <= 1e-5
    for k in ("loss", "aux_loss", "tokens"):
        assert tm[k].dtype == torch.float32
        assert abs(float(jm[k]) - float(tm[k])) <= 1e-5, k
    assert float(tm["tokens"]) == 64.0
    assert len(jax.tree_util.tree_leaves(jg)) == len(tree_leaves(tg))
    err = _rel(jg, tg)
    assert err <= GRAD_TOL.get(arch, 1e-4), err


def test_lm_loss_mask_matches_reference():
    jc, tc, jp, tp = _params("smollm-135m", "float32")
    jb, tb = _batches(jc, mask=True)
    (jl, jm), jg = jax.value_and_grad(lambda p: jlm.lm_loss(jc, p, jb),
                                      has_aux=True)(jp)
    (tl, tm), tg = tstep.value_and_grad(lambda p: tlm.lm_loss(tc, p, tb), tp)
    assert abs(float(jl) - float(tl)) <= 1e-5
    assert _rel(jg, tg) <= 1e-4
    # the masked mean is not the plain one, and an all-zero mask gives 0
    plain = tlm.lm_loss(tc, tp, {k: v for k, v in tb.items()
                                 if k != "loss_mask"})[0]
    assert abs(float(plain) - float(tl)) > 1e-4
    zero = tlm.lm_loss(tc, tp, {**tb, "loss_mask": torch.zeros(2, 32)})[0]
    assert float(zero) == 0.0


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m"])
def test_train_step_matches_reference(arch):
    jc, tc, jp, tp = _params(arch, "float32")
    jb, tb = _batches(jc)
    jo = jopt.AdamW(lr=jopt.warmup_cosine(1e-3, 2, 10))
    to = topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10))
    js = jo.init(jp)
    ts = lm_params_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    jp2, js2, jm = jax.jit(jstep.make_train_step(jc, jo))(jp, js, jb)
    tp2, ts2, tm = tstep.make_train_step(tc, to)(tp, ts, tb)
    assert set(tm) == set(jm) == {"loss", "aux_loss", "tokens", "grad_norm",
                                  "lr", "loss_total"}
    assert not any(v.requires_grad for v in tm.values())
    for k in jm:
        assert abs(float(jm[k]) - float(tm[k])) <= 1e-5 * max(
            1.0, abs(float(jm[k]))), k
    assert float(tm["lr"]) == float(jm["lr"])
    assert int(ts2["step"]) == int(js2["step"]) == 1
    assert _rel(js2["m"], ts2["m"]) <= 1e-4
    assert _rel(js2["v"], ts2["v"]) <= 2e-4
    lr = float(jm["lr"])
    moved = max(float(np.abs(np.asarray(w) - g.numpy()).max())
                for w, g in zip(jax.tree_util.tree_leaves(jp2),
                                tree_leaves(tp2)))
    assert moved <= 0.1 * lr, moved / lr
    # the step returns new trees and leaves its inputs alone
    assert all(torch.equal(a, torch.as_tensor(np.array(b)))
               for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)))


def test_five_step_trajectory_matches_reference():
    jc, tc, jp, tp = _params("smollm-135m", "float32")
    jo = jopt.AdamW(lr=jopt.warmup_cosine(3e-3, 2, 5))
    to = topt.AdamW(lr=topt.warmup_cosine(3e-3, 2, 5))
    js, ts = jo.init(jp), to.init(tp)
    jf = jax.jit(jstep.make_train_step(jc, jo))
    tf = tstep.make_train_step(tc, to)
    stream = JBigram(jc.vocab_size, seed=0)
    jl, tl = [], []
    for i in range(5):
        toks = stream.sample(np.random.default_rng(1000 + i), 4, 32)
        jp, js, jm = jf(jp, js, {"tokens": jnp.asarray(toks[:, :-1]),
                                 "labels": jnp.asarray(toks[:, 1:])})
        tp, ts, tm = tf(tp, ts, {"tokens": torch.as_tensor(toks[:, :-1]),
                                 "labels": torch.as_tensor(toks[:, 1:])})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    assert tl[-1] < tl[0]


def _port_setup(arch, B=2, S=32, seed=0):
    cfg = tconfigs.get_smoke_config(arch)
    params = materialize(lm_specs(cfg), torch.Generator().manual_seed(seed),
                         "cpu")
    return cfg, params, _batches(cfg, B, S, seed + 1)[1]


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_train_step_runs_and_moves_params(arch):
    """The step counterpart of ``test_arch_smoke.py``'s: one bf16-compute
    AdamW step of every config on the port's own seeded weights."""
    cfg, params, batch = _port_setup(arch)
    opt = topt.AdamW(lr=topt.constant_lr(1e-3))
    p2, _, m = tstep.make_train_step(cfg, opt)(params, opt.init(params),
                                               batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert float(m["grad_norm"]) > 0.0
    delta = sum(float((a - b).abs().sum())
                for a, b in zip(tree_leaves(params), tree_leaves(p2)))
    assert delta > 0.0


def _saved_bytes(cfg, params, batch):
    """Bytes autograd keeps for the backward of one ``lm_loss``."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(live)
    live = tree_map(lambda _: next(it), params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tlm.lm_loss(cfg, live, batch)
    return total[0]


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_remat_block_equals_none_bit_for_bit(arch):
    cfg, params, batch = _port_setup(arch)
    assert cfg.remat == "block"
    out = {}
    for remat in ("block", "none"):
        c = tconfigs.scaled(cfg, remat=remat)
        (loss, _), grads = tstep.value_and_grad(
            lambda p: tlm.lm_loss(c, p, batch), params)
        out[remat] = (loss, tree_leaves(grads), _saved_bytes(c, params,
                                                             batch))
    (lb, gb, sb), (ln, gn, sn) = out["block"], out["none"]
    assert torch.equal(lb, ln)
    assert all(torch.equal(a, b) for a, b in zip(gb, gn))
    assert sb < sn          # remat keeps fewer activations for the backward
    # under no_grad it is the identity: serving is unchanged
    with torch.no_grad():
        assert torch.equal(tlm.lm_loss(cfg, params, batch)[0], lb)

"""The reference's memory levers in the port (``cfg.opt_seq_shard``,
``opt_attn_remat``, ``opt_chunk_remat``; the dry run's ``--opt``) on
plain tensors on the CPU: each moves memory, never values.

- Each lever gives the loss and every gradient of the lever off, bit for
  bit: ``seq_shard`` and ``attn_remat`` on smollm with S above one
  q-chunk (2048 tokens: two chunks of 1024), ``chunk_remat`` on zamba2
  (Mamba2) and xlstm (mLSTM) over three SSM chunks, in float32 and in
  the config's own bfloat16.
- The port with each lever against the reference's ``lm_loss`` with the
  same ``opt_*`` set, at the tolerances of ``test_torch_train.py``'s
  float32 parity test: loss within 1e-5, each gradient leaf within 1e-4
  of the leaf's largest |reference gradient| (zamba2 within 1e-3, its
  chunked Mamba2 being ill-conditioned in float32, the reference's too).
- A lever is the identity where it does not apply: without grad
  (serving), and ``seq_shard`` for a prefill (a cache is wanted).
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.lm as jlm
import repro.sharding.api as japi
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm_specs
from repro_torch.sharding.api import materialize, tree_leaves
from repro_torch.train import step as tstep

# (lever, arch, sequence length): S above one attention q-chunk (1024)
# for attn_remat, three SSM chunks (ssm_chunk 16 in the smoke configs)
# for chunk_remat
CASES = [("seq_shard", "smollm-135m", 2048),
         ("attn_remat", "smollm-135m", 2048),
         ("chunk_remat", "zamba2-2.7b", 48),
         ("chunk_remat", "xlstm-125m", 48)]
GRAD_TOL = {"zamba2-2.7b": 1e-3}


def _ids(case):
    return f"{case[0]}-{case[1]}"


def _batch(cfg, S, B=1, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _port(arch, S, dtype=None):
    cfg = tconfigs.get_smoke_config(arch)
    if dtype:
        cfg = tconfigs.scaled(cfg, dtype=dtype)
    params = materialize(lm_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, S).items()}
    return cfg, params, batch


def _loss_and_grads(cfg, params, batch):
    (loss, metrics), grads = tstep.value_and_grad(
        lambda p: tlm.lm_loss(cfg, p, batch), params)
    return loss, metrics, tree_leaves(grads)


@pytest.mark.parametrize("dtype", ["float32", None])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_lever_changes_no_value(case, dtype):
    lever, arch, S = case
    cfg, params, batch = _port(arch, S, dtype)
    on = tconfigs.scaled(cfg, **{f"opt_{lever}": True})
    assert getattr(on, f"opt_{lever}") and not getattr(cfg, f"opt_{lever}")
    l0, m0, g0 = _loss_and_grads(cfg, params, batch)
    l1, m1, g1 = _loss_and_grads(on, params, batch)
    assert torch.equal(l0, l1)
    assert torch.equal(m0["aux_loss"], m1["aux_loss"])
    assert len(g0) == len(g1) > 0
    for a, b in zip(g0, g1):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_lever_is_the_identity_without_grad(case):
    lever, arch, S = case
    cfg, params, batch = _port(arch, S, "float32")
    on = tconfigs.scaled(cfg, **{f"opt_{lever}": True})
    prompt = {"tokens": batch["tokens"]}
    with torch.no_grad():
        want = tlm.lm_forward(cfg, params, batch)[0]
        got = tlm.lm_forward(on, params, batch)[0]
        want_c, want_l = tlm.lm_prefill(cfg, params, prompt, max_seq=S)
        got_c, got_l = tlm.lm_prefill(on, params, prompt, max_seq=S)
    assert torch.equal(want, got)
    assert torch.equal(want_l, got_l)
    for a, b in zip(tree_leaves(want_c, torch.is_tensor),
                    tree_leaves(got_c, torch.is_tensor), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_lever_matches_reference(case):
    lever, arch, S = case
    opt = {f"opt_{lever}": True}
    jc = jconfigs.scaled(jconfigs.get_smoke_config(arch), dtype="float32",
                         **opt)
    tc = tconfigs.scaled(tconfigs.get_smoke_config(arch), dtype="float32",
                         **opt)
    jp = japi.materialize(jlm.lm_specs(jc), jax.random.key(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    nb = _batch(jc, S)
    jb = {k: jax.numpy.asarray(v) for k, v in nb.items()}
    tb = {k: torch.as_tensor(v) for k, v in nb.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(jc, p, jb), has_aux=True))(jp)
    tl, tm, tg = _loss_and_grads(tc, tp, tb)
    assert abs(float(jl) - float(tl)) <= 1e-5
    assert abs(float(jm["aux_loss"]) - float(tm["aux_loss"])) <= 1e-5
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg)
    err = max(float(np.abs(np.asarray(w) - g.numpy()).max())
              / max(float(np.abs(np.asarray(w)).max()), 1e-30)
              for w, g in zip(jleaves, tg))
    assert err <= GRAD_TOL.get(arch, 1e-4), err

"""The port's ``lm_loss`` in bfloat16, the configs' own dtype, against
the reference's on the CPU for all ten smoke configs: the same weights
(the reference's ``materialize(lm_specs(cfg), jax.random.key(0))``
carried across by ``convert.lm_params_from_numpy``) and the same
numpy-seeded batch.

Tolerance: against the reference compiled with
``xla_allow_excess_precision=False`` (which rounds to bf16 where the code
says so, as the port does), in the ulp units of ``test_torch_lm.py``
(one bf16 ulp at the logits' scale, ``2**(floor(log2(max|logit|)) -
7)``): the loss within 0.5 ulp, the bound on the logits' mean error
there (measured: at most 0.03 ulp, gemma3).
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
from repro_torch.convert import lm_params_from_numpy


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_lm_loss_bfloat16_matches_reference_in_ulps(arch):
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    assert tc.dtype == "bfloat16"
    jp = japi.materialize(jlm.lm_specs(jc), jax.random.key(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab_size, (2, 33)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jc.is_encoder_decoder:
        b["audio_embed"] = rng.standard_normal(
            (2, jc.encoder_seq, jc.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    f = jax.jit(lambda p, b: (jlm.lm_loss(jc, p, b)[1]["loss"],
                              jlm.lm_forward(jc, p, b)[0]))
    f = f.lower(jp, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want, logits = f(jp, jb)
    got = tlm.lm_loss(tc, tp, tb)[1]["loss"]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(np.asarray(
        logits.astype(jnp.float32))[..., :jc.vocab_size]).max())) - 7)
    assert abs(float(want) - float(got)) / ulp <= 0.5

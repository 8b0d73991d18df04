"""The port's GPipe pipeline (``repro_torch.train.pipeline_parallel``)
over 4 CPU stages (``fleet_mesh(4, "stage", device="cpu")``) against
the port's unpipelined ``lm_loss`` and against the reference's
``make_pp_loss`` over 4 fake CPU devices (a subprocess, as
``tests/test_distributed.py`` runs it), on smollm's smoke config at 4
layers in float32 with 4 microbatches.

Tolerances: the loss within 1e-6 of the port's unpipelined loss (the
same per-token arithmetic; the microbatches change only the matmuls'
row counts) and within 1e-5 of the reference's pipelined loss; each
gradient leaf within 1e-5 of that leaf's largest unpipelined gradient
(measured: 2e-7), and within 1e-4 of the reference's pipelined gradient
(the CPU tests' float32 gradient bound, ``test_torch_train.py``).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config, scaled
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.fleet import fleet_mesh
from repro_torch.models import lm_loss, lm_specs
from repro_torch.sharding.api import materialize, tree_leaves, \
    tree_unflatten
from repro_torch.train.pipeline_parallel import make_pp_loss
from repro_torch.train.step import value_and_grad

REPO = Path(__file__).resolve().parent.parent

REF_PP = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config, scaled
from repro.models import lm_specs
from repro.sharding.api import materialize, use_mesh
from repro.train.pipeline_parallel import make_pp_loss
cfg = scaled(get_smoke_config('smollm-135m'), num_layers=4, remat='none',
             dtype='float32')
params = materialize(lm_specs(cfg), jax.random.key(0))
toks = np.load(sys.argv[1])
batch = {'tokens': jnp.asarray(toks[:, :-1]), 'labels': jnp.asarray(toks[:, 1:])}
mesh = jax.make_mesh((4,), ('stage',))
pp_loss = make_pp_loss(cfg, mesh, num_microbatches=4)
with use_mesh(mesh):
    loss, g = jax.jit(jax.value_and_grad(pp_loss))(params, batch)
leaves = jax.tree_util.tree_leaves
np.savez(sys.argv[2], *[np.asarray(x) for x in leaves(params)],
         *[np.asarray(x) for x in leaves(g)], loss=np.asarray(loss))
"""


def _cfg():
    return scaled(get_smoke_config("smollm-135m"), num_layers=4,
                  remat="none", dtype="float32")


def _batch(cfg, B=8, S=16, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return toks, {"tokens": torch.as_tensor(toks[:, :-1]),
                  "labels": torch.as_tensor(toks[:, 1:])}


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's pipelined loss and gradients, and its weights, from
    a 4-device subprocess."""
    cfg = _cfg()
    toks, _ = _batch(cfg)
    d = tmp_path_factory.mktemp("pp")
    np.save(d / "toks.npy", toks)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4").strip()
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", REF_PP, str(d / "toks.npy"),
                          str(d / "ref.npz")], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = np.load(d / "ref.npz")
    arrays = [ref[f"arr_{i}"] for i in range(len(ref.files) - 1)]
    n = len(arrays) // 2
    skeleton = materialize(lm_specs(cfg), torch.Generator().manual_seed(0),
                           "cpu")
    params = lm_params_from_numpy(tree_unflatten(skeleton, arrays[:n]),
                                  "cpu")
    grads = [torch.as_tensor(a) for a in arrays[n:]]
    return params, float(ref["loss"]), grads


def test_pp_loss_and_gradients_match_unpipelined_and_reference(reference):
    cfg = _cfg()
    params, ref_loss, ref_grads = reference
    _, batch = _batch(cfg)
    pp_loss = make_pp_loss(cfg, fleet_mesh(4, "stage", device="cpu"), 4)
    (loss, _), grads = value_and_grad(lambda p: (pp_loss(p, batch), {}),
                                      params)
    (want, _), want_g = value_and_grad(lambda p: lm_loss(cfg, p, batch),
                                       params)
    assert abs(float(loss) - float(want)) <= 1e-6
    assert abs(float(loss) - ref_loss) <= 1e-5
    got_g, want_g = tree_leaves(grads), tree_leaves(want_g)
    assert len(got_g) == len(want_g) == len(ref_grads)
    for g, w, r in zip(got_g, want_g, ref_grads):
        assert _rel(g, w) <= 1e-5
        assert _rel(g, r) <= 1e-4
    # every stage's repetitions get a non-zero gradient
    for leaf in tree_leaves(grads["blocks"][0]):
        per_stage = leaf.reshape(4, -1).abs().sum(dim=1)
        assert (per_stage > 0).all()


@pytest.mark.parametrize("stages,micro", [(2, 2), (4, 8), (1, 1)])
def test_pp_schedules_give_the_unpipelined_loss(stages, micro):
    cfg = _cfg()
    params = materialize(lm_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    _, batch = _batch(cfg)
    pp_loss = make_pp_loss(cfg, fleet_mesh(stages, "stage", device="cpu"),
                           micro)
    with torch.no_grad():
        assert abs(float(pp_loss(params, batch))
                   - float(lm_loss(cfg, params, batch)[0])) <= 1e-6


def test_pp_refusals():
    mesh = fleet_mesh(4, "stage", device="cpu")
    with pytest.raises(ValueError, match="one-kind"):
        make_pp_loss(get_smoke_config("gemma3-12b"), mesh, 2)
    with pytest.raises(ValueError, match="repetitions"):
        make_pp_loss(scaled(_cfg(), num_layers=6), mesh, 2)
    with pytest.raises(ValueError, match="decoder-only"):
        make_pp_loss(get_smoke_config("whisper-tiny"), mesh, 2)
    cfg = _cfg()
    params = materialize(lm_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    _, batch = _batch(cfg, B=6)
    with pytest.raises(ValueError, match="microbatches"):
        make_pp_loss(cfg, mesh, 4)(params, batch)

"""The port's gradient compression (``repro_torch.train.compression``)
against the reference's (``repro.train.compression``) on the CPU.

Tolerances:
- ``int8_quantize``: bit-identical values and scale, ties at .5
  included (both round half to even).
- ``topk_mask``: equal, every entry tied with the k-th magnitude kept.
- Error feedback (``tests/test_runtime.py:149``): over 20 steps the sum
  of the compressed sums plus the final residual equals the sum of the
  true gradients within 1e-5.
- ``make_dp_compressed_train_step`` over 4 CPU pods against the
  reference's over 4 fake CPU devices (a subprocess, as
  ``tests/test_distributed.py`` runs them): the first step's reduced
  gradient (read through an optimizer whose new parameters are the
  gradient it is given) within one int8 quantum of each leaf (the
  largest pod's ``max|g| / 127``): a pod's entry whose ``g / scale``
  lies within rounding of .5 may go to either neighbour; metrics within
  1e-5. Float32 smollm smoke, 2 layers.
- The convergence test of ``tests/test_distributed.py:85`` on the port:
  60 int8-compressed steps over 4 pods lower the loss by more than 0.5.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as jc
from repro_torch.configs import get_smoke_config, scaled
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.fleet import fleet_mesh
from repro_torch.data.pipeline import BigramStream
from repro_torch.models import lm_loss, lm_specs
from repro_torch.sharding.api import materialize, tree_leaves, \
    tree_unflatten
from repro_torch.train import compression as tc
from repro_torch.train.optimizer import AdamW, constant_lr
from repro_torch.train.step import value_and_grad

REPO = Path(__file__).resolve().parent.parent


def test_int8_quantize_bit_identical_with_ties(rng):
    x = rng.standard_normal(1000).astype(np.float32)
    q_j, s_j = jc.int8_quantize(jnp.asarray(x))
    q_t, s_t = tc.int8_quantize(torch.as_tensor(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    assert s_t.numpy().tobytes() == np.asarray(s_j).tobytes()
    np.testing.assert_array_equal(
        tc.int8_dequantize(q_t, s_t).numpy(),
        np.asarray(jc.int8_dequantize(q_j, s_j)))
    # max |x| = 127 makes the scale exactly 1: x / scale lands on .5
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, -3.5, 126.5],
                    np.float32)
    q_t = tc.int8_quantize(torch.as_tensor(ties))[0].numpy()
    np.testing.assert_array_equal(q_t, [127, 0, 2, 2, 0, -2, -4, 126])
    np.testing.assert_array_equal(
        q_t, np.asarray(jc.int8_quantize(jnp.asarray(ties))[0]))


@pytest.mark.parametrize("frac", [0.1, 0.05, 0.3])
def test_topk_mask_equal_with_ties(rng, frac):
    x = rng.standard_normal(100).astype(np.float32)
    x[[3, 17, 40, 41]] = [2.5, -2.5, 2.5, -2.5]     # tied magnitudes
    x[[5, 6]] = [9.0, -9.0]
    for v in (x, np.round(x, 1)):                    # many ties
        want = np.asarray(jc.topk_mask(jnp.asarray(v), frac))
        got = tc.topk_mask(torch.as_tensor(v), frac).numpy()
        np.testing.assert_array_equal(got, want)
    y = tc.topk_mask(torch.as_tensor(x), 0.1).numpy()
    assert (y != 0).sum() >= 10
    assert np.abs(x[y != 0]).min() >= np.abs(x[y == 0]).max()


@pytest.mark.parametrize("method", ["int8", "topk", "none"])
def test_compress_matches_reference(rng, method):
    x = rng.standard_normal((16, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tc.compress(torch.as_tensor(x), method, 0.05).numpy(),
        np.asarray(jc.compress(jnp.asarray(x), method, 0.05)))
    with pytest.raises(ValueError):
        tc.compress(torch.as_tensor(x), "fp4", 0.05)


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_ef_accumulates_to_exact_sum(rng, method):
    """Error feedback over 2 mesh entries: the sum over steps of the
    compressed sums plus the residuals equals the sum of the true
    gradients."""
    g_seq = [[torch.as_tensor(rng.standard_normal(64), dtype=torch.float32)
              * 0.01 for _ in range(2)] for _ in range(20)]
    ef = [{"g": torch.zeros(64)} for _ in range(2)]
    total_true = torch.zeros(64)
    total_comp = torch.zeros(64)
    for gs in g_seq:
        red, ef = tc.ef_compressed_psum([{"g": g} for g in gs], ef, method)
        total_true += gs[0] + gs[1]
        total_comp += red["g"]
    resid = float((total_true - (total_comp + ef[0]["g"] + ef[1]["g"])
                   ).abs().max())
    assert resid < 1e-5


class _GradOut:
    """An optimizer whose new parameters are the gradient it is given."""

    def update(self, grads, state, params):
        return grads, state, {}


def _dp_setup(dtype="float32"):
    cfg = scaled(get_smoke_config("smollm-135m"), num_layers=2,
                 **({"dtype": dtype} if dtype else {}))
    return cfg, lambda p, b: lm_loss(cfg, p, b)


REF_DP = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config, scaled
from repro.models import lm_specs, lm_loss
from repro.sharding.api import materialize, use_mesh
from repro.train.compression import make_dp_compressed_train_step
cfg = scaled(get_smoke_config('smollm-135m'), num_layers=2, dtype='float32')
params = materialize(lm_specs(cfg), jax.random.key(0))
class GradOut:
    def update(self, grads, state, params):
        return grads, state, {}
mesh = jax.make_mesh((4,), ('pod',))
step, init_ef = make_dp_compressed_train_step(
    lambda p, b: lm_loss(cfg, p, b), GradOut(), mesh, axis='pod',
    method='int8')
toks = np.load(sys.argv[1])
batch = {'tokens': jnp.asarray(toks[:, :-1]), 'labels': jnp.asarray(toks[:, 1:])}
with use_mesh(mesh):
    red, _, ef, m = jax.jit(step)(params, {}, init_ef(params), batch)
leaves = jax.tree_util.tree_leaves
np.savez(sys.argv[2], *[np.asarray(x) for x in leaves(params)],
         *[np.asarray(x) for x in leaves(red)],
         *[np.asarray(x) for x in leaves(ef)],
         loss=np.asarray(m['loss']), tokens=np.asarray(m['tokens']))
"""


def _run_ref(tmp_path, toks):
    np.save(tmp_path / "toks.npy", toks)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4").strip()
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", REF_DP, str(tmp_path / "toks.npy"),
         str(tmp_path / "ref.npz")], capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return np.load(tmp_path / "ref.npz")


def test_dp_compressed_step_matches_reference_over_4_pods(tmp_path):
    cfg, loss_fn = _dp_setup()
    toks = BigramStream(cfg.vocab_size, seed=0).sample(
        np.random.default_rng(0), 8, 32)
    ref = _run_ref(tmp_path, toks)
    arrays = [ref[f"arr_{i}"] for i in range(len(ref.files) - 2)]
    n = len(arrays) // 3
    skeleton = materialize(lm_specs(cfg), torch.Generator().manual_seed(0),
                           "cpu")
    params = lm_params_from_numpy(tree_unflatten(skeleton, arrays[:n]),
                                  "cpu")
    mesh = fleet_mesh(4, "pod", device="cpu")
    step, init_ef = tc.make_dp_compressed_train_step(
        loss_fn, _GradOut(), mesh, axis="pod", method="int8")
    batch = {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])}
    ef0 = init_ef(params)
    assert all(e.shape == (4,) + p.shape and e.dtype == torch.float32
               for e, p in zip(tree_leaves(ef0), tree_leaves(params)))
    red, _, ef, m = step(params, {}, ef0, batch)
    # each pod's gradient on its rows: the int8 quantum of each leaf
    pod_grads = [tree_leaves(value_and_grad(
        loss_fn, params, {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
    )[1]) for i in range(4)]
    for j, (want, got) in enumerate(zip(arrays[n:2 * n], tree_leaves(red))):
        quantum = max(float(g[j].abs().max()) for g in pod_grads) / 127.0
        assert float(np.abs(got.numpy() - want).max()) <= quantum + 1e-7, j
    for j, (want, got) in enumerate(zip(arrays[2 * n:], tree_leaves(ef))):
        quantum = max(float(g[j].abs().max()) for g in pod_grads) / 127.0
        assert float(np.abs(got.numpy() - want).max()) <= quantum + 1e-7, j
    assert abs(float(m["loss"]) - float(ref["loss"])) <= 1e-5
    assert float(m["tokens"]) == float(ref["tokens"]) == 64.0


def test_dp_compressed_training_converges():
    """``tests/test_distributed.py:85`` on the port: 4 CPU pods, int8."""
    cfg, loss_fn = _dp_setup(dtype=None)
    params = materialize(lm_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    opt = AdamW(lr=constant_lr(1e-2), weight_decay=0.0)
    step, init_ef = tc.make_dp_compressed_train_step(
        loss_fn, opt, fleet_mesh(4, "pod", device="cpu"), axis="pod",
        method="int8")
    ef, opt_state = init_ef(params), opt.init(params)
    stream = BigramStream(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(60):
        toks = stream.sample(rng, 8, 32)
        batch = {"tokens": torch.as_tensor(toks[:, :-1]),
                 "labels": torch.as_tensor(toks[:, 1:])}
        params, opt_state, ef, m = step(params, opt_state, ef, batch)
        losses.append(float(m["loss"]))
    assert set(m) == {"loss", "aux_loss", "tokens", "grad_norm", "lr"}
    assert losses[-1] < losses[0] - 0.5, losses

"""The port's fault-tolerant training loop (``repro_torch.train.fault``)
on torch tensors: the four ``run_training`` tests of
``tests/test_runtime.py`` (:92-130) on the same toy problem, and
checkpoints crossing between the reference's ``run_training`` and the
port's in both directions.

Exact throughout: step counts, restart counts and checkpoint steps are
integers, and a state that crosses between the two packages is held bit
for bit (both write and read the same file format).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro.train import fault as jfault
from repro.train import optimizer as jopt
from repro_torch.sharding.api import tree_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.fault import FaultConfig, FaultInjector, run_training
from repro_torch.train.step import value_and_grad


def _toy_problem(tmp_path, fail_at=(), max_restarts=3, steps=20, every=5):
    """The reference test's toy: AdamW on sum((w - batch)^2)."""
    opt = topt.AdamW(lr=topt.constant_lr(0.1), weight_decay=0.0)
    params = {"w": torch.tensor([1.0, 2.0])}
    state = {"params": params, "opt_state": opt.init(params)}

    def step_fn(state, batch):
        (l, _), g = value_and_grad(
            lambda p: (torch.sum((p["w"] - batch) ** 2), {}),
            state["params"])
        p, o, m = opt.update(g, state["opt_state"], state["params"])
        return {"params": p, "opt_state": o}, {"loss": l, **m}

    def batch_fn(i):
        return torch.tensor([0.0, 0.0]) + 0.01 * i

    fcfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=every,
                       max_restarts=max_restarts, async_checkpoint=False)
    return step_fn, state, batch_fn, steps, fcfg, FaultInjector(fail_at)


def _ref_toy(tmp_path, every=5):
    """The same toy in the reference package."""
    opt = jopt.AdamW(lr=jopt.constant_lr(0.1), weight_decay=0.0)
    params = {"w": jnp.asarray([1.0, 2.0])}
    state = {"params": params, "opt_state": opt.init(params)}

    def step_fn(state, batch):
        (l, _), g = jax.value_and_grad(
            lambda p: (jnp.sum((p["w"] - batch) ** 2), {}),
            has_aux=True)(state["params"])
        p, o, m = opt.update(g, state["opt_state"], state["params"])
        return {"params": p, "opt_state": o}, {"loss": l, **m}

    def batch_fn(i):
        return jnp.asarray([0.0, 0.0]) + 0.01 * i

    fcfg = jfault.FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=every,
                              async_checkpoint=False)
    return step_fn, state, batch_fn, fcfg


def test_training_completes_and_checkpoints(tmp_path):
    step_fn, state, batch_fn, steps, fcfg, inj = _toy_problem(tmp_path)
    rep = run_training(step_fn, state, batch_fn, steps, fcfg)
    assert rep.steps_run == steps
    assert ckpt.latest_step(tmp_path) == steps
    assert rep.last_metrics["loss"] < 5.0 and len(rep.step_times) == steps


def test_recovers_from_injected_fault(tmp_path):
    step_fn, state, batch_fn, steps, fcfg, inj = _toy_problem(
        tmp_path, fail_at=(7,))
    rep = run_training(step_fn, state, batch_fn, steps, fcfg, injector=inj)
    assert rep.restarts == 1
    assert rep.steps_run == steps + 2      # steps 5 and 6 replayed
    assert ckpt.latest_step(tmp_path) == steps


def test_gives_up_after_max_restarts(tmp_path):
    step_fn, state, batch_fn, steps, fcfg, inj = _toy_problem(
        tmp_path, max_restarts=1)

    class AlwaysFail(FaultInjector):
        def maybe_fail(self, step):
            raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="persistent failure"):
        run_training(step_fn, state, batch_fn, steps, fcfg,
                     injector=AlwaysFail())


def test_resume_from_existing_checkpoint(tmp_path):
    step_fn, state, batch_fn, steps, fcfg, _ = _toy_problem(tmp_path,
                                                            steps=10)
    run_training(step_fn, state, batch_fn, 10, fcfg)
    rep2 = run_training(step_fn, state, batch_fn, 15, fcfg)
    assert rep2.steps_run == 5             # resumed at step 10


def _first_state(step_fn, seen):
    """``step_fn`` that records the state of its first call."""
    def wrapped(state, batch):
        if not seen:
            seen.append(state)
        return step_fn(state, batch)
    return wrapped


def _assert_state_equal(ref_state, port_state):
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_state)]
    port = [t.numpy() for t in tree_leaves(port_state)]
    assert len(ref) == len(port) == 4          # w, m, v, step
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    j_step, j_state, j_batch, j_fcfg = _ref_toy(tmp_path)
    jfault.run_training(j_step, j_state, j_batch, 10, j_fcfg)
    saved, step, _ = jckpt.restore(tmp_path, j_state)
    assert step == 10
    step_fn, state, batch_fn, _, fcfg, _ = _toy_problem(tmp_path)
    seen = []
    rep = run_training(_first_state(step_fn, seen), state, batch_fn, 15,
                       fcfg)
    assert rep.steps_run == 5
    _assert_state_equal(saved, seen[0])
    assert int(seen[0]["opt_state"]["step"]) == 10


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    step_fn, state, batch_fn, _, fcfg, _ = _toy_problem(tmp_path)
    run_training(step_fn, state, batch_fn, 10, fcfg)
    saved, step, _ = ckpt.restore(tmp_path, state, device="cpu")
    assert step == 10
    j_step, j_state, j_batch, j_fcfg = _ref_toy(tmp_path)
    seen = []
    rep = jfault.run_training(_first_state(j_step, seen), j_state, j_batch,
                              15, j_fcfg)
    assert rep.steps_run == 5
    _assert_state_equal(seen[0], saved)


def test_restore_goes_to_the_states_device(tmp_path):
    """A resumed state lands on the device of the state's first tensor
    leaf, and an async checkpoint in flight is finished before a restart
    restores from it."""
    step_fn, state, batch_fn, steps, fcfg, inj = _toy_problem(
        tmp_path, fail_at=(7,))
    fcfg.async_checkpoint = True
    rep = run_training(step_fn, state, batch_fn, steps, fcfg, injector=inj)
    assert rep.restarts == 1 and rep.steps_run == steps + 2
    seen = []
    run_training(_first_state(step_fn, seen), state, batch_fn, steps + 1,
                 fcfg)
    assert all(t.device.type == "cpu" for t in tree_leaves(seen[0]))

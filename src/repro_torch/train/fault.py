"""Fault-tolerant training loop: checkpoint/restart, retries,
straggler detection, failure injection for tests — the port of
``src/repro/train/fault.py``, with the same policy and counters.

Policy:
  * periodic async checkpoints in the reference's file format
    (``repro_torch.train.checkpoint``: atomic rename; restore picks the
    latest), so a run of either package resumes the other's;
  * a failed step (device error, preemption, injected fault) triggers
    restore-from-last-checkpoint and replay (a checkpoint still being
    written is finished first, so the restore finds it); after
    ``max_restarts`` the loop re-raises the error, so a sticky CUDA
    error ends the run;
  * per-step wall-time is tracked against a rolling median — steps
    slower than ``straggler_factor`` x median are counted and reported;
  * the data pipeline is re-seeded per step index, so replayed steps see
    identical data (deterministic recovery).

A state of DTensors (``launch.train.build`` on a mesh, one rank a
device) is saved whole by rank 0 and restored onto each leaf's own
placements. Every rank restores the same step: rank 0 finishes its
pending write, then the ranks meet at a barrier before they look for the
latest checkpoint, and again when the loop ends. The ranks run one
program, so a failure must reach them all, as an injected fault does; a
rank that fails alone leaves the others in a collective until the
process group's timeout.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.sharding.api import is_dtensor, sharding_of, tree_leaves, \
    tree_map
from repro_torch.train import checkpoint as ckpt


@dataclass
class FaultConfig:
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    async_checkpoint: bool = True


class FaultInjector:
    """Deterministically raise on chosen step indices (tests/demos)."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.already = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.already:
            self.already.add(step)
            raise RuntimeError(f"injected fault at step {step}")


@dataclass
class TrainReport:
    steps_run: int = 0
    restarts: int = 0
    stragglers: int = 0
    last_metrics: dict = field(default_factory=dict)
    step_times: list = field(default_factory=list)


def _restore(path, state):
    """The latest checkpoint under ``path`` in ``state``'s structure, on
    the device of ``state``'s first leaf; a DTensor leaf placed as it
    is."""
    return ckpt.restore(path, state, device=tree_leaves(state)[0].device,
                        shardings=tree_map(sharding_of, state,
                                           torch.is_tensor))


def _meet(state) -> None:
    """A barrier of the default process group where ``state`` is
    sharded over a mesh."""
    if any(is_dtensor(x) for x in tree_leaves(state, torch.is_tensor)):
        torch.distributed.barrier()


def run_training(step_fn: Callable, state: dict, batch_fn: Callable,
                 num_steps: int, fcfg: FaultConfig,
                 injector: Optional[FaultInjector] = None,
                 metrics_cb: Optional[Callable] = None) -> TrainReport:
    """state: a tree of tensors, 'params' and 'opt_state' (+ anything
    step_fn needs). step_fn(state, batch) -> (state, metrics).
    batch_fn(step) -> batch (deterministic per step for replay).
    """
    report = TrainReport()
    _meet(state)
    start = ckpt.latest_step(fcfg.ckpt_dir)
    step0 = 0
    if start is not None:
        state, step0, _ = _restore(fcfg.ckpt_dir, state)
    times = deque(maxlen=50)
    pending_save = None

    step = step0
    while step < num_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.perf_counter()
            batch = batch_fn(step)
            state, metrics = step_fn(state, batch)
            leaf = tree_leaves(state)[0]
            if leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
            dt = time.perf_counter() - t0
            times.append(dt)
            report.step_times.append(dt)
            med = float(np.median(times))
            if len(times) >= 10 and dt > fcfg.straggler_factor * med:
                report.stragglers += 1
            report.steps_run += 1
            report.last_metrics = {k: float(v) for k, v in metrics.items()}
            if metrics_cb:
                metrics_cb(step, report.last_metrics, dt)
            step += 1
            if step % fcfg.ckpt_every == 0 or step == num_steps:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt.save(
                    fcfg.ckpt_dir, step, state,
                    metadata={"metrics": report.last_metrics},
                    async_=fcfg.async_checkpoint)
                ckpt.prune(fcfg.ckpt_dir, fcfg.keep)
        except Exception:  # noqa: BLE001 — any step failure is retriable
            report.restarts += 1
            if report.restarts > fcfg.max_restarts:
                raise
            if pending_save is not None:
                pending_save.join()
                pending_save = None
            _meet(state)
            last = ckpt.latest_step(fcfg.ckpt_dir)
            if last is not None:
                state, step, _ = _restore(fcfg.ckpt_dir, state)
            else:
                step = 0
    if pending_save is not None:
        pending_save.join()
    _meet(state)
    return report


__all__ = ["FaultConfig", "FaultInjector", "TrainReport", "run_training"]

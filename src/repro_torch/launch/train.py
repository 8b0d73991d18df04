"""Training launcher: the language model trained end to end — the port
of ``src/repro/launch/train.py``.

Wires together: config -> seeded weights (sharded over a device mesh
where one is asked for) -> AdamW with a warmup-cosine schedule -> the
fault-tolerant training loop (checkpoint/restart/straggler,
``repro_torch.train.fault``) -> replay-deterministic batches of a
``BigramStream``. Runs on the CUDA card unless ``--device cpu`` is
given.

``build(data_axis=, model_axis=)`` above 1 trains on a ``("data",
"model")`` mesh from ``launch.mesh.make_host_mesh``, one rank per device
(``torchrun --nproc-per-node N``): parameters and AdamW's moments are
DTensors placed by the logical-axis rules, ``step`` is replicated, the
batch is split ``("data", None)``, and DTensor inserts the collectives.
A mesh that clamps to ``(1, 1)`` (one rank) is the one-device program,
so it keeps plain tensors.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --steps 100
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import BigramStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm_specs
from repro_torch.sharding.api import NamedSharding, P, device_put, \
    distribute, is_dtensor, materialize, num_params, spec_shardings, \
    use_mesh
from repro_torch.train.fault import FaultConfig, FaultInjector, run_training
from repro_torch.train.optimizer import AdamW, warmup_cosine
from repro_torch.train.step import make_train_step


def build(arch: str, smoke: bool, batch: int, seq: int, steps: int,
          data_axis: int = 1, model_axis: int = 1, lr: float = 3e-4, *,
          device: DeviceLike = None):
    """``(cfg, params, opt_state, step, device)``: the config (its smoke
    version with ``smoke``), weights from ``materialize(lm_specs(cfg),
    torch.Generator().manual_seed(0))`` on ``device`` (default: the CUDA
    card), AdamW's state and ``make_train_step``'s step. ``batch`` and
    ``seq`` are the reference's arguments; the weights do not depend on
    them. With ``data_axis``/``model_axis`` above 1, see ``shard_training``:
    the step then takes a whole batch (alike on every rank) and returns
    whole metrics."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    opt = AdamW(lr=warmup_cosine(lr, max(10, steps // 20), steps))
    specs = lm_specs(cfg)
    params = materialize(specs, torch.Generator().manual_seed(0), dev)
    step = make_train_step(cfg, opt)
    if data_axis * model_axis > 1:
        mesh = make_host_mesh(data_axis, model_axis, device=dev)
        if mesh.size() > 1:
            params, opt_state, step = shard_training(mesh, specs, params,
                                                     opt, step)
            return cfg, params, opt_state, step, dev
    return cfg, params, opt.init(params), step, dev


def shard_training(mesh, specs, params, opt: AdamW, step):
    """``(params, opt_state, mesh_step)`` on ``mesh``: ``params`` (whole,
    alike on every rank) distributed to ``spec_shardings(specs, mesh)``,
    AdamW's moments sharded like them and ``step`` replicated, and
    ``step`` run under ``use_mesh(mesh)`` on the batch split ``("data",
    None)``, its metrics gathered whole."""
    with use_mesh(mesh):
        params = device_put(params, spec_shardings(specs, mesh))
        opt_state = opt.init(params)
        opt_state["step"] = distribute(opt_state["step"],
                                       NamedSharding(mesh, P()))
    batch_sharding = NamedSharding(mesh, P("data", None))

    def mesh_step(params, opt_state, batch):
        with use_mesh(mesh):
            batch = {k: v if is_dtensor(v) else distribute(v, batch_sharding)
                     for k, v in batch.items()}
            params, opt_state, metrics = step(params, opt_state, batch)
        return params, opt_state, {k: v.full_tensor() if is_dtensor(v)
                                   else v for k, v in metrics.items()}
    return params, opt_state, mesh_step


def main(argv=None, *, metrics_cb=None):
    """Parse ``argv`` (default: the command line), train, print the
    reference's lines, return the ``TrainReport``. ``metrics_cb(step,
    metrics, seconds)``, if given, also sees every step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-fault-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg, params, opt_state, step, dev = build(
        args.arch, args.smoke, args.batch, args.seq, args.steps, lr=args.lr,
        device=args.device)
    devices = (torch.distributed.get_world_size()
               if torch.distributed.is_initialized() else 1)
    print(f"arch={cfg.name} params={num_params(lm_specs(cfg)):,} "
          f"devices={devices} device={dev}")

    stream = BigramStream(cfg.vocab_size, seed=0)

    def batch_fn(step_idx):
        rng = np.random.default_rng(1000 + step_idx)   # replay-deterministic
        toks = stream.sample(rng, args.batch, args.seq)
        return {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
                "labels": torch.as_tensor(toks[:, 1:], device=dev)}

    state = {"params": params, "opt_state": opt_state}

    def step_fn(state, batch):
        p, o, m = step(state["params"], state["opt_state"], batch)
        return {"params": p, "opt_state": o}, m

    injector = (FaultInjector([args.inject_fault_at])
                if args.inject_fault_at is not None else None)
    fcfg = FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)

    def cb(step_idx, metrics, dt):
        if step_idx % 10 == 0 or step_idx == args.steps - 1:
            print(f"step {step_idx:5d} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms",
                  flush=True)
        if metrics_cb is not None:
            metrics_cb(step_idx, metrics, dt)

    report = run_training(step_fn, state, batch_fn, args.steps, fcfg,
                          injector=injector, metrics_cb=cb)
    print(f"done: steps={report.steps_run} restarts={report.restarts} "
          f"stragglers={report.stragglers} "
          f"final_loss={report.last_metrics.get('loss'):.4f}")
    return report


if __name__ == "__main__":
    main()

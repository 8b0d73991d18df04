"""Multi-pod dry run: trace every (arch x shape x mesh) cell over a fake
world — the port of ``src/repro/launch/dryrun.py``.

For each cell this proves the sharding config is coherent (DTensor
propagates every op), records the memory a device would hold (fits per
card?), the local FLOPs and bytes, and the per-device collective bytes
— the inputs to the roofline analysis.

On torch, "lower and compile a cell on 256/512 fake devices" means:
start a fake process group of the mesh's world size
(``torch.testing._internal.distributed.fake_pg``: this process is rank 0,
and its collectives move nothing), build the params, the optimizer state
or the caches as *meta* DTensors with the cell's shardings over a
``"meta"`` device mesh, and trace the train, prefill or decode step once
under ``hlo_analysis.StepRecorder``. Nothing touches a device or
allocates memory, as the reference compiles on the host: this is the one
entry point of the port that does not default to the card. A process
holds one default group, so the dry run runs in a process of its own,
never beside ``launch.mesh.make_host_mesh``'s real group.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, all_cells, get_config
from repro_torch.launch.hlo_analysis import DEVICE_BYTES, StepRecorder, \
    collective_bytes, roofline_terms
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import init_caches, lm_specs
from repro_torch.sharding.api import DEFAULT_RULES, NamedSharding, P, \
    device_put, distribute, is_dtensor, mesh_shape, num_params, \
    spec_partition_specs, spec_shapes, tree_leaves, tree_map, use_mesh
from repro_torch.sharding.caches import cache_partition_specs
from repro_torch.train.optimizer import AdamW, constant_lr
from repro_torch.train.step import make_decode_step, make_prefill_step, \
    make_train_step

FSDP_RULES = {**DEFAULT_RULES, "embed": ("data",)}
# the reference's ``--opt`` levers, each a ``cfg.opt_*`` flag that the
# port's models read: head_nofsdp (``lm_specs``), kv_int8 (the caches),
# seq_shard (``lm_forward``), attn_remat (``attend_full``), chunk_remat
# (``ssm``'s chunked forms); decode_carry (caches updated in place) is
# what the port's decode always does
PORT_LEVERS = ("head_nofsdp", "decode_carry", "seq_shard", "attn_remat",
               "kv_int8", "chunk_remat")


def check_opts(opts) -> None:
    """Raise ``ValueError`` naming each lever of ``opts`` that the
    reference does not have, so that no record claims a lever that
    nothing reads."""
    missing = [o for o in opts if o not in PORT_LEVERS]
    if missing:
        raise ValueError(f"no --opt lever {', '.join(missing)} (the "
                         f"levers are {', '.join(PORT_LEVERS)})")


def _dp_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape, mesh):
    """Meta-tensor stand-ins for every model input of the cell, and their
    partition specs."""
    B, S = shape.global_batch, shape.seq_len
    dp = _dp_axes(mesh)
    tok = _meta((B, S), torch.int32)
    batch_spec = P(dp if B > 1 else None, None)
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": tok}
        specs = {"tokens": batch_spec}
        if shape.kind == "train":
            batch["labels"] = _meta((B, S), torch.int32)
            specs["labels"] = batch_spec
        if cfg.is_encoder_decoder:
            batch["audio_embed"] = _meta((B, cfg.encoder_seq, cfg.d_model),
                                         torch.float32)
            specs["audio_embed"] = P(dp if B > 1 else None, None, None)
        return batch, specs
    # decode
    return {"tokens": _meta((B, 1), torch.int32), "pos": S - 1}, \
        {"tokens": P(dp if B > 1 else None, None), "pos": P()}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    rank 0, destroyed on exit. Refuses to start beside another group."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: this process already holds a "
                           "process group; run the dry run in its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _shard(mesh, pspecs):
    return tree_map(lambda s: NamedSharding(mesh, s), pspecs,
                    is_leaf=lambda x: isinstance(x, P))


def _local_bytes(tree) -> int:
    return sum((t.to_local() if is_dtensor(t) else t).numel()
               * t.element_size()
               for t in tree_leaves(tree, is_leaf=torch.is_tensor)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Compiled:
    """What the trace of one step saw on rank 0."""
    recorder: StepRecorder
    argument_bytes: int
    output_bytes: int

    def memory_analysis(self) -> dict:
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.recorder.peak_bytes,
                "temp_at_peak": self.recorder.peak_allocations}

    def cost_analysis(self) -> dict:
        return {"flops": float(self.recorder.flops),
                "bytes accessed": float(self.recorder.bytes)}


@dataclasses.dataclass
class Lowered:
    """A cell's step and its meta DTensor arguments, ready to trace."""
    mesh: object
    step: Callable
    args: tuple

    def compile(self) -> Compiled:
        """Trace the step once under ``StepRecorder``."""
        rec = StepRecorder(device_type="meta")
        with use_mesh(self.mesh), rec:
            out = self.step(*self.args)
        return Compiled(rec, _local_bytes(self.args), _local_bytes(out))


def lower_cell(arch: str, shape_name: str, mesh, *, fsdp: bool = True,
               unroll: bool = False, opts: tuple = (), config=None,
               shape=None):
    """``(Lowered, n_params, cfg)``. ``unroll`` is the reference's
    argument and changes nothing: the port's layers are a Python loop
    already. So does ``opts``' ``decode_carry``: the port's decode
    updates its caches in place, which is that lever's program. Each
    lever of ``opts`` sets its ``cfg.opt_*``; a name outside
    ``PORT_LEVERS`` raises ``ValueError``.
    ``config`` and ``shape`` (a ``ShapeConfig``), if given, stand in for
    the named ones (a smoke-size cell)."""
    check_opts(opts)
    cfg = config or get_config(arch)
    if opts:
        cfg = dataclasses.replace(cfg, **{f"opt_{o}": True for o in opts})
    shape = shape or SHAPES[shape_name]
    rules = FSDP_RULES if (fsdp and shape.kind == "train") else DEFAULT_RULES
    specs = lm_specs(cfg)
    pdtype = "float32" if shape.kind == "train" else "bfloat16"
    param_pspecs = spec_partition_specs(specs, mesh, rules)
    n_params = num_params(specs)
    batch, batch_pspecs = input_specs(cfg, shape, mesh)
    with use_mesh(mesh):
        params = device_put(spec_shapes(specs, dtype_override=pdtype),
                            _shard(mesh, param_pspecs))
        if shape.kind == "train":
            opt = AdamW(lr=constant_lr(3e-4))
            opt_state = {
                "m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "step": distribute(_meta((), torch.int32),
                                   NamedSharding(mesh, P()))}
            batch = device_put(batch, _shard(mesh, batch_pspecs))
            lowered = Lowered(mesh, make_train_step(cfg, opt),
                              (params, opt_state, batch))
        elif shape.kind == "prefill":
            batch = device_put(batch, _shard(mesh, batch_pspecs))
            lowered = Lowered(mesh, make_prefill_step(cfg,
                                                      max_seq=shape.seq_len),
                              (params, batch))
        else:
            caches = init_caches(cfg, shape.global_batch, shape.seq_len,
                                 device="meta")
            caches = device_put(caches, _shard(mesh, cache_partition_specs(
                caches, mesh, shape.global_batch)))
            tokens = distribute(batch["tokens"],
                                NamedSharding(mesh, batch_pspecs["tokens"]))
            lowered = Lowered(mesh, make_decode_step(cfg),
                              (params, caches, tokens, batch["pos"]))
    return lowered, n_params, cfg


def analyse_cell(arch: str, shape_name: str, *, multi_pod: bool,
                 fsdp: bool = True, want_hlo: bool = True,
                 cost_mode: str = "unroll", opts: tuple = (),
                 mesh=None, config=None, shape=None) -> dict:
    """Trace one cell on ``mesh`` (default: the production mesh, which
    needs ``fake_world(256 or 512)``) and return the reference's record.
    ``cost_mode`` is the reference's argument: one trace of the port's
    Python loop over layers counts every layer, so ``cost_source`` is
    ``"trace"``; a time loop (the sLSTM's) is recorded one step deep and
    counted L times (``StepRecorder.repeat``; ``loops_recorded_once``
    counts them), where the reference's cost analysis counts its scan's
    body once. ``want_hlo=False`` leaves out the collectives.
    ``config`` and ``shape`` as in ``lower_cell``."""
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    t0 = time.time()
    lowered, n_params, cfg = lower_cell(arch, shape_name, mesh, fsdp=fsdp,
                                        opts=opts, config=config,
                                        shape=shape)
    t_lower = time.time() - t0
    t0 = time.time()
    compiled = lowered.compile()
    t_compile = time.time() - t0

    mem = compiled.memory_analysis()
    cost = compiled.cost_analysis()
    coll = collective_bytes(compiled.recorder.collectives if want_hlo
                            else ())
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    from repro_torch.configs.base import active_param_fraction
    n_active = n_params * active_param_fraction(cfg, n_params)
    shape = shape or SHAPES[shape_name]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2.0 * n_active * tokens
    else:
        tokens = shape.global_batch
        model_flops = 2.0 * n_active * tokens
    sizes = mesh_shape(mesh)
    chips = int(np.prod(list(sizes.values())))
    terms = roofline_terms(flops, bytes_acc, coll["total"])
    peak = mem["argument_bytes"] + mem["temp_bytes"]
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in sizes.values()),
        "chips": chips, "fsdp": fsdp,
        "n_params": n_params,
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "memory": {**mem, "peak_bytes_est": int(peak),
                   "device_bytes": int(DEVICE_BYTES),
                   "fits": bool(peak <= DEVICE_BYTES)},
        "cost": {"flops_per_device": flops,
                 "bytes_per_device": bytes_acc,
                 "bytes_counted": "unfused",
                 "cost_source": "trace",
                 "loops_recorded_once": compiled.recorder.repeated},
        "collectives": coll,
        "model_flops_global": model_flops,
        "model_flops_per_device": model_flops / chips,
        "useful_flops_ratio": (model_flops / chips) / flops if flops else 0.0,
        "roofline": terms,
        "traced_ops": compiled.recorder.ops,
        "opts": list(opts),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--opt", action="append", default=[],
                    help="enable a beyond-paper memory lever (repeat for "
                         "more): " + ", ".join(PORT_LEVERS))
    args = ap.parse_args(argv)
    try:
        check_opts(args.opt)
    except ValueError as e:
        ap.error(str(e))

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    cells = []
    for arch, shape, skip in all_cells():
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape.name != args.shape:
            continue
        cells.append((arch, shape.name, skip))
    if not cells:
        raise SystemExit("no cells matched")

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for arch, shape_name, skip in cells:
        for multi in meshes:
            tagpart = f"--{args.tag}" if args.tag else ""
            name = (f"{arch}--{shape_name}--{'multi' if multi else 'single'}"
                    f"{tagpart}.json")
            path = outdir / name
            if path.exists() and not args.force:
                print(f"[skip-existing] {name}")
                continue
            if skip:
                path.write_text(json.dumps(
                    {"arch": arch, "shape": shape_name,
                     "mesh": "multi" if multi else "single",
                     "skipped": skip}, indent=2))
                print(f"[skipped] {arch} {shape_name}: {skip}")
                continue
            print(f"[dryrun] {arch} {shape_name} multi_pod={multi} ...",
                  flush=True)
            try:
                with fake_world(512 if multi else 256):
                    res = analyse_cell(arch, shape_name, multi_pod=multi,
                                       fsdp=not args.no_fsdp,
                                       opts=tuple(args.opt))
                path.write_text(json.dumps(res, indent=2))
                r = res["roofline"]
                print(f"  ok: compile={res['compile_s']}s "
                      f"peak={res['memory']['peak_bytes_est']/2**30:.2f}GiB/dev "
                      f"compute={r['compute_s']:.4f}s mem={r['memory_s']:.4f}s "
                      f"coll={r['collective_s']:.4f}s dom={r['dominant']} "
                      f"frac={r['roofline_fraction']:.3f}", flush=True)
            except Exception as e:
                err = {"arch": arch, "shape": shape_name,
                       "mesh": "multi" if multi else "single",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                path.with_suffix(".error.json").write_text(
                    json.dumps(err, indent=2))
                print(f"  FAILED: {type(e).__name__}: {str(e)[:400]}",
                      flush=True)


if __name__ == "__main__":
    main()

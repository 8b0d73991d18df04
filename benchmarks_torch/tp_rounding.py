#!/usr/bin/env python3
"""How far tensor-parallel rounding moves zamba2's loss gradient, on the
CPU over gloo ranks (no card, no JAX).

    python3 benchmarks_torch/tp_rounding.py [--seeds 12 20 30 40] [--out FILE]

zamba2's smoke config (its Mamba2 mixers split over their 8 heads on
``model``), batch 4 x 32 tokens of each seed, weights from the same seed:
the largest per-leaf distance of the loss gradient on a ``(2, 2)`` and a
``(1, 4)`` mesh of 4 gloo ranks from one device's, each leaf relative to
its own largest entry, in float32 and float64 (the norm's statistic and
the loss stay float32 in a float64 config), beside one device's float32
gradient against its float64 one: the float32 gradient's own precision.
Prints one JSON object; ``--out`` writes it too.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RANK = r"""
import json, sys
import torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method="env://")
from repro_torch.configs import get_smoke_config, scaled
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm_loss, lm_specs
from repro_torch.sharding.api import (NamedSharding, P, device_put, distribute,
                                      materialize, spec_shardings, tree_flatten_with_path,
                                      tree_leaves, use_mesh)
from repro_torch.train.step import value_and_grad

def whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x

def worst(a, b):
    rows = [("/".join(map(str, path)),
             float((x.double() - whole(y).double()).abs().max()
                   / max(float(x.abs().max()), 1e-30)))
            for (path, x), y in zip(tree_flatten_with_path(a, is_leaf=torch.is_tensor),
                                    tree_leaves(b))]
    return max(rows, key=lambda r: r[1])

meshes = {"2x2": make_host_mesh(2, 2, device="cpu"), "1x4": make_host_mesh(1, 4, device="cpu")}
out = {}
for seed in json.loads(sys.argv[1]):
    row = {}
    grads = {}
    for dtype in ("float32", "float64"):
        cfg = scaled(get_smoke_config("zamba2-2.7b"), dtype=dtype)
        specs = lm_specs(cfg)
        params = materialize(specs, torch.Generator().manual_seed(seed), "cpu")
        toks = torch.randint(0, cfg.vocab_size, (4, 33),
                             generator=torch.Generator().manual_seed(seed + 1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        _, one = value_and_grad(lambda p: lm_loss(cfg, p, batch), params)
        grads[dtype] = one
        for name, mesh in meshes.items():
            with use_mesh(mesh):
                ps = device_put(params, spec_shardings(specs, mesh))
                bs = {k: distribute(v, NamedSharding(mesh, P("data", None)))
                      for k, v in batch.items()}
                _, g = value_and_grad(lambda p: lm_loss(cfg, p, bs), ps)
            row[f"{name}_{dtype}"] = worst(one, g)
    row["one_device_float32_vs_float64"] = worst(grads["float64"], grads["float32"])
    out[str(seed)] = row
dist.barrier()
if dist.get_rank() == 0:
    print("RESULT " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[12, 20, 30, 40])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="4", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, json.dumps(args.seeds)],
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    outs = [p.communicate(timeout=1800) for p in procs]
    for p, (_, err) in zip(procs, outs):
        if p.returncode:
            print(err[-3000:], file=sys.stderr)
            return 1
    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT ")][-1]
    res = json.loads(line[len("RESULT "):])
    print(json.dumps(res, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's sharded training over real ranks: 4 gloo processes on the
CPU form a ``(2, 2)`` ``("data", "model")`` mesh, the torch counterpart
of the reference's ``tests/test_distributed.py`` meshes of fake devices.

One world of 4 ranks checks, rank by rank, that each DTensor shard holds
the NumPy slice its mesh coordinate should (JAX's major-to-minor order),
that a sharded float32 train step matches the one-device step (smollm,
granite's MoE dispatch on each rank's batch rows, smollm with
``opt_seq_shard``), as does the embedding table's gradient under vocab
shards,
that ``launch.train.build(data_axis=2, model_axis=2)`` trains on the mesh,
alone and under the fault-tolerant training loop with an injected fault,
that MoE, sliding-window and recurrent losses and decode steps over
slot-sharded caches match the one-device path, as does a ring prefill
into such caches, that ``TokenPipeline(shardings=)`` splits its batches
over the mesh, and saves a sharded checkpoint. On a ``(1, 4)`` mesh of
the same ranks it checks the paths that keep split what the reference
keeps split where "model" divides neither the KV heads nor the
experts: chameleon's query heads, mixtral's expert d_ff (6 experts),
zamba2's SSD heads, and a zamba2 prefill and decode over caches split
on heads. On both meshes it runs greedy decode steps over caches split
along their slots and heads (zamba2, gemma3, an int8 cache) and the
greedy token of logits split along the vocab with ties. A second world of 2 ranks restores it onto ``(1, 2)``
(elastic resharding), and restores a file the reference wrote. Every
rank runs in a subprocess with a time limit of its own: a hung rank
fails its test."""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 300

PRELUDE = r"""
import json, os
import numpy as np
import torch
import torch.distributed as dist
torch.manual_seed(0)
dist.init_process_group("gloo", init_method="env://")
rank, world = dist.get_rank(), dist.get_world_size()
from repro_torch.configs import get_smoke_config, scaled
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_caches, lm_decode_step, lm_loss, lm_prefill, lm_specs
from repro_torch.sharding.api import (NamedSharding, P, device_put, distribute, materialize,
                                      spec_shardings, tree_leaves, tree_map, use_mesh)
from repro_torch.sharding.caches import cache_shardings
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamW, warmup_cosine
from repro_torch.train.step import make_train_step

results = {}
LOSS_ARCHS = ("granite-moe-1b-a400m", "gemma3-12b", "xlstm-125m")
DECODE_ARCHS = ("smollm-135m", "gemma3-12b")

def whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x

def worst(a, b):
    # max |a - b| over all leaves, each relative to its leaf's max |a|
    return max(float((x - whole(y)).abs().max() / max(float(x.abs().max()), 1e-30))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))

def batch_of(cfg, B, S, seed):
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1),
                         generator=torch.Generator().manual_seed(seed))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
"""

WORLD4 = PRELUDE + r"""
mesh = make_host_mesh(2, 2, device="cpu")
results["mesh"] = [list(mesh.mesh_dim_names), list(mesh.shape)]

# each shard against the slice JAX's NamedSharding gives its coordinate
bad = 0
x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
for spec in (P("data"), P(None, "model"), P("model", "data"), P(("data", "model")),
             P(None, ("data", "model")), P()):
    local = distribute(x, NamedSharding(mesh, spec)).to_local()
    want = x.numpy()
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        n = int(np.prod([sizes[a] for a in axes])) if axes else 1
        i = 0
        for a in axes:
            i = i * sizes[a] + coord[a]
        size = x.shape[d] // n
        want = np.take(want, range(i * size, (i + 1) * size), axis=d)
    bad += int(not np.array_equal(local.numpy(), want))
t = torch.tensor([bad])
dist.all_reduce(t)
results["placement_mismatches"] = int(t)

# one float32 train step, sharded vs one device
cfg = scaled(get_smoke_config("smollm-135m"), dtype="float32")
specs = lm_specs(cfg)
opt = AdamW(lr=warmup_cosine(3e-4, 10, 100))
step = make_train_step(cfg, opt)
params = materialize(specs, torch.Generator().manual_seed(0), "cpu")
batch = batch_of(cfg, 4, 32, 1)
p1, o1, m1 = step(params, opt.init(params), batch)
ps, os_, mstep = launch.shard_training(mesh, specs, params, opt, step)
results["sharded_leaves"] = sum(int(any(type(p).__name__ == "Shard" for p in x.placements))
                                for x in tree_leaves(ps))
results["leaves"] = len(tree_leaves(ps))
p2, o2, m2 = mstep(ps, os_, batch)
results["train_loss"] = [float(m1["loss"]), float(m2["loss"])]
results["train_gnorm"] = [float(m1["grad_norm"]), float(m2["grad_norm"])]
results["train_params_rel"] = worst(p1, p2)
results["train_m_rel"] = worst(o1["m"], o2["m"])
results["step_placements"] = [str(p) for p in o2["step"].placements]

# the launcher's own mesh path (bf16 smoke config), against its plain build
cfg_b, pb, ob, sb, _ = launch.build("smollm-135m", True, 4, 32, 10, data_axis=2,
                                    model_axis=2, device="cpu")
cfg_1, p1b, o1b, s1b, _ = launch.build("smollm-135m", True, 4, 32, 10, device="cpu")
bb = batch_of(cfg_b, 4, 32, 2)
results["build_mesh"] = list(tree_leaves(pb)[0].device_mesh.shape)
_, _, mb = sb(pb, ob, bb)
_, _, m1b = s1b(p1b, o1b, bb)
results["build_loss"] = [float(m1b["loss"]), float(mb["loss"])]

# the fault-tolerant training loop on the mesh: a fault injected before step 3
# restores step 2's checkpoint onto the mesh's placements and replays;
# every step and the final checkpoint equal a run without the fault
from repro_torch.sharding.api import is_dtensor, spec_shapes
from repro_torch.train.fault import FaultConfig, FaultInjector, run_training

def fault_run(name, injector):
    cfg_f, pf, of, sf, _ = launch.build("smollm-135m", True, 4, 16, 5, data_axis=2,
                                        model_axis=2, device="cpu")
    seen, placed = [], []

    def step_fn(state, b):
        placed.append(all(is_dtensor(x) for x in tree_leaves(state)))
        p, o, m = sf(state["params"], state["opt_state"], b)
        return {"params": p, "opt_state": o}, m
    ckdir = os.path.join(os.environ["CKPT_DIR"], name)
    rep = run_training(step_fn, {"params": pf, "opt_state": of},
                       lambda i: batch_of(cfg_f, 4, 16, 100 + i), 5,
                       FaultConfig(ckpt_dir=ckdir, ckpt_every=2, keep=2),
                       injector=injector,
                       metrics_cb=lambda i, m, dt: seen.append([i, m["loss"]]))
    saved = ckpt.restore(ckdir, {"params": spec_shapes(lm_specs(cfg_f)), "opt_state": of},
                         device="cpu")[0]
    return rep, seen, placed, saved, sorted(os.listdir(ckdir))

rep_a, seen_a, placed_a, saved_a, files_a = fault_run("ft_clean", None)
rep_b, seen_b, placed_b, saved_b, files_b = fault_run("ft_fault", FaultInjector([3]))
results["fault"] = {
    "restarts": [rep_a.restarts, rep_b.restarts],
    "steps_run": [rep_a.steps_run, rep_b.steps_run],
    "losses": [seen_a, seen_b],
    "all_dtensor": all(placed_a) and all(placed_b),
    "files": [files_a, files_b],
    "final_equal": all(torch.equal(whole(x), whole(y)) for x, y in
                       zip(tree_leaves(saved_a), tree_leaves(saved_b), strict=True))}

# losses of other families over DTensors: MoE dispatch (granite), heads
# sharded over "model" with local/global layers (gemma3), recurrent
# mixers (xlstm)
for arch in LOSS_ARCHS:
    cfg_m = scaled(get_smoke_config(arch), dtype="float32")
    pm = materialize(lm_specs(cfg_m), torch.Generator().manual_seed(3), "cpu")
    bm = batch_of(cfg_m, 4, 16, 4)
    l1, a1 = lm_loss(cfg_m, pm, bm)
    with use_mesh(mesh):
        pms = device_put(pm, spec_shardings(lm_specs(cfg_m), mesh))
        bms = {k: distribute(v, NamedSharding(mesh, P("data", None))) for k, v in bm.items()}
        l2, a2 = lm_loss(cfg_m, pms, bms)
    results["loss_" + arch] = [float(l1), float(whole(l2)),
                               float(a1["aux_loss"]), float(whole(a2["aux_loss"]))]

# one float32 train step of granite (MoE dispatch and combine on each
# rank's own batch rows) and of smollm with opt_seq_shard (block inputs
# split along the sequence over "model"), each sharded vs one device
for name, arch, lever in (("granite", "granite-moe-1b-a400m", {}),
                          ("seq_shard", "smollm-135m", {"opt_seq_shard": True})):
    cfg_t = scaled(get_smoke_config(arch), dtype="float32", **lever)
    st = lm_specs(cfg_t)
    step_t = make_train_step(cfg_t, opt)
    pt = materialize(st, torch.Generator().manual_seed(8), "cpu")
    bt = batch_of(cfg_t, 4, 32, 9)
    q1, r1, n1 = step_t(pt, opt.init(pt), bt)
    pts, rts, tstep_ = launch.shard_training(mesh, st, pt, opt, step_t)
    q2, r2, n2 = tstep_(pts, rts, bt)
    results["step_" + name] = {
        "loss": [float(n1["loss"]), float(n2["loss"])],
        "aux": [float(n1["aux_loss"]), float(n2["aux_loss"])],
        "gnorm": [float(n1["grad_norm"]), float(n2["grad_norm"])],
        "params_rel": worst(q1, q2), "m_rel": worst(r1["m"], r2["m"])}

# every family's loss gradient over DTensors (DEFAULT_RULES on (2, 2),
# the batch split over "data") vs one device: the worst leaf's largest
# difference over its largest entry
from repro_torch.configs import ARCH_IDS
from repro_torch.train.step import value_and_grad
grad_rel = {}
for arch in ARCH_IDS:
    # zamba2's Mamba2 mixers split over their heads sum their norm's
    # statistic and their output product over "model", in another order
    # than one device: its chunked SSD form, ill-conditioned in float32
    # (one device's float32 gradient is 1.05e-3 from its float64 one
    # here), turns that rounding into 0.2-3.3e-3 of a leaf in float32,
    # so zamba2 is held in float64
    cfg_g = scaled(get_smoke_config(arch),
                   dtype="float64" if arch == "zamba2-2.7b" else "float32")
    sg = lm_specs(cfg_g)
    pg = materialize(sg, torch.Generator().manual_seed(12), "cpu")
    bg = batch_of(cfg_g, 4, 32, 13)
    if cfg_g.is_encoder_decoder:
        bg["audio_embed"] = torch.randn((4, cfg_g.encoder_seq, cfg_g.d_model),
                                        generator=torch.Generator().manual_seed(14))
    _, g1g = value_and_grad(lambda p: lm_loss(cfg_g, p, bg), pg)
    with use_mesh(mesh):
        pgs = device_put(pg, spec_shardings(sg, mesh))
        bgs = {k: distribute(v, NamedSharding(mesh, P("data", *(None,) * (v.ndim - 1))))
               for k, v in bg.items()}
        _, g2g = value_and_grad(lambda p: lm_loss(cfg_g, p, bgs), pgs)
    grad_rel[arch] = worst(g1g, g2g)
results["grad_rel"] = grad_rel

# the embedding table's gradient under vocab shards (DEFAULT_RULES: the
# vocab on "model"; qwen2.5's head is untied, so the gradient is the
# lookup's alone), vs one device
cfg_e = scaled(get_smoke_config("qwen2.5-32b"), dtype="float32")
se = lm_specs(cfg_e)
pe = materialize(se, torch.Generator().manual_seed(10), "cpu")
be = batch_of(cfg_e, 4, 16, 11)
(l1e, _), g1e = value_and_grad(lambda p: lm_loss(cfg_e, p, be), pe)
with use_mesh(mesh):
    pes = device_put(pe, spec_shardings(se, mesh))
    bes = {k: distribute(v, NamedSharding(mesh, P("data", None))) for k, v in be.items()}
    (l2e, _), g2e = value_and_grad(lambda p: lm_loss(cfg_e, p, bes), pes)
results["embed_grad"] = {
    "placements": [str(p) for p in pes["embed"].placements],
    "grad_placements": [str(p) for p in g2e["embed"].placements],
    "loss": [float(l1e), float(whole(l2e))],
    "rel": float((g1e["embed"] - whole(g2e["embed"])).abs().max()
                 / g1e["embed"].abs().max()),
    "rows_touched": int((g1e["embed"].abs().sum(-1) > 0).sum())}

# decode over caches sharded along their slots (cache_seq -> model):
# smollm (heads whole), gemma3 (heads sharded, sliding-window rings)
for arch in DECODE_ARCHS:
    cfg_d = scaled(get_smoke_config(arch), dtype="float32")
    sd = lm_specs(cfg_d)
    pd = materialize(sd, torch.Generator().manual_seed(5), "cpu")
    toks = batch_of(cfg_d, 4, 12, 5)["tokens"]
    caches, _ = lm_prefill(cfg_d, pd, {"tokens": toks[:, :8]}, max_seq=16)
    with use_mesh(mesh):
        pds = device_put(pd, spec_shardings(sd, mesh))
        cds = device_put(tree_map(torch.clone, caches, is_leaf=torch.is_tensor),
                         cache_shardings(caches, mesh, 4))
    diffs = []
    for i in range(8, 12):
        tok = toks[:, i:i + 1]
        _, lg1 = lm_decode_step(cfg_d, pd, caches, tok, i)
        with use_mesh(mesh):
            _, lg2 = lm_decode_step(cfg_d, pds, cds, distribute(tok, NamedSharding(mesh, P("data"))), i)
        diffs.append(float((lg1 - whole(lg2)).abs().max() / lg1.abs().max()))
    k_whole = whole(cds["blocks"][-1]["k"])              # (reps, B, W, nkv, hd)
    W = k_whole.shape[2]
    results["decode_" + arch] = {
        "k_placements": [str(p) for p in cds["blocks"][-1]["k"].placements],
        "logits_rel": max(diffs), "cache_rel": worst(caches, cds),
        "written": [bool(k_whole[:, :, i].abs().sum() > 0) for i in range(min(12, W))],
        "empty": [bool(k_whole[:, :, i].abs().sum() == 0) for i in range(12, W)]}

# a ring prefill into caches sharded along their slots (cache_seq ->
# model): gemma3's local layer 0 (window 16), k/v projected over heads
# split on "model", a prompt longer than the window (wrapping) and one
# shorter (half the slots empty); each rank's own slots against the
# plain ring's slice at its offset
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch.models.attention import attend_full, prefill_into_cache
from repro_torch.models.lm import _block_params, _rep
cfg_r = scaled(get_smoke_config("gemma3-12b"), dtype="float32")
sr = lm_specs(cfg_r)
pr = materialize(sr, torch.Generator().manual_seed(6), "cpu")
kind_r, win = cfg_r.block_pattern[0], cfg_r.sliding_window
with use_mesh(mesh):
    prs = device_put(pr, spec_shardings(sr, mesh))
for S_r in (24, 10):
    h = torch.randn((4, S_r, cfg_r.d_model), generator=torch.Generator().manual_seed(S_r))
    pos_r = torch.arange(S_r, dtype=torch.int32)
    plain = init_caches(cfg_r, 4, 32, device="cpu")
    _, (k1, v1) = attend_full(_block_params(pr, kind_r, 0, 0)["attn"], cfg_r, h, pos_r,
                              causal=True, window=win)
    prefill_into_cache(_rep(plain["blocks"][0], 0), k1, v1, pos_r, window=win)
    with use_mesh(mesh):
        placed = device_put(init_caches(cfg_r, 4, 32, device="cpu"),
                            cache_shardings(plain, mesh, 4))
        hs = distribute(h, NamedSharding(mesh, P("data", None, None)))
        _, (k2, v2) = attend_full(_block_params(prs, kind_r, 0, 0)["attn"], cfg_r, hs, pos_r,
                                  causal=True, window=win)
        prefill_into_cache(_rep(placed["blocks"][0], 0), k2, v2, pos_r, window=win)
    line = {"window": win, "k_placements": [str(p) for p in placed["blocks"][0]["k"].placements]}
    bad, rel = 0, 0.0
    for name in ("k", "v"):
        dt = placed["blocks"][0][name]
        shape, offset = compute_local_shape_and_global_offset(dt.shape, dt.device_mesh,
                                                              dt.placements)
        want = plain["blocks"][0][name][tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        got = dt.to_local()
        wrote = lambda t: (t.float().abs().sum(dim=(0, 1, 3, 4)) > 0).tolist()  # a slot
        bad += int(wrote(got) != wrote(want))
        rel = max(rel, float((got.float() - want.float()).abs().max()
                             / max(float(want.float().abs().max()), 1e-30)))
    t = torch.tensor([bad, rel], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    kw = whole(placed["blocks"][0]["k"])[0]
    line.update(written_mismatches=int(t[0]), kv_rel=float(t[1]),
                written=[bool(kw[:, i].abs().sum() > 0) for i in range(kw.shape[1])],
                pos=whole(placed["blocks"][0]["pos"])[0].tolist(),
                pos_plain=plain["blocks"][0]["pos"][0].tolist())
    results[f"ring_prefill_{S_r}"] = line

# TokenPipeline(shardings=): tokens split along the batch over "data",
# labels (no key) a plain tensor; the batches equal the unsharded ones
from repro_torch.data.pipeline import TokenPipeline
tp_plain = TokenPipeline(64, 4, 8, seed=9, device="cpu")
tp_mesh = TokenPipeline(64, 4, 8, seed=9, device="cpu",
                        shardings={"tokens": NamedSharding(mesh, P("data", None))})
try:
    seen = []
    for _ in range(3):
        a, b = next(tp_plain), next(tp_mesh)
        seen.append({"tokens_equal": torch.equal(a["tokens"], b["tokens"].full_tensor()),
                     "labels_equal": torch.equal(a["labels"], b["labels"]),
                     "tokens_placements": [str(p) for p in b["tokens"].placements],
                     "tokens_local": list(b["tokens"].to_local().shape),
                     "labels_plain": type(b["labels"]) is torch.Tensor})
finally:
    tp_plain.close()
    tp_mesh.close()
results["token_pipeline"] = seen

# a (1, 4) mesh over the same ranks, where "model" divides neither
# chameleon's 2 KV heads (its 4 query heads split, 1 a rank) nor 6 of
# mixtral's experts (their d_ff split: "expert_mlp"), and zamba2's 8 SSD
# heads split 2 a rank: the float32 loss and every gradient leaf vs one
# device, and a zamba2 prefill and 4 decode steps over caches placed by
# cache_shardings
from repro_torch.sharding.api import is_dtensor, tree_flatten_with_path, tree_unflatten
mesh14 = make_host_mesh(1, 4, device="cpu")
results["mesh14"] = list(mesh14.shape)
split = {}
for arch, over in (("chameleon-34b", {}), ("mixtral-8x7b", {"num_experts": 6}),
                   ("zamba2-2.7b", {})):
    cfg_s = scaled(get_smoke_config(arch), dtype="float32", **over)
    ss = lm_specs(cfg_s)
    ps = materialize(ss, torch.Generator().manual_seed(15), "cpu")
    bs = batch_of(cfg_s, 4, 32, 16)
    (l1s, _), g1s = value_and_grad(lambda p: lm_loss(cfg_s, p, bs), ps)
    with use_mesh(mesh14):
        pss = device_put(ps, spec_shardings(ss, mesh14))
        bss = {k: distribute(v, NamedSharding(mesh14, P("data", None))) for k, v in bs.items()}
        (l2s, _), g2s = value_and_grad(lambda p: lm_loss(cfg_s, p, bss), pss)
    split[arch] = {"loss": [float(l1s), float(whole(l2s))], "grad_rel": worst(g1s, g2s)}
results["split_1x4"] = split

cfg_z = scaled(get_smoke_config("zamba2-2.7b"), dtype="float32")
sz = lm_specs(cfg_z)
pz = materialize(sz, torch.Generator().manual_seed(17), "cpu")
toks = batch_of(cfg_z, 4, 20, 18)["tokens"]
c1, p1z = lm_prefill(cfg_z, pz, {"tokens": toks[:, :16]}, max_seq=24)
placed_like = lambda t: [str(p) for p in t.placements]
with use_mesh(mesh14):
    pzs = device_put(pz, spec_shardings(sz, mesh14))
    c2, p2z = lm_prefill(cfg_z, pzs, {"tokens": distribute(
        toks[:, :16], NamedSharding(mesh14, P("data", None)))}, max_seq=24)
    want = tree_leaves(cache_shardings(c1, mesh14, 4),
                       is_leaf=lambda s: isinstance(s, NamedSharding))
    got = tree_leaves(c2, is_leaf=torch.is_tensor)
    mamba = [i for i, (path, _) in enumerate(tree_flatten_with_path(
        c1, is_leaf=torch.is_tensor)) if path[-1] in ("s", "conv")]
    state_placed = [placed_like(got[i]) == [str(p) for p in want[i].placements]
                    for i in mamba]
    c2 = tree_unflatten(c2, [x.redistribute(mesh14, sh.placements) if is_dtensor(x)
                             else distribute(x, sh) for x, sh in zip(got, want)])
    before = [placed_like(x) for x in tree_leaves(c2, is_leaf=torch.is_tensor)]
diffs = []
for i in range(16, 20):
    tok = toks[:, i:i + 1]
    _, d1 = lm_decode_step(cfg_z, pz, c1, tok, i)
    with use_mesh(mesh14):
        _, d2 = lm_decode_step(cfg_z, pzs, c2, distribute(tok, NamedSharding(mesh14, P("data"))), i)
    diffs.append(float((d1 - whole(d2)).abs().max() / d1.abs().max()))
results["zamba2_decode_1x4"] = {
    "prefill_rel": float((p1z - whole(p2z)).abs().max() / p1z.abs().max()),
    "logits_rel": max(diffs), "cache_rel": worst(c1, c2),
    "mamba_leaves": len(mamba), "state_placed": state_placed,
    "kept": before == [placed_like(x) for x in tree_leaves(c2, is_leaf=torch.is_tensor)],
    "conv_s_placements": [before[i] for i in mamba[:2]]}

# decode over caches split along their slots (each step make_decode_step's
# greedy token too), held to one device: batch 1 on (2, 2), the long_500k
# layout ("longseq" puts the slots on "data", the KV heads on "model"),
# and batch 4 on (1, 4), the decode_32k layout ("cache_seq" puts the
# slots on "model", which splits the query heads too); zamba2's shared
# attention, gemma3's rings (window 16) and global layer, one int8 case.
# On (1, 4) a rank's slots are all empty or past the position at first
from repro_torch.train.step import _greedy_token, make_decode_step
SLOT_CASES = {"zamba2_2x2_b1": ("zamba2-2.7b", mesh, 1, False, 16),
              "zamba2_1x4_b4": ("zamba2-2.7b", mesh14, 4, False, 16),
              "gemma3_2x2_b1": ("gemma3-12b", mesh, 1, False, 10),
              "gemma3_1x4_b4": ("gemma3-12b", mesh14, 4, False, 10),
              "gemma3_2x2_b1_int8": ("gemma3-12b", mesh, 1, True, 10)}

def slots_written(t):          # a slot of a (reps, B, W, ...) leaf holds a write
    return (t.float().abs().sum(dim=[d for d in range(t.ndim) if d != 2]) > 0).tolist()

for name, (arch, m, B, int8, prompt) in SLOT_CASES.items():
    cfg_c = scaled(get_smoke_config(arch), dtype="float32", opt_kv_int8=int8)
    sc = lm_specs(cfg_c)
    pc = materialize(sc, torch.Generator().manual_seed(19), "cpu")
    toks = batch_of(cfg_c, B, prompt + 4, 20)["tokens"]
    c1, _ = lm_prefill(cfg_c, pc, {"tokens": toks[:, :prompt]}, max_seq=24)
    step_c = make_decode_step(cfg_c)
    with use_mesh(m):
        pcs = device_put(pc, spec_shardings(sc, m))
        c2 = device_put(tree_map(torch.clone, c1, is_leaf=torch.is_tensor),
                        cache_shardings(c1, m, B))
    before = [placed_like(x) for x in tree_leaves(c2, is_leaf=torch.is_tensor)]
    line = {"logits_rel": 0.0, "finite": True, "tokens": [], "tokens_mesh": [],
            "margins": [], "logit_diffs": [], "greedy_exact": True}
    for i in range(prompt, prompt + 4):
        tok = toks[:, i:i + 1]
        _, t1, l1 = step_c(pc, c1, tok, i)
        with use_mesh(m):
            _, t2, l2 = step_c(pcs, c2, distribute(tok, NamedSharding(m, P("data" if B > 1 else None))), i)
        l2w, t2w = whole(l2), whole(t2)
        line["logits_rel"] = max(line["logits_rel"], float((l1 - l2w).abs().max() / l1.abs().max()))
        line["finite"] &= bool(torch.isfinite(l2w).all())
        line["greedy_exact"] &= torch.equal(t2w[:, 0].long(), torch.argmax(l2w, -1))
        top2 = l1.topk(2, dim=-1).values
        line["tokens"].append(t1[:, 0].tolist())
        line["tokens_mesh"].append(t2w[:, 0].tolist())
        line["margins"].append((top2[:, 0] - top2[:, 1]).tolist())
        line["logit_diffs"].append((l1 - l2w).abs().amax(-1).tolist())
    # each rank's slots of every KV leaf written where one device's are
    bad, attn = 0, []
    for (path, x1), x2 in zip(tree_flatten_with_path(c1, is_leaf=torch.is_tensor),
                              tree_leaves(c2, is_leaf=torch.is_tensor)):
        if path[-1] not in ("k", "v", "k_scale", "v_scale"):
            continue
        shape, offset = compute_local_shape_and_global_offset(x2.shape, x2.device_mesh,
                                                              x2.placements)
        want = x1[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        bad += int(slots_written(x2.to_local()) != slots_written(want))
        attn.append(placed_like(x2))
    t = torch.tensor([bad])
    dist.all_reduce(t)
    line.update(written_mismatches=int(t), kv_placements=attn, cache_rel=worst(c1, c2),
                kept=before == [placed_like(x) for x in tree_leaves(c2, is_leaf=torch.is_tensor)],
                pos_equal=all(torch.equal(a, whole(b)) for (p, a), b in zip(
                    tree_flatten_with_path(c1, is_leaf=torch.is_tensor),
                    tree_leaves(c2, is_leaf=torch.is_tensor)) if p[-1] == "pos"))
    results["slot_decode_" + name] = line

# greedy tokens of float32 logits split along the vocab, equal maxima on
# two vocab shards (and on one, and everywhere): rank 0 keeps the array
# for the test to hold to jnp.argmax
ties = np.random.default_rng(21).standard_normal((4, 64)).astype(np.float32)
ties[0, [40, 5]] = 9.0
ties[1, [33, 60]] = 9.0
ties[2, [63, 0, 31]] = 9.0
ties[3] = 1.0
argmax = {"logits": ties.tolist(),
          "plain": _greedy_token(torch.from_numpy(ties)).tolist(),
          "torch": torch.argmax(torch.from_numpy(ties), dim=-1).tolist()}
for m, spec in ((mesh, P("data", "model")), (mesh14, P(None, "model"))):
    with use_mesh(m):
        got = _greedy_token(distribute(torch.from_numpy(ties), NamedSharding(m, spec)))
    argmax["x".join(map(str, m.shape))] = {"tokens": whole(got).tolist(),
                                           "placements": placed_like(got)}
results["argmax_ties"] = argmax

# a sharded checkpoint for the elastic restore (qwen2.5's smoke config)
cfg_q = get_smoke_config("qwen2.5-32b")
sq = lm_specs(cfg_q)
pq = materialize(sq, torch.Generator().manual_seed(0), "cpu")
with use_mesh(mesh):
    ckpt.save(os.environ["CKPT_DIR"], 11, device_put(pq, spec_shardings(sq, mesh)))
dist.barrier()
if rank == 0:
    print("RESULT " + json.dumps(results), flush=True)
dist.destroy_process_group()
"""

WORLD2 = PRELUDE + r"""
mesh = make_host_mesh(1, 2, device="cpu")
cfg_q = get_smoke_config("qwen2.5-32b")
sq = lm_specs(cfg_q)
pq = materialize(sq, torch.Generator().manual_seed(0), "cpu")
from repro_torch.sharding.api import spec_shapes
out, step, _ = ckpt.restore(os.environ["CKPT_DIR"], spec_shapes(sq),
                            shardings=spec_shardings(sq, mesh), device="cpu")
results["elastic_step"] = step
results["elastic_mesh"] = list(tree_leaves(out)[0].device_mesh.shape)
results["elastic_equal"] = all(torch.equal(a, whole(b)) for a, b in zip(tree_leaves(pq), tree_leaves(out)))
one, _, _ = ckpt.restore(os.environ["CKPT_DIR"], spec_shapes(sq), device="cpu")
results["one_device_equal"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(pq), tree_leaves(one)))
# a file the reference wrote, placed on the mesh
ref_dir = os.environ["REF_DIR"]
got, rstep, _ = ckpt.restore(ref_dir, spec_shapes(sq), shardings=spec_shardings(sq, mesh),
                             device="cpu")
want = np.load(os.path.join(ref_dir, "leaves.npz"))
results["reference_step"] = rstep
results["reference_equal"] = all(
    np.array_equal(whole(g).numpy(), want[f"a{i}"]) for i, g in enumerate(tree_leaves(got)))
results["reference_is_dtensor"] = all(hasattr(g, "full_tensor") for g in tree_leaves(got))
dist.barrier()
if rank == 0:
    print("RESULT " + json.dumps(results), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(code: str, n: int, extra_env: dict) -> dict:
    """Run ``code`` as ``n`` gloo ranks, each in its own process; return
    rank 0's ``RESULT`` object. Every rank is killed at the deadline."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               OMP_NUM_THREADS="1", **extra_env)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    line = [l for l in outs[0][1].splitlines() if l.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import lm_specs as ref_specs
    from repro.sharding.api import materialize as ref_materialize
    from repro.train import checkpoint as ref_ckpt

    d = tmp_path_factory.mktemp("dist")
    ref_dir = d / "ref"
    params = ref_materialize(ref_specs(ref_smoke("qwen2.5-32b")), jax.random.key(7))
    ref_ckpt.save(ref_dir, 5, params)
    np.savez(ref_dir / "leaves.npz", **{
        f"a{i}": np.asarray(a) for i, a in enumerate(jax.tree_util.tree_leaves(params))})
    env = {"CKPT_DIR": str(d / "ck"), "REF_DIR": str(ref_dir)}
    four = run_ranks(WORLD4, 4, env)
    two = run_ranks(WORLD2, 2, env)
    return four, two


def test_mesh_and_placements_follow_jax_major_to_minor(worlds):
    four, _ = worlds
    assert four["mesh"] == [["data", "model"], [2, 2]]
    assert four["placement_mismatches"] == 0


def test_sharded_train_step_matches_one_device(worlds):
    four, _ = worlds
    assert 0 < four["sharded_leaves"] <= four["leaves"]
    l1, l2 = four["train_loss"]
    assert abs(l1 - l2) <= 1e-5, (l1, l2)
    g1, g2 = four["train_gnorm"]
    assert abs(g1 - g2) <= 1e-5 * g1, (g1, g2)
    assert four["train_params_rel"] <= 1e-5
    assert four["train_m_rel"] <= 1e-5
    assert four["step_placements"] == ["R", "R"]


def test_fault_tolerant_training_restores_onto_the_mesh(worlds):
    got = worlds[0]["fault"]
    assert got["restarts"] == [0, 1]
    assert got["steps_run"] == [5, 6]          # step 2 replayed
    clean, faulty = got["losses"]
    assert [i for i, _ in faulty] == [0, 1, 2, 2, 3, 4]
    replay = dict(faulty[:3] + faulty[4:])
    assert dict(clean) == replay and faulty[3] == faulty[2]
    assert got["all_dtensor"]                  # the restored state too
    # rank 0 alone writes and prunes (an async write may land after the
    # prune, which then keeps one more)
    assert all(f[-1] == "0000000005.ckpt" and 2 <= len(f) <= 3
               for f in got["files"])
    assert got["final_equal"]


def test_launch_build_trains_on_the_mesh(worlds):
    four, _ = worlds
    assert four["build_mesh"] == [2, 2]
    l1, l2 = four["build_loss"]
    # bf16 activations: a sharded matmul sums in another order
    assert abs(l1 - l2) <= 1e-2 * abs(l1), (l1, l2)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "gemma3-12b",
                                  "xlstm-125m"])
def test_family_loss_over_dtensors_matches_one_device(worlds, arch):
    four, _ = worlds
    l1, l2, a1, a2 = four["loss_" + arch]
    assert abs(l1 - l2) <= 1e-5, (l1, l2)
    assert abs(a1 - a2) <= 1e-6, (a1, a2)


@pytest.mark.parametrize("name", ["granite", "seq_shard"])
def test_lever_and_dispatch_train_steps_match_one_device(worlds, name):
    """granite's MoE dispatch and combine on each rank's batch rows, and
    smollm with ``opt_seq_shard``: one float32 step on ``(2, 2)`` within
    1e-5 of one device, as the other sharded steps above."""
    got = worlds[0]["step_" + name]
    l1, l2 = got["loss"]
    assert abs(l1 - l2) <= 1e-5, (l1, l2)
    a1, a2 = got["aux"]
    assert abs(a1 - a2) <= 1e-6, (a1, a2)
    g1, g2 = got["gnorm"]
    assert abs(g1 - g2) <= 1e-5 * g1, (g1, g2)
    assert got["params_rel"] <= 1e-5 and got["m_rel"] <= 1e-5, got


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-12b", "qwen2.5-32b",
                                  "mixtral-8x7b", "chameleon-34b",
                                  "internlm2-20b", "xlstm-125m", "zamba2-2.7b",
                                  "whisper-tiny", "granite-moe-1b-a400m"])
def test_family_gradients_over_dtensors_match_one_device(worlds, arch):
    """Every leaf of the float32 loss gradient on ``(2, 2)`` within 1e-4
    of its largest one-device entry (zamba2 1e-3: its chunked Mamba2 is
    ill-conditioned in float32), the bounds of ``test_torch_train.py``'s
    parity with the reference. MoE expert weights are partial sums over
    the batch split (they were not: 0.56-0.94 off). zamba2 runs in
    float64: its Mamba2 mixers split over their heads reduce over
    "model", whose float32 rounding its float32 gradient amplifies past
    1e-3 (WORLD4's note)."""
    got = worlds[0]["grad_rel"][arch]
    assert got <= (1e-3 if arch == "zamba2-2.7b" else 1e-4), got


def test_embedding_gradient_under_vocab_shards_matches_one_device(worlds):
    got = worlds[0]["embed_grad"]
    assert got["placements"] == got["grad_placements"] == ["R", "S(0)"]
    l1, l2 = got["loss"]
    assert abs(l1 - l2) <= 1e-5, (l1, l2)
    assert got["rows_touched"] > 0
    assert got["rel"] <= 1e-5, got


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-12b"])
def test_decode_over_slot_sharded_caches_matches_one_device(worlds, arch):
    got = worlds[0]["decode_" + arch]
    assert got["k_placements"] == ["S(1)", "S(2)"]
    # every decoded token's slot written on the rank that holds it, none
    # beyond (DTensor alone writes a slot of a sharded dim into a gathered
    # copy and drops it)
    assert all(got["written"]) and all(got["empty"])
    # the caches are bf16: a k/v that the sharded projection sums in
    # another order can round to the neighbouring bf16 value (2**-8 to
    # 2**-7 apart, relative), and a later layer's k/v comes from inputs
    # that already differ: measured 5.4e-3 (smollm, 3 layers) and 1.6e-2
    # (gemma3, 6) on the caches, 1.3e-2 and 1.5e-2 on the logits (9.3e-3
    # and 1.5e-2 when the softmax gathered the slots). A lost write
    # leaves a zero slot (checked exactly above).
    assert got["cache_rel"] <= 4 * 2.0 ** -7
    assert got["logits_rel"] <= 4e-2


@pytest.mark.parametrize("prompt", [24, 10])
def test_ring_prefill_into_slot_sharded_caches_matches_one_device(worlds, prompt):
    got = worlds[0][f"ring_prefill_{prompt}"]
    W = got["window"]
    assert prompt > W if prompt == 24 else prompt < W
    assert got["k_placements"] == ["S(1)", "S(2)"]
    # each rank's own slots written exactly where the plain ring's are,
    # and the whole ring: every slot past a wrap, the first `prompt` else
    assert got["written_mismatches"] == 0
    assert got["written"] == [i < prompt for i in range(W)]
    want_pos = [-1] * W
    for p in range(max(0, prompt - W), prompt):
        want_pos[p % W] = p
    assert got["pos"] == got["pos_plain"] == want_pos
    # bf16 caches: the bound of the slot-sharded decode test above
    assert got["kv_rel"] <= 4 * 2.0 ** -7


@pytest.mark.parametrize("arch", ["chameleon-34b", "mixtral-8x7b",
                                  "zamba2-2.7b"])
def test_split_query_heads_expert_dff_and_ssd_heads_match_one_device(
        worlds, arch):
    """On ``(1, 4)``: chameleon's 4 query heads split 1 a rank over its 2
    whole KV heads (k's and v's gradients partial sums over "model"),
    mixtral's d_ff split where its 6 experts do not divide 4, zamba2's 8
    SSD heads 2 a rank. The float32 loss within 1e-5 and every gradient
    leaf within 1e-4 (zamba2 1e-3) of one device, the bounds above."""
    four, _ = worlds
    assert four["mesh14"] == [1, 4]
    got = four["split_1x4"][arch]
    l1, l2 = got["loss"]
    assert abs(l1 - l2) <= 1e-5, (l1, l2)
    assert got["grad_rel"] <= (1e-3 if arch == "zamba2-2.7b" else 1e-4), got


def test_zamba2_prefill_and_decode_keep_the_heads_split(worlds):
    """zamba2 on ``(1, 4)``: the prefill gives each Mamba2 state ``s``
    split on its heads and ``conv`` on its channels, the placements
    ``cache_shardings`` gives them (nothing to move), and 4 decode steps
    over caches so placed keep every leaf's placements. The prefill's
    float32 logits within zamba2's 1e-3 of one device; the decode's and
    the caches within the slot-sharded decode test's bounds (the shared
    attention block's caches are bf16)."""
    got = worlds[0]["zamba2_decode_1x4"]
    assert got["mamba_leaves"] == 10 and all(got["state_placed"]), got
    assert got["conv_s_placements"] == [["R", "S(3)"], ["R", "S(2)"]]
    assert got["kept"]
    assert got["prefill_rel"] <= 1e-3, got
    assert got["cache_rel"] <= 4 * 2.0 ** -7, got
    assert got["logits_rel"] <= 4e-2, got


SLOT_CASES = ["zamba2_2x2_b1", "zamba2_1x4_b4", "gemma3_2x2_b1",
              "gemma3_1x4_b4", "gemma3_2x2_b1_int8"]


@pytest.mark.parametrize("case", SLOT_CASES)
def test_decode_over_slot_split_caches_keeps_slots_and_heads_split(worlds,
                                                                   case):
    """A float32 smoke config prefilled on one device, its caches placed
    by ``cache_shardings``, then 4 steps of ``make_decode_step``: batch 1
    on ``(2, 2)`` (the slots on "data", the KV heads on "model": the
    ``long_500k`` layout) and batch 4 on ``(1, 4)`` (the slots on
    "model", which splits the query heads too: ``decode_32k``); zamba2's
    shared attention, gemma3's rings and global layer, one int8 cache.
    Every KV leaf keeps its placements, each rank's slots are written
    where one device's are and ``pos`` is equal. The bounds of the
    slot-sharded decode test above: caches within ``4 * 2**-7`` and
    logits within 4e-2 of one device; measured 5.5e-4 / 3.1e-6 / 1.2e-2
    / 2.0e-2 / 2.4e-2 (int8: three int8 steps in 127) on the caches and
    2.9e-3 / 2.5e-3 / 1.2e-2 / 1.9e-2 / 1.1e-2 on the logits, in the
    order of ``SLOT_CASES``. The greedy token is the argmax of the mesh's
    own logits exactly, and one device's wherever one device's top-two
    margin is more than twice the row's largest logit difference (a
    rounding cannot flip it); gemma3 on ``(1, 4)`` flips one near tie
    (margin 2.5e-4)."""
    got = worlds[0]["slot_decode_" + case]
    want = ["S(2)", "S(3)"] if "_2x2_" in case else ["R", "S(2)"]
    assert got["kv_placements"] and all(p == want
                                        for p in got["kv_placements"])
    assert got["kept"] and got["pos_equal"]
    assert got["written_mismatches"] == 0
    assert got["finite"] and got["greedy_exact"]
    assert got["cache_rel"] <= 4 * 2.0 ** -7, got["cache_rel"]
    assert got["logits_rel"] <= 4e-2, got["logits_rel"]
    rows = zip(*(np.ravel(got[k]) for k in ("tokens", "tokens_mesh",
                                             "margins", "logit_diffs")))
    for t1, t2, margin, diff in rows:
        assert t1 == t2 or margin <= 2 * diff, (t1, t2, margin, diff)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_greedy_token_over_vocab_shards_takes_the_lowest_index(worlds, mesh):
    """Float32 logits split along the vocab over "model" (2 and 4
    shards), with equal maxima on two shards, on one shard and on every
    entry: the greedy token is ``jnp.argmax``'s on the same array, the
    lowest index, and the batch split stays; plain logits take
    ``torch.argmax``'s answer."""
    got = worlds[0]["argmax_ties"]
    logits = np.asarray(got["logits"], dtype=np.float32)
    want = np.asarray(jax.numpy.argmax(logits, axis=-1)).tolist()
    assert want == [5, 33, 0, 0]
    assert got[mesh]["tokens"] == want
    assert got[mesh]["placements"] == (["S(0)", "R"] if mesh == "2x2"
                                       else ["R", "R"])
    assert got["plain"] == got["torch"] == want


def test_token_pipeline_places_batches_over_the_mesh(worlds):
    seen = worlds[0]["token_pipeline"]
    assert len(seen) == 3
    for b in seen:
        assert b["tokens_equal"] and b["labels_equal"]
        assert b["tokens_placements"] == ["S(0)", "R"]
        assert b["tokens_local"] == [2, 8]
        assert b["labels_plain"]


def test_elastic_checkpoint_reshard(worlds):
    _, two = worlds
    assert two["elastic_step"] == 11
    assert two["elastic_mesh"] == [1, 2]
    assert two["elastic_equal"] and two["one_device_equal"]


def test_reference_checkpoint_restores_onto_a_mesh(worlds):
    _, two = worlds
    assert two["reference_step"] == 5
    assert two["reference_equal"] and two["reference_is_dtensor"]

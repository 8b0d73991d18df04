"""The port's dry run (``repro_torch.launch.dryrun``) and its analysis
(``repro_torch.launch.hlo_analysis``) on fake process groups: nothing is
allocated, every tensor is a meta DTensor, and ``StepRecorder`` sees the
local program of rank 0.

- ``roofline_terms`` given the reference's v5e rates is the reference's.
- ``collective_bytes`` of known redistributions over 4 ranks of a
  ``(2, 4)`` world: output bytes per device, by kind.
- A smoke train cell's argument bytes are the local shard bytes that the
  reference's partition specs give; its FLOPs on a one-rank mesh are
  ``FlopCounterMode``'s count of the plain step, and a product sharded
  four ways counts a quarter of its global FLOPs.
- ``main`` writes the reference's JSON layout, ``.error.json`` for a cell
  that fails, and a skip record for a skipped cell; each of the
  reference's six ``--opt`` levers is accepted (repeated ``--opt``s too)
  and named in the record, a name the reference lacks refused.
- The levers move memory: ``seq_shard`` leaves the residual stream's
  block inputs split along the sequence at the peak, ``attn_remat`` one
  q-chunk of probabilities, ``chunk_remat`` lowers the peak.
- MoE dispatch and combine hold only the rank's batch rows, and a
  prefill's embedding lookup no whole table.
- A batch-1 decode over a cache split along its slots gathers neither
  the cache nor its scores, and its greedy token no logits.
- ``StepRecorder`` keeps what is live at the peak, collectives' outputs
  included; a sharded train cell's peak holds no logits whole along
  the vocab.
- ``sharding_of`` inverts ``NamedSharding.placements``.
- ``StepRecorder.repeat``: the sLSTM's time loop recorded one step deep
  counts the full loop's FLOPs, bytes, ops and collectives exactly, with
  a peak within one carry state, alone and in a smoke prefill cell."""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JaxAbstractMesh
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as jconfigs
import repro.launch.hlo_analysis as jhlo
import repro.models as jmodels
import repro.sharding.api as japi
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.models import lm_loss, lm_specs
from repro_torch.models.lm import padded_vocab
from repro_torch.sharding.api import NamedSharding, P, distribute, \
    gather_dim, reshape, sharding_of, spec_shapes, tree_leaves, tree_map, \
    use_mesh

SMOKE_TRAIN = ShapeConfig("train_4k", "train", 32, 8)
# the reference's src/repro/launch/dryrun.py:44 (importing that module
# sets XLA_FLAGS for 512 fake devices in this process)
JAX_FSDP_RULES = {**japi.DEFAULT_RULES, "embed": ("data",)}


@pytest.fixture
def world8():
    """A fake world of 8 ranks and its ``(2, 4)`` mesh."""
    with dryrun.fake_world(8):
        yield init_device_mesh("cuda", (2, 4),
                               mesh_dim_names=("data", "model"))
    assert not dist.is_initialized()


@pytest.mark.parametrize("terms", [(3.2e14, 1.1e12, 4.0e9),
                                   (1e9, 5e11, 7e11), (0.0, 0.0, 0.0)])
def test_roofline_terms_match_reference_given_its_rates(terms):
    got = hlo_analysis.roofline_terms(
        *terms, peak_flops=jhlo.PEAK_FLOPS, hbm_bw=jhlo.HBM_BW,
        link_bw=jhlo.ICI_BW)
    assert got == jhlo.roofline_terms(*terms)


def test_roofline_rates_are_the_h100s():
    assert (hlo_analysis.PEAK_FLOPS, hlo_analysis.HBM_BW,
            hlo_analysis.LINK_BW) == (989e12, 3.35e12, 450e9)
    t = hlo_analysis.roofline_terms(989e12, 0.0, 0.0)
    assert t["compute_s"] == 1.0 and t["dominant"] == "compute_s"


# (placements before, after, kind, output bytes per device) of an (8, 64)
# float32 DTensor, redistributed over the 4 ranks of the "model" axis
REDISTRIBUTIONS = {
    "gather": (Shard(0), Replicate(), "all-gather", 8 * 64 * 4),
    "reduce": (Partial(), Replicate(), "all-reduce", 8 * 64 * 4),
    "reduce_scatter": (Partial(), Shard(0), "reduce-scatter", 2 * 64 * 4),
    "all_to_all": (Shard(0), Shard(1), "all-to-all", 8 * 16 * 4),
}


@pytest.mark.parametrize("case", sorted(REDISTRIBUTIONS))
def test_collective_bytes_of_known_redistributions(world8, case):
    before, after, kind, nbytes = REDISTRIBUTIONS[case]
    local = torch.empty((2, 64) if before == Shard(0) else (8, 64),
                        device="meta")
    x = DTensor.from_local(local, world8, [Replicate(), before],
                           run_check=False, shape=torch.Size((8, 64)),
                           stride=(64, 1))
    rec = hlo_analysis.StepRecorder()
    with rec:
        y = x.redistribute(world8, [Replicate(), after])
    assert y.shape == (8, 64)
    got = hlo_analysis.collective_bytes(rec.collectives)
    want = {k: 0 for k in hlo_analysis.COLLECTIVE_OPS}
    want.update({kind: nbytes, "count": 1, "total": nbytes})
    assert got == want


def test_smoke_cell_argument_bytes_are_the_reference_shards(world8):
    cfg = get_smoke_config("smollm-135m")
    res = dryrun.analyse_cell("smollm-135m", "train_4k", multi_pod=False,
                              mesh=world8, config=cfg, shape=SMOKE_TRAIN)
    jmesh = JaxAbstractMesh((2, 4), ("data", "model"))
    jspecs = jmodels.lm_specs(jconfigs.get_smoke_config("smollm-135m"))
    pspecs = japi.spec_partition_specs(jspecs, jmesh, JAX_FSDP_RULES)
    import jax
    local = 0
    for s, p in zip(jax.tree_util.tree_leaves(
            jspecs, is_leaf=lambda x: isinstance(x, japi.ParamSpec)),
            jax.tree_util.tree_leaves(
                pspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        n = 1
        for d, entry in zip(s.shape, tuple(p) + (None,) * len(s.shape)):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= d // int(np.prod([jmesh.shape[a] for a in axes]))
        local += n * 4                       # float32
    B, S = SMOKE_TRAIN.global_batch // 2, SMOKE_TRAIN.seq_len
    want = 3 * local + 4 + 2 * B * S * 4     # params, m, v, step, batch
    assert res["memory"]["argument_bytes"] == want
    assert res["chips"] == 8 and res["mesh"] == "2x4"
    assert res["collectives"]["count"] > 0
    assert 0 < res["memory"]["temp_bytes"] and res["memory"]["fits"]
    assert res["cost"]["cost_source"] == "trace"


def test_flops_on_one_rank_are_the_plain_steps():
    """A one-rank mesh holds every tensor whole: the recorder's local
    FLOPs are ``FlopCounterMode``'s count of the plain step."""
    cfg = get_smoke_config("smollm-135m")
    with dryrun.fake_world(1):
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        res = dryrun.analyse_cell("smollm-135m", "train_4k",
                                  multi_pod=False, mesh=mesh, config=cfg,
                                  shape=SMOKE_TRAIN)
    params = spec_shapes(lm_specs(cfg), dtype_override="float32")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    B, S = SMOKE_TRAIN.global_batch, SMOKE_TRAIN.seq_len
    toks = torch.empty((B, S), dtype=torch.int32, device="meta")
    with FlopCounterMode(display=False) as fc:
        loss, _ = lm_loss(cfg, params, {"tokens": toks, "labels": toks})
        torch.autograd.grad(loss, tree_leaves(params))
    assert res["cost"]["flops_per_device"] == fc.get_total_flops() > 0
    assert res["collectives"]["total"] == 0


def test_flops_of_a_product_sharded_four_ways_are_a_quarter(world8):
    x = DTensor.from_local(torch.empty(64, 32, device="meta"), world8,
                           [Replicate(), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(32, 12, device="meta"), world8,
                           [Replicate(), Shard(1)], run_check=False,
                           shape=torch.Size((32, 48)), stride=(48, 1))
    rec = hlo_analysis.StepRecorder()
    with rec:
        y = x @ w
    with FlopCounterMode(display=False) as fc:   # above DTensor: global
        x @ w
    assert y.shape == (64, 48) and y.placements[1] == Shard(1)
    assert fc.get_total_flops() == 2 * 64 * 32 * 48
    assert rec.flops == fc.get_total_flops() // 4
    assert rec.collectives == []


def test_main_writes_records_errors_and_skips(tmp_path, monkeypatch):
    """``main`` over the production mesh of a fake 256-rank world, with
    smoke configs and shapes standing in for the full ones (the full
    ones are traced on the card's host: ``chip_smoke.py``)."""
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "SHAPES", {
        "train_4k": ShapeConfig("train_4k", "train", 16, 32),
        "decode_32k": ShapeConfig("decode_32k", "decode", 32, 32)})
    out = tmp_path / "dry"
    dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                 "--out", str(out)])
    rec = json.loads((out / "smollm-135m--train_4k--single.json").read_text())
    assert {"arch", "shape", "mesh", "chips", "fsdp", "n_params", "lower_s",
            "compile_s", "memory", "cost", "collectives",
            "model_flops_global", "model_flops_per_device",
            "useful_flops_ratio", "roofline", "opts"} <= set(rec)
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert set(rec["collectives"]) == set(jhlo.COLLECTIVE_OPS) | {
        "count", "total"}
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert not dist.is_initialized()

    def broken(*a, **k):
        raise RuntimeError("no sharding rule")
    monkeypatch.setattr(dryrun, "analyse_cell", broken)
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                 "--mesh", "multi", "--out", str(out)])
    err = json.loads((out / "smollm-135m--decode_32k--multi.error.json")
                     .read_text())
    assert err["error"] == "RuntimeError: no sharding rule"
    assert err["mesh"] == "multi" and "traceback" in err
    dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k",
                 "--out", str(out)])
    skip = json.loads((out / "smollm-135m--long_500k--single.json")
                      .read_text())
    assert "skipped" in skip
    assert not dist.is_initialized()


def test_recorder_keeps_what_is_live_at_the_peak():
    rec = hlo_analysis.StepRecorder()
    with rec:
        a = torch.zeros(256, device="meta")     # 1 KiB
        b = a * 2                               # 1 KiB: the peak, 2 KiB
        del a
        c = b[:128] + 1                         # 0.5 KiB, after a's free
    assert rec.peak_bytes == 2048 and rec.live_bytes == 1536
    at_peak = rec.peak_allocations
    assert [(e["shape"], e["bytes"], e["count"]) for e in at_peak] == [
        ([256], 1024, 1), ([256], 1024, 1)]
    assert "aten.mul.Tensor" in {e["op"] for e in at_peak}
    assert c.shape == (128,)


def test_collective_output_is_live_at_the_peak(world8):
    x = DTensor.from_local(torch.empty(2, 64, device="meta"), world8,
                           [Replicate(), Shard(0)], run_check=False,
                           shape=torch.Size((8, 64)), stride=(64, 1))
    rec = hlo_analysis.StepRecorder()
    with rec:
        y = x.redistribute(world8, [Replicate(), Replicate()])
    assert y.to_local().shape == (8, 64)
    assert rec.peak_bytes == 8 * 64 * 4         # counted once, not per wait
    assert rec.peak_allocations[0]["op"].startswith("_c10d_functional")


def test_sharded_train_cell_holds_no_whole_vocab_logits(world8):
    """The loss of logits split along the vocab reduces (B, S) partial
    results: no rank holds a row of logits whole along the vocab."""
    cfg = get_smoke_config("smollm-135m")
    res = dryrun.analyse_cell("smollm-135m", "train_4k", multi_pod=False,
                              mesh=world8, config=cfg, shape=SMOKE_TRAIN)
    at_peak = res["memory"]["temp_at_peak"]
    assert at_peak and sum(e["bytes"] for e in at_peak) <= \
        res["memory"]["temp_bytes"]
    assert all(e["shape"][-1:] != [padded_vocab(cfg)] for e in at_peak)
    assert any(e["shape"][-1:] == [padded_vocab(cfg) // 4] for e in at_peak)


def _smoke_main(monkeypatch):
    """``dryrun.main`` over smoke configs and a smoke ``train_4k``."""
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "SHAPES", {
        "train_4k": ShapeConfig("train_4k", "train", 16, 32)})


@pytest.mark.parametrize("lever", ["decode_carry", "seq_shard", "attn_remat",
                                   "chunk_remat"])
def test_levers_the_port_lacks_are_refused(tmp_path, monkeypatch, lever):
    """The four levers the port once refused are accepted now, each
    named in the record (``decode_carry`` changes nothing: the port's
    caches are written in place)."""
    with dryrun.fake_world(1):
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        _, _, cfg = dryrun.lower_cell(
            "smollm-135m", "train_4k", mesh, opts=(lever,),
            config=get_smoke_config("smollm-135m"), shape=SMOKE_TRAIN)
    assert getattr(cfg, f"opt_{lever}")
    _smoke_main(monkeypatch)
    out = tmp_path / "dry"
    dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                 "--opt", lever, "--out", str(out)])
    rec = json.loads((out / "smollm-135m--train_4k--single.json").read_text())
    assert rec["opts"] == [lever]
    assert rec["memory"]["temp_bytes"] > 0
    assert not dist.is_initialized()


def test_a_lever_the_reference_lacks_is_refused(tmp_path):
    with pytest.raises(ValueError, match="no_such_lever"):
        dryrun.lower_cell("smollm-135m", "train_4k", None,
                          opts=("seq_shard", "no_such_lever"))
    out = tmp_path / "dry"
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                     "--opt", "no_such_lever", "--out", str(out)])
    assert not out.exists()
    assert set(dryrun.PORT_LEVERS) == {
        "head_nofsdp", "decode_carry", "seq_shard", "attn_remat", "kv_int8",
        "chunk_remat"}


def test_repeated_opts_are_all_applied_and_named(tmp_path, monkeypatch):
    _smoke_main(monkeypatch)
    out = tmp_path / "dry"
    dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k", "--opt",
                 "seq_shard", "--opt", "attn_remat", "--out", str(out)])
    rec = json.loads((out / "smollm-135m--train_4k--single.json").read_text())
    assert rec["opts"] == ["seq_shard", "attn_remat"]
    assert not dist.is_initialized()


def test_port_levers_apply(world8):
    cfg = get_smoke_config("smollm-135m")
    shape = ShapeConfig("decode_32k", "decode", 32, 8)
    base, int8 = (dryrun.analyse_cell("smollm-135m", "decode_32k",
                                      multi_pod=False, mesh=world8,
                                      config=cfg, shape=shape, opts=o)
                  for o in ((), ("kv_int8",)))
    assert int8["memory"]["argument_bytes"] < base["memory"]["argument_bytes"]


class _AllShapes(hlo_analysis.StepRecorder):
    """A recorder that also counts every allocation's shape, and keeps
    the (op, shape, dtype) of each."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.shapes = {}
        self.made = set()

    def _alloc(self, func, t):
        self.shapes[tuple(t.shape)] = self.shapes.get(tuple(t.shape), 0) + 1
        self.made.add((str(func), tuple(t.shape), t.dtype))
        super()._alloc(func, t)


def _recorded(monkeypatch, mesh, arch, shape, opts=(), config=None):
    """A cell traced under ``_AllShapes``: its recorder and config."""
    monkeypatch.setattr(dryrun, "StepRecorder", _AllShapes)
    lowered, _, cfg = dryrun.lower_cell(
        arch, shape.name, mesh, opts=opts,
        config=config or get_smoke_config(arch), shape=shape)
    return lowered.compile().recorder, cfg


def _all_shapes(monkeypatch, mesh, arch, shape, opts=(), config=None):
    rec, cfg = _recorded(monkeypatch, mesh, arch, shape, opts, config)
    return rec.shapes, cfg


def test_moe_dispatch_holds_only_the_ranks_rows(world8, monkeypatch):
    """granite's smoke train cell on ``(2, 4)``: the dispatch buffer and
    the token copies of the combine are the rank's 4 batch rows of 8,
    never all of them (sizes chosen so that no two shapes coincide)."""
    from repro_torch.models.moe import capacity
    shape = ShapeConfig("train_4k", "train", 40, 8)
    seen, cfg = _all_shapes(monkeypatch, world8, "granite-moe-1b-a400m",
                            shape)
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    E, k, C = cfg.num_experts, cfg.top_k, capacity(cfg, shape.seq_len)
    b = B // 2                                   # the "data" split
    assert len({B * E * C, B * S * k, b * E * C, b * S * k, d}) == 5
    for whole in [(B * E * C, d), (B, E * C, d), (B, E, C, d),
                  (B * S * k, d), (B, S * k, d)]:
        assert whole not in seen, whole
    assert seen.get((b * E * C, d), 0) > 0       # the rank's buffer
    assert seen.get((b, S * k, d), 0) > 0        # its token copies


def test_query_heads_split_where_kv_heads_do_not_divide(world8,
                                                       monkeypatch):
    """chameleon's smoke train cell on ``(2, 4)``: its 2 KV heads do not
    divide "model", its 4 query heads do. No allocation holds the scores
    of all query heads, (b, 2, 2, S, S); each rank's are those of its
    one query head against the KV head it groups with, (b, 1, 1, S, S)."""
    shape = ShapeConfig("train_4k", "train", 40, 16)
    seen, cfg = _all_shapes(monkeypatch, world8, "chameleon-34b", shape)
    b, S = shape.global_batch // 2, shape.seq_len
    nkv, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    assert (nkv, g, cfg.num_heads % 4) == (2, 2, 0)
    assert (b, nkv, g, S, S) not in seen
    assert (2 * b, nkv, g, S, S) not in seen
    assert seen.get((b, 1, 1, S, S), 0) > 0


def test_expert_dff_split_where_experts_do_not_divide(world8, monkeypatch):
    """mixtral's smoke train cell with 6 experts on ``(2, 4)`` (the
    ``"expert_mlp"`` fallback): no expert hidden state holds the whole
    d_ff, (b, E, C, d_ff); each rank's holds its d_ff / 4."""
    from repro_torch.configs import scaled
    from repro_torch.models.moe import capacity
    cfg = scaled(get_smoke_config("mixtral-8x7b"), num_experts=6)
    shape = ShapeConfig("train_4k", "train", 24, 10)
    seen, cfg = _all_shapes(monkeypatch, world8, "mixtral-8x7b", shape,
                            config=cfg)
    b, E, C, f = (shape.global_batch // 2, cfg.num_experts,
                  capacity(cfg, shape.seq_len), cfg.d_ff)
    assert len({b, E, C, f, f // 4, cfg.d_model}) == 6
    for whole in [(b, E, C, f), (2 * b, E, C, f), (b * E * C, f)]:
        assert whole not in seen, whole
    assert seen.get((b, E, C, f // 4), 0) > 0


def test_mamba2_runs_split_over_its_heads(world8, monkeypatch):
    """zamba2's smoke cells on ``(2, 4)``, its 8 SSD heads 2 a rank: the
    train cell holds no chunk term of all heads, (b, Q, Q, H), only the
    rank's (b, Q, Q, H/4); the decode cell no state of all heads, (b, H,
    P, N), only the rank's (b, H/4, P, N)."""
    train = ShapeConfig("train_4k", "train", 32, 6)
    seen, cfg = _all_shapes(monkeypatch, world8, "zamba2-2.7b", train)
    b, Q = train.global_batch // 2, cfg.ssm_chunk
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    assert len({b, Q, H, H // 4}) == 4 and train.seq_len == 2 * Q
    assert (b, Q, Q, H) not in seen and (2 * b, Q, Q, H) not in seen
    assert seen.get((b, Q, Q, H // 4), 0) > 0
    decode = ShapeConfig("decode_32k", "decode", 48, 10)
    seen, _ = _all_shapes(monkeypatch, world8, "zamba2-2.7b", decode)
    b = decode.global_batch // 2
    assert len({b, H, H // 4, P}) == 4 and P == N
    assert (b, H, P, N) not in seen and (2 * b, H, P, N) not in seen
    assert seen.get((b, H // 4, P, N), 0) > 0


def _first_branch(q, k, v, mask, scale):
    """Decode attention as the port computed it over a cache split along
    its slots before: q, k and v gathered along their heads, then
    DTensor's own propagation of the plain products and softmax."""
    q, k, v = (gather_dim(t, 2) for t in (q, k, v))
    B, Sq, nq, hd = q.shape
    nkv = k.shape[2]
    qg = reshape(q, B, Sq, nkv, nq // nkv, hd).permute(0, 2, 3, 1, 4)
    s = torch.matmul(qg, k.permute(0, 2, 3, 1).unsqueeze(2)).float() * scale
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype,
                                          device=s.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(p, v.permute(0, 2, 1, 3).unsqueeze(2))
    return reshape(out.permute(0, 3, 1, 2, 4), B, Sq, nq, hd)


def test_slot_split_decode_gathers_no_cache_scores_or_logits(world8,
                                                             monkeypatch):
    """zamba2's smoke decode at batch 1 over 96 slots on ``(2, 4)`` (the
    ``long_500k`` layout: the slots on "data", 48 a rank, its 4 KV heads
    on "model"), greedy: the shared attention gathers no cache's heads
    or slots, (1, 48 or 96, 4, 16), and no float32 scores along the
    slots (last dim 96); the one all-gather is the greedy token's (max,
    index) pairs of the 4 vocab shards, never the (B, V) logits. Its
    collective bytes are below those of the route that gathered the
    heads and left the softmax to DTensor (the cache's heads and the
    scores gathered)."""
    from repro_torch.models import attention
    shape = ShapeConfig("long_500k", "decode", 96, 1)
    rec, cfg = _recorded(monkeypatch, world8, "zamba2-2.7b", shape)
    nkv, hd, V = cfg.num_kv_heads, cfg.resolved_head_dim, padded_vocab(cfg)
    assert len({48, 96, nkv, hd, V, V // 4, cfg.d_model}) == 7
    made = rec.made
    for slots in (48, 96):
        assert not any(s[1:] == (slots, nkv, hd) for _, s, _ in made)
    assert not any(s[1:2] == (96,) for _, s, _ in made)
    assert not any(s[-1:] == (96,) and dt == torch.float32
                   for _, s, dt in made)
    gathers = {(s, dt) for op, s, dt in made if "all_gather" in op}
    assert gathers == {((4, 2), torch.float64)}, gathers
    assert not any(s in ((1, V), (4, 1, V // 4)) for _, s, _ in made)
    new = hlo_analysis.collective_bytes(rec.collectives)["total"]
    monkeypatch.setattr(attention, "_slot_split", _first_branch)
    before, _ = _recorded(monkeypatch, world8, "zamba2-2.7b", shape)
    old = hlo_analysis.collective_bytes(before.collectives)["total"]
    assert any(s[1:] == (48, nkv, hd) for _, s, _ in before.made)
    assert 0 < new < old / 4, (new, old)


def test_prefill_cell_holds_no_whole_embedding_table(world8, monkeypatch):
    """The lookup of a prefill cell (DEFAULT_RULES: the table's vocab on
    "model") runs on the rank's vocab shard: no allocation holds the
    table whole, and the rows come back summed over "model"."""
    shape = ShapeConfig("prefill_32k", "prefill", 48, 8)
    seen, cfg = _all_shapes(monkeypatch, world8, "qwen2.5-32b", shape)
    vp, d = padded_vocab(cfg), cfg.d_model
    assert len({vp, vp // 2, shape.seq_len * shape.global_batch // 2,
                shape.seq_len * shape.global_batch}) == 4
    assert (vp, d) not in seen and (vp // 2, d) not in seen
    assert seen.get((shape.global_batch // 2, shape.seq_len, d), 0) > 0


def _peak(world8, arch, shape, opts=()):
    return dryrun.analyse_cell(arch, shape.name, multi_pod=False,
                               mesh=world8, config=get_smoke_config(arch),
                               shape=shape, opts=opts)


def _saved_by_forward(mesh, arch, shape, opts):
    """What is live once ``lm_loss``'s forward has run on a cell's
    arguments with grad enabled: what the backward will read."""
    lowered, _, cfg = dryrun.lower_cell(arch, shape.name, mesh, opts=opts,
                                        config=get_smoke_config(arch),
                                        shape=shape)
    params, _, batch = lowered.args
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    rec = hlo_analysis.StepRecorder(device_type="meta")
    with use_mesh(mesh), rec:
        loss, _ = lm_loss(cfg, live, batch)     # its graph holds them
    assert loss.requires_grad
    return rec.live_allocations, cfg


def test_seq_shard_splits_the_saved_block_inputs(world8):
    """smollm's smoke train cell (3 layers): after the forward, each
    layer's saved block input is the rank's (B/2, S/4, d) slice of the
    residual stream (split along the sequence over "model") instead of
    (B/2, S, d), and the step's peak is lower."""
    shape = ShapeConfig("train_4k", "train", 256, 8)

    def stream(saved, seq):
        return sum(e["count"] for e in saved
                   if e["shape"] == [4, seq, cfg.d_model]
                   and e["dtype"] == "bfloat16")
    base, cfg = _saved_by_forward(world8, "smollm-135m", shape, ())
    lever, _ = _saved_by_forward(world8, "smollm-135m", shape,
                                 ("seq_shard",))
    layers = cfg.num_layers
    assert stream(base, 64) == 0 and stream(base, 256) >= layers
    assert stream(lever, 64) == layers
    assert stream(lever, 256) == stream(base, 256) - layers
    peak = [_peak(world8, "smollm-135m", shape, o)["memory"]["temp_bytes"]
            for o in ((), ("seq_shard",))]
    assert peak[1] < peak[0]


def test_attn_remat_keeps_one_q_chunk_of_probabilities(world8):
    """smollm's smoke train cell at S 2048 (two q-chunks of 1024): under
    block remat the backward holds the softmax outputs of both chunks
    of a layer at the peak; with ``attn_remat`` one, and a lower peak."""
    shape = ShapeConfig("train_4k", "train", 2048, 4)

    def probs(rec):
        return sum(e["count"] for e in rec["memory"]["temp_at_peak"]
                   if e["op"] == "aten._softmax.default"
                   and e["shape"][-2:] == [1024, 2048])
    base = _peak(world8, "smollm-135m", shape)
    lever = _peak(world8, "smollm-135m", shape, ("attn_remat",))
    assert probs(base) == 2
    assert probs(lever) == 1
    assert lever["memory"]["temp_bytes"] < base["memory"]["temp_bytes"]


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_chunk_remat_lowers_the_peak(world8, arch):
    """The smoke train cell over 8 SSM chunks of 16: a chunk's
    intermediates are recomputed, not saved, in the backward."""
    shape = ShapeConfig("train_4k", "train", 128, 8)
    base = _peak(world8, arch, shape)
    lever = _peak(world8, arch, shape, ("chunk_remat",))
    assert lever["opts"] == ["chunk_remat"]
    assert lever["memory"]["temp_bytes"] < base["memory"]["temp_bytes"]
    for key in ("flops_per_device", "bytes_per_device"):   # recomputed
        assert lever["cost"][key] > base["cost"][key]


@pytest.mark.parametrize("spec", [P(), P("data"), P(None, "model"),
                                  P("model", "data"), P(("data", "model"))])
def test_sharding_of_inverts_named_sharding(world8, spec):
    want = NamedSharding(world8, spec)
    x = distribute(torch.empty(8, 16, device="meta"), want)
    assert sharding_of(x).placements == want.placements
    assert sharding_of(x).mesh is world8
    assert sharding_of(x.to_local()) is None


class _FullLoop(hlo_analysis.StepRecorder):
    """A recorder that offers no ``repeat``: time loops run every step."""
    repeat = None


def _slstm_recorded(recorder_cls, cfg, B, L):
    from repro_torch.models import ssm
    params = spec_shapes(ssm.slstm_specs(cfg))
    x = torch.empty((B, L, cfg.d_model), dtype=torch.bfloat16, device="meta")
    rec = recorder_cls(device_type="meta")
    with rec:
        out, st = ssm.slstm_train(params, cfg, x, return_state=True)
    assert out.shape == (B, L, cfg.d_model) and out.dtype == torch.bfloat16
    assert set(st) == {"c", "n", "h", "m"}
    return rec


def test_slstm_loop_recorded_once_counts_the_full_loop():
    cfg = get_smoke_config("xlstm-125m")
    B, L = 2, 16
    full = _slstm_recorded(_FullLoop, cfg, B, L)
    once = _slstm_recorded(hlo_analysis.StepRecorder, cfg, B, L)
    assert (full.repeated, once.repeated) == (0, 1)
    assert (once.flops, once.bytes, once.ops) == \
        (full.flops, full.bytes, full.ops)
    assert once.flops > 0
    assert hlo_analysis.collective_bytes(once.collectives) == \
        hlo_analysis.collective_bytes(full.collectives)
    carry = 4 * B * cfg.d_model * 4         # c, n, h, m in float32
    assert abs(once.peak_bytes - full.peak_bytes) <= carry
    # the output is live at the peak, whole
    assert once.peak_bytes >= B * L * cfg.d_model * 4


def test_repeat_counts_collectives_n_times_and_the_peak_once(world8):
    x = DTensor.from_local(torch.empty(2, 64, device="meta"), world8,
                           [Replicate(), Shard(0)], run_check=False,
                           shape=torch.Size((8, 64)), stride=(64, 1))
    one, three = hlo_analysis.StepRecorder(), hlo_analysis.StepRecorder()
    with one:
        x.redistribute(world8, [Replicate(), Replicate()]) * 2
    with three, three.repeat(3):
        x.redistribute(world8, [Replicate(), Replicate()]) * 2
    c1 = hlo_analysis.collective_bytes(one.collectives)
    c3 = hlo_analysis.collective_bytes(three.collectives)
    assert c1["count"] > 0 and c3 == {k: 3 * v for k, v in c1.items()}
    assert (three.flops, three.bytes, three.ops) == \
        (3 * one.flops, 3 * one.bytes, 3 * one.ops)
    assert three.peak_bytes == one.peak_bytes > 0
    assert three.repeated == 1 and three._times == 1


def test_xlstm_prefill_cell_traces_the_slstm_one_step_deep(world8,
                                                            monkeypatch):
    """The smoke xlstm prefill cell on a ``(2, 4)`` mesh: recorded one
    sLSTM step deep, its record equals the full loop's but for the peak
    (within one carry state a sLSTM layer) and the loops it names."""
    cfg = get_smoke_config("xlstm-125m")
    shape = ShapeConfig("prefill_32k", "prefill", 48, 4)
    once = dryrun.analyse_cell("xlstm-125m", "prefill_32k", multi_pod=False,
                               mesh=world8, config=cfg, shape=shape)
    monkeypatch.setattr(hlo_analysis.StepRecorder, "repeat", None)
    full = dryrun.analyse_cell("xlstm-125m", "prefill_32k", multi_pod=False,
                               mesh=world8, config=cfg, shape=shape)
    n_slstm = cfg.pattern_repeats
    assert once["cost"]["loops_recorded_once"] == n_slstm > 0
    assert full["cost"]["loops_recorded_once"] == 0
    for key in ("flops_per_device", "bytes_per_device"):
        assert once["cost"][key] == full["cost"][key] > 0
    assert once["collectives"] == full["collectives"]
    assert once["traced_ops"] == full["traced_ops"]
    carry = 4 * (shape.global_batch // 2) * cfg.d_model * 4
    assert abs(once["memory"]["temp_bytes"]
               - full["memory"]["temp_bytes"]) <= carry

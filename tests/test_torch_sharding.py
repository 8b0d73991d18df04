"""The mesh half of the port's sharding layer (``repro_torch.sharding``)
against the reference's (``repro.sharding``): partition specs of every
config's parameters under ``DEFAULT_RULES`` and the dry run's
``FSDP_RULES``, and of its decode caches, on the production meshes and on
small ones. Both sides resolve on an abstract mesh (axis names and
sizes, no devices): ``jax.sharding.AbstractMesh`` and the port's
``AbstractMesh``. Specs are compared entry for entry. Also: meta-tensor
shapes, the ``*rest`` trees of ``tree_map_specs``, and the mesh-free
identities of ``constrain`` and ``reshape``."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as JaxP

import repro.configs as jconfigs
import repro.models as jmodels
import repro.sharding.api as japi
import repro.sharding.caches as jcaches
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
import repro_torch.sharding as tsharding
import repro_torch.sharding.api as tapi
import repro_torch.sharding.caches as tcaches
from repro_torch.launch.dryrun import FSDP_RULES

# the reference's src/repro/launch/dryrun.py:44 (importing that module
# sets XLA_FLAGS for 512 fake devices in this process)
JAX_FSDP_RULES = {**japi.DEFAULT_RULES, "embed": ("data",)}

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x2": ((1, 2), ("data", "model")),
}


def _ref_specs(tree):
    return [tuple(p) for p in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JaxP))]


def _port_specs(tree):
    return [tuple(p) for p in tapi.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, tapi.PartitionSpec))]


def test_rules_and_exports_are_the_references():
    assert tapi.DEFAULT_RULES == japi.DEFAULT_RULES
    assert FSDP_RULES == JAX_FSDP_RULES
    import repro.sharding as jsharding
    assert set(jsharding.__all__) <= set(tsharding.__all__)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_partition_specs_match_reference(arch, mesh):
    sizes, names = MESHES[mesh]
    jm, tm = JaxAbstractMesh(sizes, names), tapi.AbstractMesh(sizes, names)
    jspecs = jmodels.lm_specs(jconfigs.get_config(arch))
    tspecs = tmodels.lm_specs(tconfigs.get_config(arch))
    for jrules, trules in ((japi.DEFAULT_RULES, tapi.DEFAULT_RULES),
                           (JAX_FSDP_RULES, FSDP_RULES)):
        want = _ref_specs(japi.spec_partition_specs(jspecs, jm, jrules))
        got = _port_specs(tapi.spec_partition_specs(tspecs, tm, trules))
        assert got == want


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_cache_partition_specs_match_reference(arch):
    """``decode_32k`` (B 128) and, where the config decodes 512k tokens,
    ``long_500k`` (B 1: the ``longseq`` branch), on both production
    meshes."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    shapes = ["decode_32k"] + (["long_500k"] if jcfg.supports_long_decode
                               else [])
    for name in shapes:
        shape = jconfigs.SHAPES[name]
        B, S = shape.global_batch, shape.seq_len
        jtree = jax.eval_shape(lambda: jmodels.init_caches(jcfg, B, S))
        ttree = tmodels.init_caches(tcfg, B, S, device="meta")
        for mesh in ("16x16", "2x16x16"):
            sizes, names = MESHES[mesh]
            want = _ref_specs(jcaches.cache_partition_specs(
                jtree, JaxAbstractMesh(sizes, names), B))
            got = _port_specs(tcaches.cache_partition_specs(
                ttree, tapi.AbstractMesh(sizes, names), B))
            assert got == want, (name, mesh)


def test_cache_shardings_carry_the_specs():
    cfg = tconfigs.get_smoke_config("zamba2-2.7b")
    caches = tmodels.init_caches(cfg, 4, 32, device="meta")
    mesh = tapi.AbstractMesh((2, 2), ("data", "model"))
    sh = tcaches.cache_shardings(caches, mesh, 4)
    specs = tcaches.cache_partition_specs(caches, mesh, 4)
    assert [s.spec for s in tapi.tree_leaves(sh)] == \
        tapi.tree_leaves(specs, is_leaf=lambda x: isinstance(
            x, tapi.PartitionSpec))
    assert all(s.mesh is mesh for s in tapi.tree_leaves(sh))


def test_partition_spec_strips_trailing_nones_and_falls_back():
    mesh = tapi.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert tapi.partition_spec(("batch", None, None), (64, 3, 5), mesh) == \
        tapi.P(("pod", "data"))
    # 40 heads do not divide by 16: the rules fall back to head_dim
    assert tapi.partition_spec(("embed", "heads", "head_dim"),
                               (512, 40, 128), mesh) == \
        tapi.P(None, None, "model")
    # a batch of 2 takes the largest single dp axis that divides it
    assert tapi.partition_spec(("batch",), (2,), mesh) == tapi.P("pod")
    assert repr(tapi.P("data", None)) == "P('data', None)"


def test_spec_shapes_are_meta_tensors_with_the_spec_dtype():
    specs = tmodels.lm_specs(tconfigs.get_smoke_config("smollm-135m"))
    jshapes = japi.spec_shapes(jmodels.lm_specs(
        jconfigs.get_smoke_config("smollm-135m")))
    shapes = tapi.spec_shapes(specs)
    leaves = tapi.tree_leaves(shapes)
    assert all(t.is_meta for t in leaves)
    assert [tuple(t.shape) for t in leaves] == \
        [s.shape for s in jax.tree_util.tree_leaves(jshapes)]
    assert [str(t.dtype).split(".")[1] for t in leaves] == \
        [str(s.dtype) for s in jax.tree_util.tree_leaves(jshapes)]
    for override in ("bfloat16", torch.bfloat16):
        over = tapi.tree_leaves(tapi.spec_shapes(specs, override))
        assert {t.dtype for t in over} == {torch.bfloat16}


def test_tree_map_specs_takes_rest_trees():
    specs = {"b": tapi.ParamSpec((2, 3), ("embed", "mlp")),
             "a": (tapi.ParamSpec((4,), ("vocab",)), {})}
    ones = {"b": 10, "a": (20, {})}
    twos = {"b": "x", "a": ("y", {})}
    out = tapi.tree_map_specs(lambda s, o, t: (s.shape, o, t), specs, ones,
                              twos)
    assert out == {"a": (((4,), 20, "y"), {}), "b": ((2, 3), 10, "x")}


def test_named_sharding_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = tapi.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    sh = tapi.NamedSharding(mesh, tapi.P(("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert tapi.NamedSharding(mesh, tapi.P()).placements == \
        (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        tapi.NamedSharding(mesh, tapi.P(("data", "pod"))).placements


def test_constrain_and_reshape_are_plain_without_a_mesh():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert tapi.constrain(x, "batch", None, "embed") is x
    with tapi.use_mesh(tapi.AbstractMesh((2, 2), ("data", "model"))):
        assert tapi.constrain(x, "batch", None, "embed") is x
    assert torch.equal(tapi.reshape(x, 2, 12), x.reshape(2, 12))
    assert tapi._current_mesh() is None


def test_device_put_leaves_none_shardings_alone():
    tree = {"a": torch.ones(2), "b": torch.zeros(3)}
    out = tapi.device_put(tree, {"a": None, "b": None})
    assert out["a"] is tree["a"] and out["b"] is tree["b"]

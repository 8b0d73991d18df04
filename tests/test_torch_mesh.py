"""The port's meshes (``repro_torch.launch.mesh``) against the
reference's (``repro.launch.mesh``): the production meshes' shapes and
axis names on fake worlds of 256 and 512 ranks, and the host mesh clamped
to the ranks that exist, as the reference's is to the devices that
exist. ``launch.train.build`` on a mesh that clamps to ``(1, 1)`` is the
one-device program, bit for bit. Each test destroys the process group it
starts."""
import jax
import pytest
import torch
import torch.distributed as dist

import repro.launch.mesh as jmesh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as launch
from repro_torch.sharding.api import tree_leaves


@pytest.fixture
def no_group():
    """Start without a default process group and leave none behind."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_host_mesh_clamps_to_one_rank(no_group):
    ref = jmesh.make_host_mesh(2, 2)            # one CPU device
    mesh = tmesh.make_host_mesh(2, 2, device="cpu")
    assert tuple(mesh.shape) == tuple(ref.shape.values()) == (1, 1)
    assert mesh.mesh_dim_names == tuple(ref.axis_names)
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    # a second call reuses the group
    assert tuple(tmesh.make_host_mesh(4, 1, device="cpu").shape) == (1, 1)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_world(no_group, multi_pod):
    ref = jax.sharding.AbstractMesh(
        (2, 16, 16) if multi_pod else (16, 16),
        ("pod", "data", "model") if multi_pod else ("data", "model"))
    with dryrun.fake_world(512 if multi_pod else 256):
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert tuple(mesh.shape) == tuple(ref.shape.values())
        assert mesh.mesh_dim_names == tuple(ref.axis_names)
        # a fake group holds no devices: the host mesh refuses it
        with pytest.raises(RuntimeError, match="fake"):
            tmesh.make_host_mesh(1, 1, device="cpu")
    assert not dist.is_initialized()


def test_production_mesh_needs_its_world(no_group):
    with pytest.raises(RuntimeError, match="256 ranks.*none is started"):
        tmesh.make_production_mesh()
    with dryrun.fake_world(8):
        with pytest.raises(RuntimeError, match="512 ranks.*it has 8"):
            tmesh.make_production_mesh(multi_pod=True)
        with pytest.raises(RuntimeError, match="already holds"):
            with dryrun.fake_world(8):
                pass


def test_build_on_a_mesh_that_clamps_to_one_rank_is_the_plain_step(no_group):
    args = ("smollm-135m", True, 4, 32, 10)
    cfg, p1, o1, s1, _ = launch.build(*args, device="cpu")
    _, p2, o2, s2, _ = launch.build(*args, data_axis=2, model_axis=2,
                                    device="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    toks = torch.randint(0, cfg.vocab_size, (4, 33),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    a, b = s1(p1, o1, batch), s2(p2, o2, batch)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert type(y) is torch.Tensor and torch.equal(x, y)

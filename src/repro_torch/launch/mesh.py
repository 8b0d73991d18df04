"""Production and host meshes: the port of ``src/repro/launch/mesh.py``.
Functions (not module constants) so importing this module never touches
``torch.distributed`` state.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group, one rank per device, with the reference's
axis names. ``torchrun --nproc-per-node N`` starts the group of a
multi-card run; ``make_host_mesh`` starts a one-rank group itself where
there is none.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


def _group_device_type() -> str:
    """The mesh's device type for the default group's backend: a fake
    group (``launch.dryrun``) holds meta tensors."""
    return {"nccl": "cuda", "fake": "cuda"}.get(dist.get_backend(), "cpu")


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single pod (256 ranks) or 2x16x16 (512 ranks, 2 pods) over the
    default process group, which must have that many ranks: ``torchrun``
    over 32 or 64 nodes of 8 cards, or ``launch.dryrun``'s fake world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != n:
        raise RuntimeError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a default "
            f"process group of {n} ranks (torchrun, or launch.dryrun's fake "
            f"world); {'none is started' if have is None else f'it has {have}'}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_group_device_type(), shape, mesh_dim_names=axes)


def _start_host_group(device: DeviceLike = None) -> None:
    """A one-rank default process group on this process's device where
    there is none: NCCL on the card, gloo on the CPU, over an in-memory
    store (no environment variables, no port)."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: DeviceLike = None):
    """Small ``("data", "model")`` mesh over the ranks that exist, clamped
    as the reference clamps it to the devices that exist: ``(1, 1)`` in a
    one-rank group. Starts that group (``_start_host_group(device)``)
    where there is none; runs on the card unless ``device`` says
    otherwise."""
    _start_host_group(device)
    if dist.get_backend() == "fake":
        raise RuntimeError("make_host_mesh: this process holds a fake "
                           "process group (launch.dryrun); a host mesh "
                           "needs real ranks")
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(1, n // data))
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_group_device_type(),
                      torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=("data", "model"))


__all__ = ["make_host_mesh", "make_production_mesh"]

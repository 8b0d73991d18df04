"""Atomic, async-capable checkpoints in the reference's file format.

Format (the same bytes as ``src/repro/train/checkpoint.py`` writes, so a
file restores in either package): one ``{step:010d}.ckpt`` file per
checkpoint — zstd-compressed msgpack of ``{"__step__", "__meta__",
"arrays": {key: {dtype, shape, data}}}``, keys being the tree paths
joined by ``/`` in sorted-key flatten order, ``data`` the raw C-order
bytes. Writes go to ``.tmp.{step}.ckpt`` and are renamed into place, so a
crash mid-write never corrupts the latest checkpoint.

A tree is nested dicts / tuples / lists of tensors or NumPy arrays
(``repro_torch.sharding.api`` flattens it as JAX does: dict keys sorted).
A DTensor leaf is saved whole (every rank gathers it; rank 0 of the
default process group writes the file), and ``restore(shardings=)``
places leaves on a mesh again, whatever mesh saved them.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import msgpack
import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sharding.api import NamedSharding, distribute, \
    is_dtensor, tree_flatten_with_path, tree_map

try:  # optional: fall back to uncompressed checkpoints when unavailable
    import zstandard
except ImportError:
    zstandard = None

_SEP = "/"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _flatten(tree) -> Dict[str, Any]:
    return {_SEP.join(str(p) for p in path): leaf
            for path, leaf in tree_flatten_with_path(tree)}


def _host_copy(leaf) -> np.ndarray:
    """A NumPy copy of a leaf that no later write to the leaf can reach
    (a DTensor's whole value)."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


def _writes_here() -> bool:
    """Rank 0 of the default process group, or a process without one."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.empty(0, np.dtype(leaf.dtype))).dtype


def save(path: os.PathLike, step: int, tree: Any,
         metadata: Optional[dict] = None, *,
         async_: bool = False) -> Optional[threading.Thread]:
    """Serialize ``tree`` to ``path/{step:010d}.ckpt``. Every leaf is
    copied to host memory before the (optional) writer thread starts, so
    the caller may go on changing its tensors; with ``async_`` the
    started thread is returned (join it before reading the file)."""
    path = Path(path)
    host = {k: _host_copy(v) for k, v in _flatten(tree).items()}
    if not _writes_here():
        return None
    path.mkdir(parents=True, exist_ok=True)

    def _write():
        payload = {
            "__step__": int(step),
            "__meta__": metadata or {},
            "arrays": {
                k: {"dtype": str(a.dtype), "shape": list(a.shape),
                    "data": a.tobytes()}
                for k, a in host.items()
            },
        }
        raw = msgpack.packb(payload, use_bin_type=True)
        comp = (zstandard.ZstdCompressor(level=3).compress(raw)
                if zstandard is not None else raw)
        tmp = path / f".tmp.{step}.ckpt"
        final = path / f"{step:010d}.ckpt"
        with open(tmp, "wb") as f:
            f.write(comp)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(path: os.PathLike) -> Optional[int]:
    path = Path(path)
    if not path.exists():
        return None
    steps = [int(p.stem) for p in path.glob("*.ckpt") if p.stem.isdigit()]
    return max(steps) if steps else None


def _row_blocks(a: np.ndarray, mesh, dtype: torch.dtype, key: str):
    """``a`` split by its leading rows into one block per mesh entry,
    block ``i`` a tensor on the mesh's device ``i``."""
    S = len(mesh.devices)
    if a.ndim == 0 or a.shape[0] % S:
        raise ValueError(f"{key}: cannot split shape {a.shape} by rows over "
                         f"{S} mesh entries")
    n = a.shape[0] // S
    return tuple(torch.from_numpy(a[i * n:(i + 1) * n].copy()).to(d, dtype)
                 for i, d in enumerate(mesh.devices))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore(path: os.PathLike, template: Any, *, step: Optional[int] = None,
            device: DeviceLike = None, shardings: Any = None):
    """Load into the structure of ``template`` (a tree of tensors or
    arrays: only their shapes and dtypes are read). Returns ``(tree,
    step, metadata)`` with every leaf a tensor of the template leaf's
    dtype on ``device``. Raises ``KeyError`` when the file lacks a key of
    the template and ``ValueError`` on a shape mismatch, as the reference
    does.

    ``shardings``: a tree matching ``template`` with, at each leaf,
    ``None``, a ``sharding.api.NamedSharding`` over a device mesh, or a
    camera mesh (``repro_torch.core.fleet.CameraMesh``: anything with
    ``.devices``). A leaf with a ``NamedSharding`` comes back as a DTensor
    with its placements (on the mesh's device type); a leaf with a camera
    mesh as the tuple of its leading-row blocks, block ``i`` on the mesh's
    device ``i``; a leaf with ``None`` whole on ``device``. The file holds
    global arrays, so any mesh restores it."""
    dev = resolve_device(device)
    path = Path(path)
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    raw = (path / f"{step:010d}.ckpt").read_bytes()
    if raw[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError(
                "checkpoint is zstd-compressed but zstandard is not installed")
        raw = zstandard.ZstdDecompressor().decompress(raw)
    payload = msgpack.unpackb(raw, raw=False)
    arrays = payload["arrays"]

    flat_template = _flatten(template)
    missing = set(flat_template) - set(arrays)
    if missing:
        raise KeyError(f"checkpoint missing {sorted(missing)[:5]}...")
    flat_shard = _flatten(shardings) if shardings is not None else {}
    leaves = []
    for k, t in flat_template.items():
        rec = arrays[k]
        a = np.frombuffer(rec["data"], dtype=rec["dtype"]).reshape(
            rec["shape"])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{k}: ckpt shape {a.shape} != template "
                             f"{tuple(t.shape)}")
        mesh = flat_shard.get(k)
        if isinstance(mesh, NamedSharding):
            leaves.append(distribute(torch.from_numpy(a.copy()).to(
                _mesh_device(mesh.mesh), _torch_dtype(t)), mesh))
        elif mesh is not None:
            leaves.append(_row_blocks(a, mesh, _torch_dtype(t), k))
        else:
            leaves.append(torch.from_numpy(a.copy()).to(dev, _torch_dtype(t)))
    it = iter(leaves)
    return (tree_map(lambda _: next(it), template), int(payload["__step__"]),
            payload["__meta__"])


def prune(path: os.PathLike, keep: int = 3) -> None:
    """Delete all but the latest ``keep`` checkpoints; in a process
    group, rank 0 alone, as it alone writes."""
    if not _writes_here():
        return
    path = Path(path)
    ckpts = sorted(p for p in path.glob("*.ckpt") if p.stem.isdigit())
    for p in ckpts[:-keep]:
        p.unlink()


__all__ = ["latest_step", "prune", "restore", "save"]

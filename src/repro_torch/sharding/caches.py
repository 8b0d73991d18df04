"""Partition-spec derivation for decode caches (shape-keyed, path-keyed):
the port of ``src/repro/sharding/caches.py``.

Caches are not ParamSpec trees (they are created by ``init_caches``), so
their logical axes are reconstructed from tree paths + ranks:

  k/v KV cache      (reps, B, W, n_kv, hd)
  pos               (reps, W)
  mamba2 s          (reps, B, H, P, N)
  mamba2 conv       (reps, B, 3, d_in)
  mlstm C           (reps, B, H, P, P) ; n (reps,B,H,P) ; m (reps,B,H)
  slstm c/n/h/m     (reps, B, d)
  cross_kv k/v      (layers, B, T, n_kv, hd)

A cache tree holds tensors (``init_caches(..., device="meta")`` gives one
that allocates nothing); its paths come from ``tree_flatten_with_path``.
"""
from __future__ import annotations

import torch

from repro_torch.sharding.api import NamedSharding, partition_spec, \
    tree_flatten_with_path, tree_unflatten


def _axes_for(path_keys, shape, batch_size):
    key = path_keys[-1] if path_keys else ""
    nd = len(shape)
    seq_axis = "longseq" if batch_size == 1 else "cache_seq"
    if key in ("k", "v") and nd == 5:
        return ("layers", "batch", seq_axis, "kv_heads", "head_dim")
    if key in ("k_scale", "v_scale") and nd == 4:
        return ("layers", "batch", seq_axis, "kv_heads")
    if key == "pos":
        return ("layers", None)
    if key == "s" and nd == 5:
        return ("layers", "batch", "heads", None, None)
    if key == "conv":
        return ("layers", "batch", None, "mlp")
    if key == "C" and nd == 5:
        return ("layers", "batch", "heads", None, None)
    if key in ("n", "m", "c", "h"):
        return ("layers", "batch") + (None,) * (nd - 2)
    return (None,) * nd


def _leaf_specs(cache_shapes, mesh, batch_size: int):
    return [partition_spec(_axes_for([str(k) for k in path], leaf.shape,
                                     batch_size), leaf.shape, mesh)
            for path, leaf in tree_flatten_with_path(cache_shapes,
                                                     is_leaf=torch.is_tensor)]


def cache_partition_specs(cache_shapes, mesh, batch_size: int):
    return tree_unflatten(cache_shapes,
                          _leaf_specs(cache_shapes, mesh, batch_size))


def cache_shardings(cache_shapes, mesh, batch_size: int):
    return tree_unflatten(cache_shapes, [
        NamedSharding(mesh, s)
        for s in _leaf_specs(cache_shapes, mesh, batch_size)])


__all__ = ["cache_partition_specs", "cache_shardings"]

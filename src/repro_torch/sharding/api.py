"""Parameter specs and their materialisation: the single-device subset
of ``src/repro/sharding/api.py`` that the model forward needs.

A parameter tree is nested dicts / tuples / lists with ``ParamSpec``
leaves; dict entries are visited in sorted key order, as JAX flattens
them. Meshes, logical-axis rules and ``partition_spec`` wait for fleet
sharding; ``constrain`` is the identity on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Metadata for a single parameter tensor."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis name per dim
    init: str = "normal"                  # normal | zeros | ones | small_normal
    dtype: str = "float32"
    scale: Optional[float] = None         # stddev override

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_leaves(tree, is_leaf: Callable = is_spec) -> List:
    """Leaves of a dict / tuple / list tree, dict keys in sorted order;
    ``None`` is an empty subtree."""
    if tree is None:
        return []
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


def tree_flatten_with_path(tree, is_leaf: Callable = is_spec,
                           prefix: Tuple = ()) -> List[Tuple[Tuple, object]]:
    """``(path, leaf)`` pairs in ``tree_leaves`` order; a path holds the
    dict keys and sequence indices from the root down, as JAX's
    ``tree_flatten_with_path`` gives them."""
    if tree is None:
        return []
    if is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_flatten_with_path(tree[k], is_leaf,
                                                prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree)
                for x in tree_flatten_with_path(t, is_leaf, prefix + (i,))]
    return [(prefix, tree)]


def tree_map(fn, tree, is_leaf: Callable = is_spec):
    """``fn`` applied to every leaf in ``tree_leaves`` order, keeping the
    nesting."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, is_leaf) for t in tree)
    return fn(tree)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s nesting holding ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def spec_leaves(tree):
    return tree_leaves(tree, is_spec)


def tree_map_specs(fn, tree):
    return tree_map(fn, tree, is_spec)


def num_params(spec_tree) -> int:
    return int(sum(np.prod(s.shape) for s in spec_leaves(spec_tree)))


DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16, "float16": torch.float16}


def _init_one(spec: ParamSpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """One leaf, by the reference's rules (``_init_one``); random draws
    are made on the generator's device and moved to ``device``."""
    dtype = DTYPES[spec.dtype]
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    gdev = generator.device
    if spec.init == "neg_ssm_a":
        # A_log init for SSM blocks: A = -exp(A_log) in [-16, -1)
        u = torch.rand(spec.shape, generator=generator, device=gdev)
        return torch.log(1.0 + 15.0 * u).to(device=device, dtype=dtype)
    fan_in = spec.shape[-1] if len(spec.shape) >= 2 else spec.shape[0]
    std = spec.scale if spec.scale is not None else \
        (1.0 / np.sqrt(max(1, fan_in)))
    if spec.init == "small_normal":
        std = 0.02
    x = torch.randn(spec.shape, generator=generator, device=gdev) * std
    return x.to(device=device, dtype=dtype)


def materialize(spec_tree, generator: torch.Generator,
                device: DeviceLike = None):
    """Instantiate a spec tree into tensors on ``device``, drawing every
    leaf in turn from ``generator``. A CPU generator gives the same
    weights on every device."""
    dev = resolve_device(device)
    return tree_map_specs(lambda s: _init_one(s, generator, dev), spec_tree)


def constrain(x, *axes, rules=None):
    """The reference's sharding constraint; the identity on one device."""
    return x


__all__ = ["DTYPES", "ParamSpec", "constrain", "is_spec", "materialize", "num_params",
           "spec_leaves", "tree_flatten_with_path", "tree_leaves", "tree_map",
           "tree_map_specs", "tree_unflatten"]

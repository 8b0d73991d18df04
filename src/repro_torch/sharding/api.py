"""Logical-axis sharding with divisibility-aware fallbacks, parameter
specs and their materialisation: the port of
``src/repro/sharding/api.py``.

Params and activations are annotated with *logical* axis names; a rules
table maps each logical name to an ordered list of physical mesh-axis
candidates. At spec-resolution time we pick, per tensor dimension, the
first candidate whose size divides the dimension and which is not
already used by another dimension of the same tensor. This is what lets
one rule set cover qwen2.5 (40 heads — not divisible by 16 → falls back
to sharding head_dim) and smollm (9 heads) alongside the cleanly
divisible archs.

On torch a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
the reference's axis names, one rank per device (SPMD), or an
``AbstractMesh`` (names and sizes, no devices) where only specs are
resolved. A ``NamedSharding`` turns a ``PartitionSpec`` into DTensor
placements; a parameter is a ``DTensor`` with those placements, and
DTensor's sharding propagation inserts the collectives, as GSPMD does.
``constrain`` is a ``redistribute`` under ``use_mesh`` and the identity
elsewhere.

A parameter tree is nested dicts / tuples / lists with ``ParamSpec``
leaves; dict entries are visited in sorted key order, as JAX flattens
them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

# Logical axis name -> ordered physical candidates. "data" expands to all
# pure-DP axes present in the mesh (pod + data).
DEFAULT_RULES: dict[str, Tuple[str, ...]] = {
    "batch": ("dp",),            # activation batch: pod+data combined
    "seq": (),                   # unsharded by default
    "longseq": ("dp", "model"),  # long-context KV/sequence sharding
    "cache_seq": ("model",),     # decode KV-cache sequence dim
    "vocab": ("model",),
    "embed": (),                 # d_model dim of params: replicated (TP = megatron)
    "fsdp_embed": ("data",),     # d_model dim, optimizer-state/fsdp sharding
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),      # used as fallback when heads don't divide
    "qkv": ("model",),           # fused q/k/v output dim
    "expert": ("model",),
    "expert_mlp": ("model",),    # fallback: shard inside-expert d_ff
    "layers": (),                # stacked-scan leading dim: never sharded
    "state": (),                 # SSM state dims
    "dconv": (),
    "table_d": (),               # embed/lm-head d_model dim: never sharded
    "seq_shard": ("model",),     # saved-activation sequence sharding (SP)
    # serve-plane camera lanes (repro.core.fleet): per-camera session
    # state is embarrassingly parallel, so the leading C dim shards over
    # a dedicated "camera" mesh axis, or rides a pure-DP axis when the
    # fleet shares a training mesh
    "camera": ("camera", "data", "dp"),
}


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


def _map_with_rest(fn, tree, rest, is_leaf):
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_with_rest(fn, tree[k], [r[k] for r in rest], is_leaf)
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_rest(fn, t, [r[i] for r in rest],
                                         is_leaf)
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_map_specs(fn, tree, *rest):
    """``fn(spec, *leaves)`` at every ``ParamSpec`` of ``tree``; each tree
    of ``rest`` has ``tree``'s nesting down to those leaves, as
    ``jax.tree_util.tree_map``'s extra trees have."""
    return _map_with_rest(fn, tree, rest, is_spec)


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


# ---------------------------------------------------------------------------
# Meshes, partition specs and shardings
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    names (major to minor), as ``jax.sharding.PartitionSpec`` holds."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P({', '.join(map(repr, self))})"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices (``jax.sharding.AbstractMesh``):
    enough to resolve specs for a mesh this process cannot build."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or an
    ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a mesh for logical-axis rules needs axis names")
    return dict(zip(names, mesh.shape))


def _dp_axes(mesh_axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_axes)


def resolve_axis(logical: Optional[str], dim: int, mesh,
                 used: set, rules=None):
    """Pick physical sharding (axis name, tuple of names, or None) for one dim."""
    if logical is None:
        return None
    rules = rules or DEFAULT_RULES
    shape = mesh_shape(mesh)
    candidates = rules.get(logical, ())
    for cand in candidates:
        if cand == "dp":
            axes = tuple(a for a in _dp_axes(tuple(shape)) if a not in used)
            if not axes:
                continue
            size = int(np.prod([shape[a] for a in axes]))
            if dim % size == 0:
                used.update(axes)
                return axes if len(axes) > 1 else axes[0]
            # try the largest single dp axis
            for a in axes:
                if dim % shape[a] == 0:
                    used.add(a)
                    return a
        else:
            if cand in shape and cand not in used and dim % shape[cand] == 0:
                used.add(cand)
                return cand
    return None


def partition_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                   mesh, rules=None) -> PartitionSpec:
    used: set = set()
    out = []
    for logical, dim in zip(axes, shape):
        out.append(resolve_axis(logical, dim, mesh, used, rules))
    # strip trailing Nones for tidiness
    while out and out[-1] is None:
        out.pop()
    return P(*out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` over a mesh. ``placements`` gives DTensor's
    ``Shard(d)``/``Replicate()`` for each mesh dim: a tensor dim split over
    ``("pod", "data")`` is ``Shard(d)`` on both mesh dims, which DTensor
    nests in mesh order, JAX's major-to-minor; an axis of size 1 is
    ``Replicate()``."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        sizes = mesh_shape(self.mesh)
        names = list(sizes)
        out = []
        for ax in names:
            dims = []
            for d, entry in enumerate(self.spec):
                group = entry if isinstance(entry, tuple) else (entry,)
                if ax in group:
                    order = [names.index(a) for a in group]
                    if order != sorted(order):
                        raise ValueError(
                            f"{self.spec}: axes {group} are not in mesh "
                            f"order {tuple(names)}")
                    dims.append(d)
            if len(dims) > 1:
                raise ValueError(f"{self.spec}: mesh axis {ax!r} used twice")
            # a split over one rank is no split (JAX's too)
            out.append(Shard(dims[0]) if dims and sizes[ax] > 1
                       else Replicate())
        return tuple(out)


def spec_partition_specs(spec_tree, mesh, rules=None):
    return tree_map_specs(
        lambda s: partition_spec(s.axes, s.shape, mesh, rules), spec_tree)


def spec_shardings(spec_tree, mesh, rules=None):
    return tree_map_specs(
        lambda s: NamedSharding(mesh, partition_spec(s.axes, s.shape, mesh,
                                                     rules)),
        spec_tree)


def _torch_dtype(dtype) -> torch.dtype:
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


def spec_shapes(spec_tree, dtype_override=None):
    """Meta tensors of each spec's shape and dtype (``dtype_override``, a
    name or a torch dtype, for every leaf if given): the torch form of
    ``jax.ShapeDtypeStruct``; they allocate nothing."""
    return tree_map_specs(
        lambda s: torch.empty(s.shape,
                              dtype=_torch_dtype(dtype_override or s.dtype),
                              device="meta"),
        spec_tree)


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _place(x: torch.Tensor, mesh, placements):
    """``x``, a whole tensor that every rank holds alike, as a DTensor:
    each rank keeps its own slice, with no communication (meta tensors
    too)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def sharding_of(x) -> Optional[NamedSharding]:
    """The ``NamedSharding`` that places the DTensor ``x`` (``None`` for
    a plain tensor): the inverse of ``NamedSharding.placements``."""
    if not is_dtensor(x):
        return None
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    entries = [[] for _ in range(x.ndim)]
    for ax, p in zip(mesh.mesh_dim_names, x.placements):
        if isinstance(p, Shard):
            entries[p.dim].append(ax)
        elif not p.is_replicate():
            raise ValueError(f"{p}: a partial value has no sharding")
    return NamedSharding(mesh, P(*(
        None if not e else e[0] if len(e) == 1 else tuple(e)
        for e in entries)))


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (alike on every rank) as a DTensor placed by ``sharding``."""
    return _place(x, sharding.mesh, sharding.placements)


def distribute_like(x: torch.Tensor, ref):
    """``x`` (alike on every rank) placed as the DTensor ``ref`` is."""
    return _place(x, ref.device_mesh, ref.placements)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous. DTensor wraps the
    gradient of a local tensor with the layout of the DTensor it came
    from (contiguous), whatever the local gradient's strides: a later
    view of it fails."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` whose gradient comes back contiguous (a local tensor taken
    from a DTensor)."""
    return _ContiguousGrad.apply(x) if x.requires_grad else x


def batch_local(fn, params, *args):
    """``fn(params, *args)`` on each rank's own batch rows, for code that
    DTensor cannot propagate (the recurrent mixers' loops and batched
    products over sharded heads, MoE's scatter and gather by computed
    rows). ``params`` are gathered whole (``None`` for none); every
    tensor in ``args`` and in ``fn``'s output is batch-leading and split
    over the mesh dims that split the first DTensor of ``args`` along
    its batch, whole over the others. The parameters' gradients are
    partial sums over those mesh dims. Plain tensors and no DTensor at
    all: ``fn(params, *args)``."""
    ref = next((t for t in tree_leaves(list(args), torch.is_tensor)
                if is_dtensor(t)), None)
    if ref is None:
        return fn(params, *args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = ref.device_mesh
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in ref.placements]
    whole_ = [Replicate()] * mesh.ndim
    grads = [Partial() if p == Shard(0) else Replicate() for p in rows]

    def local_param(t):
        if not is_dtensor(t):
            return t
        return contiguous_grad(t.redistribute(mesh, whole_).to_local(
            grad_placements=grads))

    def local_arg(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.redistribute(mesh, rows) if is_dtensor(t) else \
            _place(t, mesh, rows)
        return contiguous_grad(t.to_local())

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        return DTensor.from_local(t, mesh, rows, run_check=False)

    out = fn(tree_map(local_param, params, torch.is_tensor),
             *(tree_map(local_arg, a, torch.is_tensor) for a in args))
    return tree_map(wrap, out, torch.is_tensor)


def head_local(fn, dim: int, ref, args, ins, outs):
    """``fn(*args)`` on each rank's own batch rows (those of the mesh
    dims that split the DTensor ``ref`` along its batch) and, on mesh
    dim ``dim``, its own heads: what ``batch_local`` does without
    gathering what the heads split. ``ins`` and ``outs`` give each
    tensor of ``args`` and of ``fn``'s output tuple a ``(role, d)``:
    ``"heads"``, batch-leading and split along its dim ``d`` on ``dim``;
    ``"whole"``, batch-leading and whole on ``dim`` (its gradient a
    partial sum there); ``"weight"``, split along ``d`` on ``dim`` and
    whole over the batch split (its gradient a partial sum over it). A
    plain tensor in ``args`` (alike on every rank) is placed first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ref.device_mesh
    rows = [p == Shard(0) and i != dim for i, p in enumerate(ref.placements)]

    def place(role, d, grad=False):
        partial = Partial() if grad else Replicate()
        return [(partial if role == "whole" else Shard(d)) if i == dim
                else (partial if role == "weight" else Shard(0)) if r
                else Replicate() for i, r in enumerate(rows)]
    in_p = [place(*k) for k in ins]
    args = [t if is_dtensor(t) else _place(t, mesh, p)
            for t, p in zip(args, in_p)]
    return local_map(
        lambda *a: fn(*map(contiguous_grad, a)),
        out_placements=tuple(place(*k) for k in outs),
        in_placements=tuple(in_p),
        in_grad_placements=tuple(place(*k, grad=True) for k in ins),
        device_mesh=mesh, redistribute_inputs=True)(*args)


def _shard_window(dst: torch.Tensor, dim: int, src: torch.Tensor):
    """``(dst's local tensor, src's local tensor, lo, hi)`` for a write
    into the DTensor ``dst`` along ``dim``: ``src`` placed as ``dst`` is
    but whole along ``dim``, and ``[lo, hi)`` the slots of ``dim`` that
    this rank holds."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = dst.device_mesh
    want = [Replicate() if p == Shard(dim) else p for p in dst.placements]
    src = src.redistribute(mesh, want) if is_dtensor(src) else \
        _place(src, mesh, want)
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    return (dst.to_local(), src.to_local(), offset[dim],
            offset[dim] + shape[dim])


def write_slice(dst: torch.Tensor, dim: int, start: int,
                src: torch.Tensor) -> None:
    """``dst.narrow(dim, start, src.shape[dim]).copy_(src)``, in place, on
    a DTensor ``dst``: DTensor itself would write a slice of a sharded
    dim into a gathered copy and drop it; here each rank writes the rows
    of ``src`` that fall in its own shard."""
    n = src.shape[dim]
    dst_local, src_local, lo, hi = _shard_window(dst, dim, src)
    a, b = max(start, lo), min(start + n, hi)
    if a < b:
        dst_local.narrow(dim, a - lo, b - a).copy_(
            src_local.narrow(dim, a - start, b - a).to(dst.dtype))


def write_index(dst: torch.Tensor, dim: int, idx, src: torch.Tensor
                ) -> None:
    """``dst[(:,) * dim + (idx,)] = src``, in place, ``idx`` a slice of
    step 1 or a plain 1-D tensor of unique indices (which of two writes
    to one index wins is unspecified; a split ``dim`` asserts that there
    are none). A plain ``dst`` takes the plain
    ``__setitem__``. On a DTensor ``dst`` each rank writes what falls in
    its own shard of ``dim`` (DTensor has no rule for ``index_put_`` in
    some torch versions, and writes a sharded dim's slice into a gathered
    copy): a slice through ``write_slice``; the entries of ``idx`` in
    ``[lo, hi)`` at ``idx - lo``, from the rows of ``src`` at the same
    places. ``src`` is first placed as ``dst`` is, whole along ``dim``."""
    if not is_dtensor(dst):
        dst[(slice(None),) * dim + (idx,)] = src.to(dst.dtype)
        return
    if isinstance(idx, slice):
        assert idx.step in (None, 1), idx
        write_slice(dst, dim, idx.start or 0, src)
        return
    lead = (slice(None),) * dim
    dst_local, src_local, lo, hi = _shard_window(dst, dim, src)
    if not shards_dim(dst, dim):         # every rank holds every slot
        dst_local[lead + (idx,)] = src_local.to(dst.dtype)
        return
    assert idx.unique().numel() == idx.numel(), "repeated indices"
    mine = (idx >= lo) & (idx < hi)
    dst_local[lead + (idx[mine] - lo,)] = \
        src_local[lead + (mine,)].to(dst.dtype)


def all_reduce(t: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``t`` (a plain tensor: a rank's local values) reduced by ``op``
    (``"sum"``, ``"max"``, ...) over each process group of ``groups`` in
    turn, a functional collective waited on; ``t`` itself for none."""
    from torch.distributed import _functional_collectives as funcol
    for g in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of the process group ``group``, stacked along a
    new leading dim in the group's rank order."""
    from torch.distributed import _functional_collectives as funcol
    # all_gather_single in newer torch versions, all_gather_tensor before
    gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    return funcol.wait_tensor(gather(t, 0, group)).reshape(-1, *t.shape)


def gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with its shards along ``dim`` gathered (its other placements
    kept); a plain tensor as it is."""
    if not shards_dim(x, dim):
        return x
    from torch.distributed.tensor import Replicate, Shard
    return x.redistribute(x.device_mesh, [
        Replicate() if p == Shard(dim % x.ndim) else p
        for p in x.placements])


def shards_dim(x: torch.Tensor, dim: int) -> bool:
    """Whether ``x`` is a DTensor sharded along ``dim``."""
    if not is_dtensor(x):
        return False
    from torch.distributed.tensor import Shard
    return any(isinstance(p, Shard) and p.dim == dim % x.ndim
               for p in x.placements)


def device_put(tree, shardings):
    """The torch form of ``jax.device_put(tree, shardings)``: every leaf of
    ``tree`` distributed to the ``NamedSharding`` at its place in
    ``shardings`` (a leaf whose sharding is ``None`` stays as it is)."""
    return _map_with_rest(
        lambda x, sh: x if sh is None else distribute(x, sh), tree,
        [shardings], torch.is_tensor)


def _reshape_dtensor(x, shape):
    try:
        return x.reshape(shape)
    except RuntimeError:        # DTensor's view rule refused the split
        pass
    from torch.distributed.tensor import Replicate, Shard
    new = list(shape)
    if -1 in new:
        rest = int(np.prod([n for n in new if n != -1]))
        new[new.index(-1)] = x.numel() // max(1, rest)
    old = list(x.shape)
    lead = 0
    while lead < min(len(old), len(new)) and old[lead] == new[lead]:
        lead += 1
    tail = 0
    while (tail < min(len(old), len(new)) - lead
           and old[-1 - tail] == new[-1 - tail]):
        tail += 1
    changed = range(lead, len(old) - tail)
    placements = [Replicate() if isinstance(p, Shard) and p.dim in changed
                  else p for p in x.placements]
    return x.redistribute(x.device_mesh, placements).reshape(new)


class _DTensorReshape(torch.autograd.Function):
    """The reshape of ``reshape`` in the forward and its gradient's
    reshape back in the backward, each replicating first where it must."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _reshape_dtensor(grad, ctx.in_shape), None


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``. DTensor cannot split or merge a dim sharded
    unevenly for the new shape (GSPMD can): such a DTensor, or its
    gradient in the backward, is first replicated on the dims that the
    reshape changes (those outside the leading and trailing dims it
    keeps), then reshaped."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    return _DTensorReshape.apply(x, tuple(shape))


_MESHES: List = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh of ``constrain`` (the reference's
    ``jax.set_mesh``). Under a ``DeviceMesh`` a plain tensor that meets a
    DTensor counts as replicated (DTensor's implicit replication), as an
    unannotated array is under ``jit``: positions, masks and
    hyperparameter scalars made alike on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication
    _MESHES.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESHES.pop()


def _current_mesh():
    return _MESHES[-1] if _MESHES else None


def constrain(x, *axes, rules=None):
    """The reference's sharding constraint by logical axes: a DTensor is
    redistributed to the spec the rules give on the ambient mesh; the
    identity outside ``use_mesh`` and on a plain tensor."""
    mesh = _current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = partition_spec(axes, x.shape, mesh, rules)
    return x.redistribute(x.device_mesh, NamedSharding(mesh, spec).placements)


__all__ = ["AbstractMesh", "DEFAULT_RULES", "DTYPES", "NamedSharding", "P",
           "ParamSpec", "PartitionSpec", "all_gather", "all_reduce",
           "constrain", "device_put",
           "batch_local", "contiguous_grad", "distribute", "distribute_like",
           "head_local", "is_dtensor",
           "is_spec", "materialize", "mesh_shape",
           "num_params", "partition_spec", "reshape", "resolve_axis",
           "spec_leaves",
           "sharding_of", "shards_dim", "spec_partition_specs", "spec_shapes",
           "spec_shardings",
           "tree_flatten_with_path", "tree_leaves", "tree_map",
           "tree_map_specs", "tree_unflatten", "use_mesh", "write_index",
           "write_slice"]

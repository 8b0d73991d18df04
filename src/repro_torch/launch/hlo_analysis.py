"""The per-device program after partitioning: collective bytes, local
FLOPs, bytes and memory, and roofline terms — the port of
``src/repro/launch/hlo_analysis.py``.

Torch has no HLO text. On torch, the per-device program after
partitioning is what rank 0 issues when a step runs over DTensors: the
ops on its local shards and the functional collectives that DTensor's
sharding propagation inserts. ``StepRecorder`` sees exactly those: it
is a ``TorchDispatchMode`` that lets DTensor's own dispatch run first
(it returns ``NotImplemented`` for an op on DTensors), so every op it
records has local shapes, and every size here is bytes per device. The
roofline collective term is per_device_collective_bytes / link_bw —
algebraically identical to global_bytes / (chips * link_bw).

The rates are one NVIDIA H100 80GB HBM3's at its 700.00 W power limit
(NVIDIA's data sheet, SXM part, dense). The link rate is NVLink's within
one 8-GPU node; a 16-wide mesh axis spans two nodes, whose traffic also
crosses the slower network between them, so the collective term is a
lower bound.
"""
from __future__ import annotations

import contextlib
import heapq
import weakref
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

# NVIDIA H100 80GB HBM3, 700.00 W power limit (per card)
PEAK_FLOPS = 989e12          # bf16 FLOP/s, tensor cores, dense
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s, NVLink 4, per direction
DEVICE_BYTES = 80e9          # HBM capacity
PEAK_GROUPS = 12             # allocation groups kept at the peak

# DTensor's collectives: the functional ones, and its own shard-to-shard
# all-to-all (``_dtensor.shard_dim_alltoall``)
_FUNCTIONAL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
_COLLECTIVE_NAMESPACES = _FUNCTIONAL_NAMESPACES + ("_dtensor",)
_KINDS = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("permute", "collective-permute"),
          ("send", "collective-permute"), ("recv", "collective-permute"))


def collective_kind(op) -> Optional[str]:
    """The reference's ``COLLECTIVE_OPS`` name of a collective op
    (``None`` for any other op, ``wait_tensor`` included)."""
    if getattr(op, "namespace", None) not in _COLLECTIVE_NAMESPACES:
        return None
    name = op.name()
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Per-device bytes moved by each collective kind (output sizes), from
    ``(kind, output bytes)`` records such as ``StepRecorder.collectives``."""
    out = {op: 0 for op in COLLECTIVE_OPS}
    out["count"] = 0
    for kind, nbytes in records:
        out[kind] += int(nbytes)
        out["count"] += 1
    out["total"] = sum(out[op] for op in COLLECTIVE_OPS)
    return out


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float, *,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> Dict[str, float]:
    compute_s = flops_per_device / peak_flops
    memory_s = bytes_per_device / hbm_bw
    collective_s = coll_bytes_per_device / link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom
    terms["step_time_lower_bound_s"] = bound
    terms["roofline_fraction"] = compute_s / bound if bound > 0 else 0.0
    return terms


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _entries(groups) -> list:
    return [{"op": op, "shape": list(shape), "dtype": dtype, "count": c,
             "bytes": b} for (op, shape, dtype), c, b in groups]


class StepRecorder(TorchDispatchMode):
    """Records the local program of whatever runs under it:

    - ``collectives``: ``(kind, output bytes)`` of each collective;
    - ``flops``: FLOPs of the local shapes by ``torch.utils.flop_counter``'s
      formulas (matrix products, convolutions, attention; ``FlopCounterMode``
      above DTensor would count the global shapes);
    - ``bytes``: each op's local operand and output bytes, unfused (XLA's
      "bytes accessed" counts after fusion); views move nothing;
    - ``peak_bytes``: the peak of live bytes allocated by the ops it saw,
      collectives' outputs included, each output's storage followed
      through a weak reference until it is freed (meta tensors allocate
      nothing, so this is the count that a device would hold). A
      storage, not the tensor object: autograd keeps a saved output, and
      ``torch.utils.checkpoint`` what its recomputation saves, as another
      tensor on the same storage, and an op that returns its input's
      storage (``_unsafe_view``) allocates nothing;
    - ``peak_allocations``: what was live at that peak, grouped by the
      op, shape and dtype that made it, the ``PEAK_GROUPS`` largest.

    ``device_type``, if given, is the program's device: ops on tensors
    of another (DTensor's own bookkeeping of shard sizes runs on small
    CPU tensors) are not recorded.

    ``repeat(n)``: a context under which every op's FLOPs, bytes, op
    count and collective records count ``n`` times, for a loop whose
    iterations issue the same ops on the same shapes and that runs one
    of them (``models.ssm``'s time loop does so under a recorder, found
    as the current dispatch mode). Allocations and frees are followed
    once, so the peak is that of one iteration. ``repeated`` counts the
    loops recorded so."""

    def __init__(self, device_type: Optional[str] = None):
        super().__init__()
        self.device_type = device_type
        self.collectives = []
        self.flops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.ops = 0
        self.repeated = 0
        self._times = 1
        self._live = {}          # (op, shape, dtype) -> [count, bytes]
        self._storages = set()   # ids of the live storages followed
        self._kept = {}          # a collective's wrapper -> its inputs
        self._at_peak = []
        self._peak_unread = False

    def _snapshot(self) -> None:
        self._at_peak = heapq.nlargest(
            PEAK_GROUPS, ((k, c, b) for k, (c, b) in self._live.items()),
            key=lambda e: e[2])
        self._peak_unread = False

    def _alloc(self, func, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        if id(storage) in self._storages:  # a view that no schema names
            return
        n = storage.nbytes()
        key = (str(func), tuple(t.shape), str(t.dtype).replace("torch.", ""))
        entry = self._live.setdefault(key, [0, 0])
        entry[0] += 1
        entry[1] += n
        self.live_bytes += n
        self._storages.add(id(storage))
        weakref.finalize(storage, self._free, key, n, id(storage))

    def _free(self, key, n: int, storage_id: int) -> None:
        self._storages.discard(storage_id)
        if self._peak_unread:    # the first free after a new peak
            self._snapshot()
        self.live_bytes -= n
        entry = self._live[key]
        entry[0] -= 1
        entry[1] -= n
        if not entry[0]:
            del self._live[key]

    def _allocated(self, func, outs) -> None:
        for t in outs:
            self._alloc(func, t)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self._peak_unread = True

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside ``n`` times (see the class)."""
        outer = self._times
        self._times = outer * int(n)
        self.repeated += 1
        try:
            yield self
        finally:
            self._times = outer

    @property
    def peak_allocations(self) -> list:
        """``[{"op", "shape", "dtype", "count", "bytes"}, ...]`` live at
        the peak, largest first."""
        if self._peak_unread:    # nothing freed since: live is the peak
            self._snapshot()
        return _entries(self._at_peak)

    @property
    def live_allocations(self) -> list:
        """As ``peak_allocations``, for what is live now (all of it)."""
        return _entries(sorted(((k, c, b) for k, (c, b) in
                                self._live.items()), key=lambda e: -e[2]))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor desugars to local ops first
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        from torch._subclasses.fake_tensor import FakeTensor
        if any(isinstance(t, FakeTensor) for t in outs):
            return out                 # DTensor's global shape propagation
        if self.device_type is not None and any(
                t.device.type != self.device_type for t in outs):
            return out
        self.ops += self._times
        kind = collective_kind(func)
        if kind is not None:
            self.collectives += [(kind, sum(map(_nbytes, outs)))] * \
                self._times
            self._allocated(func, outs)
            return out
        if getattr(func, "namespace", None) in _FUNCTIONAL_NAMESPACES:
            # a wait or wrapper of a collective: on meta tensors its
            # output is another storage, and the collective's output
            # lives as long as that one does
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            for t in outs:
                self._kept[id(t)] = ins
                weakref.finalize(t.untyped_storage(), self._kept.pop, id(t),
                                 None)
            return out
        returns = func._schema.returns
        aliases = [r.alias_info for r in returns if r.alias_info is not None]
        if aliases and not any(a.is_write for a in aliases):
            return out                 # a view: no bytes, no allocation
        from torch.utils.flop_counter import flop_registry
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out)) * \
                self._times
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        self.bytes += (sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))) * \
            self._times
        if not aliases:                # fresh outputs: live until freed
            self._allocated(func, outs)
        return out


__all__ = ["COLLECTIVE_OPS", "DEVICE_BYTES", "HBM_BW", "LINK_BW",
           "PEAK_FLOPS", "StepRecorder", "collective_bytes",
           "collective_kind", "roofline_terms"]

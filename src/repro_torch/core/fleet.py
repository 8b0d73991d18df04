"""Fleet-scale sharded serving on PyTorch: the camera axis of a
ShedSession split over the entries of a camera mesh.

A ``SessionState`` is a set of per-camera lanes — ``(C, N)``
backgrounds, ``(C, W)`` CDF rings, ``(C, K)`` queue lanes, ``(C,)``
thresholds and EWMAs — and every hot-path operation (the fused ingest,
admission, CDF maintenance, queue selection, the Eq. 17–20 tick) is
row-local: camera ``c``'s outputs depend only on camera ``c``'s lanes.
So the serve plane splits over cameras: a ``CameraMesh`` of ``S``
devices gives shard ``i`` the rows ``[i*C/S, (i+1)*C/S)``, and each
shard runs the unsharded session's own cores (``_fused_ingest``,
``_control_core``, ``_tick_core``) on its rows, on its device, with no data
crossing between shards.

One process drives every shard, as the reference drives its whole mesh
from one program: a function here launches every shard's work before it
reads any shard's outputs, so shards on different devices overlap, then
brings each shard's compact outputs to the host once and lays them side
by side in camera order.

What is not row-local, and how it is kept exact:

* Eq. 19's target drop rate ``r = 1 - 1/(p * C * fps)`` counts every
  active camera of the fleet; each shard's core takes that global count
  as ``num_total``.
* The fused ingest's work plan, and so the grouping of each camera's
  gain sums, depends on the camera count of the call; each shard's call
  is planned for the whole array (``plan_cameras``), so its gains, and
  the foreground masks that follow from them, are the unsharded call's.
* The best ``k`` queued frames may all sit on one shard: each shard
  offers its own best ``min(k, C_local*K)`` candidates and the host
  merges them by (utility desc, camera asc, seq asc) — the order
  ``shed_queue.pop_topk_dev`` pops in — before each shard clears the
  slots it owns (``pop_topk``).
* The optional fleet aggregates (global offered/admitted/shed counts,
  queue depth, backend load, threshold stats) stand in for the
  reference's one ``psum``: each shard sums its own lanes on its device,
  and the host adds the shards' sums in shard order (integers exactly,
  float sums in float32).

So a sharded session's decisions, thresholds, queue lanes, pops and
checkpoints equal the unsharded session's bit for bit, for every ``S``
that divides ``C``. Checkpoints gather every lane into global ``(C,
...)`` arrays, and a restore splits them over whatever mesh the
restoring session holds.

Entry point: ``open_session(query, C, shard_cameras=True)`` or
``open_session(query, C, mesh=fleet_mesh(...))``; everything here is the
machinery behind it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import shed_queue as sq
from repro_torch.device import DeviceLike, resolve_device

AxisName = Union[str, Tuple[str, ...]]

CAMERA_AXIS = "camera"

# SessionState leaves WITHOUT a leading camera lane (every shard holds
# a copy).
_SCALAR_LEAVES = ("bg_valid",)


@dataclass(frozen=True)
class CameraMesh:
    """A one-axis mesh: an ordered tuple of devices, entry ``i`` holding
    shard ``i`` of the camera rows. A device may appear more than once
    (several shards on one card, or on the CPU)."""
    devices: Tuple[torch.device, ...]
    axis_name: str = CAMERA_AXIS

    def __post_init__(self) -> None:
        if not self.devices:
            raise ValueError("a camera mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_name: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def fleet_mesh(num_devices: Optional[int] = None,
               axis_name: str = CAMERA_AXIS, *,
               device: DeviceLike = None) -> CameraMesh:
    """A camera mesh of ``num_devices`` shards.

    Without ``device``: one shard on each of the first ``num_devices``
    (default: all) visible CUDA devices; asking for more than there are
    raises, and there is no CPU fallback. With ``device``: ``num_devices``
    (default 1) shards on that one device."""
    if device is not None:
        n = 1 if num_devices is None else int(num_devices)
        devices = (resolve_device(device),) * max(n, 0)
    else:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if avail == 0:
            raise RuntimeError(
                "fleet_mesh() spans the CUDA devices and none is available; "
                "pass device='cpu' for shards on the CPU")
        n = avail if num_devices is None else int(num_devices)
        if n > avail:
            raise ValueError(f"fleet_mesh({n}): only {avail} CUDA devices "
                             "are visible")
        devices = tuple(torch.device("cuda", i) for i in range(max(n, 0)))
    if len(devices) < 1:
        raise ValueError(f"a camera mesh needs >= 1 shard, got {n}")
    return CameraMesh(devices, axis_name)


def mesh_axis_size(mesh: CameraMesh, axis: AxisName) -> int:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return int(np.prod([mesh.shape[a] for a in axes]))


def camera_axis(mesh: CameraMesh, num_cameras: int) -> str:
    """The mesh axis carrying the camera rows. Raises when the mesh's
    shard count does not divide ``num_cameras``: camera sharding needs an
    even split (pad the session's camera count to a multiple of the mesh
    size; idle lanes are cheap)."""
    if int(num_cameras) % mesh.size:
        raise ValueError(
            f"cannot shard {num_cameras} cameras over mesh "
            f"{dict(mesh.shape)}: no axis divides the camera count "
            f"(pad num_cameras to a multiple of the mesh axis size)")
    return mesh.axis_name


def _rows(x, i: int, cl: int, dev: torch.device) -> torch.Tensor:
    """Camera rows ``[i*cl, (i+1)*cl)`` of ``x`` (a tensor or an array) on
    ``dev`` — a view when the tensor already lies there."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x[i * cl:(i + 1) * cl].to(dev)


def shard_state(state, mesh: CameraMesh):
    """Split a whole ``SessionState`` into the mesh's shards: a tuple of
    ``SessionState``s, shard ``i`` holding its rows of every camera lane
    (a copy, on its device) and its own copy of each scalar leaf."""
    camera_axis(mesh, state.num_cameras)
    cl = state.num_cameras // mesh.size
    shards = []
    for i, dev in enumerate(mesh.devices):
        leaves = {}
        for f in dataclasses.fields(state):
            x = getattr(state, f.name)
            if f.name not in _SCALAR_LEAVES:
                x = x[i * cl:(i + 1) * cl]
            leaves[f.name] = x.to(dev, copy=True)
        shards.append(type(state)(**leaves))
    return tuple(shards)


def gather_state(shards: Sequence[Any], device: DeviceLike = "cpu"):
    """The whole ``SessionState`` of a sharded one: every camera lane's
    shards concatenated in mesh order, on ``device`` (default: the host;
    ``.as_dict()`` gives the global NumPy lanes, the checkpoint form)."""
    dev = torch.device(device)
    first = shards[0]
    return type(first)(**{
        f.name: (getattr(first, f.name).to(dev, copy=True)
                 if f.name in _SCALAR_LEAVES
                 else torch.cat([getattr(s, f.name).to(dev) for s in shards]))
        for f in dataclasses.fields(first)})


# ---------------------------------------------------------------------------
# Fleet aggregates — per-shard sums, added on the host in shard order
# ---------------------------------------------------------------------------

_INT_AGGS = ("queue_depth", "cdf_fill", "threshold_finite")
_FLOAT_AGGS = ("proc_q_sum", "fps_obs_sum", "threshold_sum")
_DECISION_AGGS = ("offered", "admitted", "shed")


def _local_aggregates(state, decisions=None):
    """One shard's sums, on its device: (int64 (3 or 6,), float32 (3,)),
    in the order of ``_INT_AGGS`` (+ ``_DECISION_AGGS``) and
    ``_FLOAT_AGGS``."""
    from repro_torch.core.session import ADMIT
    finite = torch.isfinite(state.threshold)
    ints = [(state.q_seq >= 0).sum(), state.cdf_len.to(torch.int64).sum(),
            finite.sum()]
    if decisions is not None:
        ints += [(decisions >= 0).sum(), (decisions == ADMIT).sum(),
                 (decisions > ADMIT).sum()]
    floats = [state.proc_q.sum(), state.fps_obs.sum(),
              torch.where(finite, state.threshold, 0.0).sum()]
    return (torch.stack([x.to(torch.int64) for x in ints]),
            torch.stack([x.to(torch.float32) for x in floats]))


def _empty_aggregates(with_decisions: bool) -> Dict[str, Any]:
    names = _INT_AGGS + (_DECISION_AGGS if with_decisions else ())
    agg: Dict[str, Any] = {k: np.int64(0) for k in names}
    agg.update({k: np.float32(0.0) for k in _FLOAT_AGGS})
    return agg


def _combine_aggregates(parts) -> Dict[str, Any]:
    """Add the shards' host copies of ``_local_aggregates`` in shard order:
    integers exactly, float sums in float32."""
    agg = _empty_aggregates(parts[0][0].shape[0] > len(_INT_AGGS))
    for ints, floats in parts:
        for name, v in zip(_INT_AGGS + _DECISION_AGGS, ints.tolist()):
            agg[name] = np.int64(agg[name] + v)
        for name, v in zip(_FLOAT_AGGS, floats):
            agg[name] = np.float32(agg[name] + v)
    return agg


def derive_fleet_stats(agg: Dict[str, Any],
                       num_cameras: int) -> Dict[str, float]:
    """Host-side view of an aggregate tree: global rates and means."""
    a = {k: float(np.asarray(v)) for k, v in agg.items()}
    out = {
        "queue_depth": int(a["queue_depth"]),
        "cdf_fill": int(a["cdf_fill"]),
        "proc_q_mean": a["proc_q_sum"] / num_cameras,
        "fps_obs_mean": a["fps_obs_sum"] / num_cameras,
        "threshold_mean": (a["threshold_sum"] / a["threshold_finite"]
                           if a["threshold_finite"] else -np.inf),
    }
    if "offered" in a:
        out.update(
            offered=int(a["offered"]), admitted=int(a["admitted"]),
            shed=int(a["shed"]),
            shed_rate=(a["shed"] / a["offered"] if a["offered"] else 0.0))
    return out


# ---------------------------------------------------------------------------
# The sharded serve plane — the session's own cores, shard by shard
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def _run_shards(shards, mesh: CameraMesh, program, aggregate: bool,
                with_decisions: bool = True, read=_host):
    """Launch ``program(i, shard, device) -> (shard', outputs dict)`` on
    every shard, then bring each shard's outputs (and, with
    ``aggregate``, its sums) to the host once, each by ``read``, and
    concatenate them in camera order. Returns (shards', global outputs,
    aggregates | None)."""
    new, outs, sums = [], [], []
    for i, (st, dev) in enumerate(zip(shards, mesh.devices)):
        st, out = program(i, st, dev)
        new.append(st)
        outs.append(out)
        if aggregate:
            sums.append(_local_aggregates(
                st, out["decisions"] if with_decisions else None))
    host = [{k: read(v) for k, v in out.items()} for out in outs]
    merged = {k: np.concatenate([h[k] for h in host]) for k in host[0]}
    agg = (_combine_aggregates([(read(a), read(b)) for a, b in sums])
           if aggregate else None)
    return tuple(new), merged, agg


def control_step(shards, util, present=None, *, mesh: CameraMesh,
                 num_total: int, update_cdf: bool, do_tick: bool,
                 min_proc: float, budget: float, aggregate: bool = False,
                 tick_cfg=None, read=_host):
    """Sharded control step: CDF push -> admission -> queue selection ->
    (optional) tick, each shard running ``session._control_core`` on its
    rows of ``util`` (and ``present``, for a ragged batch), with Eq. 19's
    global camera count. Returns (shards', outputs as global NumPy
    arrays, aggregates or None); ``read`` brings a tensor to the host."""
    from repro_torch.core.session import DEFAULT_TICK_CONFIG, _control_core
    cl = shards[0].num_cameras
    cfg = tick_cfg if tick_cfg is not None else DEFAULT_TICK_CONFIG

    def program(i, st, dev):
        pres = None if present is None else _rows(present, i, cl, dev)
        return _control_core(
            st, _rows(util, i, cl, dev), pres, update_cdf=update_cdf,
            do_tick=do_tick, min_proc=min_proc, budget=budget,
            num_total=num_total, tick_cfg=cfg)

    return _run_shards(shards, mesh, program, aggregate, read=read)


def serve_step(shards, frames, M_pos, norm, *, mesh: CameraMesh,
               num_total: int, update_cdf: bool, do_tick: bool,
               min_proc: float, budget: float, aggregate: bool = False,
               tick_cfg=None, read=_host, **ingest_kw):
    """The sharded frames step: each shard's rows of the ``(C, T, N, 3)``
    batch go to its device (a view when they lie there already) through
    ONE fused ingest launch, planned for the whole array's camera count,
    then ``_control_core`` as in ``control_step``. Returns (shards',
    outputs as global NumPy arrays, aggregates or None); ``read`` brings
    a tensor to the host."""
    from repro_torch.core.session import (DEFAULT_TICK_CONFIG,
                                          _control_core, _fused_ingest)
    cl = shards[0].num_cameras
    C = cl * len(shards)
    cfg = tick_cfg if tick_cfg is not None else DEFAULT_TICK_CONFIG

    def program(i, st, dev):
        st, util, _ = _fused_ingest(
            st, _rows(frames, i, cl, dev), M_pos.to(dev), norm.to(dev),
            plan_cameras=C, **ingest_kw)
        return _control_core(
            st, util, update_cdf=update_cdf, do_tick=do_tick,
            min_proc=min_proc, budget=budget, num_total=num_total,
            tick_cfg=cfg)

    return _run_shards(shards, mesh, program, aggregate, read=read)


def tick(shards, *, mesh: CameraMesh, num_total: int, min_proc: float,
         budget: float, tick_cfg=None, aggregate: bool = False):
    """Sharded Eq. 18–20 tick (``session._tick_core`` on every shard, the
    rates from the global camera count). Returns (shards', rates (C,),
    resize evictions (C, K), aggregates or None)."""
    from repro_torch.core.session import DEFAULT_TICK_CONFIG, _tick_core
    cfg = tick_cfg if tick_cfg is not None else DEFAULT_TICK_CONFIG

    def program(i, st, dev):
        st, rates, resize_ev = _tick_core(st, min_proc, budget, num_total,
                                          cfg)
        return st, {"rates": rates, "resize_evicted": resize_ev}

    new, out, agg = _run_shards(shards, mesh, program, aggregate,
                                with_decisions=False)
    return new, out["rates"], out["resize_evicted"], agg


def pop_topk(shards, *, mesh: CameraMesh, k: int, rows=None, read=_host):
    """Pop the global best ``k`` queued frames of a sharded state — the
    frames, in the order, that ``shed_queue.pop_topk_dev`` pops from the
    whole lanes. Returns (shards', cams (k,), seqs (k,)) int32 NumPy
    arrays, -1 padded when the eligible queues drain.

    Each shard offers its first ``min(k, C_local*K)`` entries in pop order
    (``shed_queue.topk_candidates_dev``: a superset of its part of the
    global top ``k``) with global camera ids; the host merges them with
    one ``np.lexsort`` by (utility key, camera, seq) and each shard clears
    the popped slots it owns. ``rows``: optional global (C,) bool mask;
    ``read`` brings a tensor to the host."""
    cl, K = shards[0].q_util.shape
    k = int(k)
    kk = min(k, cl * K)
    cands = []
    for i, (st, dev) in enumerate(zip(shards, mesh.devices)):
        r = None if rows is None else _rows(rows, i, cl, dev).to(torch.bool)
        order, found, key = sq.topk_candidates_dev(st.q_util, st.q_seq, kk, r)
        seq = st.q_seq.reshape(-1)[order].to(torch.int64)
        cands.append(torch.stack([key, order, seq, found.to(torch.int64)]))
    key, order, seq, found = np.concatenate(
        [read(c) for c in cands], axis=1)
    shard = np.repeat(np.arange(len(shards)), kk)
    gcam = shard * cl + order // K
    live = np.flatnonzero(found)
    sel = live[np.lexsort((seq[live], gcam[live], key[live]))][:k]
    cams_out = np.full((k,), -1, np.int32)
    seqs_out = np.full((k,), -1, np.int32)
    cams_out[:sel.size] = gcam[sel]
    seqs_out[:sel.size] = seq[sel]
    new = list(shards)
    for i, (st, dev) in enumerate(zip(shards, mesh.devices)):
        mine = order[sel[shard[sel] == i]]
        if mine.size:
            q_util, q_seq = sq.clear_slots_dev(
                st.q_util, st.q_seq, torch.as_tensor(mine, device=dev))
            new[i] = dataclasses.replace(st, q_util=q_util, q_seq=q_seq)
    return tuple(new), cams_out, seqs_out


def aggregates(shards, *, mesh: CameraMesh,
               num_cameras: int) -> Dict[str, float]:
    """The fleet aggregates of a sharded state (no step's decisions)."""
    sums = [_local_aggregates(st) for st in shards]
    return derive_fleet_stats(
        _combine_aggregates([(_host(a), _host(b)) for a, b in sums]),
        num_cameras)


__all__ = [
    "CAMERA_AXIS", "CameraMesh", "aggregates", "camera_axis",
    "control_step", "derive_fleet_stats", "fleet_mesh", "gather_state",
    "mesh_axis_size", "pop_topk", "serve_step", "shard_state", "tick",
]

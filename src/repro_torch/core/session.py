"""Multi-camera shedding sessions on PyTorch: one query spec, one state of
per-camera tensor lanes, one fused ingest per camera batch.

``Query``
    Declarative query spec — target colors, OR/AND composition, E2E
    latency budget, per-camera target FPS, feature-bin and
    background-model constants.

``SessionState``
    The per-camera state as torch tensors with a leading camera lane:
    ``(C, N)`` background rows and ``(C,)`` illumination gains (the fused
    ingest kernel's carried state), per-camera utility-CDF ring buffers
    with their bucket counts and admission thresholds (Eq. 16–17), the
    control loop's EWMAs (Eq. 18–20) and the utility-ordered queues as
    fixed-capacity ``(C, K)`` utility/seq lanes. Its 23 leaves map one to
    one onto the JAX reference's ``SessionState``
    (``repro_torch.convert.state_from_numpy``).

``ShedSession``
    ``step`` is the serve loop: a ``(C, T, H, W, 3)`` camera batch goes
    through the fused CUDA ingest kernel, CDF maintenance, vectorized
    admission, queue selection and threshold re-derivation on the
    session's device without utilities leaving it — only compact
    ``(C, T)`` decision codes and evicted queue seqs come back.
    ``ingest``/``admit``/``tick`` are the split phases of the same
    machinery; ``offer``/``offer_batch`` admit pre-scored frames one at a
    time or coalesced; ``next_frame``/``next_frames`` are transmission
    control; ``lane``/``attach_camera``/``detach_camera`` map external
    camera ids onto lanes of a live session (camera churn) and
    ``set_rate_floor`` is the degraded-mode floor under Eq. 19;
    ``checkpoint``/``restore`` persist the state lanes, the trained model
    and the camera-id map in the reference's checkpoint format (a file
    restores in either package).

With ``cascade=Cascade(scorer, ...)`` (``repro_torch.cascade``) a frames
step is the two-stage shedder: the fused ingest also yields each frame's
foreground bbox, a stage-1 color gate keeps the frames above its
threshold, ONE batched scorer call scores the survivors' bbox crops, and
a stage-2 gate on those scores precedes queue insertion (queues then
ordered by the semantic score); the tick splits Eq. 19's rate between
the two gates.

The control plane is one torch implementation that runs on whichever
device the session has; on the CPU its results are bit-identical to the
reference's NumPy ``serve="host"`` twin (the tests hold it to that), and
on the card to this same code on the CPU. The reference's ``serve=``,
``impl=`` and ``interpret=`` keywords are accepted and change nothing
(there is one control plane, and the ingest kernel is chosen by the
device).

With ``mesh=`` (a ``fleet.CameraMesh``) or ``shard_cameras=True`` the
camera lanes are split over the mesh's shards (``repro_torch.core.fleet``):
``step``, ``offer_batch``, ``tick``, ``next_frame`` and ``next_frames``
run the same cores shard by shard with the global camera count, and give
the unsharded session's results bit for bit; ``fleet_aggregate=True``
adds the fleet's counts and means to every sharded step
(``last_fleet_stats``; ``fleet_stats()`` on demand). The rarer calls run
the unsharded code on the gathered state and split it again.

``open_session(query, num_cameras, ...)`` is the entry point.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import fleet as fl
from repro_torch.core import shed_queue as sq
from repro_torch.core.colors import COLORS, Color
from repro_torch.core.control import LatencyInputs
from repro_torch.core.frame_rows import FrameRows
from repro_torch.core.shedder import ShedderStats
from repro_torch.core.threshold import (
    bucket_index_dev,
    thresholds_from_counts_dev,
    thresholds_from_lanes_dev,
)
from repro_torch.core.utility import (
    B_S,
    B_V,
    UtilityModel,
    batch_utilities,
    train_utility_model,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.hsv_features.ops import (
    IngestState,
    ingest_core,
    ingest_pipeline,
    query_constants,
)
from repro_torch.metrics import MetricsRegistry

# decision codes — (C, T) int8 arrays, vectorized per camera
# (offer_batch marks padding slots that carried no frame with -1)
ADMIT = 0
SHED_ADMISSION = 1
SHED_QUEUE = 2
SHED_CASCADE = 3     # passed the color gate, shed by the stage-2 scorer

_DECISION_NAMES = {ADMIT: "queued", SHED_ADMISSION: "shed_admission",
                   SHED_QUEUE: "shed_queue", SHED_CASCADE: "shed_cascade"}



class TickConfig(NamedTuple):
    """Quantile-tick configuration.

    ``exact=True`` re-derives Eq. 17 thresholds with the full ``(C, W)``
    sort; ``exact=False`` (the default) uses the O(bins) cumsum over the
    incrementally maintained ``(C, bins)`` count histograms, whose
    threshold is within one bucket width above the exact one for
    in-range utilities. Counts are maintained either way. ``lo``/
    ``width``/``inv_width`` are the stage-1 utility buckets, ``s2_*`` the
    cascade scorer's.
    """
    exact: bool = False
    lo: float = 0.0
    width: float = 1.0 / 256.0
    inv_width: float = 256.0
    s2_lo: float = -1.0
    s2_width: float = 2.0 / 256.0
    s2_inv_width: float = 128.0


DEFAULT_TICK_CONFIG = TickConfig()


def _as_color(c: Union[str, Color]) -> Color:
    if isinstance(c, Color):
        return c
    return COLORS[str(c).lower()]


@dataclass(frozen=True)
class Query:
    """Declarative spec of what the camera array is watching for.

    ``colors`` compose with ``op`` (Eq. 15: OR -> max, AND -> min over
    normalized per-color utilities); ``latency_bound`` is the E2E
    budget driving dynamic queue sizing (Eq. 20); ``fps`` is the
    per-camera target ingress rate feeding the target drop rate
    (Eq. 19). The remaining fields are the feature/background constants
    of the ingest kernel.
    """
    colors: Tuple[Color, ...]
    op: str = "single"                  # single | or | and
    latency_bound: float = 1.0          # seconds, E2E
    fps: float = 10.0                   # per-camera target ingress FPS
    bs: int = B_S                       # saturation bins
    bv: int = B_V                       # value bins
    alpha: float = 0.05                 # background EMA learning rate
    threshold: float = 18.0             # foreground |diff| threshold
    use_foreground: bool = True

    def __post_init__(self) -> None:
        colors = tuple(_as_color(c) for c in (
            self.colors if isinstance(self.colors, (tuple, list))
            else (self.colors,)))
        object.__setattr__(self, "colors", colors)
        if self.op not in ("single", "or", "and"):
            raise ValueError(f"unknown composition op {self.op!r}")
        if self.op == "single" and len(colors) > 1:
            object.__setattr__(self, "op", "or")

    @classmethod
    def single(cls, color: Union[str, Color], **kw: Any) -> "Query":
        return cls(colors=(_as_color(color),), op="single", **kw)

    @classmethod
    def any_of(cls, *colors: Union[str, Color], **kw: Any) -> "Query":
        return cls(colors=tuple(_as_color(c) for c in colors), op="or", **kw)

    @classmethod
    def all_of(cls, *colors: Union[str, Color], **kw: Any) -> "Query":
        return cls(colors=tuple(_as_color(c) for c in colors), op="and", **kw)

    @property
    def hue_ranges(self) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
        return tuple(tuple(c.hue_ranges) for c in self.colors)

    @property
    def num_colors(self) -> int:
        return len(self.colors)


@dataclass
class SessionState:
    """Per-camera session state: every leaf is a tensor with a leading
    camera lane (row c belongs to camera c), all on one device.

      * ``bg (C, N)`` / ``gain (C,)`` — the fused ingest kernel's
        carried background state; ``bg_valid ()`` says whether the lanes
        hold real history yet (frame 0 seeds them otherwise).
      * ``cdf_buf (C, W)`` ring buffers of recent utilities with
        ``cdf_len`` / ``cdf_pos`` — the sliding-window utility CDF
        (Eq. 16) per camera; ``cdf_counts (C, B)`` is its bucket-count
        histogram, maintained incrementally with push/evict deltas.
      * ``threshold (C,)`` — current admission thresholds (Eq. 17).
      * ``proc_q (C,)`` (+ ``proc_seen``) — asymmetric-EWMA backend
        latency estimates; ``fps_obs (C,)`` (+ ``fps_seen``) — observed
        per-camera ingress rates (Eq. 18–19 inputs).
      * ``queue_cap (C,)`` — dynamic queue sizes (Eq. 20).
      * ``q_util`` / ``q_seq (C, K)`` + ``q_next_seq (C,)`` — the
        utility-ordered queues as array lanes (empty slots ``(-inf, -1)``).
      * ``active (C,)`` masks detached camera lanes (threshold +inf,
        excluded from Eq. 19) and ``rate_floor (C,)`` is the degraded-mode
        floor under every lane's target drop rate.
      * ``s2_buf (C, W2)`` / ``s2_len`` / ``s2_pos`` / ``s2_counts (C, B)``
        / ``s2_threshold (C,)`` — the semantic cascade's stage-2 score
        ring, bucket counts and shed thresholds, the same machinery as
        the stage-1 CDF over the scores of frames that passed the color
        gate; untouched by a session without ``cascade=``.
    """
    bg: torch.Tensor          # (C, N) float32
    gain: torch.Tensor        # (C,) float32
    bg_valid: torch.Tensor    # () bool
    cdf_buf: torch.Tensor     # (C, W) float32
    cdf_len: torch.Tensor     # (C,) int32
    cdf_pos: torch.Tensor     # (C,) int32
    cdf_counts: torch.Tensor  # (C, B) int32
    threshold: torch.Tensor   # (C,) float32
    proc_q: torch.Tensor      # (C,) float32
    proc_seen: torch.Tensor   # (C,) bool
    fps_obs: torch.Tensor     # (C,) float32
    fps_seen: torch.Tensor    # (C,) bool
    queue_cap: torch.Tensor   # (C,) int32
    q_util: torch.Tensor      # (C, K) float32
    q_seq: torch.Tensor       # (C, K) int32
    q_next_seq: torch.Tensor  # (C,) int32
    active: torch.Tensor      # (C,) bool
    rate_floor: torch.Tensor  # (C,) float32
    s2_buf: torch.Tensor      # (C, W2) float32
    s2_len: torch.Tensor      # (C,) int32
    s2_pos: torch.Tensor      # (C,) int32
    s2_threshold: torch.Tensor  # (C,) float32
    s2_counts: torch.Tensor   # (C, B) int32

    @property
    def num_cameras(self) -> int:
        return self.gain.shape[0]

    @property
    def device(self) -> torch.device:
        return self.gain.device

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}

    @classmethod
    def fresh(cls, num_cameras: int, npix: int = 0, *,
              cdf_window: int = 4096, fps: float = 10.0,
              queue_size: int = 8, queue_capacity: int = 64,
              s2_window: int = 64, quantile_bins: int = 256,
              device: DeviceLike = None) -> "SessionState":
        dev = resolve_device(device)
        C = int(num_cameras)
        K = max(int(queue_capacity), int(queue_size), 1)
        B = int(quantile_bins)
        f32, i32 = torch.float32, torch.int32

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        q_util, q_seq, q_next = sq.make_lanes(C, K, device=dev)
        return cls(
            bg=full((C, npix), 0.0, f32),
            gain=full((C,), 1.0, f32),
            bg_valid=torch.tensor(False, device=dev),
            cdf_buf=full((C, cdf_window), 0.0, f32),
            cdf_len=full((C,), 0, i32),
            cdf_pos=full((C,), 0, i32),
            cdf_counts=full((C, B), 0, i32),
            threshold=full((C,), float("-inf"), f32),
            proc_q=full((C,), 0.0, f32),
            proc_seen=full((C,), False, torch.bool),
            fps_obs=full((C,), float(fps), f32),
            fps_seen=full((C,), False, torch.bool),
            queue_cap=full((C,), int(queue_size), i32),
            q_util=q_util, q_seq=q_seq, q_next_seq=q_next,
            active=full((C,), True, torch.bool),
            rate_floor=full((C,), 0.0, f32),
            s2_buf=full((C, int(s2_window)), 0.0, f32),
            s2_len=full((C,), 0, i32),
            s2_pos=full((C,), 0, i32),
            s2_threshold=full((C,), float("-inf"), f32),
            s2_counts=full((C, B), 0, i32),
        )


_STATE_NAMES = tuple(f.name for f in dataclasses.fields(SessionState))


@dataclass(frozen=True)
class IngestResult:
    """One fused-ingest result over a camera array (host arrays)."""
    pf: np.ndarray                 # (C, T, nc, bs, bv)
    hue_fraction: np.ndarray       # (C, T, nc)
    utility: Optional[np.ndarray]  # (C, T) — None without a trained model


@dataclass(frozen=True)
class StepResult:
    """Compact host-side outcome of one serve ``step``.

    ``decisions``: (C, T) int8 codes (``ADMIT`` / ``SHED_ADMISSION`` /
    ``SHED_QUEUE``; retroactive same-batch queue evictions included).
    ``pushed_seq``: (C, T) int32 queue seq per admitted slot (-1
    otherwise). ``evicted``: per-camera int arrays of seqs of
    *previously queued* frames dropped this step (push evictions of
    residents plus tick resizes). ``target_drop_rate``: (C,) float32
    Eq. 19 rates when the step re-derived thresholds, else None.
    ``s2_scores``: (C, T) float32 stage-2 scores when the step ran the
    semantic cascade (0 for frames the color gate shed before the scorer
    saw them), else None.
    """
    decisions: np.ndarray
    pushed_seq: np.ndarray
    evicted: List[np.ndarray]
    target_drop_rate: Optional[np.ndarray] = None
    s2_scores: Optional[np.ndarray] = None


# ---------------------------------------------------------------------------
# Serve-step cores (torch, on the state's device)
# ---------------------------------------------------------------------------

def _ring_push(buf, pos, ln, counts, us, lo: float, inv_width: float,
               mask=None):
    """Append a (C, T) utility batch into the per-camera ring buffers;
    ``mask`` (C, T) marks the real entries (None = all), which land in
    order on consecutive slots of their row. The (C, B) bucket ``counts``
    are maintained incrementally (ring-wrap aware: slot s is pre-push
    live iff s < len, wherever ``pos`` wrapped), so they always equal a
    recount of the live window."""
    C, W = buf.shape
    B = counts.shape[1]
    if mask is None:
        if us.shape[1] >= W:                   # only the tail can survive
            us = us[:, -W:]
        T = us.shape[1]
        idx = ((pos[:, None] + torch.arange(T, dtype=torch.int32,
                                            device=buf.device)[None, :]) % W
               ).to(torch.int64)
        old = torch.gather(buf, 1, idx)
        evict = idx < ln[:, None]
        buf = buf.scatter(1, idx, us)
        add = torch.ones_like(us, dtype=torch.int32)
        cnt = T
    else:
        kk = torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32)
        # absent entries go to a padding slot W that is cut off after
        idx = torch.where(mask, (pos[:, None] + kk - 1) % W, W).to(
            torch.int64)
        old = torch.gather(buf, 1, torch.clamp_max(idx, W - 1))
        evict = mask & (idx < ln[:, None])
        buf = torch.cat([buf, buf.new_zeros((C, 1))], dim=1).scatter(
            1, idx, us)[:, :W]
        add = mask.to(torch.int32)
        cnt = kk[:, -1]
    counts = counts.scatter_add(
        1, bucket_index_dev(us, lo, inv_width, B).to(torch.int64), add)
    counts = counts.scatter_add(
        1, bucket_index_dev(old, lo, inv_width, B).to(torch.int64),
        -evict.to(torch.int32))
    pos = ((pos + cnt) % W).to(torch.int32)
    ln = torch.clamp_max(ln + cnt, W).to(torch.int32)
    return buf, pos, ln, counts


def _eq19_rates(state: SessionState, min_proc: float, C: int):
    """Eq. 19 target drop rates, float32, in the reference's
    single-division form ``1 - 1/(p*C*max(fps, 1e-9))`` (every division
    is tensor by tensor: torch turns ``scalar / tensor`` into a
    reciprocal and a product, which rounds differently)."""
    p = torch.clamp_min(state.proc_q, min_proc)
    denom = p * C * torch.clamp_min(state.fps_obs, 1e-9)
    rates = torch.clamp(1.0 - torch.ones_like(denom) / denom, 0.0, 1.0)
    rates = torch.maximum(rates, state.rate_floor)
    return p, torch.where(state.active, rates, 0.0).to(torch.float32)


def _tick_core(state: SessionState, min_proc: float, budget: float,
               num_total: Optional[int] = None,
               tick_cfg: TickConfig = DEFAULT_TICK_CONFIG):
    """Eq. 18–20 re-derivation: target rates from the metric lanes,
    thresholds via the O(bins) bucket cumsum (or ONE batched (C, W) sort
    under ``tick_cfg.exact``), queue caps + resize."""
    C = num_total if num_total is not None else state.threshold.shape[0]
    p, rates = _eq19_rates(state, min_proc, C)
    threshold = _stage_thresholds(state.cdf_buf, state.cdf_len,
                                  state.cdf_counts, rates, tick_cfg.exact,
                                  tick_cfg.lo, tick_cfg.width)
    state = dataclasses.replace(
        state, threshold=torch.where(state.active, threshold, float("inf")))
    state, resize_ev = _resize_queues(state, p, budget, tick_cfg.exact)
    return state, rates, resize_ev


def _stage_thresholds(buf, ln, counts, rates, exact: bool, lo: float,
                      width: float):
    """Eq. 17 thresholds of one ring at ``rates``: the full (C, W) sort
    under ``exact``, else the O(bins) cumsum over its bucket counts."""
    if exact:
        return thresholds_from_lanes_dev(buf, ln, rates)
    return thresholds_from_counts_dev(counts, ln, rates, lo, width)


def _resize_queues(state: SessionState, p, budget: float, exact: bool):
    """Eq. 20 queue caps from the latency lanes ``p`` and the queue
    resize. Outside ``exact`` mode the lanes stay as they are when no
    lane holds more entries than its new cap (the reference host tick's
    no-eviction fast path, kept here without a host sync), so the
    physical lane layout stays bit-identical to that twin."""
    cap = torch.clamp_min(
        (torch.full_like(p, budget) / p + 1e-9).to(torch.int32) - 1, 1)
    q_util, q_seq, resize_ev = sq.resize_dev(state.q_util, state.q_seq, cap)
    if not exact:
        K = state.q_seq.shape[1]
        occ = (state.q_seq >= 0).sum(dim=1)
        keep = ~(occ > torch.clamp(cap, 1, K)).any()
        q_util = torch.where(keep, state.q_util, q_util)
        q_seq = torch.where(keep, state.q_seq, q_seq)
        resize_ev = torch.where(keep, -1, resize_ev).to(torch.int32)
    state = dataclasses.replace(state, queue_cap=cap.to(torch.int32),
                                q_util=q_util, q_seq=q_seq)
    return state, resize_ev


def _queue_insert(state: SessionState, util, admit, decisions):
    """Push the admitted entries of a (C, T) batch into the queue lanes
    keyed by ``util``, and flip this batch's frames that the push evicted
    to ``SHED_QUEUE`` (a scatter-max: evicted slots were ``ADMIT`` = 0 and
    the dummy writes are -1). Returns (state', outputs-dict)."""
    q_util, q_seq, q_next, pushed_seq, ev_s, ev_b = sq.push_batch_dev(
        state.q_util, state.q_seq, state.q_next_seq, util, admit,
        state.queue_cap)
    flip = ev_b >= 0
    decisions = decisions.scatter_reduce(
        1, torch.where(flip, ev_b, 0).to(torch.int64),
        torch.where(flip, SHED_QUEUE, -1).to(torch.int32),
        reduce="amax").to(torch.int8)
    state = dataclasses.replace(state, q_util=q_util, q_seq=q_seq,
                                q_next_seq=q_next)
    return state, {
        "decisions": decisions,
        "pushed_seq": pushed_seq,
        "evicted_resident": torch.where((ev_b < 0) & (ev_s >= 0), ev_s, -1),
        "push_evictions": (ev_s >= 0).sum(dim=-1).to(torch.int32),
    }


def _control_core(state: SessionState, util, present=None, *,
                  update_cdf: bool, do_tick: bool, min_proc: float,
                  budget: float, num_total: Optional[int] = None,
                  tick_cfg: TickConfig = DEFAULT_TICK_CONFIG):
    """CDF push -> admission -> queue selection -> (optional) tick.
    ``present`` (C, T) marks the real entries of a ragged batch (None =
    all); absent slots get decision code -1 and touch no state.
    Returns (state', outputs-dict of compact tensors)."""
    util = util.to(torch.float32)
    C, T = util.shape
    cdf_buf, cdf_pos, cdf_len = state.cdf_buf, state.cdf_pos, state.cdf_len
    cdf_counts = state.cdf_counts
    if update_cdf:
        cdf_buf, cdf_pos, cdf_len, cdf_counts = _ring_push(
            cdf_buf, cdf_pos, cdf_len, cdf_counts, util, tick_cfg.lo,
            tick_cfg.inv_width, present)
    admit = ~(util < state.threshold[:, None])
    if present is not None:
        admit = present & admit
    decisions = torch.where(admit, ADMIT, SHED_ADMISSION).to(torch.int32)
    if present is not None:
        decisions = torch.where(present, decisions, -1)
    state = dataclasses.replace(
        state, cdf_buf=cdf_buf, cdf_pos=cdf_pos, cdf_len=cdf_len,
        cdf_counts=cdf_counts)
    state, out = _queue_insert(state, util, admit, decisions)
    if do_tick:
        state, rates, resize_ev = _tick_core(state, min_proc, budget,
                                             num_total, tick_cfg)
        out["rates"] = rates
        out["resize_evicted"] = resize_ev
    return state, out


# ---------------------------------------------------------------------------
# Semantic-cascade cores: the reference host twins' arithmetic in torch,
# split around the scorer call: phase A (stage-1 CDF push + color gate)
# -> scorer on the survivors -> phase B (stage-2 ring push + gate + queue
# insertion + optional two-threshold tick). The single-stage cores above
# share their queue and resize helpers and nothing else, so cascade-off
# sessions stay bit-identical.
# ---------------------------------------------------------------------------

def _cascade_rates(rates, gate_fraction: float):
    """Split the Eq. 19 combined target drop rate r into the stage-1
    share r1 = g*r and the stage-2 CONDITIONAL share r2 = (r-r1)/(1-r1)
    (of the survivors), float32 as the reference computes them, so
    r1 + (1-r1)*r2 tracks r and the degraded floor (already folded into
    ``rates``) bounds the combined rate."""
    def f32(x):
        return torch.full((), float(np.float32(x)), dtype=torch.float32,
                          device=rates.device)
    r1 = rates * f32(gate_fraction)
    r2 = (rates - r1) / torch.maximum(1.0 - r1, f32(1e-9))
    return r1, r2


def _cascade_tick_core(state: SessionState, min_proc: float, budget: float,
                       gate_fraction: float, num_total: Optional[int] = None,
                       tick_cfg: TickConfig = DEFAULT_TICK_CONFIG):
    """Two-threshold tick: the combined Eq. 18–20 rate (floor and churn
    mask applied first, as in ``_tick_core``) is split across the stages;
    each stage's threshold comes from ITS ring at ITS share, through the
    same bucket machinery (the s2 geometry covers the scorer's range)."""
    C = num_total if num_total is not None else state.threshold.shape[0]
    p, rates = _eq19_rates(state, min_proc, C)
    r1, r2 = _cascade_rates(rates, gate_fraction)
    threshold = _stage_thresholds(state.cdf_buf, state.cdf_len,
                                  state.cdf_counts, r1, tick_cfg.exact,
                                  tick_cfg.lo, tick_cfg.width)
    s2_threshold = _stage_thresholds(state.s2_buf, state.s2_len,
                                     state.s2_counts, r2, tick_cfg.exact,
                                     tick_cfg.s2_lo, tick_cfg.s2_width)
    state = dataclasses.replace(
        state,
        threshold=torch.where(state.active, threshold, float("inf")),
        s2_threshold=torch.where(state.active, s2_threshold, float("inf")))
    state, resize_ev = _resize_queues(state, p, budget, tick_cfg.exact)
    return state, rates, resize_ev


def _cascade_admit(state: SessionState, util, present, *, update_cdf: bool,
                   tick_cfg: TickConfig = DEFAULT_TICK_CONFIG):
    """Cascade phase A: stage-1 CDF push + color gate. Returns (state',
    pass1 (C, T) bool — the frames the scorer sees)."""
    util = util.to(torch.float32)
    if update_cdf:
        buf, pos, ln, counts = _ring_push(
            state.cdf_buf, state.cdf_pos, state.cdf_len, state.cdf_counts,
            util, tick_cfg.lo, tick_cfg.inv_width, present)
        state = dataclasses.replace(state, cdf_buf=buf, cdf_pos=pos,
                                    cdf_len=ln, cdf_counts=counts)
    return state, present & ~(util < state.threshold[:, None])


def _cascade_finish_core(state: SessionState, s2, present, pass1, *,
                         do_tick: bool, min_proc: float, budget: float,
                         gate_fraction: float,
                         num_total: Optional[int] = None,
                         tick_cfg: TickConfig = DEFAULT_TICK_CONFIG):
    """Cascade phase B: stage-2 ring push (survivors only) -> stage-2
    gate -> queue insertion keyed by the SEMANTIC score -> (optional)
    two-threshold tick. Returns (state', outputs-dict)."""
    s2 = s2.to(torch.float32)
    buf, pos, ln, counts = _ring_push(
        state.s2_buf, state.s2_pos, state.s2_len, state.s2_counts, s2,
        tick_cfg.s2_lo, tick_cfg.s2_inv_width, pass1)
    admit = pass1 & ~(s2 < state.s2_threshold[:, None])
    decisions = torch.where(admit, ADMIT,
                            torch.where(pass1, SHED_CASCADE, SHED_ADMISSION))
    decisions = torch.where(present, decisions, -1).to(torch.int32)
    state = dataclasses.replace(state, s2_buf=buf, s2_pos=pos, s2_len=ln,
                                s2_counts=counts)
    state, out = _queue_insert(state, s2, admit, decisions)
    if do_tick:
        state, rates, resize_ev = _cascade_tick_core(
            state, min_proc, budget, gate_fraction, num_total, tick_cfg)
        out["rates"] = rates
        out["resize_evicted"] = resize_ev
    return state, out


def _fused_ingest(state: SessionState, frames, M_pos, norm, *, hue_ranges,
                  bs, bv, alpha, fg_threshold, use_fg, bg_valid, op,
                  width: int = 0, plan_cameras: Optional[int] = None):
    """Fused ingest of (C, T, N, 3) frames (the CUDA kernel on a CUDA
    state) carrying the state's background lanes. Returns (state',
    utilities (C, T), and with ``width > 0`` the (C, T, 4) foreground
    bboxes, else None). ``plan_cameras``: see ``ingest_core`` (a camera
    shard passes the whole array's count)."""
    bg0 = state.bg if bg_valid else torch.zeros_like(state.bg)
    gain0 = state.gain if bg_valid else torch.ones_like(state.gain)
    res = ingest_core(
        frames, bg0, gain0, M_pos, norm, hue_ranges=hue_ranges, bs=bs,
        bv=bv, alpha=alpha, threshold=fg_threshold, use_fg=use_fg,
        bg_valid=bg_valid, op=op, width=width, plan_cameras=plan_cameras)
    # filled on the device: a flag copied from the host syncs the stream
    state = dataclasses.replace(
        state, bg=res[4], gain=res[5],
        bg_valid=torch.ones((), dtype=torch.bool, device=state.device))
    return state, res[3], (res[6] if width else None)


def _on_whole_state(method):
    """Run a rarely called method of a camera-sharded session on the
    whole state: the shards are gathered onto the session's device, the
    unsharded code runs on that global state, and the result is split
    over the mesh again — bit-identical to the unsharded session by
    construction. An unsharded session runs the method as it is."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        if self._shards is None:
            return method(self, *args, **kwargs)
        self._state = fl.gather_state(self._shards, self.device)
        self._shards = None
        try:
            return method(self, *args, **kwargs)
        finally:
            self._shards = fl.shard_state(self._state, self.mesh)
            self._state = None
    return run


def _host(x) -> np.ndarray:
    """A compact output on the host (tensors are copied, arrays pass)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _nonzero(x):
    return torch.nonzero(x, as_tuple=True)


def _tolist(x):
    return x.tolist()


class ShedSession:
    """A camera array's Load Shedder: fused scoring + per-camera
    admission/queues + shared-backend control loop, on one device or
    split by camera rows over a ``fleet.CameraMesh``.

    Use :func:`open_session` to construct one.
    """

    def __init__(self, query: Query, num_cameras: int = 1, *,
                 frame_shape: Optional[Tuple[int, int]] = None,
                 model: Optional[UtilityModel] = None,
                 train_utilities: Optional[Sequence[float]] = None,
                 queue_size: int = 8,
                 queue_capacity: int = 64,
                 latency_inputs: Optional[LatencyInputs] = None,
                 cdf_window: int = 4096,
                 ewma_alpha: float = 0.2, ewma_alpha_up: float = 0.6,
                 min_proc: float = 1e-6,
                 update_cdf_online: bool = True,
                 impl: Optional[str] = None,
                 interpret: Optional[bool] = None,
                 serve: Optional[str] = None,
                 mesh: Optional[Any] = None,
                 shard_cameras: Optional[bool] = None,
                 fleet_aggregate: bool = False,
                 cascade: Optional[Any] = None,
                 exact_tick: bool = False,
                 quantile_bins: int = 256,
                 quantile_range: Tuple[float, float] = (0.0, 1.0),
                 s2_quantile_range: Tuple[float, float] = (-1.0, 1.0),
                 device: DeviceLike = None) -> None:
        if num_cameras < 1:
            raise ValueError("num_cameras must be >= 1")
        if cascade is not None and (mesh is not None or shard_cameras):
            raise ValueError(
                "cascade= is not supported with camera sharding yet: the "
                "stage-2 scorer is one call over the whole array's "
                "survivors, and the sharded serve plane has no such step")
        if serve not in (None, "host", "device"):
            raise ValueError(f"unknown serve impl {serve!r}")
        # fleet mode: shard the camera lanes over a camera mesh
        # (repro_torch.core.fleet). shard_cameras=True without a mesh
        # builds one over every device of the session's kind; a mesh
        # alone implies sharding.
        if shard_cameras is None:
            shard_cameras = mesh is not None
        if device is None and mesh is not None:
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.mesh: Optional[fl.CameraMesh] = None
        self._state: Optional[SessionState] = None
        self._shards: Optional[Tuple[SessionState, ...]] = None
        self.fleet_aggregate = bool(fleet_aggregate)
        self.last_fleet_stats: Optional[Dict[str, float]] = None
        if shard_cameras:
            if serve == "host":
                raise ValueError(
                    "shard_cameras requires serve='device' (the sharded "
                    "serve plane runs the device cores shard by shard)")
            if mesh is None:
                mesh = (fl.fleet_mesh() if self.device.type == "cuda"
                        else fl.fleet_mesh(1, device=self.device))
            self.mesh = mesh         # fl.shard_state refuses uneven splits
        self.query = query
        self.num_cameras = int(num_cameras)
        self.model = model
        # semantic cascade (repro_torch.cascade.Cascade, duck-typed:
        # .scorer / .gate_fraction / .window) — strictly opt-in; None
        # leaves every decision bit-identical to the single-stage pipeline
        self.cascade = cascade
        self._gate_fraction = (float(getattr(cascade, "gate_fraction", 0.5))
                               if cascade is not None else 0.5)
        s2_window = (int(getattr(cascade, "window", 1024))
                     if cascade is not None else 64)
        self.latency_inputs = latency_inputs or LatencyInputs()
        self.ewma_alpha = float(ewma_alpha)
        self.ewma_alpha_up = float(ewma_alpha_up)
        self.min_proc = float(min_proc)
        self.update_cdf_online = bool(update_cdf_online)
        bins = int(quantile_bins)
        if bins < 2:
            raise ValueError(f"quantile_bins {bins} must be >= 2")
        qlo, qhi = float(quantile_range[0]), float(quantile_range[1])
        s2lo, s2hi = float(s2_quantile_range[0]), float(s2_quantile_range[1])
        if not (qhi > qlo and s2hi > s2lo):
            raise ValueError("quantile ranges must satisfy hi > lo")
        self.exact_tick = bool(exact_tick)
        self.quantile_bins = bins
        self._tick_cfg = TickConfig(
            exact=self.exact_tick, lo=qlo, width=(qhi - qlo) / bins,
            inv_width=bins / (qhi - qlo), s2_lo=s2lo,
            s2_width=(s2hi - s2lo) / bins, s2_inv_width=bins / (s2hi - s2lo))
        self._queue_size = int(queue_size)
        npix = frame_shape[0] * frame_shape[1] if frame_shape else 0
        self.load_state(SessionState.fresh(
            num_cameras, npix, cdf_window=cdf_window, fps=query.fps,
            queue_size=queue_size, queue_capacity=queue_capacity,
            s2_window=s2_window, quantile_bins=bins, device=self.device))
        self.stats = ShedderStats()
        # the session's own spans and counters: the step path's spans
        # (``shed.*``, ``cascade.*``) while ``metrics.tracing``, and
        # ``session.host_syncs``, one a device read on that path, always
        self.metrics = MetricsRegistry()
        self._host_syncs = self.metrics.counter("session.host_syncs")
        # a cascade session's ``cascade.frames_gathered``: the survivors'
        # whole frames its scorer copied out (``FrameRows.gather``)
        if cascade is not None:
            self._frames_gathered = self.metrics.counter(
                "cascade.frames_gathered")
        self.per_camera_offered = np.zeros((self.num_cameras,), np.int64)
        self.per_camera_dropped = np.zeros((self.num_cameras,), np.int64)
        self._consts: Optional[Tuple[Any, Tuple[Any, Any, str]]] = None
        if train_utilities is not None:
            self.seed_cdf(train_utilities)

    @property
    def state(self) -> SessionState:
        """The whole ``SessionState``; on a camera-sharded session a
        gathered copy on the session's device (writes to it do not reach
        the shards: assign a whole state instead)."""
        if self._shards is None:
            return self._state
        return fl.gather_state(self._shards, self.device)

    @state.setter
    def state(self, state: SessionState) -> None:
        if self._shards is None:
            self._state = state
        else:
            self._shards = fl.shard_state(state, self.mesh)

    def _lanes(self) -> Sequence[SessionState]:
        """The state as it is held: the whole state, or its shards in
        mesh (camera) order."""
        return (self._state,) if self._shards is None else self._shards

    def _read(self, x, read=_host):
        """``read(x)`` where it reads a device value: a tensor's read is
        one host sync of the step path, counted in ``session.host_syncs``
        and spanned as ``shed.sync``; anything else is read as it is.
        A camera-sharded session's reads of its shards' outputs are
        counted too (``fleet`` reads through this). The step path makes
        no other stream sync (its constants are filled on the device, not
        copied there), beyond uploads of data from the host: inputs given
        there, and a sharded pop's slots."""
        if not isinstance(x, torch.Tensor):
            return read(x)
        self._host_syncs.inc()
        with self.metrics.span("shed.sync"):
            return read(x)

    def _host_leaf(self, name: str) -> np.ndarray:
        """One leaf's global lanes on the host, without gathering the
        rest of a sharded state."""
        return np.concatenate([getattr(s, name).cpu().numpy()
                               for s in self._lanes()])

    def load_state(self, state: SessionState) -> None:
        """Adopt a whole ``SessionState`` (e.g. one carried over from the
        reference by ``repro_torch.convert.state_from_numpy``): its lanes
        move to this session's device (or its mesh's shards), the
        host-side queue-depth cache is recounted, and queued payloads fall
        back to ``(cam, seq)`` pairs."""
        if state.num_cameras != self.num_cameras:
            raise ValueError(f"state has {state.num_cameras} camera lanes, "
                             f"session has {self.num_cameras}")
        if self.mesh is None:
            self._adopt((SessionState(**{
                f.name: getattr(state, f.name).to(self.device, copy=True)
                for f in dataclasses.fields(state)}),))
        else:
            self._adopt(fl.shard_state(state, self.mesh))

    def _adopt(self, lanes: Sequence[SessionState]) -> None:
        """Hold ``lanes`` (the whole state, or its shards in mesh order)
        as this session's state and rebuild the host-side bookkeeping."""
        if self.mesh is None:
            self._state, self._shards = lanes[0], None
        else:
            self._state, self._shards = None, tuple(lanes)
        self.queue_capacity = int(lanes[0].q_util.shape[1])
        self._payloads: List[Dict[int, Any]] = [
            {} for _ in range(self.num_cameras)]
        # live queue depths, maintained incrementally from the compact
        # step/pop outputs so __len__/queue_depths never transfer the
        # (C, K) q_seq lanes to host
        self._depths = np.concatenate([
            (s.q_seq >= 0).sum(dim=1).cpu().numpy() for s in lanes]
        ).astype(np.int64)
        # external camera id -> lane; unmapped lanes sit in a min-heap, so
        # lane() claims the smallest free lane (first-seen order)
        self._lane_of: Dict[Any, int] = {}
        self._free_lanes: List[int] = list(range(self.num_cameras))
        self._active_host = self._host_leaf("active").copy()
        self._num_active = int(self._active_host.sum())
        self._rate_floor_host = float(self._host_leaf("rate_floor").max())

    # -- camera lanes / churn ------------------------------------------------

    def lane(self, cam_id: Any) -> int:
        """Map an external camera id to a state lane (first-seen order).

        An unknown id claims the lowest free lane; a lane left inactive
        by ``detach_camera`` is reset to fresh per-camera state for the
        newcomer (an implicit ``attach_camera``)."""
        lane = self._lane_of.get(cam_id)
        if lane is None:
            if not self._free_lanes:
                raise ValueError(
                    f"camera id {cam_id!r} exceeds the session's "
                    f"{self.num_cameras} lanes")
            lane = heapq.heappop(self._free_lanes)
            self._lane_of[cam_id] = lane
            if not self._active_host[lane]:
                self._reset_lane(lane, active=True)
                self._active_host[lane] = True
                self._num_active += 1
        return lane

    @property
    def num_active(self) -> int:
        """Live camera count — Eq. 19's backend-sharing multiplier."""
        return self._num_active

    def attach_camera(self, cam_id: Any) -> int:
        """Add a camera to a live session: claim a free lane (fresh
        per-camera state when reclaiming a detached lane) and return
        it. Raises when the id is already attached or no lane is free."""
        if cam_id in self._lane_of:
            raise ValueError(f"camera {cam_id!r} is already attached")
        return self.lane(cam_id)

    @_on_whole_state
    def detach_camera(self, cam_id: Any) -> List[Any]:
        """Remove a live camera: its queued frames are drained (returned,
        and counted as queue sheds — they will never transmit), the lane
        is masked out of admission/control (threshold pinned to +inf,
        Eq. 19 excludes it), and the lane is freed for reuse."""
        lane = self._lane_of.pop(cam_id, None)
        if lane is None:
            raise ValueError(f"unknown camera id {cam_id!r}")
        seq_row = self.state.q_seq[lane].cpu().numpy()
        drained = [self._payloads[lane].pop(int(s), (lane, int(s)))
                   for s in seq_row[seq_row >= 0]]
        self._payloads[lane] = {}
        self.stats.dropped_queue += len(drained)
        self.per_camera_dropped[lane] += len(drained)
        self._depths[lane] = 0
        self._reset_lane(lane, active=False)
        heapq.heappush(self._free_lanes, lane)
        self._active_host[lane] = False
        self._num_active -= 1
        return drained

    def _write_lane(self, name: str, lane: int, value: Any) -> None:
        """Set one lane row of a state leaf (a new tensor, so no earlier
        holder of the leaf sees the write)."""
        arr = getattr(self.state, name).clone()
        arr[lane] = torch.as_tensor(np.asarray(value), dtype=arr.dtype)
        setattr(self.state, name, arr)

    @_on_whole_state
    def _reset_lane(self, lane: int, active: bool) -> None:
        """Fresh per-camera state for one lane — the leaves the
        reference's ``_reset_lane`` resets and no others. Inactive lanes
        park at threshold=+inf (admit nothing); (re)attached lanes start
        at -inf (admit everything) until their CDF window fills."""
        q = self.query
        K = self.queue_capacity
        B = int(self.state.cdf_counts.shape[1])
        for name, v in (
                ("gain", 1.0), ("cdf_len", 0), ("cdf_pos", 0),
                ("cdf_counts", np.zeros((B,), np.int32)),
                ("threshold", np.float32(-np.inf if active else np.inf)),
                ("proc_q", 0.0), ("proc_seen", False),
                ("fps_obs", float(q.fps)), ("fps_seen", False),
                ("queue_cap", self._queue_size), ("q_next_seq", 0),
                ("q_util", np.full((K,), -np.inf, np.float32)),
                ("q_seq", np.full((K,), -1, np.int32)),
                ("rate_floor", np.float32(self._rate_floor_host)),
                ("s2_len", 0), ("s2_pos", 0),
                ("s2_threshold",
                 np.float32(-np.inf if active else np.inf)),
                ("s2_counts", np.zeros((B,), np.int32)),
                ("active", bool(active))):
            self._write_lane(name, lane, v)
        self._depths[lane] = 0
        if self.state.bg.shape[1]:
            self._write_lane("bg", lane,
                             np.zeros((self.state.bg.shape[1],), np.float32))

    # -- degraded-mode control (serve/fault.py drives this) ------------------

    @property
    def rate_floor(self) -> float:
        return self._rate_floor_host

    @_on_whole_state
    def set_rate_floor(self, floor: float) -> None:
        """Degraded-regime floor under every lane's Eq. 19 target drop
        rate, applied at the next ``tick``/``step``. 0.0 restores the
        normal regime bit-identically (``max(r, 0)`` is the identity on
        the clipped rates)."""
        f = float(floor)
        if not 0.0 <= f <= 1.0:
            raise ValueError(f"rate floor {f} outside [0, 1]")
        self._rate_floor_host = f
        self.state.rate_floor = torch.full((self.num_cameras,), f,
                                           dtype=torch.float32,
                                           device=self.device)

    @property
    def _budget(self) -> float:
        li = self.latency_inputs
        return (self.query.latency_bound - li.net_cam_ls - li.net_ls_q
                - li.proc_cam)

    def _model_constants(self):
        """The (M_pos, norm, op) device constants of the trained model —
        computed once per model object, not per step."""
        if self._consts is None or self._consts[0] is not self.model:
            q = self.query
            self._consts = (self.model, query_constants(
                self.model, q.num_colors, q.bs, q.bv, q.op,
                device=self.device))
        return self._consts[1]

    # -- training / scoring --------------------------------------------------

    def fit(self, pfs: np.ndarray, labels: np.ndarray) -> UtilityModel:
        """Train the query's utility function (Eq. 12–13) on PF matrices
        and seed every camera's utility CDF with the train utilities."""
        self.model = train_utility_model(
            np.asarray(pfs, np.float32), labels, self.query.colors,
            op=self.query.op)
        self.seed_cdf(batch_utilities(self.model, np.asarray(pfs, np.float32),
                                      device=self.device))
        return self.model

    @_on_whole_state
    def seed_cdf(self, utilities: Union[np.ndarray, Sequence[float]]) -> None:
        """Fill every camera's CDF window with a shared utility history."""
        us = np.asarray(utilities, np.float32).reshape(-1)
        us = torch.as_tensor(np.broadcast_to(us, (self.num_cameras, us.size))
                             .copy(), device=self.device)
        st, cfg = self.state, self._tick_cfg
        st.cdf_buf, st.cdf_pos, st.cdf_len, st.cdf_counts = _ring_push(
            st.cdf_buf, st.cdf_pos, st.cdf_len, st.cdf_counts, us, cfg.lo,
            cfg.inv_width)

    # -- fused ingest --------------------------------------------------------

    def _check_frames(self, frames) -> torch.Tensor:
        """(C, T, H, W, 3) float32 frames on the session's device: a numpy
        array is copied there, a tensor must already lie there. A sharded
        session takes a tensor on the host or on a mesh device, and keeps
        an array on the host: each shard's rows go to its device later."""
        if isinstance(frames, torch.Tensor):
            ok = ((self.device,) if self.mesh is None
                  else (torch.device("cpu"),) + self.mesh.devices)
            if frames.device not in ok:
                raise ValueError(f"frames on {frames.device}, session on "
                                 f"{self.device}")
            frames = frames.to(torch.float32)
        else:
            frames = torch.as_tensor(
                np.asarray(frames, np.float32),
                device=self.device if self.mesh is None else "cpu")
        if frames.ndim == 4:
            frames = frames[None]
        if frames.ndim != 5 or frames.shape[0] != self.num_cameras:
            raise ValueError(
                f"expected ({self.num_cameras}, T, H, W, 3) frames, "
                f"got {tuple(frames.shape)}")
        n = frames.shape[2] * frames.shape[3]
        for st in self._lanes():
            if st.bg.shape[1] != n:
                if self._read(st.bg_valid, bool):
                    raise ValueError(
                        f"frame size {n} px does not match carried "
                        f"background state {(self.num_cameras, st.bg.shape[1])}")
                st.bg = torch.zeros((st.num_cameras, n), dtype=torch.float32,
                                    device=st.device)
        return frames.contiguous()

    @_on_whole_state
    def ingest(self, frames, *, impl: Optional[str] = None,
               interpret: Optional[bool] = None) -> IngestResult:
        """Score one frame batch for the whole camera array in one fused
        ingest, carrying per-camera background state.

        frames: (C, T, H, W, 3) float32 RGB in [0, 255] — or
        (T, H, W, 3) for single-camera sessions. The reference's
        ``impl=``/``interpret=`` are accepted and change nothing.
        """
        frames = self._check_frames(frames)
        st = self.state
        state_in = (IngestState(bg=st.bg, gain=st.gain)
                    if bool(st.bg_valid) else None)
        q = self.query
        pf, hf, util, state_out = ingest_pipeline(
            frames, q.colors, self.model, state=state_in, alpha=q.alpha,
            threshold=q.threshold, use_foreground=q.use_foreground,
            op=q.op, bs=q.bs, bv=q.bv)
        st.bg = state_out.bg
        st.gain = state_out.gain.reshape(-1)
        st.bg_valid = torch.tensor(True, device=self.device)
        return IngestResult(
            pf=pf.cpu().numpy(), hue_fraction=hf.cpu().numpy(),
            utility=None if util is None else util.cpu().numpy())

    @property
    def ingest_state(self) -> IngestState:
        """The kernel-facing ``(bg, gain)`` lanes (for host handoff)."""
        st = self.state
        return IngestState(bg=st.bg, gain=st.gain)

    @_on_whole_state
    def set_ingest_state(self, state: Optional[IngestState]) -> None:
        """Adopt carried ``(bg, gain)`` lanes (tensors or arrays; a
        single-camera state gets a camera lane), or forget them with
        ``None`` so the next batch's frame 0 seeds the background."""
        if state is None:
            self.state.bg_valid = torch.tensor(False, device=self.device)
            return
        bg = torch.as_tensor(state.bg, dtype=torch.float32).to(self.device)
        if bg.ndim == 1:
            bg = bg[None]
        if bg.shape[0] != self.num_cameras:
            raise ValueError(
                f"state has {bg.shape[0]} camera lanes, session has "
                f"{self.num_cameras}")
        self.state.bg = bg.contiguous()
        self.state.gain = torch.as_tensor(
            state.gain, dtype=torch.float32).to(self.device).reshape(-1)
        self.state.bg_valid = torch.tensor(True, device=self.device)

    # -- the serve step ------------------------------------------------------

    def step(self, frames=None, *, utilities: Optional[np.ndarray] = None,
             s2_utilities: Optional[np.ndarray] = None,
             items: Optional[Sequence[Sequence[Any]]] = None,
             tick: bool = True, impl: Optional[str] = None,
             interpret: Optional[bool] = None) -> StepResult:
        """One serve-loop iteration for the whole camera array: score ->
        CDF push -> admission -> queue selection -> (``tick=True``)
        threshold/queue-size re-derivation.

        Give either ``frames`` — a (C, T, H, W, 3) batch (numpy, or a
        tensor already on the session's device) scored by the fused
        ingest kernel (requires a trained model) — or precomputed
        ``utilities`` (C, T) to run the control plane alone.

        With a session ``cascade``, a frames step also scores the color
        gate's survivors in ONE batched scorer call (on the foreground
        bboxes the same fused ingest computes) and applies the stage-2
        threshold before queue insertion; queues are then ordered by the
        SEMANTIC score. ``s2_utilities`` (C, T) gives precomputed stage-2
        scores with ``utilities`` — the control-plane-only cascade form;
        a utilities-only step on a cascade session runs stage 1 alone.

        ``items[c][t]`` are frame payloads for ``next_frame``; absent,
        queued frames are identified by their ``(cam, t)`` index pair.
        The reference's ``impl=``/``interpret=`` are accepted and change
        nothing (the device picks the kernel).

        On a camera-sharded session each shard takes its rows of the
        batch through one fused ingest on its device (``fleet.serve_step``)
        or its rows of the utilities (``fleet.control_step``).
        """
        if (frames is None) == (utilities is None):
            raise ValueError("pass exactly one of frames= or utilities=")
        if s2_utilities is not None and self.cascade is None:
            raise ValueError("s2_utilities= needs a session cascade")
        if s2_utilities is not None and frames is not None:
            raise ValueError("s2_utilities= goes with utilities=, not "
                             "frames= (frames are scored by the cascade)")
        with self.metrics.span("shed.step"):
            if self.cascade is not None and (frames is not None
                                             or s2_utilities is not None):
                return self._cascade_step(frames, utilities, s2_utilities,
                                          items, tick)
            return self._single_stage_step(frames, utilities, items, tick)

    def _single_stage_step(self, frames, utilities, items,
                           tick) -> StepResult:
        """The single-stage step of ``step``: the fused ingest of
        ``frames`` (or the given ``utilities``), then the control plane."""
        span = self.metrics.span
        kw = dict(update_cdf=self.update_cdf_online, do_tick=bool(tick),
                  min_proc=self.min_proc, budget=self._budget,
                  num_total=self._num_active, tick_cfg=self._tick_cfg)
        if frames is not None:
            frames = self._step_frames(frames)
            if self.mesh is not None:
                # ingest and control in one launch a shard
                with span("shed.serve"):
                    args, ingest_kw = self._ingest_args(frames)
                    self._shards, out, agg = fl.serve_step(
                        self._shards, *args, mesh=self.mesh,
                        aggregate=self.fleet_aggregate, read=self._read,
                        **ingest_kw, **kw)
                    self._absorb_fleet(agg)
                return self._absorb_control(out, items, tick)
            with span("shed.ingest"):
                args, ingest_kw = self._ingest_args(frames)
                self._state, util, _ = _fused_ingest(self._state, *args,
                                                     **ingest_kw)
        else:
            util = self._step_utilities(utilities)
        with span("shed.control"):
            if self.mesh is not None:
                self._shards, out, agg = fl.control_step(
                    self._shards, util, mesh=self.mesh,
                    aggregate=self.fleet_aggregate, read=self._read, **kw)
                self._absorb_fleet(agg)
            else:
                self._state, out = _control_core(self._state, util, **kw)
        return self._absorb_control(out, items, tick)

    def _step_frames(self, frames) -> torch.Tensor:
        if self.model is None:
            raise ValueError("step(frames=...) needs a trained model "
                             "(call fit() or pass model=)")
        with self.metrics.span("shed.check_frames"):
            frames = self._check_frames(frames)
        if frames.shape[1] == 0:
            raise ValueError("empty frame batch")
        return frames

    def _ingest_args(self, frames):
        """``_fused_ingest``'s positional arguments and query keywords for
        a checked (C, T, H, W, 3) batch."""
        q = self.query
        C, T, H, W = frames.shape[:4]
        M_pos, norm, op = self._model_constants()
        return ((frames.reshape(C, T, H * W, 3), M_pos, norm),
                dict(hue_ranges=q.hue_ranges, bs=q.bs, bv=q.bv,
                     alpha=q.alpha, fg_threshold=q.threshold,
                     use_fg=q.use_foreground,
                     bg_valid=self._read(self._lanes()[0].bg_valid, bool),
                     op=op))

    def _step_utilities(self, utilities) -> torch.Tensor:
        util = np.asarray(utilities, np.float32)
        if util.ndim == 1:
            util = util[None]
        if util.shape[0] != self.num_cameras:
            raise ValueError(
                f"expected ({self.num_cameras}, T) utilities, "
                f"got {util.shape}")
        if util.shape[1] == 0:
            raise ValueError("empty utility batch")
        return torch.as_tensor(util, device=self.device)

    def _cascade_step(self, frames, utilities, s2_utilities, items,
                      tick) -> StepResult:
        """Two-stage serve step, in the reference's three phases: fused
        ingest (utilities and the foreground bbox rider in one kernel
        launch) and phase A (stage-1 CDF push + color gate) on the
        session's device -> the survivors' index on the host (one sync)
        -> ONE batched scorer call over the survivors, handed as a
        ``FrameRows`` (the batch and their index: a ROI scorer crops them
        in place) -> phase B (stage-2 ring/gate + queue insertion +
        optional tick)."""
        dev = self.device
        span = self.metrics.span
        if frames is not None:
            frames = self._step_frames(frames)
            with span("shed.ingest"):
                args, ingest_kw = self._ingest_args(frames)
                self.state, util, bbox = _fused_ingest(
                    self.state, *args, **ingest_kw, width=frames.shape[3])
        else:
            util = self._step_utilities(utilities)
        present = torch.ones(util.shape, dtype=torch.bool, device=dev)
        with span("cascade.admit"):
            self.state, pass1 = _cascade_admit(
                self.state, util, present, update_cdf=self.update_cdf_online,
                tick_cfg=self._tick_cfg)
        if s2_utilities is not None:
            s2 = torch.as_tensor(np.asarray(s2_utilities, np.float32)
                                 .reshape(tuple(util.shape)), device=dev)
        else:
            s2 = torch.zeros_like(util)
            with span("cascade.survivors"):
                r, t = self._read(pass1, _nonzero)
                rows = FrameRows(frames, r, t) if r.numel() else None
            if rows is not None:
                with span("cascade.score"):
                    s2[r, t] = torch.as_tensor(self.cascade.scorer.score(
                        rows, bbox[r, t])).to(dev, torch.float32)
                if rows.gathered:
                    self._frames_gathered.inc(r.numel())
        with span("cascade.finish"):
            self.state, out = _cascade_finish_core(
                self.state, s2, present, pass1, do_tick=bool(tick),
                min_proc=self.min_proc, budget=self._budget,
                gate_fraction=self._gate_fraction,
                num_total=self._num_active, tick_cfg=self._tick_cfg)
        return self._absorb_control(out, items, tick,
                                    s2_scores=self._read(s2))

    def _absorb_control(self, out: Dict[str, torch.Tensor],
                        items: Optional[Sequence[Sequence[Any]]],
                        ticked: bool,
                        s2_scores: Optional[np.ndarray] = None
                        ) -> StepResult:
        """Fold a control step's compact outputs (tensors, or a sharded
        step's global arrays) into host bookkeeping: stats, payload
        registry, per-camera counters."""
        with self.metrics.span("shed.absorb_control"):
            host = {k: self._read(v) for k, v in out.items()}
            decisions = host["decisions"]
            pushed_seq = host["pushed_seq"]
            ev_res = host["evicted_resident"]
            push_ev = host["push_evictions"]
            C = decisions.shape[0]
            offered = decisions >= 0
            st = self.stats
            st.offered += int(offered.sum())
            st.dropped_admission += int((decisions == SHED_ADMISSION).sum())
            st.dropped_cascade += int((decisions == SHED_CASCADE).sum())
            st.dropped_queue += int(push_ev.sum())
            self.per_camera_offered += offered.sum(axis=1)
            res_cnt = (ev_res >= 0).sum(axis=1)
            self.per_camera_dropped += ((decisions > ADMIT).sum(axis=1)
                                        + res_cnt)
            # net queue-depth change: frames that survived the batch as
            # ADMIT minus evicted residents (resize evictions below)
            self._depths += (decisions == ADMIT).sum(axis=1) - res_cnt
            evicted: List[np.ndarray] = []
            for c in range(C):
                pl = self._payloads[c]
                for t in np.flatnonzero(decisions[c] == ADMIT):
                    item = items[c][t] if items is not None else (c, int(t))
                    pl[int(pushed_seq[c, t])] = item
                evs = ev_res[c][ev_res[c] >= 0]
                for s in evs:
                    pl.pop(int(s), None)
                evicted.append(evs.astype(np.int64))
            rates = None
            if ticked:
                rates = host["rates"]
                self._absorb_resize(host["resize_evicted"], evicted)
            return StepResult(decisions=decisions, pushed_seq=pushed_seq,
                              evicted=evicted, target_drop_rate=rates,
                              s2_scores=s2_scores)

    def _absorb_resize(self, rz: np.ndarray,
                       evicted: Optional[List[np.ndarray]] = None) -> None:
        """Book a tick's (C, K) resize evictions (-1 padded)."""
        cnt = (rz >= 0).sum(axis=1)
        self.stats.dropped_queue += int(cnt.sum())
        self.per_camera_dropped += cnt
        self._depths -= cnt
        for c in np.flatnonzero(cnt):
            evs = rz[c][rz[c] >= 0]
            pl = self._payloads[c]
            for s in evs:
                pl.pop(int(s), None)
            if evicted is not None:
                evicted[c] = np.concatenate([evicted[c],
                                             evs.astype(np.int64)])

    # -- fleet observability (sharded sessions) ------------------------------

    def _absorb_fleet(self, agg: Optional[Dict[str, Any]]) -> None:
        """Keep the latest fleet aggregates (host view) when the sharded
        step computed them."""
        if self.fleet_aggregate and agg is not None:
            self.last_fleet_stats = fl.derive_fleet_stats(agg,
                                                          self.num_cameras)

    def fleet_stats(self) -> Dict[str, float]:
        """Global fleet aggregates — queue depth, backend load, mean
        threshold — from each shard's sums, added on the host in shard
        order."""
        if self.mesh is None:
            raise ValueError("fleet_stats() needs a camera-sharded "
                             "session (open_session(..., shard_cameras"
                             "=True))")
        return fl.aggregates(self._shards, mesh=self.mesh,
                             num_cameras=self.num_cameras)

    # -- admission + queues --------------------------------------------------

    def admit(self, utilities: np.ndarray,
              items: Optional[Sequence[Sequence[Any]]] = None) -> np.ndarray:
        """Vectorized admission + queue decisions for a scored (C, T)
        batch (float32 end to end); returns the (C, T) int8 decision
        codes. A queue eviction of an earlier frame of this batch flips
        it to ``SHED_QUEUE`` retroactively."""
        return self.step(utilities=utilities, items=items,
                         tick=False).decisions

    @_on_whole_state
    def offer(self, item: Any, utility: float,
              cam: Optional[int] = None) -> str:
        """Frame-at-a-time admission (the simulator/serving surface).

        Returns 'queued' | 'shed_admission' | 'shed_queue'. The camera
        lane comes from ``cam``, else from ``item.cam_id`` (external ids
        are mapped to lanes in first-seen order), else lane 0. The CDF
        ring and the queue lanes are updated on the session's device; one
        small transfer brings the decision back.
        """
        c = self.lane(getattr(item, "cam_id", 0)) if cam is None else int(cam)
        self.stats.offered += 1
        self.per_camera_offered[c] += 1
        st, cfg, dev = self.state, self._tick_cfg, self.device
        C = self.num_cameras
        u = torch.tensor(np.float32(utility), device=dev)
        row = torch.arange(C, device=dev) == c
        if self.update_cdf_online:
            st.cdf_buf, st.cdf_pos, st.cdf_len, st.cdf_counts = _ring_push(
                st.cdf_buf, st.cdf_pos, st.cdf_len, st.cdf_counts,
                u.expand(C, 1), cfg.lo, cfg.inv_width, row[:, None])
        shed = u < st.threshold[c]
        do_push = row & ~shed
        st.q_util, st.q_seq, st.q_next_seq, pushed, evicted, inc_ev = \
            sq.push_one_dev(st.q_util, st.q_seq, st.q_next_seq,
                            u.expand(C), do_push, st.queue_cap)
        code = torch.where(shed, SHED_ADMISSION,
                           torch.where(inc_ev[c], SHED_QUEUE, ADMIT))
        code, pushed, evicted = torch.stack(
            [code.to(torch.int32), pushed[c], evicted[c]]).tolist()
        if code == SHED_ADMISSION:
            self.stats.dropped_admission += 1
            self.per_camera_dropped[c] += 1
            return "shed_admission"
        if evicted >= 0:
            self.stats.dropped_queue += 1
            self.per_camera_dropped[c] += 1
        if code == SHED_QUEUE:
            return "shed_queue"
        self._payloads[c][pushed] = item
        if evicted >= 0:
            self._payloads[c].pop(evicted, None)
        else:
            self._depths[c] += 1        # push without eviction: net +1
        return "queued"

    def offer_batch(self, items: Sequence[Any],
                    utilities: Sequence[float],
                    cams: Optional[Sequence[int]] = None) -> List[str]:
        """Admit several frames that arrived together — ONE vectorized
        control pass instead of per-frame ``offer`` calls, with identical
        decisions/state (thresholds only move on ``tick``, so coalescing
        commutes). Lanes come from ``cams`` or each item's ``cam_id``;
        multiple frames may share a camera (kept in order).

        Returns per-item 'queued' | 'shed_admission' | 'shed_queue'.
        """
        if cams is None:
            lanes = [self.lane(getattr(it, "cam_id", 0)) for it in items]
        else:
            lanes = [int(c) for c in cams]
        C = self.num_cameras
        per_cam: List[List[int]] = [[] for _ in range(C)]
        for i, c in enumerate(lanes):
            per_cam[c].append(i)
        T = max((len(v) for v in per_cam), default=0)
        if T == 0:
            return []
        util = np.zeros((C, T), np.float32)
        present = np.zeros((C, T), bool)
        slot_of: Dict[Tuple[int, int], int] = {}
        batch_items: List[List[Any]] = [[None] * T for _ in range(C)]
        for c in range(C):
            for t, i in enumerate(per_cam[c]):
                util[c, t] = np.float32(utilities[i])
                present[c, t] = True
                batch_items[c][t] = items[i]
                slot_of[(c, t)] = i
        kw = dict(update_cdf=self.update_cdf_online, do_tick=False,
                  min_proc=self.min_proc, budget=self._budget,
                  num_total=self._num_active, tick_cfg=self._tick_cfg)
        if self.mesh is not None:
            self._shards, out, agg = fl.control_step(
                self._shards, util, present, mesh=self.mesh,
                aggregate=self.fleet_aggregate, read=self._read, **kw)
            self._absorb_fleet(agg)
        else:
            self._state, out = _control_core(
                self._state, torch.as_tensor(util, device=self.device),
                torch.as_tensor(present, device=self.device), **kw)
        res = self._absorb_control(out, batch_items, ticked=False)
        codes = [""] * len(items)
        for (c, t), i in slot_of.items():
            codes[i] = _DECISION_NAMES[int(res.decisions[c, t])]
        return codes

    def next_frame(self, cam: Optional[int] = None) -> Optional[Any]:
        """Transmission control: send the best queued frame — of one
        camera, or (default) the best across the whole array (on a
        sharded session the cross-shard top-1 of ``fleet.pop_topk``)."""
        if self.mesh is not None:
            rows = None
            if cam is not None:
                rows = np.zeros((self.num_cameras,), bool)
                rows[int(cam)] = True
            self._shards, pc, ps = fl.pop_topk(self._shards, mesh=self.mesh,
                                               k=1, rows=rows)
            c, seqv = int(pc[0]), int(ps[0])
        else:
            st = self._state
            st.q_util, st.q_seq, c, seqv = sq.pop_best_dev(
                st.q_util, st.q_seq, cam)
            c, seqv = int(c), int(seqv)
        if seqv < 0:
            return None
        self._depths[c] -= 1
        item = self._payloads[c].pop(seqv, (c, seqv))
        self.stats.sent += 1
        return item

    def next_frames(self, k: int,
                    cams: Optional[Sequence[int]] = None) -> List[Any]:
        """Batched transmission control: pop the ``k`` best queued
        frames in one top-k selection — the exact frames (and order) a
        loop of ``next_frame()`` calls would send. ``cams`` restricts the
        pool to those camera lanes. Returns up to ``k`` payloads."""
        if k <= 0:
            return []
        with self.metrics.span("shed.next_frames"):
            rows = None
            if cams is not None:
                rows = np.zeros((self.num_cameras,), bool)
                rows[[int(c) for c in cams]] = True
            if self.mesh is not None:
                self._shards, pc, ps = fl.pop_topk(
                    self._shards, mesh=self.mesh, k=int(k), rows=rows,
                    read=self._read)
            else:
                st = self._state
                if rows is not None:
                    rows = torch.as_tensor(rows, device=self.device)
                st.q_util, st.q_seq, pc, ps = sq.pop_topk_dev(
                    st.q_util, st.q_seq, int(k), rows)
            items: List[Any] = []
            for c, s in zip(self._read(pc, _tolist), self._read(ps, _tolist)):
                if s < 0:               # -1 padding: pool drained
                    break
                self._depths[c] -= 1
                items.append(self._payloads[c].pop(s, (c, s)))
            self.stats.sent += len(items)
            return items

    def __len__(self) -> int:
        return int(self._depths.sum())

    def queue_depths(self) -> np.ndarray:
        """Live per-camera send-queue depths, ``(C,)`` ints (a host-side
        counter maintained by every push/pop/resize)."""
        return self._depths.copy()

    def observed_drop_rate(self, cam: int = 0) -> float:
        """Fraction of camera ``cam``'s history below its threshold."""
        st = self.state
        n = int(st.cdf_len[cam])
        if n == 0:
            return 0.0
        return float((st.cdf_buf[cam, :n] < st.threshold[cam]).to(
            torch.float64).mean())

    # -- control loop (Eq. 18–20), vectorized over cameras -------------------

    @property
    def latency_bound(self) -> float:
        return self.query.latency_bound

    def expected_proc(self, cam: Optional[int] = None) -> float:
        """Current backend per-frame latency estimate: camera ``cam``'s
        lane, or (default) the worst lane."""
        q = self._host_leaf("proc_q")
        if cam is not None:
            return float(q[int(cam)])
        return float(q.max(initial=0.0))

    @_on_whole_state
    def report_backend_latency(self, proc_latency: float,
                               cam: Optional[int] = None) -> None:
        """Backend-latency metric feed: asymmetric EWMA (overload is
        detected fast, recovery smoothed) on ``(C,)`` lanes; a scalar
        call (``cam=None``) updates every lane. The EWMA step is taken in
        float64 and rounded to float32, as the reference's host twin
        does, so the lanes stay bit-identical to it."""
        with self.metrics.span("shed.report_latency"):
            st = self.state
            q = st.proc_q
            x = torch.full_like(q, max(float(proc_latency), self.min_proc))
            # the alphas are filled on the device, not copied to it: a
            # copy from the host would sync the stream
            f64 = dict(dtype=torch.float64, device=self.device)
            a = torch.where(x > q, torch.full((), self.ewma_alpha_up, **f64),
                            torch.full((), self.ewma_alpha, **f64))
            ew = (q.to(torch.float64) + a * (x - q).to(torch.float64)).to(
                torch.float32)
            new = torch.where(st.proc_seen, ew, x)
            if cam is None:
                st.proc_q = new
                st.proc_seen = torch.ones_like(st.proc_seen)
            else:
                upd = torch.arange(self.num_cameras,
                                   device=self.device) == int(cam)
                st.proc_q = torch.where(upd, new, q)
                st.proc_seen = st.proc_seen | upd

    @_on_whole_state
    def report_ingress_fps(self, fps: float, cam: Optional[int] = None) -> None:
        """Observed ingress rate: per camera, or an aggregate rate split
        evenly across the array's lanes (the aggregate form computes in
        float64, the per-camera form in float32, as the reference's host
        twin does)."""
        st = self.state
        q = st.fps_obs
        C = self.num_cameras
        if cam is None:
            x = torch.full((C,), float(fps) / C, dtype=torch.float64,
                           device=self.device)
            upd = torch.ones((C,), dtype=torch.bool, device=self.device)
            q = q.to(torch.float64)
        else:
            upd = torch.arange(C, device=self.device) == int(cam)
            x = torch.where(upd, float(fps), q)
        ew = q + self.ewma_alpha * (x - q)
        st.fps_obs = torch.where(upd, torch.where(st.fps_seen, ew, x),
                                 q).to(torch.float32)
        st.fps_seen = st.fps_seen | upd

    def tick(self) -> Dict[str, Any]:
        """Re-derive per-camera thresholds (Eq. 17–19) and queue sizes
        (Eq. 20) from the current metric lanes — one batched quantile +
        queue resize over all C camera lanes; with a cascade, both
        stages' thresholds at their shares of the rate."""
        if self.mesh is not None:
            self._shards, rates, resize_ev, agg = fl.tick(
                self._shards, mesh=self.mesh, num_total=self._num_active,
                min_proc=self.min_proc, budget=self._budget,
                tick_cfg=self._tick_cfg, aggregate=self.fleet_aggregate)
            self._absorb_fleet(agg)
        elif self.cascade is not None:
            self._state, rates, resize_ev = _cascade_tick_core(
                self._state, self.min_proc, self._budget,
                self._gate_fraction, num_total=self._num_active,
                tick_cfg=self._tick_cfg)
        else:
            self._state, rates, resize_ev = _tick_core(
                self._state, self.min_proc, self._budget,
                num_total=self._num_active, tick_cfg=self._tick_cfg)
        rates = _host(rates)
        self._absorb_resize(_host(resize_ev))
        threshold = self._host_leaf("threshold")
        # report the EFFECTIVE queue sizes: Eq. 20's cap clipped to the
        # physical (C, K) lane bound the queues actually honor
        queue_cap = np.minimum(self._host_leaf("queue_cap"),
                               self.queue_capacity)
        finite = np.isfinite(threshold)
        # aggregate over live lanes only: detached lanes carry rate 0 and
        # threshold +inf
        act = self._active_host
        snap = {
            "target_drop_rate": float(rates[act].mean()) if act.any()
            else 0.0,
            "threshold": float(threshold[finite].mean()) if finite.any()
            else -np.inf,
            "queue_size": int(queue_cap.max()),
            "per_camera": {
                "target_drop_rate": rates.tolist(),
                "threshold": threshold.tolist(),
                "queue_size": queue_cap.tolist(),
            },
        }
        if self.cascade is not None:
            s2_th = self._host_leaf("s2_threshold")
            fin2 = np.isfinite(s2_th)
            snap["s2_threshold"] = (float(s2_th[fin2].mean())
                                    if fin2.any() else -np.inf)
            snap["per_camera"]["s2_threshold"] = s2_th.tolist()
        return snap

    # -- checkpoint / restore (serve-path state) -----------------------------

    def _model_arrays(self) -> Dict[str, np.ndarray]:
        """The trained utility model as fixed-shape arrays (zeros when
        untrained) so one checkpoint template covers both cases."""
        q = self.query
        nc = q.num_colors
        if self.model is not None:
            return {"model_M_pos": np.asarray(self.model.M_pos, np.float32),
                    "model_M_neg": np.asarray(self.model.M_neg, np.float32),
                    "model_norm": np.asarray(self.model.norm, np.float32)}
        return {"model_M_pos": np.zeros((nc, q.bs, q.bv), np.float32),
                "model_M_neg": np.zeros((nc, q.bs, q.bv), np.float32),
                "model_norm": np.zeros((nc,), np.float32)}

    def checkpoint(self, path, step: int = 0, *, async_: bool = False):
        """Persist the state lanes (plus the trained utility model and the
        camera-id map) via ``repro_torch.train.checkpoint``, in the
        reference's file format, keys and dtypes (atomic, async-capable:
        every lane is copied to host before a writer thread starts).
        Queued frame *payloads* are live host objects and do not persist —
        restored queue entries fall back to ``(cam, seq)`` pairs."""
        from repro_torch.train import checkpoint as ckpt
        st = self.state          # gathered: the file is mesh-independent
        meta = {
            "kind": "shed_session",
            "num_cameras": self.num_cameras,
            "colors": [c.name for c in self.query.colors],
            "op": self.query.op,
            "npix": int(st.bg.shape[1]),
            "has_model": self.model is not None,
            "model_op": self.model.op if self.model is not None else "",
            # camera-id -> lane map, restored so a resumed session keeps
            # serving the same external ids (ids must be msgpack-able —
            # ints/strings; numpy ints are coerced)
            "lane_map": [[int(k) if isinstance(k, (int, np.integer))
                          else k, int(v)]
                         for k, v in sorted(self._lane_of.items(),
                                            key=lambda kv: kv[1])],
        }
        tree = {**st.as_dict(), **self._model_arrays()}
        return ckpt.save(path, step, tree, metadata=meta, async_=async_)

    def restore(self, path,
                step: Optional[int] = None) -> Tuple[int, Dict[str, Any]]:
        """Load a session checkpoint (written by either package) into this
        session, whose lane shapes must match (same ``num_cameras``; pass
        ``frame_shape`` to ``open_session`` so the background lanes are
        allocated). The lanes are adopted through ``load_state`` on the
        session's device; the camera-id map, free lanes, active mask,
        rate floor and queue depths are rebuilt from the state and the
        metadata; queued payloads are dropped; the model is rebuilt when
        the checkpoint has one. A camera-sharded session takes each lane
        straight into its own mesh's shards (``restore(shardings=)``),
        whatever mesh wrote the file. Returns ``(step, metadata)``."""
        from repro_torch.train import checkpoint as ckpt
        template = {**self.state.as_dict(), **self._model_arrays()}
        shardings = None
        if self.mesh is not None:
            shardings = {k: (self.mesh if k in _STATE_NAMES
                             and k not in fl._SCALAR_LEAVES else None)
                         for k in template}
        out, step, meta = ckpt.restore(path, template, step=step,
                                       device=self.device,
                                       shardings=shardings)
        if self.mesh is None:
            self.load_state(SessionState(**{
                k: out[k] for k in _STATE_NAMES}))
        else:
            self._adopt(tuple(SessionState(**{
                k: (out[k][i] if isinstance(out[k], tuple)
                    else out[k].to(dev, copy=True))
                for k in _STATE_NAMES})
                for i, dev in enumerate(self.mesh.devices)))
        if meta.get("has_model"):
            self.model = UtilityModel(
                self.query.colors, out["model_M_pos"].cpu().numpy(),
                out["model_M_neg"].cpu().numpy(),
                out["model_norm"].cpu().numpy(),
                meta.get("model_op") or self.query.op)
        self._lane_of = {k: int(v) for k, v in meta.get("lane_map", [])}
        used = set(self._lane_of.values())
        self._free_lanes = [lane for lane in range(self.num_cameras)
                            if lane not in used]       # sorted: a heap
        return step, meta


def open_session(query: Query, num_cameras: int = 1, **kw: Any) -> ShedSession:
    """Open a ShedSession for ``num_cameras`` cameras running ``query``.

    Keyword options: ``device`` (default: the CUDA card; pass
    ``device="cpu"`` for the plain CPU path — without a card and without
    it, this raises), ``frame_shape=(H, W)`` (pre-allocates background
    lanes), ``model`` (a trained UtilityModel; or call ``session.fit``),
    ``train_utilities`` (seeds the admission CDFs), ``queue_size``
    (initial per-camera queue cap), ``queue_capacity`` (the physical
    (C, K) lane bound the dynamic cap is clipped to), ``latency_inputs``,
    ``cdf_window``, ``exact_tick``, ``quantile_bins``/``quantile_range``,
    ``cascade`` (a ``repro_torch.cascade.Cascade``: the two-stage shedder)
    with ``s2_quantile_range`` (its stage-2 score buckets). The
    reference's ``serve``/``impl``/``interpret`` are accepted and change
    nothing.

    Fleet scale-out: ``shard_cameras=True`` (a mesh over every device of
    the session's kind: all CUDA devices, or one CPU shard) or
    ``mesh=fleet.fleet_mesh(...)`` splits the camera lanes over the
    mesh's shards (``repro_torch.core.fleet``), bit-identical to the
    unsharded session; ``num_cameras`` must divide evenly over the mesh,
    ``serve="host"`` and ``cascade=`` are refused with it, and
    ``fleet_aggregate=True`` adds the fleet's counts and means to every
    sharded step (``last_fleet_stats``, ``fleet_stats()``).
    """
    return ShedSession(query, num_cameras, **kw)


__all__ = [
    "ADMIT", "SHED_ADMISSION", "SHED_QUEUE", "SHED_CASCADE",
    "IngestResult", "Query", "SessionState", "ShedSession", "StepResult",
    "TickConfig", "open_session",
]

"""Plain reference of the shed step, written for the benchmark alone.

It imports nothing of the program. Its parts follow, in plain PyTorch and
NumPy, the semantics that ``repro_torch``'s session documents:

* ``ingest`` — RGB -> HSV, the Value-channel EMA background with a
  one-frame-lagged mean-ratio gain, the foreground mask, per-colour joint
  (saturation, value) histograms, the Eq. 14–15 utility and, with a frame
  width, each frame's foreground bounding box. Float32 op for op, one
  torch operation per rounding (no fused multiply-add); the gain's pixel
  sums are exact float64 sums rounded to float32. The pattern is the
  port's plain ingest (``kernels/hsv_features/ref.py``), rewritten here.
* ``ControlPlane`` — the per-camera CDF rings and their bucket counts
  (recounted from the ring, never carried), admission, the utility-ordered
  queues as per-camera sets of ``(utility, seq)``, the Eq. 17–20 tick with
  its bucket-edge thresholds, queue caps and resizes, the backend-latency
  EWMA, and top-k transmission. The pattern is the JAX package's
  ``HostLoopShedder`` (one queue per camera, a loop over cameras),
  rewritten here. It keeps two behaviours of the original on purpose: a
  utility of 0 lies below the lowest bucket edge (1/256), so the colour
  gate sheds every such frame whatever its share of the rate; and the
  latency EWMA takes its step in float64 from a float32 difference and
  rounds it to float32.
* ``score`` — the stage-2 scorer: a nearest-neighbour crop of the
  foreground bounding box to a fixed grid, chroma features, a two-layer
  MLP (taken in float64 here) and a softsign.

``dtype`` below float32 gives the control: the same steps in bfloat16.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

F32 = np.float32
ADMIT, SHED_ADMISSION, SHED_QUEUE, SHED_CASCADE = 0, 1, 2, 3
GAIN_MIN, GAIN_MAX = 0.25, 4.0
BLOCK = 8           # cameras a pass of the ingest takes: a few GB of temporaries

HUE_RANGES = {"red": ((0, 10), (170, 180)), "yellow": ((20, 35),),
              "blue": ((100, 130),), "green": ((40, 80),)}


# ---------------------------------------------------------------------------
# Ingest
# ---------------------------------------------------------------------------

def rgb_to_hsv(x: torch.Tensor):
    """(..., 3) RGB in [0, 255] -> h in [0, 180), s and v in [0, 256),
    in ``x``'s dtype, one rounding per operation."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    c = v - torch.minimum(torch.minimum(r, g), b)
    s = torch.where(v > 0, c / torch.clamp_min(v, 1e-9) * 255.0,
                    torch.zeros_like(v))
    hc = torch.where(c > 0, c, torch.ones_like(c))
    m = torch.fmod((g - b) / hc, 6.0)
    m = torch.where((m != 0) & (m < 0), m + 6.0, m)     # floor-mod 6
    h = torch.where(v == r, m, torch.where(v == g, (b - r) / hc + 2.0,
                                           (r - g) / hc + 4.0))
    h = torch.where(c > 0, h * 30.0, torch.zeros_like(h))
    return h, s, v


@dataclass(frozen=True)
class IngestQuery:
    """The query's feature and background constants."""
    colors: Tuple[str, ...]
    op: str = "or"
    bs: int = 8
    bv: int = 8
    alpha: float = 0.05
    threshold: float = 18.0
    use_foreground: bool = True


def _bbox(fg: torch.Tensor, width: int) -> torch.Tensor:
    """(..., N) bool -> (..., 4) int32 inclusive (row_min, row_max,
    col_min, col_max) of the set pixels, all -1 where there is none."""
    n = fg.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=fg.device)
    rows, cols = idx // width, idx % width
    big, neg = n, -1
    out = torch.stack([torch.where(fg, rows, big).amin(-1),
                       torch.where(fg, rows, neg).amax(-1),
                       torch.where(fg, cols, big).amin(-1),
                       torch.where(fg, cols, neg).amax(-1)], -1)
    return torch.where(fg.any(-1)[..., None], out, neg).to(torch.int32)


def ingest(frames: torch.Tensor, bg: torch.Tensor, gain: torch.Tensor,
           M_pos: torch.Tensor, norm: torch.Tensor, q: IngestQuery, *,
           width: int = 0, dtype: torch.dtype = torch.float32):
    """One camera batch through the ingest, ``BLOCK`` cameras at a time.

    frames: (C, T, H, W, 3) uint8 (or float) on the device; bg (C, H*W)
    and gain (C,) the carried state; M_pos (nc, bs*bv) and norm (nc,) the
    utility model. Returns (utility (C, T) float32, bg' (C, N) float32,
    gain' (C,) float32, bbox (C, T, 4) int32 or None)."""
    C, T = frames.shape[:2]
    N = frames.shape[2] * frames.shape[3]
    nb = q.bs * q.bv
    dev = frames.device
    sum_dtype = torch.float64 if dtype == torch.float32 else dtype
    M = M_pos.to(dev, dtype).reshape(len(q.colors), nb)
    nrm = torch.clamp_min(norm.to(dev, dtype), 1e-9)
    utils, bgs, gains, boxes = [], [], [], []
    for c0 in range(0, C, BLOCK):
        c1 = min(C, c0 + BLOCK)
        cb = c1 - c0
        x = frames[c0:c1].reshape(cb, T, N, 3).to(dtype)
        h, s, v = rgb_to_hsv(x)
        del x
        b = bg[c0:c1].to(dtype)
        g = gain[c0:c1].to(dtype)
        fgs = []
        for t in range(T):
            vt = v[:, t]
            gt = torch.clamp(g, GAIN_MIN, GAIN_MAX)
            comp = vt / gt[:, None]
            fgs.append(torch.abs(comp - b) > q.threshold
                       if q.use_foreground else torch.ones_like(vt, dtype=torch.bool))
            sv = vt.to(sum_dtype).sum(-1).to(dtype)
            sb = b.to(sum_dtype).sum(-1).to(dtype)
            g = torch.clamp(sv / torch.clamp_min(sb, 1e-6), GAIN_MIN, GAIN_MAX)
            b = (1.0 - q.alpha) * b + q.alpha * comp
        fg = torch.stack(fgs, 1)                               # (cb, T, N)
        del fgs
        sbin = torch.clamp((s * (q.bs / 256.0)).to(torch.int32), 0, q.bs - 1)
        vbin = torch.clamp((v * (q.bv / 256.0)).to(torch.int32), 0, q.bv - 1)
        joint = (sbin * q.bv + vbin).to(torch.int64)
        del sbin, vbin, s, v
        frame = torch.arange(cb * T, device=dev).reshape(cb, T, 1) * nb
        us = []
        for ci, color in enumerate(q.colors):
            hue = torch.zeros_like(fg)
            for lo, hi in HUE_RANGES[color]:
                hue |= (h >= lo) & (h < hi)
            w = hue & fg
            counts = torch.bincount((frame + joint)[w], minlength=cb * T * nb)
            counts = counts.reshape(cb, T, nb).to(dtype)
            pf = counts / torch.clamp_min(counts.sum(-1, keepdim=True), 1)
            us.append((pf * M[ci]).sum(-1) / nrm[ci])
        u = torch.stack(us, -1)
        utils.append((u.amin(-1) if q.op == "and" else u.amax(-1)).float())
        bgs.append(b.float())
        gains.append(g.float())
        if width:
            boxes.append(_bbox(fg, width))
        del h, fg, joint
    return (torch.cat(utils), torch.cat(bgs), torch.cat(gains),
            torch.cat(boxes) if width else None)


def train_utility_model(pfs: np.ndarray, labels: np.ndarray):
    """Eq. 12: each colour's M_pos is the mean PF of its positive frames,
    its norm the largest training utility. pfs (n, nc, nb); labels (n,)."""
    pfs = np.asarray(pfs, np.float32)
    pos = np.asarray(labels) > 0
    nc = pfs.shape[1]
    M_pos = np.zeros(pfs.shape[1:], np.float32)
    norm = np.ones((nc,), np.float32)
    for ci in range(nc):
        if pos.any():
            M_pos[ci] = pfs[pos, ci].mean(axis=0)
        norm[ci] = float(np.sum(pfs[:, ci] * M_pos[ci], axis=-1).max())
    return M_pos, norm


def pf_matrices(frames: torch.Tensor, q: IngestQuery) -> torch.Tensor:
    """(C, T, H, W, 3) clips -> (C, T, nc, nb) PF matrices, the background
    seeded from each clip's frame 0 (whose PFs are then all 0)."""
    C, T = frames.shape[:2]
    N = frames.shape[2] * frames.shape[3]
    nb = q.bs * q.bv
    x = frames.reshape(C, T, N, 3).to(torch.float32)
    h, s, v = rgb_to_hsv(x)
    b, g = v[:, 0].clone(), torch.ones(C, device=x.device)
    fgs = []
    for t in range(T):
        comp = v[:, t] / torch.clamp(g, GAIN_MIN, GAIN_MAX)[:, None]
        fgs.append(torch.abs(comp - b) > q.threshold)
        g = torch.clamp((v[:, t].double().sum(-1) / torch.clamp_min(
            b.double().sum(-1), 1e-6)).float(), GAIN_MIN, GAIN_MAX)
        b = (1.0 - q.alpha) * b + q.alpha * comp
    fg = torch.stack(fgs, 1)
    joint = (torch.clamp((s * (q.bs / 256.0)).to(torch.int32), 0, q.bs - 1)
             * q.bv + torch.clamp((v * (q.bv / 256.0)).to(torch.int32), 0,
                                  q.bv - 1)).to(torch.int64)
    frame = torch.arange(C * T, device=x.device).reshape(C, T, 1) * nb
    out = []
    for color in q.colors:
        hue = torch.zeros_like(fg)
        for lo, hi in HUE_RANGES[color]:
            hue |= (h >= lo) & (h < hi)
        counts = torch.bincount((frame + joint)[hue & fg],
                                minlength=C * T * nb).reshape(C, T, nb).float()
        out.append(counts / torch.clamp_min(counts.sum(-1, keepdim=True), 1))
    return torch.stack(out, 2)


# ---------------------------------------------------------------------------
# Stage-2 scorer
# ---------------------------------------------------------------------------

def score(frames: torch.Tensor, bboxes: torch.Tensor,
          params: Dict[str, torch.Tensor], roi: int, *,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) frames and (B, 4) int32 bboxes -> (B,) float32 scores.
    Empty bboxes (all -1) crop the whole frame and have zero geometry."""
    B, H, W = frames.shape[:3]
    dev = frames.device
    if B == 0:
        return torch.zeros((0,), dtype=torch.float32, device=dev)
    bb = bboxes.to(dev, torch.int32)
    empty = bb[:, 1] < 0
    r0 = torch.where(empty, 0, bb[:, 0])
    r1 = torch.where(empty, H - 1, bb[:, 1])
    c0 = torch.where(empty, 0, bb[:, 2])
    c1 = torch.where(empty, W - 1, bb[:, 3])
    t = (torch.arange(roi, dtype=torch.float32, device=dev) + 0.5) / \
        torch.tensor(float(roi), dtype=torch.float32, device=dev)
    ys = r0[:, None] + torch.floor(t[None] * (r1 - r0 + 1)[:, None]).to(torch.int32)
    xs = c0[:, None] + torch.floor(t[None] * (c1 - c0 + 1)[:, None]).to(torch.int32)
    ys = torch.clamp(ys, 0, H - 1).long()
    xs = torch.clamp(xs, 0, W - 1).long()
    crops = frames[torch.arange(B, device=dev)[:, None, None],
                   ys[:, :, None], xs[:, None, :]].to(dtype)
    h, s, v = rgb_to_hsv(crops)
    ang = h * (2.0 * math.pi / 180.0)
    f = torch.stack([torch.cos(ang) * (s / 255.0), torch.sin(ang) * (s / 255.0),
                     v / 255.0], -1)
    f32 = lambda n: torch.tensor(float(n), dtype=torch.float32, device=dev)
    hf = (r1 - r0 + 1).float() / f32(H)
    wf = (c1 - c0 + 1).float() / f32(W)
    geo = torch.where(empty[:, None], 0.0,
                      torch.stack([hf, wf, hf * wf, torch.ones_like(hf)], -1))
    mm = torch.float64 if dtype == torch.float32 else dtype
    x = torch.cat([f.reshape(B, -1).to(mm), geo.to(mm)], -1)
    hid = torch.tanh(x @ params["w1"].to(mm) + params["b1"].to(mm))
    logit = (hid @ params["w2"].to(mm) + params["b2"].to(mm))[:, 0]
    return (0.5 * (1.0 + logit / (8.0 + torch.abs(logit)))).float()


# ---------------------------------------------------------------------------
# Control plane (host, float32 semantics)
# ---------------------------------------------------------------------------

def fkey(u) -> np.ndarray:
    """uint32 keys ascending in the float32 total order (-0 below +0)."""
    ub = np.ascontiguousarray(u, np.float32).view(np.uint32)
    return np.where(ub >> 31 == 1, ~ub, ub | np.uint32(0x80000000))


def key(u) -> int:
    """``fkey`` of one float32 value, as a Python int."""
    return int(fkey(np.float32(u)).reshape(-1)[0])


def bucket(u, lo: float, inv_width: float, bins: int) -> np.ndarray:
    b = np.floor((np.asarray(u, F32) - F32(lo)) * F32(inv_width))
    return np.clip(b.astype(np.int32), 0, bins - 1)


def recount(buf: np.ndarray, ln: np.ndarray, lo: float, inv_width: float,
            bins: int) -> np.ndarray:
    """(C, bins) counts of each ring's live slots [0, len)."""
    out = np.zeros((buf.shape[0], bins), np.int32)
    for c in range(buf.shape[0]):
        np.add.at(out[c], bucket(buf[c, :ln[c]], lo, inv_width, bins), 1)
    return out


def bucket_thresholds(counts, n, rates, lo: float, width: float):
    """Eq. 17 on bucket counts: the upper edge of the bucket that holds
    the rank-ceil(r*n) entry; -inf for an empty window or r <= 0."""
    n = np.asarray(n, np.int32)
    r = np.asarray(rates, F32)
    k = np.ceil(np.minimum(r, F32(1.0)) * n.astype(F32)).astype(np.int32)
    k = np.clip(k, 1, np.maximum(n, 1))
    b = np.minimum((np.cumsum(counts, -1) < k[:, None]).sum(-1),
                   counts.shape[1] - 1).astype(np.int32)
    th = F32(lo) + (b + 1).astype(F32) * F32(width)
    th[(n == 0) | (r <= 0)] = -np.inf
    return th.astype(F32)


@dataclass
class ControlConfig:
    cdf_window: int = 4096
    queue_size: int = 8
    queue_capacity: int = 64
    bins: int = 256
    lo: float = 0.0
    hi: float = 1.0
    s2_lo: float = -1.0
    s2_hi: float = 1.0
    s2_window: int = 1024
    ewma_alpha: float = 0.2
    ewma_alpha_up: float = 0.6
    min_proc: float = 1e-6
    latency_bound: float = 1.0
    fps: float = 10.0
    gate_fraction: Optional[float] = None      # None: single stage


class ControlPlane:
    """The control plane's state and steps on the host. The queues are
    per-camera lists of ``(utility, seq)``; their order carries no
    meaning. Fields named as the session state's leaves hold the same
    quantities."""

    def __init__(self, cfg: ControlConfig, C: int):
        self.cfg, self.C = cfg, C
        W, W2 = cfg.cdf_window, cfg.s2_window
        self.cdf_buf = np.zeros((C, W), F32)
        self.cdf_len = np.zeros(C, np.int32)
        self.cdf_pos = np.zeros(C, np.int32)
        self.threshold = np.full(C, -np.inf, F32)
        self.proc_q = np.zeros(C, F32)
        self.proc_seen = np.zeros(C, bool)
        self.fps_obs = np.full(C, cfg.fps, F32)
        self.fps_seen = np.zeros(C, bool)
        self.queue_cap = np.full(C, cfg.queue_size, np.int32)
        self.queues: List[List[Tuple[float, int]]] = [[] for _ in range(C)]
        self.q_next_seq = np.zeros(C, np.int32)
        self.active = np.ones(C, bool)
        self.rate_floor = np.zeros(C, F32)
        self.s2_buf = np.zeros((C, W2), F32)
        self.s2_len = np.zeros(C, np.int32)
        self.s2_pos = np.zeros(C, np.int32)
        self.s2_threshold = np.full(C, -np.inf, F32)

    @property
    def K(self) -> int:
        return max(self.cfg.queue_capacity, self.cfg.queue_size, 1)

    # -- state in and out ---------------------------------------------------

    LEAVES = ("cdf_buf", "cdf_len", "cdf_pos", "threshold", "proc_q",
              "proc_seen", "fps_obs", "fps_seen", "queue_cap", "q_next_seq",
              "active", "rate_floor", "s2_buf", "s2_len", "s2_pos",
              "s2_threshold")

    @classmethod
    def from_leaves(cls, cfg: ControlConfig, leaves: Dict[str, np.ndarray]):
        """Adopt a state given as the session's leaves (host arrays)."""
        cp = cls(cfg, leaves["threshold"].shape[0])
        for name in cls.LEAVES:
            setattr(cp, name, np.array(leaves[name]))
        cp.queues = queues_of(leaves["q_util"], leaves["q_seq"])
        return cp

    def counts(self) -> np.ndarray:
        c = self.cfg
        return recount(self.cdf_buf, self.cdf_len, c.lo, c.bins / (c.hi - c.lo),
                       c.bins)

    def s2_counts(self) -> np.ndarray:
        c = self.cfg
        return recount(self.s2_buf, self.s2_len, c.s2_lo,
                       c.bins / (c.s2_hi - c.s2_lo), c.bins)

    # -- feeds --------------------------------------------------------------

    def seed_cdf(self, us: np.ndarray) -> None:
        us = np.asarray(us, F32).reshape(-1)
        self._push(np.broadcast_to(us, (self.C, us.size)), None, "cdf")

    def report_backend_latency(self, lat: float) -> None:
        cfg = self.cfg
        x = F32(max(float(lat), cfg.min_proc))
        q = self.proc_q
        a = np.where(x > q, cfg.ewma_alpha_up, cfg.ewma_alpha)
        ew = (q.astype(np.float64) + a * (x - q).astype(F32).astype(np.float64)
              ).astype(F32)
        self.proc_q = np.where(self.proc_seen, ew, x).astype(F32)
        self.proc_seen = np.ones(self.C, bool)

    # -- the step -----------------------------------------------------------

    def _push(self, us, mask, ring: str) -> None:
        buf, pos, ln = (getattr(self, f"{ring}_{k}") for k in ("buf", "pos", "len"))
        W = buf.shape[1]
        us = np.asarray(us, F32)
        for c in range(self.C):
            vals = us[c] if mask is None else us[c][mask[c]]
            vals = vals[-W:]
            k = vals.size
            buf[c, (pos[c] + np.arange(k)) % W] = vals
            pos[c] = (pos[c] + k) % W
            ln[c] = min(ln[c] + k, W)

    def _queue_push(self, util, admit, decisions):
        """Sequential pushes of the admitted frames, each camera's queue
        cut to its cap by evicting the least (utility, seq). Returns
        (pushed_seq (C, T), evicted resident seqs per camera)."""
        C, T = util.shape
        pushed = np.full((C, T), -1, np.int32)
        evicted = []
        for c in range(C):
            cap = int(np.clip(self.queue_cap[c], 1, self.K))
            q = [(F32(u), s, -1) for u, s in self.queues[c]]
            ev = []
            for t in np.flatnonzero(admit[c]):
                s = int(self.q_next_seq[c])
                self.q_next_seq[c] += 1
                pushed[c, t] = s
                q.append((F32(util[c, t]), s, int(t)))
                if len(q) > cap:
                    worst = min(q, key=lambda e: (key(e[0]), e[1]))
                    q.remove(worst)
                    if worst[2] >= 0:
                        decisions[c, worst[2]] = SHED_QUEUE
                    else:
                        ev.append(worst[1])
            self.queues[c] = [(u, s) for u, s, _ in q]
            evicted.append(ev)
        return pushed, evicted

    def _rates(self):
        cfg = self.cfg
        p = np.maximum(self.proc_q, F32(cfg.min_proc))
        denom = p * F32(self.C) * np.maximum(self.fps_obs, F32(1e-9))
        r = np.clip(F32(1.0) - F32(1.0) / denom, F32(0), F32(1)).astype(F32)
        r = np.maximum(r, self.rate_floor)
        return p, np.where(self.active, r, F32(0)).astype(F32)

    def _tick(self, evicted):
        cfg = self.cfg
        p, rates = self._rates()
        bw = (cfg.hi - cfg.lo) / cfg.bins
        if cfg.gate_fraction is None:
            th = bucket_thresholds(self.counts(), self.cdf_len, rates, cfg.lo, bw)
        else:
            g = F32(cfg.gate_fraction)
            r1 = (rates * g).astype(F32)
            r2 = ((rates - r1) / np.maximum(F32(1.0) - r1, F32(1e-9))).astype(F32)
            th = bucket_thresholds(self.counts(), self.cdf_len, r1, cfg.lo, bw)
            th2 = bucket_thresholds(self.s2_counts(), self.s2_len, r2, cfg.s2_lo,
                                    (cfg.s2_hi - cfg.s2_lo) / cfg.bins)
            self.s2_threshold = np.where(self.active, th2, F32(np.inf)).astype(F32)
        self.threshold = np.where(self.active, th, F32(np.inf)).astype(F32)
        budget = F32(cfg.latency_bound)
        cap = np.maximum((budget / p + F32(1e-9)).astype(np.int32) - 1, 1)
        self.queue_cap = cap.astype(np.int32)
        for c in range(self.C):
            keep = int(np.clip(cap[c], 1, self.K))
            q = sorted(self.queues[c], key=lambda e: (key(e[0]), e[1]))
            evicted[c].extend(s for _, s in q[:max(0, len(q) - keep)])
            self.queues[c] = q[max(0, len(q) - keep):]
        return rates

    def step(self, util, *, tick: bool = True):
        """Single-stage step on (C, T) utilities."""
        util = np.asarray(util, F32)
        self._push(util, None, "cdf")
        admit = ~(util < self.threshold[:, None])
        decisions = np.where(admit, ADMIT, SHED_ADMISSION).astype(np.int8)
        pushed, evicted = self._queue_push(util, admit, decisions)
        rates = self._tick(evicted) if tick else None
        return decisions, pushed, evicted, rates

    def gate(self, util) -> np.ndarray:
        """Cascade phase A: stage-1 ring push, then the colour gate's
        survivors (C, T) bool."""
        util = np.asarray(util, F32)
        self._push(util, None, "cdf")
        return ~(util < self.threshold[:, None])

    def finish(self, s2, pass1, *, tick: bool = True):
        """Cascade phase B on the (C, T) stage-2 scores of the survivors."""
        s2 = np.asarray(s2, F32)
        self._push(s2, pass1, "s2")
        admit = pass1 & ~(s2 < self.s2_threshold[:, None])
        decisions = np.where(admit, ADMIT, np.where(pass1, SHED_CASCADE,
                                                    SHED_ADMISSION)).astype(np.int8)
        pushed, evicted = self._queue_push(s2, admit, decisions)
        rates = self._tick(evicted) if tick else None
        return decisions, pushed, evicted, rates

    def pop_topk(self, k: int) -> List[Tuple[int, int]]:
        """The k best queued entries, by utility (+0 and -0 alike), then
        camera, then seq; removed from the queues. Returns (cam, seq)."""
        ent = [(-key(F32(u) + F32(0.0)), c, s)
               for c in range(self.C) for u, s in self.queues[c]]
        out = [(c, s) for _, c, s in sorted(ent)[:k]]
        gone = set(out)
        for c in range(self.C):
            self.queues[c] = [e for e in self.queues[c] if (c, e[1]) not in gone]
        return out


def queues_of(q_util: np.ndarray, q_seq: np.ndarray) -> List[List[Tuple[float, int]]]:
    """(C, K) lanes -> per-camera lists of (utility, seq) of live slots."""
    return [[(F32(u), int(s)) for u, s in zip(q_util[c], q_seq[c]) if s >= 0]
            for c in range(q_util.shape[0])]


def queue_set(queue) -> set:
    """A queue as a set of (utility bits, seq)."""
    return {(int(np.asarray(u, F32).view(np.uint32)), int(s)) for u, s in queue}

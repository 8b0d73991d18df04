"""Stand-ins for the program, for the control and the planted faults.

``RefProgram`` is the reference put in the program's place: the ingest of
``yardstick.reference`` in ``dtype`` (bfloat16 for the control), its
control plane and its scorer, behind the session's interface (``state``,
``cascade.scorer``, ``report_backend_latency``, ``step``,
``next_frames``). ``fault`` plants one of the faults a run must catch:

* ``stale`` — a step that returns its state unchanged;
* ``half`` — half of the batch left out: the second half of the cameras
  is not ingested, each of its frames gets the mean utility of the rest,
  and its background stays as it was;
* ``flip`` — an answer altered where it is produced: one decision of
  every step is changed.

``flip_program`` plants ``flip`` in the real program, and ``flip_sent``
changes one frame of what every ``next_frames`` of the real program
sends.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from yardstick import reference as ref

from .check import control_config
from .inputs import ingest_query

FAULTS = ("stale", "half", "flip")


def _flip(decisions: np.ndarray) -> np.ndarray:
    d = np.array(decisions, copy=True)
    d[0, 0] = ref.SHED_ADMISSION if d[0, 0] == ref.ADMIT else ref.ADMIT
    return d


class RefScorer:
    def __init__(self, params, roi: int, dtype):
        self.params, self.roi_size, self.dtype = params, roi, dtype

    def score(self, frames, bboxes):
        return ref.score(frames, bboxes, self.params, self.roi_size,
                         dtype=self.dtype)


class RefProgram:
    def __init__(self, cfg, inputs, cameras: int, device, *,
                 dtype=torch.bfloat16, fault: Optional[str] = None):
        if fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.dtype, self.fault = cfg, dtype, fault
        self.q = ingest_query(cfg)
        self.cp = ref.ControlPlane(control_config(cfg), cameras)
        self.cp.seed_cdf(inputs.train_utilities)
        H, W = cfg["frame_shape"]
        self.width = W if cfg.get("cascade") else 0
        self.bg = torch.zeros((cameras, H * W), device=device)
        self.gain = torch.ones(cameras, device=device)
        self.bg_valid = False
        self.M = torch.as_tensor(inputs.M_pos, device=device)
        self.norm = torch.as_tensor(inputs.norm, device=device)
        self.payloads = {}
        self.cascade = (SimpleNamespace(scorer=RefScorer(
            inputs.scorer, cfg["cascade"]["roi_size"], dtype))
            if cfg.get("cascade") else None)

    @property
    def state(self):
        cp, K = self.cp, self.cp.K
        q_util = np.full((cp.C, K), -np.inf, np.float32)
        q_seq = np.full((cp.C, K), -1, np.int32)
        for c, queue in enumerate(cp.queues):
            for j, (u, s) in enumerate(queue):
                q_util[c, j], q_seq[c, j] = u, s
        leaves = {n: getattr(cp, n) for n in ref.ControlPlane.LEAVES}
        leaves.update(cdf_counts=cp.counts(), s2_counts=cp.s2_counts(),
                      q_util=q_util, q_seq=q_seq)
        out = {k: torch.as_tensor(np.array(v)) for k, v in leaves.items()}
        return SimpleNamespace(bg=self.bg, gain=self.gain, **out)

    def report_backend_latency(self, lat: float) -> None:
        self.cp.report_backend_latency(lat)

    def _ingest(self, frames):
        if not self.bg_valid:          # frame 0 seeds the background
            x = frames[:, 0].reshape(frames.shape[0], -1, 3).float()
            self.bg = x.amax(-1)
            self.bg_valid = True
        n = frames.shape[0] if self.fault != "half" else frames.shape[0] // 2
        u, bg, gain, bbox = ref.ingest(frames[:n], self.bg[:n], self.gain[:n],
                                       self.M, self.norm, self.q,
                                       width=self.width, dtype=self.dtype)
        if n < frames.shape[0]:
            rest = frames.shape[0] - n
            u = torch.cat([u, u.mean().expand(rest, u.shape[1])])
            bg = torch.cat([bg, self.bg[n:]])
            gain = torch.cat([gain, self.gain[n:]])
            if bbox is not None:
                bbox = torch.cat([bbox, bbox.new_full((rest,) + bbox.shape[1:], -1)])
        return u, bg, gain, bbox

    def step(self, frames, tick: bool = True, items=None):
        saved = (copy.deepcopy(self.cp), self.bg, self.gain)
        u, self.bg, self.gain, bbox = self._ingest(frames)
        util = u.cpu().numpy()
        s2 = None
        if self.cascade is not None:
            pass1 = self.cp.gate(util)
            s2 = np.zeros(util.shape, np.float32)
            r, t = np.nonzero(pass1)
            if r.size:
                rt = (torch.as_tensor(r, device=frames.device),
                      torch.as_tensor(t, device=frames.device))
                s2[r, t] = self.cascade.scorer.score(frames[rt], bbox[rt]).cpu().numpy()
            dec, pushed, evicted, rates = self.cp.finish(s2, pass1, tick=tick)
        else:
            dec, pushed, evicted, rates = self.cp.step(util, tick=tick)
        for c, t in zip(*np.nonzero(dec == ref.ADMIT)):
            self.payloads[(int(c), int(pushed[c, t]))] = (
                items[c][t] if items is not None else (int(c), int(t)))
        if self.fault == "stale":
            self.cp, self.bg, self.gain = saved
        if self.fault == "flip":
            dec = _flip(dec)
        return SimpleNamespace(decisions=dec, pushed_seq=pushed,
                               evicted=[np.asarray(e, np.int64) for e in evicted],
                               target_drop_rate=rates, s2_scores=s2)

    def next_frames(self, k: int):
        return [self.payloads.pop(cs, cs) for cs in self.cp.pop_topk(k)]


def flip_program(open_program):
    """``open_program`` with the ``flip`` fault planted in its sessions:
    one decision of every step's result is changed."""
    def make(cfg, inputs, cameras, device):
        session = open_program(cfg, inputs, cameras, device)
        step = session.step

        def flipped(*a, **kw):
            res = step(*a, **kw)
            return dataclasses.replace(res, decisions=_flip(res.decisions))
        session.step = flipped
        return session
    return make


def flip_sent(open_program):
    """``open_program`` whose sessions' ``next_frames`` send, in place of
    their first frame, the frame after it by id."""
    def make(cfg, inputs, cameras, device):
        session = open_program(cfg, inputs, cameras, device)
        pop = session.next_frames

        def altered(*a, **kw):
            out = list(pop(*a, **kw))
            if out:
                out[0] = out[0] + 1
            return out
        session.next_frames = altered
        return session
    return make


VARIANTS = ("bf16",) + FAULTS + ("flip_program", "flip_sent")


def make_variant(name: str):
    """The ``make_program`` of a variant: the bfloat16 control, a fault
    planted in the float32 reference, or one planted in the program."""
    from .program import open_program
    if name == "bf16":
        return functools.partial(RefProgram, dtype=torch.bfloat16)
    if name == "flip_program":
        return flip_program(open_program)
    if name == "flip_sent":
        return flip_sent(open_program)
    if name not in FAULTS:
        raise ValueError(f"unknown variant {name!r}; known: {VARIANTS}")
    return functools.partial(RefProgram, dtype=torch.float32, fault=name)

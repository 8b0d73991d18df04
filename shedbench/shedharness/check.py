"""Decide ``correct``: the sampled steps of the window, replayed by the
reference from the program's own state before each of them.

For each sampled step the reference
* runs the ingest on the step's frames from the program's background and
  gain before the step, and compares the utilities the program pushed
  into its CDF rings, its background and its gains after the step
  (``util_gap``, ``bg_gap``, ``gain_gap``; with the cascade, the stage-2
  scores, ``s2_gap``, from the reference's own bounding boxes);
* replays the control plane on the program's utilities (and stage-2
  scores) from the program's state before the step — latency EWMA, ring
  push, gates, queue pushes, tick — and counts every decision, queue seq,
  eviction, rate, threshold, cap, ring slot, bucket count and queue entry
  that differs from the program's;
* pops what the backend takes from the program's state after the step,
  and counts the frames sent and the queue entries left that differ.
The session's state when opened is held to the reference's own, and its
differing entries are counted too. ``control_mismatches`` is the sum of
these counts; it is an exact comparison, with the limit 0. The gaps have
their limits in the configuration.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from yardstick import reference as ref
from yardstick.reference import ControlConfig, ControlPlane

from .inputs import ingest_query


def control_config(cfg) -> ControlConfig:
    s, q, cs = cfg["session"], cfg["query"], cfg.get("cascade")
    kw = dict(cdf_window=s["cdf_window"], queue_size=s["queue_size"],
              queue_capacity=s["queue_capacity"], bins=s["quantile_bins"],
              lo=s["quantile_range"][0], hi=s["quantile_range"][1],
              ewma_alpha=s["ewma_alpha"], ewma_alpha_up=s["ewma_alpha_up"],
              min_proc=s["min_proc"], latency_bound=q["latency_bound"],
              fps=q["fps"])
    if cs:
        kw.update(s2_lo=cs["s2_quantile_range"][0],
                  s2_hi=cs["s2_quantile_range"][1], s2_window=cs["window"],
                  gate_fraction=cs["gate_fraction"])
    else:
        kw.update(s2_window=64)
    return ControlConfig(**kw)


def _host(snap: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in snap.items() if k != "bg"}


def _differ(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size, 1)
    if a.dtype == np.float32 or b.dtype == np.float32:
        return int((a.astype(np.float32).view(np.uint32)
                    != b.astype(np.float32).view(np.uint32)).sum())
    return int((a != b).sum())


def _gap(a, b) -> float:
    """Largest |a - b|; equal entries (infinities too) count 0, and a NaN
    on either side counts as infinitely far."""
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).to(a.device).double()
    d = torch.where(a == b, 0.0, (a - b).abs())
    return float("inf") if bool(torch.isnan(d).any()) else float(d.max())


def state_mismatches(cp: ControlPlane, leaves: Dict[str, np.ndarray]) -> int:
    """Entries of the program's state that differ from the reference's:
    every control leaf, the bucket counts (against a recount of the
    reference's rings) and each camera's queue as a set."""
    n = sum(_differ(getattr(cp, name), leaves[name])
            for name in ControlPlane.LEAVES)
    n += _differ(cp.counts(), leaves["cdf_counts"])
    if cp.cfg.gate_fraction is not None:
        n += _differ(cp.s2_counts(), leaves["s2_counts"])
    prog = ref.queues_of(leaves["q_util"], leaves["q_seq"])
    n += sum(len(ref.queue_set(a) ^ ref.queue_set(b))
             for a, b in zip(cp.queues, prog))
    return n


def start_reference(cfg, cameras: int, train_utilities) -> ControlPlane:
    cp = ControlPlane(control_config(cfg), cameras)
    cp.seed_cdf(train_utilities)
    return cp


def frame_ids(pushed: List[np.ndarray], C: int, T: int) -> Dict:
    """(camera, queue seq) -> the id the harness gave the frame (its
    payload), from every step's ``pushed_seq``."""
    out = {}
    for k, ps in enumerate(pushed):
        c, t = np.nonzero(ps >= 0)
        ids = k * C * T + c * T + t
        out.update(zip(zip(c.tolist(), ps[c, t].tolist()), ids.tolist()))
    return out


def check(window, inputs, cfg, traffic, device) -> Dict[str, Dict]:
    """The numbers compared, each ``{"value", "limit", "rule"}``."""
    C, T = traffic["cameras"], traffic["frames_per_step"]
    ccfg = control_config(cfg)
    q = ingest_query(cfg)
    cs = cfg.get("cascade")
    M = torch.as_tensor(inputs.M_pos, device=device)
    norm = torch.as_tensor(inputs.norm, device=device)
    width = cfg["frame_shape"][1] if cs else 0

    start = start_reference(cfg, C, inputs.train_utilities)
    start_mis = state_mismatches(start, window.start)
    start_mis += _differ(np.ones(C, np.float32), window.start["gain"])

    ids = frame_ids(window.pushed, C, T)
    util_gap = bg_gap = gain_gap = s2_gap = 0.0
    control_mis = sent_mis = 0
    for s in window.samples:
        pre, post, pop = _host(s.pre), _host(s.post), _host(s.pop)
        res = s.result
        frames = inputs.pool[s.batch]
        u_ref, bg_ref, gain_ref, bbox = ref.ingest(
            frames, s.pre["bg"], s.pre["gain"], M, norm, q, width=width)
        W = ccfg.cdf_window
        slots = (pre["cdf_pos"][:, None] + np.arange(T)[None]) % W
        util = np.take_along_axis(post["cdf_buf"], slots, 1)
        util_gap = max(util_gap, _gap(util, u_ref.cpu()))
        bg_gap = max(bg_gap, _gap(s.post["bg"], bg_ref))
        gain_gap = max(gain_gap, _gap(s.post["gain"], gain_ref))
        del bg_ref

        cp = ControlPlane.from_leaves(ccfg, pre)
        cp.report_backend_latency(s.latency)
        tick = bool(traffic["tick"])
        if cs:
            pass1 = cp.gate(util)
            r, t = np.nonzero(pass1)
            want = np.zeros((C, T), np.float32)
            if r.size:
                rt = (torch.as_tensor(r, device=device),
                      torch.as_tensor(t, device=device))
                want[r, t] = ref.score(frames[rt], bbox[rt], inputs.scorer,
                                       cs["roi_size"]).cpu().numpy()
            s2 = np.asarray(res.s2_scores, np.float32)
            s2_gap = max(s2_gap, _gap(s2, want))
            dec, pushed, evicted, rates = cp.finish(s2, pass1, tick=tick)
        else:
            dec, pushed, evicted, rates = cp.step(util, tick=tick)
        control_mis += _differ(dec, res.decisions)
        control_mis += _differ(pushed, res.pushed_seq)
        control_mis += sum(len(set(a) ^ set(np.asarray(b).tolist()))
                           for a, b in zip(evicted, res.evicted))
        if tick:
            control_mis += _differ(rates, res.target_drop_rate)
        control_mis += state_mismatches(cp, post)

        after = ControlPlane.from_leaves(ccfg, post)
        sent = [ids.get(cs_, -1) for cs_ in after.pop_topk(traffic["send_per_step"])]
        got = [int(x) if np.ndim(x) == 0 else -1 for x in s.sent]
        sent_mis += abs(len(sent) - len(got)) + sum(
            a != b for a, b in zip(sent, got))
        sent_mis += sum(len(ref.queue_set(a) ^ ref.queue_set(b)) for a, b in
                        zip(after.queues, ref.queues_of(pop["q_util"],
                                                        pop["q_seq"])))
    lim = cfg["limits"]
    out = {"checked_steps": {"value": len(window.samples), "limit": 1,
                             "rule": ">="},
           "util_gap": {"value": util_gap, "limit": lim["util_gap"], "rule": "<="},
           "bg_gap": {"value": bg_gap, "limit": lim["bg_gap"], "rule": "<="},
           "gain_gap": {"value": gain_gap, "limit": lim["gain_gap"], "rule": "<="}}
    if cs:
        out["s2_gap"] = {"value": s2_gap, "limit": lim["s2_gap"], "rule": "<="}
    out["control_mismatches"] = {"value": start_mis + control_mis + sent_mis,
                                 "limit": 0, "rule": "<="}
    return out


def passed(numbers: Dict[str, Dict]) -> bool:
    return all(n["value"] >= n["limit"] if n["rule"] == ">=" else
               n["value"] <= n["limit"] for n in numbers.values())

"""The cell's inputs, made from ``--seed``: the frame pool on the device,
the utility model and its training utilities, and the stage-2 scorer's
weights. The same inputs go to the program and to the reference.

The traffic's clips come from a library fixed by the traffic file's
``library_seed``; the run's seed deals them out to the cameras. So every
seed gives the program the same frames, and so the same work, in another
order (the backend latencies, in ``window``, likewise)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from yardstick import reference as ref

from .render import render_clips


@dataclass
class Inputs:
    pool: List[torch.Tensor]            # step batches (C, T, H, W, 3) uint8
    pool_bytes: int
    M_pos: np.ndarray                   # (nc, bs, bv) float32
    norm: np.ndarray                    # (nc,) float32
    train_utilities: np.ndarray         # (C * clip_frames,) float32
    scorer: Optional[Dict[str, torch.Tensor]]


def ingest_query(cfg) -> ref.IngestQuery:
    q = cfg["query"]
    return ref.IngestQuery(colors=tuple(q["colors"]), op=q["op"], bs=q["bs"],
                           bv=q["bv"], alpha=q["alpha"],
                           threshold=q["threshold"],
                           use_foreground=q["use_foreground"])


def make_inputs(cfg, traffic, seed: int, device) -> Inputs:
    C, T, L = traffic["cameras"], traffic["frames_per_step"], traffic["clip_frames"]
    up = traffic["upsample"]
    h, w = traffic["render"]
    if [h * up, w * up] != list(cfg["frame_shape"]) or L % T:
        raise ValueError("traffic does not fit the configuration's frames")
    q = ingest_query(cfg)
    clips, labels = render_clips(cfg, traffic)
    small = torch.as_tensor(clips, device=device)
    # the utility model, trained offline as a deployment would: Eq. 12 on
    # the library's PF matrices and labels; its training utilities seed
    # the CDF windows
    pfs = ref.pf_matrices(small, q).reshape(C * L, len(q.colors), -1)
    pfs = pfs.cpu().numpy()
    M_pos, norm = ref.train_utility_model(pfs, labels.reshape(-1))
    u = (pfs * M_pos[None]).sum(-1) / np.maximum(norm, np.float32(1e-9))
    train_u = (u.min(-1) if q.op == "and" else u.max(-1)).astype(np.float32)
    # each clip forward then backward, so a camera's frames go on across
    # the pool's wrap without a jump; upsampled on the device
    # every seed serves the same clips, each on another camera: the same
    # work in another order
    perm = np.random.default_rng(np.random.SeedSequence([seed, 4])).permutation(C)
    small = small[torch.as_tensor(perm, device=device)]
    seq = torch.cat([small, small.flip(1)], 1)
    pool = [seq[:, b:b + T].repeat_interleave(up, 2).repeat_interleave(up, 3)
            .contiguous() for b in range(0, 2 * L, T)]
    del small, seq
    scorer = None
    if cfg.get("cascade"):
        cs = cfg["cascade"]
        d = cs["roi_size"] ** 2 * 3 + 4
        gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
        w1 = torch.randn((d, cs["hidden"]), generator=gen, device=device)
        w2 = torch.randn((cs["hidden"], 1), generator=gen, device=device)
        scorer = {"w1": w1 / math.sqrt(d),
                  "b1": torch.zeros(cs["hidden"], device=device),
                  "w2": w2 / math.sqrt(cs["hidden"]),
                  "b2": torch.zeros(1, device=device)}
    return Inputs(pool=pool, pool_bytes=sum(b.numel() for b in pool),
                  M_pos=M_pos.reshape(len(q.colors), q.bs, q.bv), norm=norm,
                  train_utilities=train_u, scorer=scorer)

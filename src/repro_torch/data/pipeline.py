"""Host-side data pipelines, video path (paper Fig. 8).

Thin wrappers over the session API (``repro_torch.core.session``).
``ingest_stream`` / ``scenario_records`` chunk one camera's RGB stream
through a single-camera ``ShedSession``; ``camera_array_records`` stacks
C same-shape camera streams into a ``(C, T, H, W, 3)`` array and scores
the whole array with one fused ingest per batch (per-camera background
lanes carried across batches) — the CUDA ingest kernel on the card, its
plain version on the CPU. ``interleave_streams`` merges per-camera
record streams for the Load Shedder. Every entry point takes ``device``
(default: the CUDA card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.colors import Color
from repro_torch.core.session import Query, ShedSession
from repro_torch.core.utility import UtilityModel, pixel_fraction_matrix
from repro_torch.data.synthetic import (
    VideoScenario,
    combined_label,
    combined_objects,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.hsv_features.ops import IngestState


# ---------------------------------------------------------------------------
# Video features
# ---------------------------------------------------------------------------

def features_from_hsv(frames_hsv: np.ndarray, colors: Sequence[Color],
                      fg_mask: Optional[np.ndarray] = None,
                      batch: int = 64, bs: int = 8, bv: int = 8,
                      device: DeviceLike = None) -> np.ndarray:
    """(T,H,W,3) HSV -> (T, n_colors, 8, 8) PF matrices (numpy).

    Legacy staged path (separate background model, host-side batching);
    the fused camera path is ``ingest_stream``.
    """
    dev = resolve_device(device)
    T = frames_hsv.shape[0]
    outs = []
    for i in range(0, T, batch):
        hsv_b = torch.as_tensor(np.asarray(frames_hsv[i:i + batch],
                                           np.float32), device=dev)
        fg_b = (None if fg_mask is None else
                torch.as_tensor(np.asarray(fg_mask[i:i + batch], bool),
                                device=dev))
        outs.append(torch.stack(
            [pixel_fraction_matrix(hsv_b, c, fg_b, bs, bv) for c in colors],
            dim=-3).cpu().numpy())
    return np.concatenate(outs, axis=0)


def _ingest_session(colors: Sequence[Color], num_cameras: int,
                    model: Optional[UtilityModel],
                    use_foreground: bool, op: Optional[str],
                    device: DeviceLike) -> ShedSession:
    """A scoring-only session for the camera-side ingest wrappers."""
    op = op or (model.op if model is not None else "or")
    if op == "single":
        op = "or" if len(colors) > 1 else "single"
    query = Query(colors=tuple(colors), op=op, use_foreground=use_foreground)
    return ShedSession(query, num_cameras, model=model, cdf_window=1,
                       device=device)


def ingest_stream(frames_rgb: np.ndarray, colors: Sequence[Color],
                  model: Optional[UtilityModel] = None, *,
                  state: Optional[IngestState] = None, batch: int = 64,
                  use_foreground: bool = True, op: Optional[str] = None,
                  device: DeviceLike = None):
    """Fused camera-side ingest over a (T, H, W, 3) RGB stream — a thin
    wrapper over a single-camera ``ShedSession``.

    Chunks the stream into ``batch``-frame batches, each one fused ingest
    (RGB->HSV + background subtraction + PF features + utility), carrying
    the background state across batches — chunked output is identical to
    one long batch.

    Returns (pf (T, nc, 8, 8) np, hf (T, nc) np, util (T,) np | None,
    state') — pass ``state'`` back in to continue the same stream.
    """
    sess = _ingest_session(colors, 1, model, use_foreground, op, device)
    if state is not None:
        sess.set_ingest_state(state)
    T = frames_rgb.shape[0]
    pfs, hfs, us = [], [], []
    for i in range(0, T, batch):
        res = sess.ingest(frames_rgb[i:i + batch][None])
        pfs.append(res.pf[0])
        hfs.append(res.hue_fraction[0])
        if res.utility is not None:
            us.append(res.utility[0])
    util = np.concatenate(us) if us else None
    st = sess.ingest_state
    state_out = IngestState(bg=st.bg[0], gain=st.gain[0])
    return np.concatenate(pfs), np.concatenate(hfs), util, state_out


@dataclass
class FrameRecord:
    cam_id: int
    frame_idx: int
    t_gen: float                 # generation timestamp (seconds)
    pf: np.ndarray               # (n_colors, 8, 8)
    label: bool
    objects: frozenset
    busy: bool                   # big blob present -> backend runs DNN stage
    utility: float = float("nan")


def _records_for(sc: VideoScenario, cam_id: int, names: Sequence[str],
                 op: str, fps: float, t0: float, pfs: np.ndarray,
                 util: Optional[np.ndarray]) -> List[FrameRecord]:
    labels = combined_label(sc, names, op)
    objs = combined_objects(sc, names)
    return [FrameRecord(cam_id, t, t0 + t / fps, pfs[t], bool(labels[t]),
                        frozenset(objs[t]), bool(sc.busy[t]),
                        utility=float(util[t]) if util is not None
                        else float("nan"))
            for t in range(sc.num_frames)]


def scenario_records(sc: VideoScenario, cam_id: int, colors: Sequence[Color],
                     op: str = "or", fps: float = 10.0,
                     use_foreground: bool = True, t0: float = 0.0,
                     model: Optional[UtilityModel] = None,
                     batch: int = 64,
                     device: DeviceLike = None) -> List[FrameRecord]:
    """Camera stream -> FrameRecords via the fused ingest path (the
    camera sees RGB; HSV conversion, background subtraction, PF features
    and — when ``model`` is given — utility scores all happen in one
    fused ingest per ``batch`` frames)."""
    pfs, _hf, util, _state = ingest_stream(
        sc.frames_rgb().astype(np.float32), colors, model,
        batch=batch, use_foreground=use_foreground, op=op, device=device)
    return _records_for(sc, cam_id, [c.name for c in colors], op, fps, t0,
                        pfs, util)


def camera_array_records(scenarios: Sequence[VideoScenario],
                         colors: Sequence[Color], op: str = "or",
                         fps: float = 10.0, use_foreground: bool = True,
                         t0: float = 0.0,
                         model: Optional[UtilityModel] = None,
                         cam_ids: Optional[Sequence[int]] = None,
                         batch: int = 64,
                         device: DeviceLike = None
                         ) -> List[List[FrameRecord]]:
    """C same-shape camera streams -> per-camera FrameRecord lists via
    ONE C-camera ``ShedSession``: each ``batch``-frame chunk of the whole
    array is a single fused ingest with per-camera ``(bg, gain)`` state
    lanes carried across chunks."""
    frames = np.stack([sc.frames_rgb().astype(np.float32)
                       for sc in scenarios])            # (C, T, H, W, 3)
    sess = _ingest_session(colors, len(scenarios), model, use_foreground,
                           op, device)
    T = frames.shape[1]
    pfs, us = [], []
    for i in range(0, T, batch):
        res = sess.ingest(frames[:, i:i + batch])
        pfs.append(res.pf)
        if res.utility is not None:
            us.append(res.utility)
    pfs = np.concatenate(pfs, axis=1)                   # (C, T, nc, bs, bv)
    util = np.concatenate(us, axis=1) if us else None
    names = [c.name for c in colors]
    cam_ids = list(cam_ids) if cam_ids is not None else list(
        range(len(scenarios)))
    return [_records_for(sc, cam_ids[c], names, op, fps, t0, pfs[c],
                         util[c] if util is not None else None)
            for c, sc in enumerate(scenarios)]


def interleave_streams(per_cam_records: Sequence[List[FrameRecord]]
                       ) -> List[FrameRecord]:
    """Merge multi-camera streams by generation time (paper §V-E2)."""
    allr = [r for rs in per_cam_records for r in rs]
    return sorted(allr, key=lambda r: (r.t_gen, r.cam_id, r.frame_idx))


__all__ = ["FrameRecord", "features_from_hsv", "ingest_stream",
           "scenario_records", "camera_array_records", "interleave_streams"]

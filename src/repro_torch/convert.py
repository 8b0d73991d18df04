"""Carry a trained model and a session state over from NumPy arrays.

The reference package exposes its utility model as arrays
(``UtilityModel.M_pos``/``M_neg``/``norm``/``op``) and its session state
as ``SessionState.as_dict()`` — ``{leaf name: np.ndarray}``. These two
functions build the port's objects from exactly those arrays, so a
reference session and a port session can start from the same trained
model and the same state. They take NumPy only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Union

import numpy as np
import torch

from repro_torch.core.colors import COLORS, Color
from repro_torch.core.session import SessionState
from repro_torch.core.utility import UtilityModel
from repro_torch.device import DeviceLike, resolve_device

# the reference's leaf dtypes, one entry per SessionState field
_BOOL_LEAVES = {"bg_valid", "proc_seen", "fps_seen", "active"}
_INT_LEAVES = {"cdf_len", "cdf_pos", "cdf_counts", "queue_cap", "q_seq",
               "q_next_seq", "s2_len", "s2_pos", "s2_counts"}


def _color(c) -> Color:
    """A port Color from a name or any object with ``name`` and
    ``hue_ranges`` (e.g. the reference's Color)."""
    if isinstance(c, str):
        return COLORS[c.lower()]
    return Color(str(c.name), tuple(tuple(int(x) for x in r)
                                    for r in c.hue_ranges))


def model_from_numpy(colors: Sequence[Union[str, object]], M_pos, M_neg,
                     norm, op: str) -> UtilityModel:
    """The port's UtilityModel from the reference model's arrays."""
    return UtilityModel(tuple(_color(c) for c in colors),
                        np.asarray(M_pos, np.float32).copy(),
                        np.asarray(M_neg, np.float32).copy(),
                        np.asarray(norm, np.float32).copy(), str(op))


def state_from_numpy(d: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> SessionState:
    """The port's SessionState from a ``SessionState.as_dict()`` of the
    reference (all 23 leaves), placed on ``device``."""
    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(SessionState)]
    missing = set(names) - set(d)
    if missing:
        raise ValueError(f"state dict lacks leaves {sorted(missing)}")
    leaves = {}
    for name in names:
        dtype = (np.bool_ if name in _BOOL_LEAVES
                 else np.int32 if name in _INT_LEAVES else np.float32)
        leaves[name] = torch.as_tensor(np.array(d[name], dtype=dtype),
                                       device=dev)
    return SessionState(**leaves)


__all__ = ["model_from_numpy", "state_from_numpy"]

"""Carry a trained model, a session state and model weights over from
NumPy arrays.

The reference package exposes its utility model as arrays
(``UtilityModel.M_pos``/``M_neg``/``norm``/``op``), its session state
as ``SessionState.as_dict()`` — ``{leaf name: np.ndarray}`` — its
language model's parameters and KV caches as pytrees of arrays and its cascade
scorer's as ``MLPScorer.params`` (``w1``/``b1``/``w2``/``b2``). These
functions build the port's objects from exactly those arrays, so a
reference and a port object can start from the same trained model,
state or weights. They take NumPy only. (A checkpoint file is the second
route: both packages write and read the same format.)
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


def _tensor(a, dev: torch.device) -> torch.Tensor:
    """A NumPy array as a tensor of its dtype; bfloat16 (``ml_dtypes``'
    type, which torch cannot read) goes through its bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(dev)
    return torch.as_tensor(a, device=dev)


def _tree_from_numpy(tree, dev: torch.device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_from_numpy(v, dev) for v in tree)
    return _tensor(tree, dev)


def lm_params_from_numpy(tree, device: DeviceLike = None):
    """The port's language-model parameters from the reference's
    parameter pytree with NumPy leaves (``embed``, ``final_norm``, the
    ``blocks`` tuple of dicts stacked over the pattern repetitions — an
    attention block's ``attn`` with an ``mlp`` or ``moe``, a recurrent
    block's ``mixer``, ``{}`` at a SHARED_ATTN entry — an optional
    ``lm_head``, ``shared``, ``encoder`` and ``cross``), nesting and
    dtypes kept, on ``device``."""
    return _tree_from_numpy(tree, resolve_device(device))


def lm_caches_from_numpy(tree, device: DeviceLike = None):
    """The port's caches from the reference's cache tree with NumPy
    leaves (``{"blocks": (one dict per pattern entry, each leaf stacked
    over the repetitions: an attention block's k, v, pos[, k_scale,
    v_scale], a Mamba2 block's s, conv, an mLSTM block's C, n, m, an
    sLSTM block's c, n, h, m), "cross_kv": None or {"k", "v"}}``), dtypes
    kept (bf16 and int8 included), on ``device``: the reference's own
    prefilled cache, ready for ``lm_decode_step``."""
    return _tree_from_numpy(tree, resolve_device(device))


def scorer_params_from_numpy(params: Dict[str, np.ndarray],
                             device: DeviceLike = None
                             ) -> Dict[str, torch.Tensor]:
    """The port's ``MLPScorer`` parameters from the reference scorer's
    ``params`` as NumPy arrays (``{k: np.asarray(v)}``): float32 tensors
    on ``device``, for ``MLPScorer(params=..., roi_size=...)``."""
    dev = resolve_device(device)
    missing = {"w1", "b1", "w2", "b2"} - set(params)
    if missing:
        raise ValueError(f"scorer params lack {sorted(missing)}")
    return {k: torch.as_tensor(np.array(params[k], np.float32), device=dev)
            for k in ("w1", "b1", "w2", "b2")}


__all__ = ["lm_caches_from_numpy", "lm_params_from_numpy",
           "model_from_numpy", "scorer_params_from_numpy",
           "state_from_numpy"]

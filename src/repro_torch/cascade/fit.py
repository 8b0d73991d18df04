"""Distillation training for the stage-2 semantic scorer.

The scorer never sees hand labels: it is fit on synthetic scenarios
(``repro_torch.data.synthetic``) whose per-frame ground truth — "a
target-color *vehicle* is present", not merely "target-color pixels are
present" — is exactly the semantic distinction stage 1 cannot make. Each
training example is the frame's foreground-bbox crop (the same ROI the
serving path gets from the fused ingest) plus that ground-truth bit, so
train and serve see identical inputs.

Optimization: AdamW + ``make_scorer_train_step`` from
``repro_torch.train`` on ``torch.autograd``; checkpoints via
``repro_torch.train.checkpoint``. The batches and their augmentation are
drawn from ``np.random.default_rng(seed)`` in the reference's order, so
from the same initial parameters the port trains on the same batches.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.cascade.scorer import (
    MLPScorer,
    extract_rois,
    roi_geometry,
    scorer_logits,
)
from repro_torch.data.synthetic import combined_label
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.hsv_features.ops import ingest_pipeline
from repro_torch.train.optimizer import AdamW, constant_lr
from repro_torch.train.step import make_scorer_train_step


def collect_examples(scenarios, colors, *, op: str = "or",
                     alpha: float = 0.05, threshold: float = 18.0,
                     use_foreground: bool = True, device: DeviceLike = None,
                     impl: Optional[str] = None,
                     interpret: Optional[bool] = None):
    """Scenarios -> (frames (M, H, W, 3) float32, bboxes (M, 4) int32,
    labels (M,) float32), tensors on ``device``. Bboxes come from the
    fused ingest (``ingest_pipeline(with_bbox=True)``: the CUDA kernel on
    the card), so training crops match what the cascade sees at serve
    time. The reference's ``impl=``/``interpret=`` are accepted and
    change nothing (the device picks the kernel).
    """
    dev = resolve_device(device)
    names = [c.name for c in colors]
    frames_all, bbox_all, labels_all = [], [], []
    for sc in scenarios:
        rgb = torch.as_tensor(np.asarray(sc.frames_rgb(), np.float32),
                              device=dev)
        bbox = ingest_pipeline(
            rgb, colors, None, with_bbox=True, alpha=alpha,
            threshold=threshold, use_foreground=use_foreground)[4]
        frames_all.append(rgb)
        bbox_all.append(bbox)
        labels_all.append(torch.as_tensor(
            np.asarray(combined_label(sc, names, op), np.float32),
            device=dev))
    return (torch.cat(frames_all), torch.cat(bbox_all),
            torch.cat(labels_all))


def _bce_loss(params, batch):
    """Class-weighted, numerically stable binary cross-entropy on the
    logits, and the batch accuracy."""
    x, geo, y, w = batch
    logits = scorer_logits(params, x, geo)
    ce = (torch.clamp_min(logits, 0.0) - logits * y
          + torch.log1p(torch.exp(-torch.abs(logits))))
    loss = torch.sum(w * ce) / torch.clamp_min(torch.sum(w), 1e-9)
    acc = torch.mean(((logits > 0) == (y > 0.5)).to(torch.float32))
    return loss, {"accuracy": acc}


def fit_scorer(scenarios, colors, *, op: str = "or", roi_size: int = 16,
               hidden: int = 32, steps: int = 200, batch_size: int = 256,
               lr: float = 3e-3, seed: int = 0, augment: bool = True,
               checkpoint_dir=None, alpha: float = 0.05,
               threshold: float = 18.0, use_foreground: bool = True,
               device: DeviceLike = None, impl: Optional[str] = None,
               interpret: Optional[bool] = None):
    """Fit an ``MLPScorer`` on synthetic-scenario ground truth, on
    ``device`` (the card by default). ``impl=``/``interpret=``: accepted
    no-ops, as in ``collect_examples``.

    Returns ``(scorer, metrics)``; ``metrics`` reports the class
    balance, the first and final training losses, the final accuracy
    over all examples, and the mean score separation between positive
    and negative frames. With ``checkpoint_dir`` the fitted parameters
    are saved there (restore with ``MLPScorer.from_checkpoint``).
    """
    dev = resolve_device(device)
    frames, bboxes, labels_t = collect_examples(
        scenarios, colors, op=op, alpha=alpha, threshold=threshold,
        use_foreground=use_foreground, device=dev)
    crops_t = extract_rois(frames, bboxes, roi_size)
    geo_t = roi_geometry(bboxes, frames.shape[1], frames.shape[2])
    del frames
    # the batches are drawn and augmented on the host, with the
    # reference's NumPy calls in its order
    crops = crops_t.cpu().numpy()
    geo = geo_t.cpu().numpy()
    labels = labels_t.cpu().numpy()

    pos = float(labels.sum())
    neg = float(len(labels) - pos)
    # class-balance the BCE: scenarios are mostly-idle by construction
    w_pos = neg / max(pos, 1.0)
    weights = np.where(labels > 0.5, w_pos, 1.0).astype(np.float32)

    scorer = MLPScorer.init(seed, roi_size=roi_size, hidden=hidden,
                            device=dev)
    opt = AdamW(lr=constant_lr(lr), weight_decay=0.0)
    step_fn = make_scorer_train_step(_bce_loss, opt)
    params, opt_state = scorer.params, opt.init(scorer.params)

    rng = np.random.default_rng(seed)
    bs = min(batch_size, len(labels))
    losses = []
    for _ in range(steps):
        idx = rng.integers(0, len(labels), size=bs)
        x = crops[idx]
        if augment:
            # brightness gain (the scenarios carry illumination drift),
            # horizontal flip (traffic runs both ways) and pixel noise
            x = x * rng.uniform(0.75, 1.25, (bs, 1, 1, 1))
            flip = rng.random(bs) < 0.5
            x[flip] = x[flip, :, ::-1]
            x = np.clip(x + rng.normal(0.0, 4.0, x.shape), 0.0, 255.0)
            x = x.astype(np.float32)
        batch = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                      for a in (x, geo[idx], labels[idx], weights[idx]))
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))

    fitted = MLPScorer(params=params, roi_size=roi_size)
    with torch.no_grad():
        scores = torch.sigmoid(scorer_logits(params, crops_t, geo_t)
                               ).cpu().numpy()
    acc = float(np.mean((scores > 0.5) == (labels > 0.5)))
    sep = float((scores[labels > 0.5].mean() if pos else 0.0)
                - (scores[labels <= 0.5].mean() if neg else 0.0))
    metrics = {
        "examples": int(len(labels)), "positives": int(pos),
        "loss_first": losses[0] if losses else float("nan"),
        "loss_final": losses[-1] if losses else float("nan"),
        "accuracy": acc, "separation": sep,
    }
    if checkpoint_dir is not None:
        fitted.save(checkpoint_dir, step=steps)
    return fitted, metrics


__all__ = ["collect_examples", "fit_scorer"]

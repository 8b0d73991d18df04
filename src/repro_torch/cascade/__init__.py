"""Two-stage shedding cascade: color gate -> semantic scorer.

Stage 1 is the paper's color-utility shedder (size/shape-blind by
construction). Stage 2 re-scores only the frames that pass the color
threshold with a tiny learned head over the fused ingest's foreground
bbox crop, under its own shed threshold driven by the same Eq. 17-20
control loop. Attach with ``ShedSession(cascade=Cascade(scorer))`` —
strictly opt-in; without it the session's decisions are bit-identical
to the single-stage pipeline.
"""
from repro_torch.cascade.fit import collect_examples, fit_scorer
from repro_torch.cascade.scorer import (
    CallableScorer,
    Cascade,
    FrameRows,
    MLPScorer,
    SemanticScorer,
    extract_rois,
    roi_geometry,
    scorer_logits,
)

__all__ = [
    "Cascade",
    "SemanticScorer",
    "FrameRows",
    "MLPScorer",
    "CallableScorer",
    "extract_rois",
    "roi_geometry",
    "scorer_logits",
    "collect_examples",
    "fit_scorer",
]

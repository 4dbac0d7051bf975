"""Evaluation of the port: the language-grounding evaluators."""

from butd_detr_tpu_torch.eval.grounding import (
    BREAKDOWN_FIELDS,
    GroundingEvaluator,
    GroundingGTEvaluator,
    contrast_scores,
    grounding_batch_hits,
    gt_grounding_batch_hits,
    pred_boxes,
    span_scores,
    topk_box_hits,
)

__all__ = [
    "BREAKDOWN_FIELDS",
    "GroundingEvaluator",
    "GroundingGTEvaluator",
    "contrast_scores",
    "grounding_batch_hits",
    "gt_grounding_batch_hits",
    "pred_boxes",
    "span_scores",
    "topk_box_hits",
]

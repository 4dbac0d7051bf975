"""Evaluation of the port: grounding accuracy (on the device, vectorized)
and detection mAP (host numpy, copied from the JAX package's `eval/`,
with its NMS and VOC matcher in the host C++ of `native.py`)."""

from butd_detr_tpu_torch.eval.box_util import (
    aabb_iou,
    box3d_iou,
    box3d_vol,
    corners_to_aabb,
    flip_axis_to_camera,
    flip_axis_to_depth,
    get_3d_box,
    get_3d_box_batch,
    get_iou_obb,
)
from butd_detr_tpu_torch.eval.detection import (
    APCalculator,
    default_parse_config,
    eval_det,
    eval_det_cls,
    eval_grounding,
    parse_groundtruths,
    parse_predictions,
    voc_ap,
)
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
from butd_detr_tpu_torch.eval.metrics import (
    calc_iou,
    multi_scene_precision_recall,
    precision_recall,
    single_scene_precision_recall,
)
from butd_detr_tpu_torch.eval.nms import (
    nms_2d_faster,
    nms_3d_faster,
    nms_3d_faster_samecls,
)

__all__ = [
    "APCalculator",
    "BREAKDOWN_FIELDS",
    "GroundingEvaluator",
    "GroundingGTEvaluator",
    "aabb_iou",
    "box3d_iou",
    "box3d_vol",
    "calc_iou",
    "contrast_scores",
    "corners_to_aabb",
    "default_parse_config",
    "eval_det",
    "eval_det_cls",
    "eval_grounding",
    "flip_axis_to_camera",
    "flip_axis_to_depth",
    "get_3d_box",
    "get_3d_box_batch",
    "get_iou_obb",
    "grounding_batch_hits",
    "gt_grounding_batch_hits",
    "multi_scene_precision_recall",
    "nms_2d_faster",
    "nms_3d_faster",
    "nms_3d_faster_samecls",
    "parse_groundtruths",
    "parse_predictions",
    "precision_recall",
    "pred_boxes",
    "single_scene_precision_recall",
    "span_scores",
    "topk_box_hits",
    "voc_ap",
]

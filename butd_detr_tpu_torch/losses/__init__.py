"""The set criterion of the port: box math, Hungarian matching and the
7-prefix loss."""

from butd_detr_tpu_torch.losses.criterion import (
    CriterionConfig,
    compute_hungarian_loss,
    compute_points_obj_cls_loss_hard_topk,
    loss_boxes,
    loss_contrastive_align,
    loss_labels_st,
    set_criterion_losses,
    sigmoid_focal_loss,
)
from butd_detr_tpu_torch.losses.matcher import (
    hungarian_match,
    linear_sum_assignment_host,
    matcher_cost_matrix,
)

__all__ = [
    "CriterionConfig",
    "compute_hungarian_loss",
    "compute_points_obj_cls_loss_hard_topk",
    "hungarian_match",
    "linear_sum_assignment_host",
    "loss_boxes",
    "loss_contrastive_align",
    "loss_labels_st",
    "matcher_cost_matrix",
    "set_criterion_losses",
    "sigmoid_focal_loss",
]

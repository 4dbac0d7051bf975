"""Hungarian matching, where the costs live.

Counterpart of `butd_detr_tpu/losses/matcher.py`. The cost matrices are
computed where the predictions lie (`matcher_cost_matrix`, as
matcher.py:154-189), and the assignment is solved there too, by the
port's counterpart of the JAX package's on-device Jonker-Volgenant solver
(`ops/assignment.py`: the kernel csrc/assignment.cu on the card, its plain
version on the CPU). A call reads nothing back to the host. The reference
solves on the host with scipy on each matrix sliced to its valid targets
(models/losses.py:318-324); `scipy_match_oracle` is that path, kept for
the tests. Both give the exact optimum and agree up to cost ties.
"""

import numpy as np
import torch

from butd_detr_tpu_torch.losses.boxes import (
    box_cxcyczwhd_to_xyzxyz,
    generalized_box_iou3d,
)
from butd_detr_tpu_torch.ops.assignment import batched_linear_sum_assignment
from butd_detr_tpu_torch.utils.spans import span


def matcher_cost_matrix(pred_logits, pred_boxes, positive_map, gt_boxes,
                        box_label_mask, cost_class: float = 1.0,
                        cost_bbox: float = 0.0, cost_giou: float = 2.0,
                        tgt_labels=None) -> torch.Tensor:
    """(B, Q, C) logits, (B, Q, 6) and (B, G, 6) cxcyczwhd boxes,
    (B, G, C) positive map, (B, G) validity -> (B, Q, G) matching cost
    (reference HungarianMatcher.forward with weights (1, 0, 2)). Invalid
    targets get constant cost 0. `tgt_labels` (B, G) switches the class
    cost to the DETR-style -prob[:, tgt_ids]."""
    prob = torch.softmax(pred_logits.float(), dim=-1)
    if tgt_labels is not None:
        Q = prob.shape[1]
        cost_cls = -torch.gather(
            prob, 2, tgt_labels.long()[:, None, :].expand(-1, Q, -1))
    else:
        cost_cls = -torch.einsum("bqc,bgc->bqg", prob, positive_map.float())
    cost_l1 = (pred_boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs() \
        .sum(dim=-1)
    cost_g = -generalized_box_iou3d(box_cxcyczwhd_to_xyzxyz(pred_boxes),
                                    box_cxcyczwhd_to_xyzxyz(gt_boxes))
    cost = cost_bbox * cost_l1 + cost_class * cost_cls + cost_giou * cost_g
    return torch.where(box_label_mask[:, None, :] > 0, cost,
                       torch.zeros_like(cost))


@torch.no_grad()
def hungarian_match(pred_logits, pred_boxes, positive_map, gt_boxes,
                    box_label_mask, cost_class: float = 1.0,
                    cost_bbox: float = 0.0, cost_giou: float = 2.0,
                    tgt_labels=None) -> torch.Tensor:
    """(B, G) int64 on the predictions' device: the query matched to each
    target (0 for the padded ones, masked downstream). The solver maps NaN
    and infinite costs (a diverged run) to finite ones, as the JAX matcher
    does before it solves (matcher.py:207), so that it still returns."""
    with span("match"):
        cost = matcher_cost_matrix(pred_logits, pred_boxes, positive_map,
                                   gt_boxes, box_label_mask, cost_class,
                                   cost_bbox, cost_giou, tgt_labels)
        n_valid = (box_label_mask > 0).sum(dim=-1)
        # rows = targets: a view, which the kernel reads as it lies
        return batched_linear_sum_assignment(cost.transpose(1, 2),
                                             n_valid).long()


def scipy_match_oracle(cost_bqg, box_label_mask) -> np.ndarray:
    """The reference's host path, for the tests: scipy on each (Q, G)
    matrix sliced to its valid targets -> (B, G) int64, the query of each
    valid target, -1 for the padded ones."""
    from scipy.optimize import linear_sum_assignment

    cost = np.asarray(cost_bqg)
    mask = np.asarray(box_label_mask)
    out = np.full(mask.shape, -1, np.int64)
    for b in range(cost.shape[0]):
        g = int((mask[b] > 0).sum())
        queries, targets = linear_sum_assignment(cost[b, :, :g])
        out[b, targets] = queries
    return out

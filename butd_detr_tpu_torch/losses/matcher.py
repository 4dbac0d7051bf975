"""Hungarian matching: the cost matrices on the device, the assignment on
the host.

Counterpart of `butd_detr_tpu/losses/matcher.py`. The cost matrix is
computed where the predictions live (`matcher_cost_matrix`, as
matcher.py:154-189). The assignment is `scipy.optimize.
linear_sum_assignment` on the host, on each matrix sliced to its valid
targets, as the reference does (models/losses.py:318-324); all matrices of a
call travel to the host in ONE copy. The JAX package solves the same problem
on the device (a Jonker-Volgenant solver, matcher.py:33-141); both return
the exact optimum and agree up to cost ties.
"""

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from butd_detr_tpu_torch.losses.boxes import (
    box_cxcyczwhd_to_xyzxyz,
    generalized_box_iou3d,
)


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


def linear_sum_assignment_host(cost_bqg: np.ndarray,
                               n_valid: np.ndarray) -> np.ndarray:
    """(B, Q, G) costs and (B,) valid-target counts -> (B, G) int64: the
    query matched to each valid target, 0 for the padded ones (masked
    downstream)."""
    B, _, G = cost_bqg.shape
    out = np.zeros((B, G), np.int64)
    for b in range(B):
        g = int(n_valid[b])
        queries, targets = linear_sum_assignment(cost_bqg[b, :, :g])
        out[b, targets] = queries
    return out


@torch.no_grad()
def hungarian_match(pred_logits, pred_boxes, positive_map, gt_boxes,
                    box_label_mask, cost_class: float = 1.0,
                    cost_bbox: float = 0.0, cost_giou: float = 2.0,
                    tgt_labels=None) -> torch.Tensor:
    """(B, G) int64 on the predictions' device: the query matched to each
    target. NaN costs (a diverged run) are mapped to large finite values so
    that the solver still returns."""
    cost = matcher_cost_matrix(pred_logits, pred_boxes, positive_map,
                               gt_boxes, box_label_mask, cost_class,
                               cost_bbox, cost_giou, tgt_labels)
    cost = torch.nan_to_num(cost, nan=1e6, posinf=1e6, neginf=-1e6)
    B = cost.shape[0]
    n_valid = (box_label_mask > 0).sum(dim=-1).to(cost.dtype)
    # one device-to-host copy: the costs with the counts appended
    host = torch.cat([cost.reshape(B, -1), n_valid[:, None]], dim=1).cpu() \
        .numpy()
    assignment = linear_sum_assignment_host(
        host[:, :-1].reshape(cost.shape), host[:, -1].astype(np.int64))
    return torch.from_numpy(assignment).to(cost.device)

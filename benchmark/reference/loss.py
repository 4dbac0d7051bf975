"""The Hungarian set loss of BUTD-DETR in plain PyTorch and float32, and the
judge of a matching.

A frozen copy of `butd_detr_tpu_torch/losses/` (boxes, the matching cost
and the criterion) that takes its assignment from the caller: the loss is
compared on the program's matching, and the matching is judged apart by
`assignment_excess`, the cost by which the program's assignment exceeds
the optimum on the reference's own cost matrix (the optimum by scipy, on
the host).
"""

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from benchmark.reference.model import prediction_prefixes

_EPS_VOL = 1e-10


def box_cxcyczwhd_to_xyzxyz(x):
    c, s = x[..., :3], x[..., 3:].clamp_min(1e-6)
    return torch.cat([c - 0.5 * s, c + 0.5 * s], dim=-1)


def _volume(box):
    d = box[..., 3:] - box[..., :3]
    return d[..., 0] * d[..., 1] * d[..., 2]


def _clipped_volume(lo, hi):
    d = (hi - lo).clamp_min(0)
    return d[..., 0] * d[..., 1] * d[..., 2]


def pairwise_iou3d(a, b):
    inter = _clipped_volume(torch.maximum(a[..., :, None, :3],
                                          b[..., None, :, :3]),
                            torch.minimum(a[..., :, None, 3:],
                                          b[..., None, :, 3:]))
    union = _volume(a)[..., :, None] + _volume(b)[..., None, :] - inter
    return inter / union.clamp_min(_EPS_VOL), union


def matched_iou3d(a, b):
    inter = _clipped_volume(torch.maximum(a[..., :3], b[..., :3]),
                            torch.minimum(a[..., 3:], b[..., 3:]))
    union = _volume(a) + _volume(b) - inter
    return inter / union.clamp_min(_EPS_VOL)


def generalized_box_iou3d(a, b):
    iou, union = pairwise_iou3d(a, b)
    vol = _clipped_volume(torch.minimum(a[..., :, None, :3],
                                        b[..., None, :, :3]),
                          torch.maximum(a[..., :, None, 3:],
                                        b[..., None, :, 3:]))
    return iou - (vol - union) / vol.clamp_min(_EPS_VOL)


def matched_giou3d(a, b):
    inter = _clipped_volume(torch.maximum(a[..., :3], b[..., :3]),
                            torch.minimum(a[..., 3:], b[..., 3:]))
    union = _volume(a) + _volume(b) - inter
    iou = inter / union.clamp_min(_EPS_VOL)
    vol = _clipped_volume(torch.minimum(a[..., :3], b[..., :3]),
                          torch.maximum(a[..., 3:], b[..., 3:]))
    return iou - (vol - union) / vol.clamp_min(_EPS_VOL)


def cost_matrix(logits, boxes, positive_map, gt_boxes, mask):
    """(B, Q, G) matching cost with weights class 1, L1 0, GIoU 2."""
    prob = torch.softmax(logits.float(), dim=-1)
    cost = -torch.einsum("bqc,bgc->bqg", prob, positive_map.float()) \
        - 2.0 * generalized_box_iou3d(box_cxcyczwhd_to_xyzxyz(boxes),
                                      box_cxcyczwhd_to_xyzxyz(gt_boxes))
    return torch.where(mask[:, None, :] > 0, cost, torch.zeros_like(cost))


def assignment_excess(cost_bqg: torch.Tensor, assignment: torch.Tensor,
                      mask: torch.Tensor) -> float:
    """The widest excess, over the matrices, of the cost of `assignment`
    (B, G: the query of each target) over the optimal assignment's, both
    on `cost_bqg`, as a share of the matrix's spread of valid costs. An
    assignment that gives one query two targets counts as 1."""
    from scipy.optimize import linear_sum_assignment

    cost = cost_bqg.double().cpu().numpy()
    assign = assignment.long().cpu().numpy()
    valid = (mask > 0).cpu().numpy()
    worst = 0.0
    for b in range(cost.shape[0]):
        g = np.flatnonzero(valid[b])
        if g.size == 0:
            continue
        c = cost[b][:, g]
        q = assign[b, g]
        if len(set(q.tolist())) < q.size:
            return 1.0
        rows, cols = linear_sum_assignment(c)
        best = c[rows, cols].sum()
        spread = max(float(c.max() - c.min()), 1e-12)
        worst = max(worst, (c[q, np.arange(g.size)].sum() - best) / spread)
    return float(worst)


def _matched_rows(assignment, mask, Q):
    q_ids = torch.where(mask > 0, assignment.long(),
                        torch.full_like(assignment.long(), Q))
    b_ids = torch.arange(q_ids.shape[0], device=q_ids.device)[:, None] \
        .expand_as(q_ids)
    return b_ids, q_ids


def _matched_weight(b_ids, q_ids, Q, eos_coef):
    matched = torch.zeros(q_ids.shape[0], Q + 1, dtype=torch.bool,
                          device=q_ids.device)
    matched[b_ids, q_ids] = True
    return torch.where(matched[:, :Q], 1.0, eos_coef)


def loss_labels_st(logits, positive_map, assignment, mask, num_boxes,
                   eos_coef):
    B, Q, C = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    b_ids, q_ids = _matched_rows(assignment, mask, Q)
    target = torch.zeros(B, Q + 1, C, device=logp.device)
    target[:, :, -1] = 1.0
    target[b_ids, q_ids] = positive_map.float()
    target = target[:, :Q]
    ce = (torch.log(target + 1e-6) * target - logp * target).sum(dim=-1)
    return (ce * _matched_weight(b_ids, q_ids, Q, eos_coef)).sum() \
        / num_boxes


def loss_boxes(boxes, gt_boxes, assignment, mask, num_boxes):
    src = torch.gather(boxes, 1, assignment.long()[..., None]
                       .expand(-1, -1, 6))
    l1 = (src - gt_boxes).abs()
    l1 = l1[..., :3].sum(-1) + 0.2 * l1[..., 3:].sum(-1)
    m = mask.float()
    giou = matched_giou3d(box_cxcyczwhd_to_xyzxyz(src),
                          box_cxcyczwhd_to_xyzxyz(gt_boxes))
    return (l1 * m).sum() / num_boxes, ((1.0 - giou) * m).sum() / num_boxes


def loss_contrastive_align(proj_queries, proj_tokens, text_mask,
                           positive_map, assignment, mask, num_boxes,
                           eos_coef, temperature):
    B, Q, _ = proj_queries.shape
    L = proj_tokens.shape[1]
    dev = proj_queries.device
    logits = torch.einsum("bqd,bld->bql", proj_queries, proj_tokens) \
        / temperature
    tok_real = text_mask > 0
    logits = logits.masked_fill(~tok_real[:, None, :], -1e9)
    ar = torch.arange(B, device=dev)
    inds = text_mask.long().sum(dim=1) - 1
    pm = torch.zeros(B, Q + 1, L, device=dev)
    pm[ar, :, inds] = 0.5
    pm[ar, :, inds - 1] = 0.5
    pm[:, Q] = 0.0
    b_ids, q_ids = _matched_rows(assignment, mask, Q)
    pm[b_ids, q_ids] = positive_map[..., :L].float()
    positive = (pm[:, :Q] > 0) & tok_real[:, None, :]
    qmask = _matched_weight(b_ids, q_ids, Q, eos_coef)
    tmask = torch.full((B, L), float(eos_coef), device=dev)
    tmask[ar, inds] = 1.0
    tmask = tmask * tok_real
    pos_logits = torch.where(positive, -logits, torch.zeros_like(logits))

    def direction(dim):
        with_pos = positive.any(dim=dim)
        nb_pos = positive.sum(dim=dim) + 1e-6
        entropy = -torch.log(nb_pos + 1e-6) / nb_pos
        return torch.where(
            with_pos, entropy + pos_logits.sum(dim=dim) / nb_pos
            + torch.logsumexp(logits, dim=dim), torch.zeros_like(nb_pos))

    return ((direction(2) * qmask).sum() + (direction(1) * tmask).sum()) \
        / 2 / num_boxes


def points_obj_cls_loss(ep, topk: int):
    """The keypoint-objectness focal loss (hard top-k positives)."""
    mask = ep["box_label_mask"]
    seed_inds = ep["seed_inds"].long()
    seed_xyz = ep["seed_xyz"]
    logits = ep["seeds_obj_cls_logits"]
    gt_center = ep["center_label"][:, :, :3]
    gt_size = ep["size_gts"][:, :, :3]
    B, K = seed_inds.shape
    G = gt_center.shape[1]
    dev = logits.device
    obj = torch.gather(ep["point_instance_label"].long(), 1, seed_inds)
    bg = obj < 0
    one_hot = torch.nn.functional.one_hot(obj.masked_fill(bg, G - 1),
                                          G).float()
    delta = (seed_xyz[:, :, None, :] - gt_center[:, None, :, :]) / (
        gt_size[:, None, :, :] + 1e-6)
    dist = torch.sqrt((delta ** 2).sum(dim=-1) + 1e-6)
    dist = (dist * one_hot + 100.0 * (1.0 - one_hot)).transpose(1, 2)
    topk_inds = torch.sort(dist, dim=-1, stable=True).indices[..., :topk]
    topk_inds = torch.where(mask[:, :, None] > 0, topk_inds,
                            torch.full_like(topk_inds, K)).reshape(B, -1)
    label = torch.zeros(B, K + 1, device=dev)
    label[torch.arange(B, device=dev)[:, None], topk_inds] = 1.0
    label = label[:, :K].masked_fill(bg, 0.0)
    z = logits.float()
    p = torch.sigmoid(z)
    alpha_w = label * 0.25 + (1 - label) * 0.75
    pt = label * (1 - p) + (1 - label) * p
    bce = z.clamp_min(0) - z * label + torch.log1p(torch.exp(-z.abs()))
    return (alpha_w * pt ** 2 * bce / K).sum() / B


def hungarian_loss(ep: Dict, assignment_all: torch.Tensor,
                   num_decoder_layers: int, eos_coef=0.1, temperature=0.07,
                   topk=4, group=None):
    """(loss, {name: value}) on the program's assignment (P, B, G) over the
    prefixes proposal_, 0head_ .. last_. With a process `group` the box
    count is the group's total over its number of ranks, so that the mean
    of the ranks' losses is the loss of all their rows together."""
    prefixes = prediction_prefixes(num_decoder_layers)
    gt = torch.cat([ep["center_label"][:, :, :3], ep["size_gts"]], dim=-1)
    mask = ep["box_label_mask"]
    if group is None:
        num_boxes = mask.float().sum().clamp_min(1.0)
    else:
        num_boxes = mask.float().sum()
        dist.all_reduce(num_boxes, group=group)
        num_boxes = num_boxes.clamp_min(1.0) / dist.get_world_size(group)
    ce = bbox = giou = contr = 0.0
    for pi, p in enumerate(prefixes):
        a = assignment_all[pi]
        boxes = torch.cat([ep[f"{p}center"], ep[f"{p}pred_size"]], dim=-1)
        ce = ce + loss_labels_st(ep[f"{p}sem_cls_scores"],
                                 ep["positive_map"], a, mask, num_boxes,
                                 eos_coef)
        b, g = loss_boxes(boxes, gt, a, mask, num_boxes)
        bbox, giou = bbox + b, giou + g
        contr = contr + loss_contrastive_align(
            ep[f"{p}proj_queries"], ep["proj_tokens"], ep["text_mask"],
            ep["positive_map"], a, mask, num_boxes, eos_coef, temperature)
    kps = points_obj_cls_loss(ep, topk)
    loss = 8 * kps + (ce + 5 * bbox + giou + contr) / (num_decoder_layers + 1)
    return loss, {"loss": loss, "loss_ce": ce, "loss_bbox": bbox,
                  "loss_giou": giou, "loss_contrastive_align": contr,
                  "query_points_generation_loss": kps}


def costs_by_prefix(ep: Dict, num_decoder_layers: int) -> torch.Tensor:
    """(P, B, Q, G) matching costs of every prefix."""
    gt = torch.cat([ep["center_label"][:, :, :3], ep["size_gts"]], dim=-1)
    out = []
    for p in prediction_prefixes(num_decoder_layers):
        boxes = torch.cat([ep[f"{p}center"], ep[f"{p}pred_size"]], dim=-1)
        out.append(cost_matrix(ep[f"{p}sem_cls_scores"], boxes,
                               ep["positive_map"], gt, ep["box_label_mask"]))
    return torch.stack(out)

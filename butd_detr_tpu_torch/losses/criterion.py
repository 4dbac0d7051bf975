"""Set criterion: soft-token CE, box L1 + GIoU, contrastive alignment and
the keypoint-objectness focal loss, fixed-shape and mask-driven.

Counterpart of `butd_detr_tpu/losses/criterion.py` (reference
models/losses.py:94-617): every loss is a masked tensor op over padded
(B, G_max) targets. `num_boxes` is the one global count of valid targets
of the batch. The matched predictions are gathered with the port's
`gather_points`, so their gradient is the row scatter-add.
"""

from typing import Dict, NamedTuple

import torch

from butd_detr_tpu_torch.losses.boxes import (
    box_cxcyczwhd_to_xyzxyz,
    matched_giou3d,
)
from butd_detr_tpu_torch.losses.matcher import hungarian_match
from butd_detr_tpu_torch.models.bdetr import prediction_prefixes
from butd_detr_tpu_torch.ops import gather_points


class CriterionConfig(NamedTuple):
    eos_coef: float = 0.1
    temperature: float = 0.07
    cost_class: float = 1.0
    cost_bbox: float = 0.0
    cost_giou: float = 2.0
    use_contrastive_align: bool = True
    # matcher class cost: soft-token (-prob @ positive_map^T) or, when
    # False, DETR-style -prob[:, sem_cls_label]
    use_soft_token: bool = True
    # True: pad tokens are masked out of the contrastive normalizer. False
    # reproduces the reference, where pad logits inside the padded window
    # contribute to the logsumexp (losses.py:420-489).
    mask_pad_tokens: bool = True


def _matched_rows(assignment, box_label_mask, num_queries):
    """Batch and query indices that scatter per-target rows onto their
    matched queries; padded targets go to the spare row `num_queries`."""
    q_ids = torch.where(box_label_mask > 0, assignment.long(),
                        torch.full_like(assignment.long(), num_queries))
    b_ids = torch.arange(q_ids.shape[0], device=q_ids.device)[:, None] \
        .expand_as(q_ids)
    return b_ids, q_ids


def _matched_weight(b_ids, q_ids, num_queries, eos_coef):
    """(B, Q): 1 for matched queries, eos_coef for the others."""
    B = q_ids.shape[0]
    matched = torch.zeros(B, num_queries + 1, dtype=torch.bool,
                          device=q_ids.device)
    matched[b_ids, q_ids] = True
    one = torch.ones((), device=q_ids.device)
    return torch.where(matched[:, :num_queries], one, eos_coef * one)


def loss_labels_st(pred_logits, positive_map, assignment, box_label_mask,
                   num_boxes, eos_coef=0.1):
    """Soft-token cross-entropy (reference loss_labels_st): unmatched
    queries target the last bin ("no object") with weight eos_coef, matched
    queries their target's positive map."""
    B, Q, C = pred_logits.shape
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    b_ids, q_ids = _matched_rows(assignment, box_label_mask, Q)
    target_sim = torch.zeros(B, Q + 1, C, device=logp.device)
    target_sim[:, :, -1] = 1.0
    target_sim[b_ids, q_ids] = positive_map.float()
    target_sim = target_sim[:, :Q]
    entropy = torch.log(target_sim + 1e-6) * target_sim
    loss_ce = (entropy - logp * target_sim).sum(dim=-1)  # (B, Q)
    w = _matched_weight(b_ids, q_ids, Q, eos_coef)
    return (loss_ce * w).sum() / num_boxes


def loss_boxes(pred_boxes, gt_boxes, assignment, box_label_mask, num_boxes):
    """L1 (size terms x 0.2) + GIoU on the matched pairs."""
    src = gather_points(pred_boxes, assignment)  # (B, G, 6)
    l1 = (src - gt_boxes).abs()
    l1 = l1[..., :3].sum(-1) + 0.2 * l1[..., 3:].sum(-1)  # (B, G)
    m = box_label_mask.float()
    giou = matched_giou3d(box_cxcyczwhd_to_xyzxyz(src),
                          box_cxcyczwhd_to_xyzxyz(gt_boxes))
    return {"loss_bbox": (l1 * m).sum() / num_boxes,
            "loss_giou": ((1.0 - giou) * m).sum() / num_boxes}


def loss_contrastive_align(proj_queries, proj_tokens, text_mask, positive_map,
                           assignment, box_label_mask, num_boxes,
                           eos_coef=0.1, temperature=0.07,
                           mask_pad_tokens: bool = True):
    """Bidirectional InfoNCE between (B, Q, 64) queries and (B, L, 64)
    tokens, both L2-normalized (losses.py:420-489). `text_mask` (B, L) is 1
    on real tokens; `positive_map` (B, G, C) has C >= L."""
    B, Q, _ = proj_queries.shape
    L = proj_tokens.shape[1]
    dev = proj_queries.device
    logits = (torch.einsum("bqd,bld->bql", proj_queries, proj_tokens)
              / temperature).float()
    tok_real = (text_mask > 0) if mask_pad_tokens else torch.ones_like(
        text_mask, dtype=torch.bool)
    logits = logits.masked_fill(~tok_real[:, None, :], -1e9)

    # 'not mentioned' default: the eos token and the one before it
    ar = torch.arange(B, device=dev)
    inds = text_mask.long().sum(dim=1) - 1  # (B,) last real token
    pm = torch.zeros(B, Q + 1, L, device=dev)
    pm[ar, :, inds] = 0.5
    pm[ar, :, inds - 1] = 0.5
    pm[:, Q] = 0.0
    # matched queries get their target's positive map rows
    b_ids, q_ids = _matched_rows(assignment, box_label_mask, Q)
    pm[b_ids, q_ids] = positive_map[..., :L].float()
    positive = (pm[:, :Q] > 0) & tok_real[:, None, :]  # (B, Q, L)

    qmask = _matched_weight(b_ids, q_ids, Q, eos_coef)
    # per-token weight: 1 for the eos token, eos_coef otherwise; 0 on pads
    tmask = torch.full((B, L), float(eos_coef), device=dev)
    tmask[ar, inds] = 1.0
    tmask = tmask * tok_real

    pos_logits = torch.where(positive, -logits, torch.zeros_like(logits))

    def direction(dim):
        with_pos = positive.any(dim=dim)
        pos_term = pos_logits.sum(dim=dim)
        neg_term = torch.logsumexp(logits, dim=dim)
        nb_pos = positive.sum(dim=dim) + 1e-6
        entropy = -torch.log(nb_pos + 1e-6) / nb_pos
        return torch.where(with_pos, entropy + pos_term / nb_pos + neg_term,
                           torch.zeros_like(neg_term))

    box_to_token = (direction(2) * qmask).sum()
    token_to_box = (direction(1) * tmask).sum()
    return (box_to_token + token_to_box) / 2 / num_boxes


def sigmoid_focal_loss(logits, targets, weights, gamma=2.0, alpha=0.25):
    """Focal BCE (reference SigmoidFocalClassificationLoss)."""
    z = logits.float()
    t = targets.float()
    p = torch.sigmoid(z)
    alpha_w = t * alpha + (1 - t) * (1 - alpha)
    pt = t * (1 - p) + (1 - t) * p
    bce = z.clamp_min(0) - z * t + torch.log1p(torch.exp(-z.abs()))
    return alpha_w * pt ** gamma * bce * weights


def compute_points_obj_cls_loss_hard_topk(end_points, topk: int):
    """Keypoint-selection objectness loss (losses.py:161-223): the `topk`
    seeds closest (size-normalized) to each valid GT centre are positives,
    background seeds (instance label < 0) negatives; focal loss normalized
    per sample by the seed count, summed / B."""
    box_label_mask = end_points["box_label_mask"]  # (B, G)
    seed_inds = end_points["seed_inds"].long()  # (B, K)
    seed_xyz = end_points["seed_xyz"]  # (B, K, 3)
    logits = end_points["seeds_obj_cls_logits"]  # (B, K)
    gt_center = end_points["center_label"][:, :, :3]  # (B, G, 3)
    gt_size = end_points["size_gts"][:, :, :3]  # (B, G, 3)
    point_instance_label = end_points["point_instance_label"]  # (B, N)
    B, K = seed_inds.shape
    G = gt_center.shape[1]
    dev = logits.device

    obj_assignment = torch.gather(point_instance_label.long(), 1, seed_inds)
    seed_is_bg = obj_assignment < 0
    obj_assignment = obj_assignment.masked_fill(seed_is_bg, G - 1)
    one_hot = torch.nn.functional.one_hot(obj_assignment, G).float()

    delta = (seed_xyz[:, :, None, :] - gt_center[:, None, :, :]) / (
        gt_size[:, None, :, :] + 1e-6)
    dist = torch.sqrt((delta ** 2).sum(dim=-1) + 1e-6)  # (B, K, G)
    dist = dist * one_hot + 100.0 * (1.0 - one_hot)
    dist = dist.transpose(1, 2)  # (B, G, K)

    # the topk smallest, ties to the lower index (lax.top_k's order)
    topk_inds = torch.sort(dist, dim=-1, stable=True).indices[..., :topk]
    # invalid targets write into the spare column K
    topk_inds = torch.where(box_label_mask[:, :, None] > 0, topk_inds,
                            torch.full_like(topk_inds, K)).reshape(B, -1)
    objectness_label = torch.zeros(B, K + 1, device=dev)
    objectness_label[torch.arange(B, device=dev)[:, None], topk_inds] = 1.0
    objectness_label = objectness_label[:, :K].masked_fill(seed_is_bg, 0.0)

    cls_weights = torch.full((B, K), 1.0 / max(K, 1), device=dev)
    loss = sigmoid_focal_loss(logits, objectness_label, cls_weights)
    return loss.sum() / B


def set_criterion_losses(outputs: Dict[str, torch.Tensor],
                         targets: Dict[str, torch.Tensor], num_boxes,
                         cfg: CriterionConfig):
    """One prefix's losses (reference SetCriterion.forward).

    outputs: pred_logits (B, Q, C), pred_boxes (B, Q, 6), optionally
    proj_queries / proj_tokens and a ready `assignment`; targets: boxes
    (B, G, 6), positive_map (B, G, C), box_label_mask (B, G), text_mask
    (B, L). Returns (losses, assignment)."""
    if "assignment" in outputs:
        assignment = outputs["assignment"]
    else:
        assignment = hungarian_match(
            outputs["pred_logits"], outputs["pred_boxes"],
            targets["positive_map"], targets["boxes"],
            targets["box_label_mask"], cfg.cost_class, cfg.cost_bbox,
            cfg.cost_giou,
            tgt_labels=None if cfg.use_soft_token else targets["labels"])
    losses = {"loss_ce": loss_labels_st(
        outputs["pred_logits"], targets["positive_map"], assignment,
        targets["box_label_mask"], num_boxes, cfg.eos_coef)}
    losses.update(loss_boxes(outputs["pred_boxes"], targets["boxes"],
                             assignment, targets["box_label_mask"],
                             num_boxes))
    if cfg.use_contrastive_align and "proj_queries" in outputs:
        losses["loss_contrastive_align"] = loss_contrastive_align(
            outputs["proj_queries"], outputs["proj_tokens"],
            targets["text_mask"], targets["positive_map"], assignment,
            targets["box_label_mask"], num_boxes, cfg.eos_coef,
            cfg.temperature, mask_pad_tokens=cfg.mask_pad_tokens)
    return losses, assignment


def compute_hungarian_loss(end_points: Dict[str, torch.Tensor],
                           num_decoder_layers: int = 6,
                           cfg: CriterionConfig = CriterionConfig(),
                           query_points_obj_topk: int = 4):
    """Total loss over the proposal and decoder-layer prefixes (reference
    compute_hungarian_loss): 8 * kps + (ce + 5 * bbox + giou + contrastive)
    / (layers + 1). Adds the per-prefix and summed losses to `end_points`
    and returns (loss, end_points). All prefixes' cost matrices are matched
    in one call (one copy to the host)."""
    prefixes = prediction_prefixes(num_decoder_layers)
    targets = {
        "boxes": torch.cat([end_points["center_label"][:, :, :3],
                            end_points["size_gts"]], dim=-1),
        "positive_map": end_points["positive_map"],
        "box_label_mask": end_points["box_label_mask"],
        "text_mask": end_points["text_mask"],
    }
    if "sem_cls_label" in end_points:
        targets["labels"] = end_points["sem_cls_label"]
    num_boxes = targets["box_label_mask"].float().sum().clamp_min(1.0)

    P = len(prefixes)
    B = targets["box_label_mask"].shape[0]
    all_logits = torch.stack(
        [end_points[f"{p}sem_cls_scores"] for p in prefixes])  # (P, B, Q, C)
    all_boxes = torch.stack(
        [torch.cat([end_points[f"{p}center"], end_points[f"{p}pred_size"]],
                   dim=-1) for p in prefixes])  # (P, B, Q, 6)
    tile = lambda x: x.expand(P, *x.shape).reshape(P * B, *x.shape[1:])
    assignment_all = hungarian_match(
        all_logits.flatten(0, 1), all_boxes.flatten(0, 1),
        tile(targets["positive_map"]), tile(targets["boxes"]),
        tile(targets["box_label_mask"]), cfg.cost_class, cfg.cost_bbox,
        cfg.cost_giou,
        tgt_labels=None if cfg.use_soft_token else tile(targets["labels"]),
    ).reshape(P, B, -1)

    loss_ce = loss_bbox = loss_giou = loss_contr = 0.0
    for pi, prefix in enumerate(prefixes):
        outputs = {"pred_logits": all_logits[pi], "pred_boxes": all_boxes[pi],
                   "assignment": assignment_all[pi]}
        if cfg.use_contrastive_align and "proj_tokens" in end_points:
            outputs["proj_queries"] = end_points[f"{prefix}proj_queries"]
            outputs["proj_tokens"] = end_points["proj_tokens"]
        losses, _ = set_criterion_losses(outputs, targets, num_boxes, cfg)
        for name in ("loss_ce", "loss_bbox", "loss_giou"):
            end_points[f"{prefix}_{name}"] = losses[name]
        loss_ce = loss_ce + losses["loss_ce"]
        loss_bbox = loss_bbox + losses["loss_bbox"]
        loss_giou = loss_giou + losses["loss_giou"]
        if "loss_contrastive_align" in losses:
            end_points[f"{prefix}_loss_contrastive_align"] = losses[
                "loss_contrastive_align"]
            loss_contr = loss_contr + losses["loss_contrastive_align"]

    if "seeds_obj_cls_logits" in end_points:
        kps_loss = compute_points_obj_cls_loss_hard_topk(
            end_points, query_points_obj_topk)
    else:
        kps_loss = 0.0

    loss = 8 * kps_loss + 1.0 / (num_decoder_layers + 1) * (
        loss_ce + 5 * loss_bbox + loss_giou + loss_contr)
    end_points["loss_ce"] = loss_ce
    end_points["loss_bbox"] = loss_bbox
    end_points["loss_giou"] = loss_giou
    end_points["query_points_generation_loss"] = kps_loss
    end_points["loss_contrastive_align"] = loss_contr
    end_points["loss"] = loss
    return loss, end_points

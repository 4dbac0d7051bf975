"""Set criterion: soft-token CE, box L1 + GIoU, contrastive alignment and
the keypoint-objectness focal loss, fixed-shape and mask-driven.

Counterpart of `butd_detr_tpu/losses/criterion.py` (reference
models/losses.py:94-617): every loss is a masked tensor op over padded
(B, G_max) targets. `num_boxes` is the one global count of valid targets
of the batch: across processes (`group`, the dp group) it is summed over
every rank's rows, and each rank divides by its share of it, so that the
mean of the ranks' losses is the global batch's loss, as under the JAX
package's dp-sharded step. Every other denominator is a per-sample mean
(the objectness loss's `/ B`) or a constant, which equal shards average
correctly. The matched predictions are gathered with the port's
`gather_points`, so their gradient is the row scatter-add. The set losses
take a leading prefix axis, (P, B, ...), and return one value a prefix,
so that the proposal and decoder-layer prefixes are computed in one pass;
the per-scene targets are broadcast over that axis.

Nothing crosses between host and device, so the loss never makes the host
wait: the matching solves where the costs lie, and a value written through
an index tensor is a tensor on the device (a Python number there is
copied from the host, a synchronisation).
"""

from typing import Dict, NamedTuple

import torch
import torch.distributed as dist

from butd_detr_tpu_torch.losses.boxes import (
    box_cxcyczwhd_to_xyzxyz,
    matched_giou3d,
)
from butd_detr_tpu_torch.losses.matcher import hungarian_match
from butd_detr_tpu_torch.models.bdetr import prediction_prefixes
from butd_detr_tpu_torch.ops import gather_points
from butd_detr_tpu_torch.parallel.collectives import reduce_from_group
from butd_detr_tpu_torch.utils.numerics import reciprocal_f32


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
    """Prefix, batch and query indices that scatter per-target rows onto
    their matched queries, for a (P, B, G) assignment; padded targets go
    to the spare row `num_queries`."""
    assignment = assignment.long()
    q_ids = torch.where(box_label_mask > 0, assignment,
                        torch.full_like(assignment, num_queries))
    P, B = q_ids.shape[:2]
    dev = q_ids.device
    p_ids = torch.arange(P, device=dev)[:, None, None].expand_as(q_ids)
    b_ids = torch.arange(B, device=dev)[None, :, None].expand_as(q_ids)
    return p_ids, b_ids, q_ids


def _matched_weight(rows, num_queries, eos_coef):
    """(P, B, Q): 1 for matched queries, eos_coef for the others."""
    P, B = rows[2].shape[:2]
    dev = rows[2].device
    matched = torch.zeros(P, B, num_queries + 1, dtype=torch.bool,
                          device=dev)
    matched[rows] = torch.ones((), dtype=torch.bool, device=dev)
    one = torch.ones((), device=dev)
    return torch.where(matched[..., :num_queries], one, eos_coef * one)


def loss_labels_st(pred_logits, positive_map, assignment, box_label_mask,
                   num_boxes, eos_coef=0.1):
    """Soft-token cross-entropy (reference loss_labels_st) of P prefixes:
    (P, B, Q, C) logits, (P, B, G) assignment, the scenes' (B, G, C)
    positive map -> (P,). Unmatched queries target the last bin ("no
    object") with weight eos_coef, matched queries their target's positive
    map."""
    P, B, Q, C = pred_logits.shape
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    rows = _matched_rows(assignment, box_label_mask, Q)
    target_sim = torch.zeros(P, B, Q + 1, C, device=logp.device)
    target_sim[..., -1] = 1.0
    target_sim[rows] = positive_map.float()  # broadcast over the prefixes
    target_sim = target_sim[:, :, :Q]
    entropy = torch.log(target_sim + 1e-6) * target_sim
    loss_ce = (entropy - logp * target_sim).sum(dim=-1)  # (P, B, Q)
    w = _matched_weight(rows, Q, eos_coef)
    return (loss_ce * w).sum(dim=(1, 2)) / num_boxes


def loss_boxes(pred_boxes, gt_boxes, assignment, box_label_mask, num_boxes):
    """L1 (size terms x 0.2) + GIoU on the matched pairs of P prefixes:
    (P, B, Q, 6) predictions, (P, B, G) assignment, the scenes' (B, G, 6)
    boxes -> {loss_bbox, loss_giou}, each (P,). One row gather for all."""
    P, B = assignment.shape[:2]
    src = gather_points(pred_boxes.flatten(0, 1),
                        assignment.flatten(0, 1)).unflatten(0, (P, B))
    l1 = (src - gt_boxes).abs()
    l1 = l1[..., :3].sum(-1) + 0.2 * l1[..., 3:].sum(-1)  # (P, B, G)
    m = box_label_mask.float()
    giou = matched_giou3d(box_cxcyczwhd_to_xyzxyz(src),
                          box_cxcyczwhd_to_xyzxyz(gt_boxes))
    return {"loss_bbox": (l1 * m).sum(dim=(1, 2)) / num_boxes,
            "loss_giou": ((1.0 - giou) * m).sum(dim=(1, 2)) / num_boxes}


def contrastive_logits(proj_queries, proj_tokens, temperature=0.07):
    """(..., B, Q, L) query-token similarities over the temperature, in
    f32, for (..., B, Q, D) queries (a leading prefix axis or none) and
    the scenes' (B, L, D) tokens, which are not copied per prefix.
    The JAX package divides by the constant inside its jitted train step.
    In f32 XLA multiplies by the f32 reciprocal instead; so does the port.
    In bf16 (`--use_bf16`) it divides for real, by bf16(temperature), and
    rounds the quotient to bf16; the port divides by a bf16 tensor on the
    device (a Python divisor would become a reciprocal multiply on CUDA)."""
    sim = torch.einsum("...bqd,bld->...bql", proj_queries, proj_tokens)
    if sim.dtype is torch.float32:
        return sim * reciprocal_f32(temperature)
    return (sim / sim.new_full((), temperature)).float()


def loss_contrastive_align(proj_queries, proj_tokens, text_mask, positive_map,
                           assignment, box_label_mask, num_boxes,
                           eos_coef=0.1, temperature=0.07,
                           mask_pad_tokens: bool = True):
    """Bidirectional InfoNCE between the (P, B, Q, 64) queries of P
    prefixes and the scenes' (B, L, 64) tokens, both L2-normalized
    (losses.py:420-489) -> (P,). `text_mask` (B, L) is 1 on real tokens;
    `positive_map` (B, G, C) has C >= L; `assignment` is (P, B, G)."""
    P, B, Q, _ = proj_queries.shape
    L = proj_tokens.shape[1]
    dev = proj_queries.device
    logits = contrastive_logits(proj_queries, proj_tokens, temperature)
    tok_real = (text_mask > 0) if mask_pad_tokens else torch.ones_like(
        text_mask, dtype=torch.bool)
    logits = logits.masked_fill(~tok_real[:, None, :], -1e9)

    # 'not mentioned' default, the same for every prefix and query: the
    # eos token and the one before it
    ar = torch.arange(B, device=dev)
    inds = text_mask.long().sum(dim=1) - 1  # (B,) last real token
    true = torch.ones((), dtype=torch.bool, device=dev)
    default = torch.zeros(B, L, dtype=torch.bool, device=dev)
    default[ar, inds] = true
    default[ar, inds - 1] = true
    pm = default[:, None, :].expand(P, B, Q + 1, L).clone(
        memory_format=torch.contiguous_format)
    # matched queries get their target's positive map rows
    rows = _matched_rows(assignment, box_label_mask, Q)
    pm[rows] = positive_map[..., :L] > 0
    positive = pm[:, :, :Q] & tok_real[:, None, :]  # (P, B, Q, L)

    qmask = _matched_weight(rows, Q, eos_coef)  # (P, B, Q)
    # per-token weight: 1 for the eos token, eos_coef otherwise; 0 on pads
    tmask = torch.full((B, L), float(eos_coef), device=dev)
    tmask[ar, inds] = torch.ones((), device=dev)
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

    box_to_token = (direction(-1) * qmask).sum(dim=(1, 2))
    token_to_box = (direction(-2) * tmask).sum(dim=(1, 2))
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
    objectness_label[torch.arange(B, device=dev)[:, None], topk_inds] = \
        torch.ones((), device=dev)
    objectness_label = objectness_label[:, :K].masked_fill(seed_is_bg, 0.0)

    cls_weights = torch.full((B, K), 1.0 / max(K, 1), device=dev)
    loss = sigmoid_focal_loss(logits, objectness_label, cls_weights)
    return loss.sum() * reciprocal_f32(B)  # jitted `/ B`


def _prefix_losses(pred_logits, pred_boxes, assignment, targets, num_boxes,
                   cfg: CriterionConfig, proj_queries=None,
                   proj_tokens=None):
    """The set losses of P prefixes in one pass: (P, B, Q, C) logits,
    (P, B, Q, 6) boxes, (P, B, G) assignment and optionally (P, B, Q, 64)
    queries, against the scenes' (B, ...) targets and (B, L, 64) tokens,
    which every prefix shares. Returns {name: (P,)}."""
    losses = {"loss_ce": loss_labels_st(
        pred_logits, targets["positive_map"], assignment,
        targets["box_label_mask"], num_boxes, cfg.eos_coef)}
    losses.update(loss_boxes(pred_boxes, targets["boxes"], assignment,
                             targets["box_label_mask"], num_boxes))
    if proj_queries is not None:
        losses["loss_contrastive_align"] = loss_contrastive_align(
            proj_queries, proj_tokens, targets["text_mask"],
            targets["positive_map"], assignment, targets["box_label_mask"],
            num_boxes, cfg.eos_coef, cfg.temperature,
            mask_pad_tokens=cfg.mask_pad_tokens)
    return losses


def set_criterion_losses(outputs: Dict[str, torch.Tensor],
                         targets: Dict[str, torch.Tensor], num_boxes,
                         cfg: CriterionConfig):
    """One prefix's losses (reference SetCriterion.forward): the stacked
    pass of `compute_hungarian_loss` at P = 1.

    outputs: pred_logits (B, Q, C), pred_boxes (B, Q, 6), optionally
    proj_queries / proj_tokens and a ready `assignment`; targets: boxes
    (B, G, 6), positive_map (B, G, C), box_label_mask (B, G), text_mask
    (B, L). Returns (losses, assignment), each loss a scalar."""
    if "assignment" in outputs:
        assignment = outputs["assignment"]
    else:
        assignment = hungarian_match(
            outputs["pred_logits"], outputs["pred_boxes"],
            targets["positive_map"], targets["boxes"],
            targets["box_label_mask"], cfg.cost_class, cfg.cost_bbox,
            cfg.cost_giou,
            tgt_labels=None if cfg.use_soft_token else targets["labels"])
    contrastive = cfg.use_contrastive_align and "proj_queries" in outputs
    losses = _prefix_losses(
        outputs["pred_logits"][None], outputs["pred_boxes"][None],
        assignment[None], targets, num_boxes, cfg,
        outputs["proj_queries"][None] if contrastive else None,
        outputs["proj_tokens"] if contrastive else None)
    return {k: v[0] for k, v in losses.items()}, assignment


def compute_hungarian_loss(end_points: Dict[str, torch.Tensor],
                           num_decoder_layers: int = 6,
                           cfg: CriterionConfig = CriterionConfig(),
                           query_points_obj_topk: int = 4, group=None):
    """Total loss over the proposal and decoder-layer prefixes (reference
    compute_hungarian_loss): 8 * kps + (ce + 5 * bbox + giou + contrastive)
    / (layers + 1). Adds the per-prefix and summed losses to `end_points`
    and returns (loss, end_points).

    One pass over the P = layers + 1 prefixes stacked on a leading axis:
    one matching call for all prefixes' cost matrices, on the device, then
    each set loss once over the (P, B, ...) predictions, the scenes'
    targets broadcast over P (one matched-box gather, so one scatter-add in
    the backward), giving (P,) per-prefix losses whose sums are the totals.
    `group`: the process group whose rows share one box count (None: this
    batch alone)."""
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
    num_boxes = reduce_from_group(
        targets["box_label_mask"].float().sum(), group).clamp_min(1.0)
    if group is not None:
        num_boxes = num_boxes / dist.get_world_size(group)

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

    all_proj = proj_tokens = None
    if cfg.use_contrastive_align and "proj_tokens" in end_points:
        all_proj = torch.stack(
            [end_points[f"{p}proj_queries"] for p in prefixes])
        proj_tokens = end_points["proj_tokens"]
    losses = _prefix_losses(all_logits, all_boxes, assignment_all, targets,
                            num_boxes, cfg, all_proj, proj_tokens)
    by_prefix = {name: v.unbind() for name, v in losses.items()}
    for pi, prefix in enumerate(prefixes):
        for name, values in by_prefix.items():
            end_points[f"{prefix}_{name}"] = values[pi]
    loss_ce = losses["loss_ce"].sum()
    loss_bbox = losses["loss_bbox"].sum()
    loss_giou = losses["loss_giou"].sum()
    loss_contr = losses["loss_contrastive_align"].sum() \
        if "loss_contrastive_align" in losses else 0.0

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

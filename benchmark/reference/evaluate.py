"""The grounding evaluators' counts of one batch, in plain PyTorch: a frozen
copy of `butd_detr_tpu_torch/eval/grounding.py`'s hit functions and of the
evaluators' accumulation, run on the program's end points to judge the
counts the program's evaluator added for that batch. Both sides compute the
same float32 operations on the same inputs, so the counts are compared
exactly."""

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.loss import (
    box_cxcyczwhd_to_xyzxyz,
    matched_iou3d,
    pairwise_iou3d,
)
from benchmark.reference.model import top_k_stable

FIELDS = (("vd", "vid", "is_view_dep"), ("hard", "easy", "is_hard"),
          ("unique", "multi", "is_unique"))


def _pad(scores, width):
    t = scores.shape[-1]
    if t < width:
        scores = F.pad(scores, (0, width - t))
    return scores[..., :width]


def _modes(ep, prefix, width):
    span = _pad(torch.softmax(ep[f"{prefix}sem_cls_scores"].float(), -1),
                width)
    sim = torch.einsum("bqd,btd->bqt", ep[f"{prefix}proj_queries"].float(),
                       ep["proj_tokens"].float())
    temp = float(np.float32(1.0) / np.float32(0.07))
    contrast = _pad(torch.softmax(sim * temp, -1), width)
    return {"bbs": span, "bbf": contrast}


def _pred(ep, prefix):
    return torch.cat([ep[f"{prefix}center"].float(),
                      ep[f"{prefix}pred_size"].float()], -1)


def _gt(ep, only_root=True):
    pmap = (ep["positive_map"] > 0).float()
    gt = torch.cat([ep["center_label"][..., :3], ep["size_gts"]],
                   dim=-1).float()
    mask = ep["box_label_mask"].float()
    if only_root:
        pmap, gt, mask = pmap[:, :1], gt[:, :1], mask[:, :1]
    return pmap, gt, mask


def _breakdown(counts, ep, found, root_mask):
    for pos_name, neg_name, key in FIELDS:
        flag = torch.as_tensor(np.asarray(ep[key]).astype(bool),
                               device=found.device)
        pos, neg = flag.float() * root_mask, (~flag).float() * root_mask
        counts[pos_name] = float((found * pos).sum())
        counts[neg_name] = float((found * neg).sum())


def topk_counts(ep: Dict, prefixes: Sequence[str],
                thresholds=(0.25, 0.5), topks=(1, 5, 10),
                width: int = 256) -> Dict:
    """GroundingEvaluator.evaluate's additions to `dets` for one batch."""
    pmap, gt, mask = _gt(ep)
    counts = {}
    kmax = max(topks)
    for p in prefixes:
        pred = _pred(ep, p)
        for m, s in _modes(ep, p, width).items():
            scores = torch.einsum("bqt,bkt->bkq", s, pmap)
            idx = top_k_stable(scores, kmax)
            B, K = idx.shape[:2]
            pb = torch.gather(pred[:, None].expand(B, K, -1, 6), 2,
                              idx[..., None].expand(-1, -1, -1, 6))
            ious = matched_iou3d(box_cxcyczwhd_to_xyzxyz(gt)[:, :, None, :],
                                 box_cxcyczwhd_to_xyzxyz(pb))
            for t in thresholds:
                for k in topks:
                    hit = (ious > t)[..., :k].any(dim=-1).float()
                    counts[(p, t, k, m)] = float((hit * mask).sum())
                    if (p, t, k, m) == ("last_", thresholds[0], 1, "bbf"):
                        found = hit[:, 0]
    _breakdown(counts, ep, found, mask[:, 0])
    return counts


def gt_counts(ep: Dict, prefixes: Sequence[str], width: int = 256) -> Dict:
    """GroundingGTEvaluator.evaluate's additions to `dets` for one batch:
    predictions suppressed where no scene box overlaps them by > 0.25, the
    top one snapped to its nearest scene box, a hit an exact match with
    the root target."""
    pmap, gt, mask = _gt(ep)
    all_boxes = ep["all_bboxes"].float()
    all_mask = ep["all_bbox_label_mask"].bool()
    all_xyz = box_cxcyczwhd_to_xyzxyz(all_boxes)
    counts = {}
    for p in prefixes:
        pred = _pred(ep, p)
        ious, _ = pairwise_iou3d(all_xyz, box_cxcyczwhd_to_xyzxyz(pred))
        ious = torch.where(all_mask[:, :, None], ious, torch.zeros_like(ious))
        correct = (ious.amax(dim=1) > 0.25).float()
        for m, s in _modes(ep, p, width).items():
            scores = torch.einsum("bqt,bkt->bkq", s, pmap)[:, 0]
            top = torch.argmax(scores * correct, dim=-1)
            pbox = torch.gather(pred, 1, top[:, None, None].expand(-1, 1, 6))
            snap, _ = pairwise_iou3d(all_xyz, box_cxcyczwhd_to_xyzxyz(pbox))
            snap = torch.where(all_mask[:, :, None], snap,
                               torch.full_like(snap, -1.0))
            best = torch.argmax(snap[:, :, 0], dim=-1)
            snapped = torch.gather(all_boxes, 1,
                                   best[:, None, None].expand(-1, 1, 6))[:, 0]
            hit = (snapped == gt[:, 0]).all(dim=-1).float()
            counts[(p, m)] = float((hit * mask[:, 0]).sum())
            if (p, m) == ("last_", "bbf"):
                found = hit
    _breakdown(counts, ep, found, mask[:, 0])
    return counts

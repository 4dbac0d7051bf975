"""Detection mAP stack: prediction parsing, NMS dispatch, VOC AP.

The port's copy of `butd_detr_tpu/eval/detection.py`, a rebuild of
reference `models/ap_helper.py` (parse_predictions:71,
parse_groundtruths:237, APCalculator:297) and `utils/eval_det.py`
(voc_ap:30, eval_det_cls:162, eval_det_multiprocessing:310,
eval_grounding:364). Host-side numpy cold path per SURVEY.md section 7.8;
the per-proposal Python loops of the reference are vectorized. BUTD-DETR is
size-class-agnostic with soft-token ("hungarian") objectness: objectness is
1 - P(no-object-bin) and class probs are renormalized by it
(ap_helper.py:146-149). The JAX package matches detections to boxes in
host C++ where it can (`csrc/butd_native.cpp voc_match`); the port runs
the numpy loop, that package's fallback.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from butd_detr_tpu_torch.eval.box_util import (
    aabb_iou,
    corners_to_aabb,
    flip_axis_to_camera,
    get_3d_box_batch,
    get_iou_obb,
)
from butd_detr_tpu_torch.eval.nms import (
    nms_2d_faster,
    nms_3d_faster,
    nms_3d_faster_samecls,
)


def softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def default_parse_config(
    dataset_num_class: int = 485,
    nms_iou: float = 0.25,
    conf_thresh: float = 0.0,
) -> Dict:
    """Mirrors the det-eval config of reference train_dist_mod.py:176-189."""
    return {
        "num_class": dataset_num_class,
        "remove_empty_box": False,
        "use_3d_nms": True,
        "nms_iou": nms_iou,
        "use_old_type_nms": False,
        "cls_nms": True,
        "per_class_proposal": True,
        "conf_thresh": conf_thresh,
    }


def parse_predictions(
    end_points: Dict,
    config_dict: Dict,
    prefix: str = "last_",
    sem_cls_probs: Optional[np.ndarray] = None,
) -> List[List[Tuple[int, np.ndarray, float]]]:
    """Predicted boxes -> per-sample [(class, (8,3) camera corners, score)].

    Vectorized equivalent of reference parse_predictions (ap_helper.py:
    71-234), size_cls_agnostic + hungarian path. `sem_cls_probs` overrides
    the soft-token class probabilities — the detection harness passes
    token->class projected probabilities here (train_dist_mod.py:206-232).
    """
    center = np.asarray(end_points[f"{prefix}center"])  # (B, K, 3)
    size = np.asarray(end_points[f"{prefix}pred_size"])  # (B, K, 3)
    B, K, _ = center.shape

    raw = softmax(np.asarray(end_points[f"{prefix}sem_cls_scores"], np.float64))
    obj_prob = 1.0 - raw[..., -1]  # (B, K)
    if sem_cls_probs is None:
        sem_cls_probs = raw[..., :-1] / np.maximum(obj_prob[..., None], 1e-12)
    pred_sem_cls = np.argmax(sem_cls_probs, axis=-1)  # (B, K)

    corners = get_3d_box_batch(
        size, np.zeros((B, K)), flip_axis_to_camera(center)
    )  # (B, K, 8, 3) camera frame
    aabb = corners_to_aabb(corners)  # (B, K, 6)

    nonempty = np.ones((B, K), bool)
    if config_dict.get("remove_empty_box", False):
        # heading==0: in-hull test reduces to AABB containment in depth frame
        pc = np.asarray(end_points["point_clouds"])[:, :, :3]  # (B, N, 3)
        # depth-frame bounds: x -> x, z_cam -> y_depth, -y_cam -> z_depth
        lo = np.stack(
            [aabb[..., 0], aabb[..., 2], -aabb[..., 4]], axis=-1
        )
        hi = np.stack(
            [aabb[..., 3], aabb[..., 5], -aabb[..., 1]], axis=-1
        )
        inside = (
            (pc[:, None] >= lo[:, :, None] - 1e-9)
            & (pc[:, None] <= hi[:, :, None] + 1e-9)
        ).all(-1)  # (B, K, N)
        nonempty = inside.sum(-1) >= 5

    pred_mask = np.zeros((B, K), bool)
    for i in range(B):
        idx = np.where(nonempty[i])[0]
        if idx.size == 0:
            continue
        if not config_dict["use_3d_nms"]:
            boxes = np.concatenate(
                [
                    aabb[i, idx][:, [0, 2, 3, 5]],
                    obj_prob[i, idx, None],
                ],
                axis=-1,
            )
            pick = nms_2d_faster(
                boxes, config_dict["nms_iou"], config_dict["use_old_type_nms"]
            )
        elif not config_dict.get("cls_nms", False):
            boxes = np.concatenate(
                [aabb[i, idx], obj_prob[i, idx, None]], axis=-1
            )
            pick = nms_3d_faster(
                boxes, config_dict["nms_iou"], config_dict["use_old_type_nms"]
            )
        else:
            boxes = np.concatenate(
                [
                    aabb[i, idx],
                    obj_prob[i, idx, None],
                    pred_sem_cls[i, idx, None].astype(np.float64),
                ],
                axis=-1,
            )
            pick = nms_3d_faster_samecls(
                boxes, config_dict["nms_iou"], config_dict["use_old_type_nms"]
            )
        pred_mask[i, idx[pick]] = True
    end_points[f"{prefix}pred_mask"] = pred_mask

    batch_pred = []
    conf = config_dict["conf_thresh"]
    for i in range(B):
        keep = np.where(pred_mask[i] & (obj_prob[i] > conf))[0]
        if config_dict.get("per_class_proposal", False):
            cur = [
                (int(c), corners[i, j], float(sem_cls_probs[i, j, c] * obj_prob[i, j]))
                for c in range(config_dict["num_class"])
                for j in keep
            ]
        else:
            cur = [
                (int(pred_sem_cls[i, j]), corners[i, j], float(obj_prob[i, j]))
                for j in keep
            ]
        batch_pred.append(cur)
    return batch_pred


def parse_groundtruths(
    end_points: Dict, config_dict: Optional[Dict] = None
) -> List[List[Tuple[int, np.ndarray]]]:
    """GT boxes -> per-sample [(class, (8,3) camera corners)]
    (ap_helper.py:237-294, size_cls_agnostic path)."""
    center = np.asarray(end_points["center_label"])[:, :, :3]
    size = np.asarray(end_points["size_gts"])
    mask = np.asarray(end_points["box_label_mask"]).astype(bool)
    cls = np.asarray(end_points["sem_cls_label"])
    B, K2 = mask.shape
    corners = get_3d_box_batch(
        size, np.zeros((B, K2)), flip_axis_to_camera(center)
    )
    return [
        [(int(cls[i, j]), corners[i, j]) for j in np.where(mask[i])[0]]
        for i in range(B)
    ]


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric=False) -> float:
    """PASCAL VOC AP from a precision/recall curve (eval_det.py:30-61)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = prec[rec >= t].max() if (rec >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[i + 1] - mrec[i]) * mpre[i + 1]).sum())


def eval_det_cls(
    pred: Dict, gt: Dict, ovthresh=0.25, use_07_metric=False,
    get_iou_func=get_iou_obb,
):
    """Single-class VOC precision/recall (eval_det.py:162-260): sort all
    detections by confidence, greedily match each against unclaimed GT of
    the same image at IoU>=ovthresh."""
    class_recs = {}
    npos = 0
    for img_id, boxes in gt.items():
        npos += len(boxes)
        class_recs[img_id] = {
            "bbox": np.array(boxes), "det": [False] * len(boxes)
        }
    for img_id in pred:
        if img_id not in class_recs:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids, confidence, BB = [], [], []
    for img_id, dets in pred.items():
        for box, score in dets:
            image_ids.append(img_id)
            confidence.append(score)
            BB.append(box)
    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    if nd > 0:
        order = np.argsort(-np.asarray(confidence))
        for rank, d in enumerate(order):
            R = class_recs[image_ids[d]]
            bb = np.asarray(BB[d], float)
            ovmax, jmax = -np.inf, -1
            for j, bgt in enumerate(R["bbox"]):
                ov = get_iou_func(bb, np.asarray(bgt, float))
                if ov > ovmax:
                    ovmax, jmax = ov, j
            if ovmax > ovthresh and not R["det"][jmax]:
                tp[rank] = 1.0
                R["det"][jmax] = True
            else:
                fp[rank] = 1.0
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos + 1e-8)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def eval_det(pred_all: Dict, gt_all: Dict, ovthresh=0.25,
             use_07_metric=False):
    """All-class detection eval (eval_det.py:263-361), one class after
    another on the calling process (the reference fans classes out over a
    Pool(10); forking after CUDA initialisation is unsafe)."""
    pred: Dict[int, Dict] = {}
    gt: Dict[int, Dict] = {}
    for img_id, dets in pred_all.items():
        for classname, bbox, score in dets:
            pred.setdefault(classname, {}).setdefault(img_id, []).append(
                (bbox, score)
            )
    for img_id, gts in gt_all.items():
        for classname, bbox in gts:
            gt.setdefault(classname, {}).setdefault(img_id, []).append(bbox)
    # reference quirk (eval_det.py:324-333): classes that appear only in
    # predictions still get (empty) gt entries, so they contribute AP=0
    # terms to the mAP mean
    for classname in pred:
        gt.setdefault(classname, {})

    rec, prec, ap = {}, {}, {}
    for c in gt:
        if c in pred:
            rec[c], prec[c], ap[c] = eval_det_cls(pred[c], gt[c], ovthresh,
                                                  use_07_metric)
        else:
            rec[c], prec[c], ap[c] = 0.0, 0.0, 0.0
    return rec, prec, ap


def eval_grounding(pred_all: Dict, gt_all: Dict, ovthresh=0.25):
    """Top-k grounding accuracy from parsed detections
    (eval_det.py:364-409): per image, rank boxes by score, hit if any of the
    top-k overlaps the (first) target GT box at IoU >= ovthresh."""
    topks = (1, 5, 10)
    score = {k: 0.0 for k in topks}
    count = 0.0
    for img_id, prediction in pred_all.items():
        target = gt_all[img_id]
        if not prediction or not target:
            continue
        pred_sorted = sorted(prediction, key=lambda x: x[2], reverse=True)
        boxes = corners_to_aabb(
            np.stack([np.asarray(p[1]) for p in pred_sorted])
        )  # (nd, 6)
        tbox = corners_to_aabb(np.asarray(target[0][1]))[None]  # (1, 6)
        ious = aabb_iou(boxes, np.broadcast_to(tbox, boxes.shape))
        for k in topks:
            if ious[:k].max() >= ovthresh:
                score[k] += 1.0
        count += 1.0
    return {k: v / max(count, 1.0) for k, v in score.items()}


class APCalculator:
    """Accumulate parsed predictions/GTs and compute per-class AP + AR
    (ap_helper.py:297-361)."""

    def __init__(self, ap_iou_thresh=0.25, class2type_map=None):
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type_map = class2type_map
        self.reset()

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0

    def step(self, batch_pred_map_cls, batch_gt_map_cls):
        assert len(batch_pred_map_cls) == len(batch_gt_map_cls)
        for pred, gt in zip(batch_pred_map_cls, batch_gt_map_cls):
            self.pred_map_cls[self.scan_cnt] = pred
            self.gt_map_cls[self.scan_cnt] = gt
            self.scan_cnt += 1

    def compute_metrics(self) -> Dict:
        rec, _, ap = eval_det(self.pred_map_cls, self.gt_map_cls,
                              ovthresh=self.ap_iou_thresh)
        ret = {}
        rec_list = []
        for key in sorted(ap.keys()):
            name = (
                self.class2type_map[key] if self.class2type_map else str(key)
            )
            ret[f"{name} Average Precision"] = ap[key]
            r = rec[key][-1] if np.ndim(rec[key]) > 0 and len(rec[key]) else 0
            ret[f"{name} Recall"] = r
            rec_list.append(r)
        ret["mAP"] = float(np.mean(list(ap.values()))) if ap else 0.0
        ret["AR"] = float(np.mean(rec_list)) if rec_list else 0.0
        return ret

    def compute_accuracy(self) -> Dict:
        return eval_grounding(
            self.pred_map_cls, self.gt_map_cls, ovthresh=self.ap_iou_thresh
        )

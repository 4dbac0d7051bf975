"""Box precision/recall utilities (class-agnostic).

The port's copy of `butd_detr_tpu/eval/metrics.py`, a rebuild of reference
`utils/metric_util.py:26-121` (multi_scene_precision_recall,
single_scene_precision_recall, calc_iou) — vectorized numpy instead of the
reference's per-pair python loops. Boxes are cxcyczwhd.
"""

from typing import Optional, Tuple

import numpy as np


def calc_iou(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """IoU of two cxcyczwhd boxes (metric_util.py:97-119)."""
    return float(_pairwise_iou(box_a[None], box_b[None])[0, 0])


def _pairwise_iou(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 6) x (M, 6) cxcyczwhd -> (N, M) IoU."""
    lo_a = boxes_a[:, :3] - boxes_a[:, 3:] / 2
    hi_a = boxes_a[:, :3] + boxes_a[:, 3:] / 2
    lo_b = boxes_b[:, :3] - boxes_b[:, 3:] / 2
    hi_b = boxes_b[:, :3] + boxes_b[:, 3:] / 2
    lo = np.maximum(lo_a[:, None], lo_b[None])
    hi = np.minimum(hi_a[:, None], hi_b[None])
    d = hi - lo
    # reference zeroes IoU unless strictly positive overlap on all axes
    inter = np.where((d > 0).all(-1), d.prod(-1), 0.0)
    va = boxes_a[:, 3:].prod(-1)
    vb = boxes_b[:, 3:].prod(-1)
    return inter / (va[:, None] + vb[None] - inter)


def single_scene_precision_recall(
    labels: np.ndarray, pred: np.ndarray, iou_thresh: float,
    conf_thresh: float,
) -> Tuple[int, int, int]:
    """labels (N, 6); pred (M, 7) = box + confidence. Class-agnostic
    TP/FP/FN (metric_util.py:57-90)."""
    gt = np.asarray(labels)[:, :6]
    pred = np.asarray(pred)
    keep = pred[:, 6] > conf_thresh
    boxes = pred[keep, :6]
    if len(boxes) == 0 or len(gt) == 0:
        return 0, len(boxes), len(gt)
    iou = _pairwise_iou(boxes, gt)
    good = iou >= iou_thresh
    tp = int(good.any(axis=1).sum())
    fp = len(boxes) - tp
    fn = len(gt) - int(good.any(axis=0).sum())
    return tp, fp, fn


def precision_recall(tp: int, fp: int, fn: int) -> Tuple[float, float]:
    prec = tp / (tp + fp) if tp + fp > 0 else 0.0
    rec = tp / (tp + fn) if tp + fn > 0 else 0.0
    return prec, rec


def multi_scene_precision_recall(
    labels: np.ndarray,
    pred: np.ndarray,
    iou_thresh: float,
    conf_thresh: float,
    label_mask: Optional[np.ndarray] = None,
    pred_mask: Optional[np.ndarray] = None,
):
    """Batched TP/FP/FN + (precision, recall) (metric_util.py:26-54)."""
    labels = np.asarray(labels)
    pred = np.asarray(pred)
    if label_mask is None:
        label_mask = np.ones(labels.shape[:2])
    if pred_mask is None:
        pred_mask = np.ones(pred.shape[:2])
    tp = fp = fn = 0
    for b in range(labels.shape[0]):
        t, f, n = single_scene_precision_recall(
            labels[b][label_mask[b] == 1],
            pred[b][pred_mask[b] == 1],
            iou_thresh, conf_thresh,
        )
        tp += t
        fp += f
        fn += n
    return tp, fp, fn, precision_recall(tp, fp, fn)

"""Axis-aligned 3D box math (cxcyczwhd and corner forms), batched.

Counterpart of `butd_detr_tpu/losses/boxes.py` (reference
models/losses.py:27-91). Sizes are clamped at 1e-6 instead of asserted
non-negative, and every IoU/GIoU denominator is guarded with `_EPS_VOL`: a
1e-6 size is absorbed by f32 at centres of magnitude >~10, two such boxes
have a zero union, and the 0/0 would escape downstream masking as 0 * NaN.
Real boxes have volumes far above the guard.
"""

import torch

_EPS_VOL = 1e-10


def box_cxcyczwhd_to_xyzxyz(x: torch.Tensor) -> torch.Tensor:
    """Center+size -> min/max corners; sizes clamped at 1e-6."""
    c, s = x[..., :3], x[..., 3:].clamp_min(1e-6)
    return torch.cat([c - 0.5 * s, c + 0.5 * s], dim=-1)


def box_volume(box: torch.Tensor) -> torch.Tensor:
    """(..., 6) corner boxes -> (...,) volumes."""
    d = box[..., 3:] - box[..., :3]
    return d[..., 0] * d[..., 1] * d[..., 2]


def _clipped_volume(lo, hi):
    d = (hi - lo).clamp_min(0)
    return d[..., 0] * d[..., 1] * d[..., 2]


def pairwise_iou3d(box_a, box_b):
    """(..., N, 6) x (..., M, 6) corner boxes -> iou, union (..., N, M)."""
    inter = _clipped_volume(
        torch.maximum(box_a[..., :, None, :3], box_b[..., None, :, :3]),
        torch.minimum(box_a[..., :, None, 3:], box_b[..., None, :, 3:]))
    union = (box_volume(box_a)[..., :, None] + box_volume(box_b)[..., None, :]
             - inter)
    return inter / union.clamp_min(_EPS_VOL), union


def matched_iou3d(boxes1, boxes2):
    """Elementwise IoU for aligned (..., 6) corner boxes."""
    inter = _clipped_volume(torch.maximum(boxes1[..., :3], boxes2[..., :3]),
                            torch.minimum(boxes1[..., 3:], boxes2[..., 3:]))
    union = box_volume(boxes1) + box_volume(boxes2) - inter
    return inter / union.clamp_min(_EPS_VOL)


def generalized_box_iou3d(boxes1, boxes2):
    """Pairwise GIoU (..., N, M) for corner boxes (losses.py:70-91)."""
    iou, union = pairwise_iou3d(boxes1, boxes2)
    volume = _clipped_volume(
        torch.minimum(boxes1[..., :, None, :3], boxes2[..., None, :, :3]),
        torch.maximum(boxes1[..., :, None, 3:], boxes2[..., None, :, 3:]))
    return iou - (volume - union) / volume.clamp_min(_EPS_VOL)


def matched_giou3d(boxes1, boxes2):
    """Elementwise GIoU for aligned (..., 6) corner boxes (the diagonal of
    `generalized_box_iou3d` without the N * M blowup)."""
    inter = _clipped_volume(torch.maximum(boxes1[..., :3], boxes2[..., :3]),
                            torch.minimum(boxes1[..., 3:], boxes2[..., 3:]))
    union = box_volume(boxes1) + box_volume(boxes2) - inter
    iou = inter / union.clamp_min(_EPS_VOL)
    vol = _clipped_volume(torch.minimum(boxes1[..., :3], boxes2[..., :3]),
                          torch.maximum(boxes1[..., 3:], boxes2[..., 3:]))
    return iou - (vol - union) / vol.clamp_min(_EPS_VOL)

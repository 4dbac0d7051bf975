"""Greedy NMS over axis-aligned boxes (2D / 3D / class-aware), numpy.

The port's copy of `butd_detr_tpu/eval/nms.py` (reference
`utils/nms.py:44-157`: nms_2d_faster, nms_3d_faster,
nms_3d_faster_samecls). One vectorized core handles all three: boxes are
``[mins..., maxs..., score(, class)]``; suppression compares the current
top-scoring box against all survivors at once. ``old_type`` divides the
intersection by the candidate's area instead of the union (legacy
overlap definition, nms.py:68-72). The JAX package first tries its host
C++ (`csrc/butd_native.cpp`); the port runs the numpy core, that
package's fallback.
"""

from typing import Optional

import numpy as np


def _greedy_nms(
    mins: np.ndarray,  # (K, d)
    maxs: np.ndarray,  # (K, d)
    scores: np.ndarray,  # (K,)
    overlap_threshold: float,
    old_type: bool = False,
    classes: Optional[np.ndarray] = None,
):
    area = np.prod(maxs - mins, axis=-1)
    order = np.argsort(scores)  # ascending; pop from the end
    pick = []
    while order.size > 0:
        i = order[-1]
        pick.append(int(i))
        rest = order[:-1]
        lo = np.maximum(mins[i], mins[rest])
        hi = np.minimum(maxs[i], maxs[rest])
        inter = np.prod(np.clip(hi - lo, 0, None), axis=-1)
        if old_type:
            o = inter / area[rest]
        else:
            o = inter / (area[i] + area[rest] - inter)
        if classes is not None:
            o = o * (classes[rest] == classes[i])
        order = rest[o <= overlap_threshold]
    return pick


def nms_2d_faster(boxes, overlap_threshold, old_type=False):
    """boxes (K, 5) = [x1, y1, x2, y2, score]."""
    b = np.asarray(boxes)
    return _greedy_nms(
        b[:, [0, 1]], b[:, [2, 3]], b[:, 4], overlap_threshold, old_type
    )


def nms_3d_faster(boxes, overlap_threshold, old_type=False):
    """boxes (K, 7) = [x1, y1, z1, x2, y2, z2, score]."""
    b = np.asarray(boxes)
    return _greedy_nms(
        b[:, :3], b[:, 3:6], b[:, 6], overlap_threshold, old_type
    )


def nms_3d_faster_samecls(boxes, overlap_threshold, old_type=False):
    """boxes (K, 8) = [x1, y1, z1, x2, y2, z2, score, cls]; only same-class
    overlaps suppress."""
    b = np.asarray(boxes)
    return _greedy_nms(
        b[:, :3], b[:, 3:6], b[:, 6], overlap_threshold, old_type,
        classes=b[:, 7],
    )

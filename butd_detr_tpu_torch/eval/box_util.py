"""Numpy 8-corner box helpers for the detection-AP cold path.

The port's copy of `butd_detr_tpu/eval/box_util.py`, a rebuild of
reference `utils/box_util.py` (get_3d_box:221, box3d_iou:100-126) and the
axis-flip helpers in `models/ap_helper.py:37-54`. The reference
computes oriented-box IoU with a Sutherland-Hodgman polygon clip + scipy
ConvexHull per pair; since BUTD-DETR boxes always have heading 0
(ap_helper.py:117 hardcodes heading_angle = 0), axis-aligned IoU is exact
— we vectorize that and keep a general convex-hull path for nonzero
headings.
"""

import numpy as np


def flip_axis_to_camera(pc: np.ndarray) -> np.ndarray:
    """Depth (X right, Y fwd, Z up) -> camera (X right, Y down, Z fwd)."""
    out = pc[..., [0, 2, 1]].copy()
    out[..., 1] *= -1
    return out


def flip_axis_to_depth(pc: np.ndarray) -> np.ndarray:
    out = pc[..., [0, 2, 1]].copy()
    out[..., 2] *= -1
    return out


# Corner sign patterns in (l, h, w) halves, camera frame, matching the
# corner ordering of reference get_3d_box (box_util.py:228-230): first four
# corners are the +h (top) face counter-clockwise, last four the bottom.
_XS = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64) * 0.5
_YS = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float64) * 0.5
_ZS = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64) * 0.5


def get_3d_box(box_size, heading_angle, center) -> np.ndarray:
    """(l, w, h), heading (rad, clockwise about +y), center -> (8, 3)."""
    return get_3d_box_batch(
        np.asarray(box_size)[None],
        np.asarray([heading_angle]),
        np.asarray(center)[None],
    )[0]


def get_3d_box_batch(box_size, heading_angle, center) -> np.ndarray:
    """Vectorized corners: (..., 3), (...,), (..., 3) -> (..., 8, 3)."""
    box_size = np.asarray(box_size, np.float64)
    heading_angle = np.asarray(heading_angle, np.float64)
    center = np.asarray(center, np.float64)
    l = box_size[..., 0:1]
    w = box_size[..., 1:2]
    h = box_size[..., 2:3]
    x = l * _XS  # (..., 8)
    y = h * _YS
    z = w * _ZS
    c, s = np.cos(heading_angle)[..., None], np.sin(heading_angle)[..., None]
    xr = c * x + s * z
    zr = -s * x + c * z
    return np.stack([xr, y, zr], axis=-1) + center[..., None, :]


def corners_to_aabb(corners: np.ndarray) -> np.ndarray:
    """(..., 8, 3) corners -> (..., 6) [min_xyz, max_xyz]."""
    return np.concatenate(
        [corners.min(axis=-2), corners.max(axis=-2)], axis=-1
    )


def box3d_vol(corners: np.ndarray) -> np.ndarray:
    """Volume from edge lengths, no axis assumption (box_util.py:87-91)."""
    a = np.linalg.norm(corners[..., 0, :] - corners[..., 1, :], axis=-1)
    b = np.linalg.norm(corners[..., 1, :] - corners[..., 2, :], axis=-1)
    c = np.linalg.norm(corners[..., 0, :] - corners[..., 4, :], axis=-1)
    return a * b * c


def aabb_iou(box_a: np.ndarray, box_b: np.ndarray) -> np.ndarray:
    """Elementwise IoU of (..., 6) [min,max] boxes."""
    lo = np.maximum(box_a[..., :3], box_b[..., :3])
    hi = np.minimum(box_a[..., 3:], box_b[..., 3:])
    d = np.clip(hi - lo, 0, None)
    inter = d[..., 0] * d[..., 1] * d[..., 2]
    va = np.prod(box_a[..., 3:] - box_a[..., :3], axis=-1)
    vb = np.prod(box_b[..., 3:] - box_b[..., :3], axis=-1)
    return inter / (va + vb - inter)


def poly_area(x, y):
    return 0.5 * np.abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def polygon_clip(subject, clip):
    """Sutherland-Hodgman clip of polygon `subject` by convex `clip`
    (box_util.py:polygon_clip). Vertex lists of (x, y); None if empty."""

    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) > (b[1] - a[1]) * (p[0] - a[0])

    def intersect(a, b, p, q):
        dc = (a[0] - b[0], a[1] - b[1])
        dp = (p[0] - q[0], p[1] - q[1])
        n1 = a[0] * b[1] - a[1] * b[0]
        n2 = p[0] * q[1] - p[1] * q[0]
        den = dc[0] * dp[1] - dc[1] * dp[0]
        return ((n1 * dp[0] - n2 * dc[0]) / den, (n1 * dp[1] - n2 * dc[1]) / den)

    output = list(subject)
    a = clip[-1]
    for b in clip:
        inputs, output = output, []
        if not inputs:
            return None
        s = inputs[-1]
        for e in inputs:
            if inside(e, a, b):
                if not inside(s, a, b):
                    output.append(intersect(a, b, s, e))
                output.append(e)
            elif inside(s, a, b):
                output.append(intersect(a, b, s, e))
            s = e
        a = b
    return output or None


def convex_hull_intersection(p1, p2):
    """Intersection polygon + area of two convex polygons."""
    from scipy.spatial import ConvexHull

    inter = polygon_clip(p1, p2)
    if inter is None:
        return None, 0.0
    return inter, ConvexHull(inter).volume


def box3d_iou(corners1: np.ndarray, corners2: np.ndarray):
    """Oriented 3D IoU of two (8, 3) camera-frame corner boxes; returns
    (iou3d, iou2d_bev). Matches reference box3d_iou (box_util.py:100-126).
    """
    rect1 = [(corners1[i, 0], corners1[i, 2]) for i in range(3, -1, -1)]
    rect2 = [(corners2[i, 0], corners2[i, 2]) for i in range(3, -1, -1)]
    area1 = poly_area(np.array(rect1)[:, 0], np.array(rect1)[:, 1])
    area2 = poly_area(np.array(rect2)[:, 0], np.array(rect2)[:, 1])
    _, inter_area = convex_hull_intersection(rect1, rect2)
    iou_2d = inter_area / (area1 + area2 - inter_area)
    ymax = min(corners1[0, 1], corners2[0, 1])
    ymin = max(corners1[4, 1], corners2[4, 1])
    inter_vol = inter_area * max(0.0, ymax - ymin)
    vol1, vol2 = box3d_vol(corners1), box3d_vol(corners2)
    return inter_vol / (vol1 + vol2 - inter_vol), iou_2d


def get_iou_obb(bb1, bb2) -> float:
    """Pairwise IoU used by the AP matcher. Axis-aligned fast path when both
    boxes are unrotated (always true for BUTD-DETR, heading==0), general
    convex-hull path otherwise."""
    a1 = corners_to_aabb(np.asarray(bb1))
    a2 = corners_to_aabb(np.asarray(bb2))
    v1, v2 = box3d_vol(np.asarray(bb1)), box3d_vol(np.asarray(bb2))
    ab1 = np.prod(a1[3:] - a1[:3])
    ab2 = np.prod(a2[3:] - a2[:3])
    if np.isclose(v1, ab1, rtol=1e-5) and np.isclose(v2, ab2, rtol=1e-5):
        return float(aabb_iou(a1, a2))
    return float(box3d_iou(np.asarray(bb1), np.asarray(bb2))[0])

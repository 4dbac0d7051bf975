"""Host-side point-cloud augmentation.

The port's copy of `butd_detr_tpu/data/augment.py` (reference
`src/joint_det_dataset.py:358-403` `_augment`, and the box round trip
`box2points`/`points2box`, :926-956, that moves detected boxes by the same
augmentation). An f32 cloud goes through the fused C++ pass of
`native.py`, as in the JAX package; the numpy passes are the plain
version (they differ from it by f32 rounding order, <= 1e-6 relative).
Every function takes an explicit `np.random.RandomState`, so a sample
depends only on its seed, in whichever process it is made.
"""

from typing import Dict, Optional, Tuple

import numpy as np

from butd_detr_tpu_torch.native import augment_fused_native

MEAN_RGB = np.array([109.8, 97.2, 83.8]) / 256


def _rot(theta_deg: float, axis: int) -> np.ndarray:
    t = np.deg2rad(theta_deg)
    c, s = np.cos(t), np.sin(t)
    m = np.eye(3)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, (-s if axis != 1 else s), (
        s if axis != 1 else -s
    ), c
    return m


def rot_x(pc: np.ndarray, theta: float) -> np.ndarray:
    """Rotate (N, 3) points `theta` degrees about x. The 3x3 matrix is
    built in f64 and cast to the points' dtype before the product, so an
    f32 cloud rotates in f32."""
    return pc @ _rot(theta, 0).astype(pc.dtype).T


def rot_y(pc: np.ndarray, theta: float) -> np.ndarray:
    return pc @ _rot(theta, 1).astype(pc.dtype).T


def rot_z(pc: np.ndarray, theta: float) -> np.ndarray:
    return pc @ _rot(theta, 2).astype(pc.dtype).T


def box2points(box: np.ndarray) -> np.ndarray:
    """(N, 6) cxcyczwhd -> (N, 8, 3) corners (joint_det_dataset.py:926-941)."""
    lo = box[:, :3] - box[:, 3:] / 2
    hi = box[:, :3] + box[:, 3:] / 2
    return np.stack([
        np.stack([
            np.where(m & 1, hi[:, 0], lo[:, 0]),
            np.where(m & 2, hi[:, 1], lo[:, 1]),
            np.where(m & 4, hi[:, 2], lo[:, 2]),
        ], axis=-1)
        for m in range(8)
    ], axis=1)


def points2box(corners: np.ndarray) -> np.ndarray:
    """(N, 8, 3) corners -> (N, 6) cxcyczwhd (joint_det_dataset.py:944-949)."""
    lo, hi = corners.min(axis=1), corners.max(axis=1)
    return np.concatenate([(lo + hi) / 2, hi - lo], axis=1)


def augment_pointcloud(pc: np.ndarray, color: Optional[np.ndarray],
                       rotate: bool, rng: np.random.RandomState,
                       plain: bool = False
                       ) -> Tuple[np.ndarray, Optional[np.ndarray], Dict]:
    """Augment points (+ optional colors) without touching the inputs;
    returns the augmentation record so that detected boxes can be moved
    alike (joint_det_dataset.py:358-403).

    rotate=True: 90k +- 5 degree z-rotation + yz/xz flips; else +- 5
    degrees only (view-dependent utterances must not be rotated). Every
    draw happens first, in f64 and in the reference's order; the
    applications run in the cloud's dtype: a C-contiguous f32 cloud with
    f32 colour (or none) in one fused C++ pass (flips and rotations folded
    into one 3x3 built in f64), any other in numpy passes. `plain=True`
    takes the numpy passes always (the tests' reference)."""
    pc = np.copy(pc)
    aug: Dict = {}
    if rotate:
        theta_z = 90 * rng.randint(0, 4) + 10 * rng.rand() - 5
        aug["yz_flip"] = rng.random_sample() > 0.5
        aug["xz_flip"] = rng.random_sample() > 0.5
    else:
        theta_z = (2 * rng.rand() - 1) * 5
    aug["theta_z"] = theta_z
    aug["theta_x"] = (2 * rng.rand() - 1) * 2.5
    aug["theta_y"] = (2 * rng.rand() - 1) * 2.5
    noise = rng.rand(len(pc), 3) * 5e-3
    aug["shift"] = rng.random_sample((3,))[None, :] - 0.5
    aug["scale"] = 0.98 + 0.04 * rng.random_sample()
    cscale = (0.98 + 0.04 * rng.random_sample((len(color), 3))
              if color is not None else None)

    if (not plain and pc.dtype == np.float32 and pc.flags.c_contiguous
            and (color is None or color.dtype == np.float32)):
        # flips apply BEFORE the rotations (reference _augment order); all
        # four fold into one matrix: M = Ry @ Rx @ Rz @ F
        F = np.diag([-1.0 if aug.get("yz_flip", False) else 1.0,
                     -1.0 if aug.get("xz_flip", False) else 1.0, 1.0])
        M = (_rot(aug["theta_y"], 1) @ _rot(aug["theta_x"], 0)
             @ _rot(aug["theta_z"], 2) @ F)
        if color is not None:  # a copy: the caller's array stays as it is
            color = np.array(color, np.float32, order="C")
        augment_fused_native(pc, M, noise, aug["shift"], aug["scale"], color,
                             cscale, MEAN_RGB)
        return pc, color, aug

    if aug.get("yz_flip", False):
        pc[:, 0] = -pc[:, 0]
    if aug.get("xz_flip", False):
        pc[:, 1] = -pc[:, 1]
    pc[:, :3] = rot_z(pc[:, :3], theta_z)
    pc[:, :3] = rot_x(pc[:, :3], aug["theta_x"])
    pc[:, :3] = rot_y(pc[:, :3], aug["theta_y"])
    pc[:, :3] = pc[:, :3] + noise.astype(pc.dtype)
    pc[:, :3] += aug["shift"].astype(pc.dtype)
    pc[:, :3] *= pc.dtype.type(aug["scale"])

    if color is not None:
        mean = MEAN_RGB.astype(color.dtype)
        color = color + mean
        color = color * cscale.astype(color.dtype)
        color = color - mean
    return pc, color, aug


def transform_boxes(boxes: np.ndarray, aug: Dict) -> np.ndarray:
    """Apply a recorded augmentation to (N, 6) cxcyczwhd boxes via the
    8-corner round trip (joint_det_dataset.py:595-607)."""
    pts = box2points(boxes).reshape(-1, 3)
    pts = rot_z(pts, aug["theta_z"])
    pts = rot_x(pts, aug["theta_x"])
    pts = rot_y(pts, aug["theta_y"])
    if aug.get("yz_flip", False):
        pts[:, 0] = -pts[:, 0]
    if aug.get("xz_flip", False):
        pts[:, 1] = -pts[:, 1]
    pts = pts + aug["shift"]
    pts = pts * aug["scale"]
    return points2box(pts.reshape(-1, 8, 3))


def corrupt_detected_boxes(boxes: np.ndarray, class_ids: np.ndarray,
                           num_classes: int, rng: np.random.RandomState,
                           corrupt_prob: float = 0.3
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """`--augment_det` box corruption: ~30% of detected boxes are replaced
    by random boxes within the scene extent with random labels
    (joint_det_dataset.py:608-620)."""
    boxes = np.copy(boxes)
    class_ids = np.copy(class_ids)
    lo = boxes.min(axis=0)
    hi = boxes.max(axis=0)
    rand_box = (hi - lo)[None] * rng.random_sample(boxes.shape) + lo
    corrupt = rng.random_sample(len(boxes)) > (1 - corrupt_prob)
    boxes[corrupt] = rand_box[corrupt]
    class_ids[corrupt] = rng.randint(0, num_classes, len(class_ids))[corrupt]
    return boxes, class_ids

"""Synthetic batches with the exact key/shape schema of the real dataset.

The port's copy of `butd_detr_tpu/data/synthetic.py:synthetic_batch` (and
of `data/scan.py:hilbert_code`, which it needs): same arguments, same numpy
random stream, so the same seed gives the same batch in both packages.
Shapes mirror `Joint3DDataset.__getitem__` after fixed-shape collation.
`SyntheticGroundingDataset` cuts such batches into per-sample dicts, with
the evaluators' extras, for a loader to batch again.
"""

from typing import Dict

import numpy as np

HILBERT_BITS = 10


def hilbert_code(xyz: np.ndarray, bits: int = HILBERT_BITS) -> np.ndarray:
    """3 * bits-bit 3D Hilbert index per point (Skilling's AxesToTranspose
    and interleave), used to put a cloud in spatially local order."""
    xyz = np.asarray(xyz, np.float32)
    lo = xyz.min(axis=0, keepdims=True)
    hi = xyz.max(axis=0, keepdims=True)
    q = np.clip(
        ((xyz - lo) / (hi - lo + 1e-6) * (1 << bits)).astype(np.int32),
        0, (1 << bits) - 1,
    )
    x = [q[:, 0].copy(), q[:, 1].copy(), q[:, 2].copy()]
    Q = 1 << (bits - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            flag = (x[i] & Q) > 0
            t = (x[0] ^ x[i]) & P
            x0_inv = x[0] ^ P
            x0_exc = x[0] ^ t
            xi_exc = x[i] ^ t
            x[0] = np.where(flag, x0_inv, x0_exc)
            if i != 0:
                x[i] = np.where(flag, x[i], xi_exc)
        Q >>= 1
    x[1] = x[1] ^ x[0]
    x[2] = x[2] ^ x[1]
    t = np.zeros_like(x[0])
    Q = 1 << (bits - 1)
    while Q > 1:
        t = np.where((x[2] & Q) > 0, t ^ (Q - 1), t)
        Q >>= 1
    for i in range(3):
        x[i] = x[i] ^ t
    code = np.zeros_like(x[0])
    for j in range(bits - 1, -1, -1):
        for i in range(3):
            code = (code << 1) | ((x[i] >> j) & 1)
    return code


def synthetic_batch(
    batch_size: int = 2,
    num_points: int = 50000,
    num_feats: int = 3,  # per-point channels beyond xyz (color)
    max_text_len: int = 64,
    max_num_obj: int = 132,
    max_det_boxes: int = 132,
    num_class_bins: int = 256,
    num_obj_class: int = 485,
    n_true_objects: int = 6,
    n_true_tokens: int = 10,
    n_true_det: int = 20,
    seed: int = 0,
    vocab_size: int = 1024,
    spatial_sort: bool = True,
) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    B, N, G, D, L = (
        batch_size, num_points, max_num_obj, max_det_boxes, max_text_len
    )

    pc = (rng.rand(B, N, 3 + num_feats) * 3 + 1).astype(np.float32)

    ids = np.full((B, L), 1, np.int32)
    ids[:, 0] = 0
    ids[:, 1:1 + n_true_tokens] = rng.randint(
        4, vocab_size, (B, n_true_tokens)
    )
    ids[:, 1 + n_true_tokens] = 2
    text_mask = (ids != 1).astype(np.int32)

    center = (rng.rand(B, G, 3) * 3 + 1).astype(np.float32)
    size = (rng.rand(B, G, 3) * 0.5 + 0.2).astype(np.float32)
    box_mask = np.zeros((B, G), np.float32)
    box_mask[:, :n_true_objects] = 1

    pmap = np.zeros((B, G, num_class_bins), np.float32)
    for b in range(B):
        for g in range(n_true_objects):
            s = rng.randint(1, n_true_tokens)
            pmap[b, g, s:s + 2] = 0.5

    pil = np.full((B, N), -1, np.int32)
    for b in range(B):
        for g in range(n_true_objects):
            lo = g * (N // (2 * n_true_objects))
            pil[b, lo:lo + 50] = g

    if spatial_sort:
        # clouds arrive Hilbert-ordered, as the data pipeline stores them;
        # per-point labels permute alongside
        for b in range(B):
            perm = np.argsort(hilbert_code(pc[b, :, :3]), kind="stable")
            pc[b] = pc[b, perm]
            pil[b] = pil[b, perm]

    det_mask = np.zeros((B, D), bool)
    det_mask[:, :n_true_det] = True

    return {
        "point_clouds": pc,
        "text_ids": ids,
        "text_mask": text_mask,
        "det_boxes": np.concatenate(
            [
                (rng.rand(B, D, 3) * 3 + 1).astype(np.float32),
                (rng.rand(B, D, 3) * 0.5 + 0.2).astype(np.float32),
            ],
            axis=-1,
        ),
        "det_class_ids": rng.randint(0, num_obj_class, (B, D)).astype(
            np.int32
        ),
        "det_bbox_label_mask": det_mask,
        "center_label": center,
        "size_gts": size,
        "sem_cls_label": rng.randint(0, 485, (B, G)).astype(np.int32),
        "box_label_mask": box_mask,
        "positive_map": pmap,
        "point_instance_label": pil,
    }


class SyntheticGroundingDataset:
    """`n` seeded synthetic scenes in memory, one dict per sample: the keys
    of `synthetic_batch` plus what the grounding evaluators read from a
    real sample: `all_bboxes` / `all_bbox_label_mask` (the scene's true
    boxes, cxcyczwhd, in a seeded order of their own as a scan lists its
    objects in no relation to the utterance's, and which rows are real) and
    the seeded flags `is_view_dep`, `is_hard`, `is_unique`. A map-style dataset for
    `data.loader.DataLoader`: `__len__` and `get(index, rng)`; samples are
    fixed, so `rng` is not drawn from. `batch_kwargs` go to
    `synthetic_batch` (num_points, max_text_len, ...)."""

    def __init__(self, n: int, seed: int = 0, **batch_kwargs):
        batch = synthetic_batch(batch_size=n, seed=seed, **batch_kwargs)
        rng = np.random.RandomState(seed + 7919)
        boxes = np.concatenate(
            [batch["center_label"], batch["size_gts"]], axis=-1)
        real = batch["box_label_mask"] > 0
        for b in range(n):
            rows = np.flatnonzero(real[b])
            boxes[b, rows] = boxes[b, rng.permutation(rows)]
        batch["all_bboxes"] = boxes
        batch["all_bbox_label_mask"] = real
        for key in ("is_view_dep", "is_hard", "is_unique"):
            batch[key] = rng.rand(n) < 0.5
        self._batch = batch
        self._n = n

    def __len__(self) -> int:
        return self._n

    def get(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        if not 0 <= index < self._n:
            raise IndexError(index)
        return {k: v[index] for k, v in self._batch.items()}

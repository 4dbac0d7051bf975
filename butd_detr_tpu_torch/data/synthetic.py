"""Synthetic data with the exact schema of the real dataset.

The port's copy of `butd_detr_tpu/data/synthetic.py`: same arguments, same
numpy random stream, so the same seed gives the same batch, and the same
files, in both packages.
  * `synthetic_batch`: batches whose shapes mirror
    `Joint3DDataset.__getitem__` after fixed-shape collation;
    `SyntheticGroundingDataset` cuts them into per-sample dicts, with the
    evaluators' extras, for a loader to batch again;
  * `make_fake_scannet` and `make_rich_scannet`: ScanNet-format data roots
    on disk (PLYs, segs/aggregation JSONs, `meta_data/`, the ReferIt3D /
    ScanRefer annotations, span-predictor and detector side files), so
    that the data pipeline runs with nothing downloaded.
"""

import json
import os
import os.path as osp
import shutil
from typing import Dict, List, Optional

import numpy as np

from butd_detr_tpu_torch.data.scan import hilbert_code

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


def _write_ply(path, pc, color=None, label=None):
    """Binary little-endian PLY with the ScanNet vertex layout."""
    n = len(pc)
    props = [("x", "float"), ("y", "float"), ("z", "float")]
    if color is not None:
        props += [("red", "uchar"), ("green", "uchar"), ("blue", "uchar")]
    if label is not None:
        props += [("label", "ushort")]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property {t} {p}" for p, t in props]
    header += ["end_header"]
    fields = {"float": "<f4", "uchar": "u1", "ushort": "<u2"}
    dt = np.dtype([(p, fields[t]) for p, t in props])
    rows = np.zeros(n, dt)
    rows["x"], rows["y"], rows["z"] = pc[:, 0], pc[:, 1], pc[:, 2]
    if color is not None:
        rows["red"], rows["green"], rows["blue"] = (
            color[:, 0], color[:, 1], color[:, 2])
    if label is not None:
        rows["label"] = label
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(rows.tobytes())


def _write_meta_maps(meta: str, align: Dict, idx2sem: Dict, inst2sem: Dict):
    with open(osp.join(meta, "scans_axis_alignment_matrices.json"), "w") as f:
        json.dump(align, f)
    with open(osp.join(meta, "scannet_idx_to_semantic_class.json"), "w") as f:
        json.dump(idx2sem, f)
    with open(osp.join(meta, "scannet_instance_class_to_semantic_class.json"),
              "w") as f:
        json.dump(inst2sem, f)


def _write_scene(sdir: str, sid: str, pc: np.ndarray, color: np.ndarray,
                 labels: List[int], seg_idx: List[int], names: List[str]):
    """One scene's PLYs, over-segmentation and aggregation (one segment
    an object)."""
    _write_ply(osp.join(sdir, f"{sid}_vh_clean_2.ply"), pc, color=color)
    _write_ply(osp.join(sdir, f"{sid}_vh_clean_2.labels.ply"), pc,
               color=None, label=np.asarray(labels))
    with open(osp.join(sdir, f"{sid}_vh_clean_2.0.010000.segs.json"),
              "w") as f:
        json.dump({"segIndices": seg_idx}, f)
    with open(osp.join(sdir, f"{sid}.aggregation.json"), "w") as f:
        json.dump({"segGroups": [
            {"objectId": o, "segments": [o], "label": names[o]}
            for o in range(len(names))
        ]}, f)


def make_fake_scannet(root: str, scan_ids: Optional[List[str]] = None,
                      points_per_scan: int = 4000, seed: int = 0) -> str:
    """Write a miniature ScanNet-format dataset (PLY + segs/aggregation
    JSONs + meta_data + sr3d/sr3d+/nr3d CSVs + ScanRefer JSONs + span, cls
    and detected-box side files) under `root`: every file the five
    annotation loaders read, with a few box-shaped 'chair'/'table' objects
    a scene."""
    rng = np.random.RandomState(seed)
    if scan_ids is None:
        scan_ids = ["scene0000_00", "scene0001_00"]
    scans_dir = osp.join(root, "scans")
    meta = osp.join(root, "meta_data")
    os.makedirs(meta, exist_ok=True)

    # meta: label TSV (raw_category -> id/nyu40id/nyu40class)
    with open(osp.join(meta, "scannetv2-labels.combined.tsv"), "w") as f:
        f.write("raw_category\tid\tnyu40id\tnyu40class\n")
        f.write("chair\t2\t5\tchair\n")
        f.write("table\t4\t7\ttable\n")

    align = {}
    for sid in scan_ids:
        sdir = osp.join(scans_dir, sid)
        os.makedirs(sdir, exist_ok=True)
        names = ["chair", "table", "chair"]
        centers = rng.rand(3, 3) * 4
        sizes = rng.rand(3, 3) * 0.6 + 0.4
        pts, seg_idx, labels = [], [], []
        per = points_per_scan // 4
        for o, (c, s) in enumerate(zip(centers, sizes)):
            pts.append(c + (rng.rand(per, 3) - 0.5) * s)
            seg_idx += [o] * per
            labels += [5 if names[o] == "chair" else 7] * per
        # background
        nbg = points_per_scan - 3 * per
        pts.append(rng.rand(nbg, 3) * 6 - 1)
        seg_idx += [99] * nbg
        labels += [0] * nbg
        pc = np.concatenate(pts).astype(np.float32)
        color = rng.randint(0, 255, (len(pc), 3)).astype(np.uint8)
        _write_scene(sdir, sid, pc, color, labels, seg_idx, names)
        align[sid] = np.eye(4).reshape(-1).tolist()

    _write_meta_maps(meta, align, {"5": "chair", "7": "table"},
                     {"chair": "chair", "table": "table"})
    for split in ("train", "val"):
        with open(osp.join(meta, f"scannetv2_{split}.txt"), "w") as f:
            f.write("\n".join(scan_ids) + "\n")
        with open(osp.join(meta, f"sr3d_{split}_scans.txt"), "w") as f:
            f.write(repr(scan_ids))
        with open(osp.join(meta, f"nr3d_{split}_scans.txt"), "w") as f:
            f.write(repr(scan_ids))
    with open(osp.join(meta, "sr3d_test_scans.txt"), "w") as f:
        f.write(repr(scan_ids))
    with open(osp.join(meta, "nr3d_test_scans.txt"), "w") as f:
        f.write(repr(scan_ids))

    # sr3d / sr3d+ annotations + span-predictor output. The reference
    # indexes `sr3d_pred_spans.json` by RAW csv row index for both csvs
    # (joint_det_dataset.py:137-161), so sr3d+.csv extends sr3d.csv row
    # for row: the same rows first, extra rows after, one span a row.
    os.makedirs(osp.join(root, "refer_it_3d"), exist_ok=True)
    utt = "the chair near the table"
    sr3d_header = (
        "scan_id,target_id,distractor_ids,utterance,instance_type,"
        "anchors_types,anchor_ids,mentions_target_class\n"
    )

    def _chair_span():
        span = np.zeros(256)
        span[2:4] = 0.5  # 'chair' tokens
        return span.tolist()

    sr3d_rows = [
        f'{sid},0,[2],{utt},chair,[\'table\'],[1],True\n' for sid in scan_ids
    ]
    # sr3d+ extras: the other chair (object 2) as target
    plus_rows = sr3d_rows + [
        f'{sid},2,[0],{utt},chair,[\'table\'],[1],True\n' for sid in scan_ids
    ]
    spans = [{"span": _chair_span(), "utterance": utt} for _ in plus_rows]
    with open(osp.join(root, "refer_it_3d", "sr3d.csv"), "w") as f:
        f.write(sr3d_header + "".join(sr3d_rows))
    with open(osp.join(root, "refer_it_3d", "sr3d+.csv"), "w") as f:
        f.write(sr3d_header + "".join(plus_rows))
    with open(osp.join(root, "sr3d_pred_spans.json"), "w") as f:
        json.dump(spans, f)
    with open(osp.join(root, "cls_results.json"), "w") as f:
        json.dump({sid: [1, 3, 1] for sid in scan_ids}, f)

    # nr3d: free-form csv (joint_det_dataset.py:163-210). Rows a scan:
    # kept; mentions_target_class=False (dropped); correct_guess=False
    # (dropped at val/test only). Spans are indexed by raw row.
    nr3d_utt = "it is the chair that stands near the table"
    nr3d_header = (
        "scan_id,target_id,utterance,instance_type,"
        "mentions_target_class,correct_guess\n"
    )
    nr3d_rows, nr3d_spans = [], []
    for sid in scan_ids:
        for tid, mentions, correct in (
            (0, "True", "True"), (2, "False", "True"), (2, "True", "False")
        ):
            nr3d_rows.append(
                f"{sid},{tid},{nr3d_utt},chair,{mentions},{correct}\n")
            nr3d_spans.append({"span": _chair_span(), "utterance": nr3d_utt})
    with open(osp.join(root, "refer_it_3d", "nr3d.csv"), "w") as f:
        f.write(nr3d_header + "".join(nr3d_rows))
    with open(osp.join(root, "nr3d_pred_spans.json"), "w") as f:
        json.dump(nr3d_spans, f)

    # scanrefer: filtered JSON + scan-id txt + per-split pred spans
    # (joint_det_dataset.py:212-278)
    os.makedirs(osp.join(root, "scanrefer"), exist_ok=True)
    sr_tokens = ["the", "table", "in", "the", "room"]
    sr_utt = " ".join(sr_tokens)
    sr_annos = [{"scene_id": sid, "object_id": "1", "object_name": "table",
                 "token": sr_tokens} for sid in scan_ids]
    sr_spans = [{"span": _chair_span(), "utterance": sr_utt}
                for _ in sr_annos]
    for split in ("train", "val"):
        base = osp.join(root, "scanrefer", f"ScanRefer_filtered_{split}")
        with open(base + ".json", "w") as f:
            json.dump(sr_annos, f)
        with open(base + ".txt", "w") as f:
            f.write("\n".join(scan_ids) + "\n")
        with open(osp.join(root, f"scanrefer_pred_spans_{split}.json"),
                  "w") as f:
            json.dump(sr_spans, f)

    # GroupFree-style detected boxes
    for split in ("train", "val"):
        ddir = osp.join(root, f"group_free_pred_bboxes_{split}")
        os.makedirs(ddir, exist_ok=True)
        for sid in scan_ids:
            boxes = np.stack([
                np.concatenate([c - s / 2, c + s / 2])
                for c, s in zip(rng.rand(4, 3) * 4,
                                rng.rand(4, 3) * 0.5 + 0.3)
            ])
            np.save(osp.join(ddir, f"{sid}.npy"), {
                "box": boxes,
                "class": ["chair", "table", "chair", "table"],
                "logits": rng.randn(4, 485),
            })
    return root


# (name, tsv id, nyu40 id) for the rich generator; single-token names so
# span maps are one-bin and any word-level tokenizer handles them
RICH_CLASSES = (
    ("chair", 2, 5), ("table", 4, 7), ("bed", 7, 4), ("sofa", 6, 6),
    ("desk", 13, 14), ("door", 8, 8), ("window", 9, 9), ("sink", 24, 34),
    ("shelf", 31, 10), ("cabinet", 3, 3),
)


def make_rich_scannet(root: str, n_train: int = 96, n_val: int = 24,
                      objects_per_scan: int = 5,
                      points_per_scan: int = 20000, seed: int = 0,
                      det_noise: float = 0.03) -> str:
    """A learnable synthetic grounding dataset at ScanNet layout: every
    scene has `objects_per_scan` objects of distinct classes (so 'the
    <class> in the room' names the target alone), one sr3d row an object,
    spans from `SimpleTokenizer` and `token_positive_map`, and
    GroupFree-style detected boxes = GT + noise with the right class
    names."""
    from butd_detr_tpu_torch.data.positive_map import token_positive_map
    from butd_detr_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from butd_detr_tpu_torch.lang.tokenizer import SimpleTokenizer

    rng = np.random.RandomState(seed)
    tok = SimpleTokenizer(max_len=256)
    id2cls = ScannetDatasetConfig(485).nyu40id2class  # tsv id -> 485-class
    scan_ids = [f"scene{i:04d}_00" for i in range(n_train + n_val)]
    train_ids, val_ids = scan_ids[:n_train], scan_ids[n_train:]
    scans_dir = osp.join(root, "scans")
    meta = osp.join(root, "meta_data")
    os.makedirs(meta, exist_ok=True)

    with open(osp.join(meta, "scannetv2-labels.combined.tsv"), "w") as f:
        f.write("raw_category\tid\tnyu40id\tnyu40class\n")
        for name, tid, nyu in RICH_CLASSES:
            f.write(f"{name}\t{tid}\t{nyu}\t{name}\n")

    align = {}
    sr3d_rows, spans, cls_results = [], [], {}
    for sid in scan_ids:
        sdir = osp.join(scans_dir, sid)
        os.makedirs(sdir, exist_ok=True)
        ks = rng.choice(len(RICH_CLASSES), objects_per_scan, replace=False)
        names = [RICH_CLASSES[k][0] for k in ks]
        nyus = [RICH_CLASSES[k][2] for k in ks]
        tids = [RICH_CLASSES[k][1] for k in ks]
        # objects on a jittered grid so boxes rarely overlap
        grid = rng.permutation(9)[:objects_per_scan]
        centers = np.stack([
            [2.0 * (g % 3) + rng.uniform(-0.4, 0.4),
             2.0 * (g // 3) + rng.uniform(-0.4, 0.4),
             rng.uniform(0.3, 0.9)] for g in grid
        ])
        sizes = rng.rand(objects_per_scan, 3) * 0.8 + 0.4
        per = int(points_per_scan * 0.7) // objects_per_scan
        pts, seg_idx, labels = [], [], []
        for o, (c, s) in enumerate(zip(centers, sizes)):
            pts.append(c + (rng.rand(per, 3) - 0.5) * s)
            seg_idx += [o] * per
            labels += [nyus[o]] * per
        nbg = points_per_scan - objects_per_scan * per
        bg = np.stack([rng.rand(nbg) * 6 - 0.5, rng.rand(nbg) * 6 - 0.5,
                       rng.rand(nbg) * 0.05], axis=1)  # floor
        pts.append(bg)
        seg_idx += [99] * nbg
        labels += [0] * nbg
        pc = np.concatenate(pts).astype(np.float32)
        color = rng.randint(0, 255, (len(pc), 3)).astype(np.uint8)
        _write_scene(sdir, sid, pc, color, labels, seg_idx, names)
        align[sid] = np.eye(4).reshape(-1).tolist()
        cls_results[sid] = [int(id2cls[t]) for t in tids]

        for o, name in enumerate(names):
            utt = f"the {name} in the room"
            sr3d_rows.append(f"{sid},{o},[],{utt},{name},[],[],True\n")
            _, pm = token_positive_map(tok, utt, [name], 1)
            spans.append({"span": pm[0].tolist(), "utterance": utt})

        # GroupFree-style detections: GT + noise, correct class names
        ddir_boxes = np.stack([
            np.concatenate([
                c - s / 2 + rng.randn(3) * det_noise,
                c + s / 2 + rng.randn(3) * det_noise,
            ]) for c, s in zip(centers, sizes)
        ])
        logits = np.full((objects_per_scan, 485), -5.0, np.float32)
        for o, t in enumerate(tids):
            logits[o, int(id2cls[t])] = 5.0
        for split in ("train", "val"):
            ddir = osp.join(root, f"group_free_pred_bboxes_{split}")
            os.makedirs(ddir, exist_ok=True)
            np.save(osp.join(ddir, f"{sid}.npy"), {
                "box": ddir_boxes, "class": names, "logits": logits,
            })

    _write_meta_maps(meta, align,
                     {str(nyu): name for name, _, nyu in RICH_CLASSES},
                     {name: name for name, _, _ in RICH_CLASSES})
    with open(osp.join(meta, "scannetv2_train.txt"), "w") as f:
        f.write("\n".join(train_ids) + "\n")
    with open(osp.join(meta, "scannetv2_val.txt"), "w") as f:
        f.write("\n".join(val_ids) + "\n")
    with open(osp.join(meta, "sr3d_train_scans.txt"), "w") as f:
        f.write(repr(train_ids))
    with open(osp.join(meta, "sr3d_test_scans.txt"), "w") as f:
        f.write(repr(val_ids))

    os.makedirs(osp.join(root, "refer_it_3d"), exist_ok=True)
    with open(osp.join(root, "refer_it_3d", "sr3d.csv"), "w") as f:
        f.write(
            "scan_id,target_id,distractor_ids,utterance,instance_type,"
            "anchors_types,anchor_ids,mentions_target_class\n"
            + "".join(sr3d_rows))
    with open(osp.join(root, "sr3d_pred_spans.json"), "w") as f:
        json.dump(spans, f)
    with open(osp.join(root, "cls_results.json"), "w") as f:
        json.dump(cls_results, f)
    return root


def make_trainval_root(root: str) -> str:
    """A shadow data root, `<root>_trainval`, whose test split lists the
    TRAIN scans: every entry of `root` linked by its absolute path (a
    relative target would resolve against the link's own directory),
    `meta_data` copied with `sr3d_test_scans.txt` and
    `scannetv2_val.txt` replaced by their train counterparts, and a
    stale val scan cache removed. Made once; later calls return it."""
    alt = root.rstrip("/") + "_trainval"
    if osp.exists(osp.join(alt, "meta_data", "sr3d_test_scans.txt")):
        return alt
    os.makedirs(alt, exist_ok=True)
    for name in os.listdir(root):
        src = osp.join(root, name)
        dst = osp.join(alt, name)
        if name == "meta_data":
            shutil.copytree(src, dst, dirs_exist_ok=True)
        elif not osp.exists(dst):
            os.symlink(osp.abspath(src), dst)
    meta = osp.join(alt, "meta_data")
    shutil.copy(osp.join(meta, "sr3d_train_scans.txt"),
                osp.join(meta, "sr3d_test_scans.txt"))
    shutil.copy(osp.join(meta, "scannetv2_train.txt"),
                osp.join(meta, "scannetv2_val.txt"))
    stale = osp.join(alt, "val_v3scans.pkl")
    if osp.exists(stale) and not osp.islink(stale):
        os.remove(stale)
    return alt


def make_fake_multiview(root: str, scans: Dict, dim: int = 32,
                        seed: int = 0) -> str:
    """Write `scanrefer_2d_feats/enet_feats_maxpool.hdf5` with per-point 2D
    features aligned to each LOADED scan's point count (the real file is
    built from the preprocessed clouds; reference joint_det_dataset.py:84-88
    reads it raw and concatenates per point, :448-450). Returns the path.
    The model's recipes read 128 features a point (`dim=128`)."""
    import h5py

    rng = np.random.RandomState(seed)
    d = osp.join(root, "scanrefer_2d_feats")
    os.makedirs(d, exist_ok=True)
    path = osp.join(d, "enet_feats_maxpool.hdf5")
    with h5py.File(path, "w") as f:
        for sid, scan in scans.items():
            f.create_dataset(
                sid, data=rng.rand(len(scan.orig_pc), dim).astype(np.float32)
            )
    return path

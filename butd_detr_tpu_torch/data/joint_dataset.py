"""Joint grounding + detection dataset over ScanNet-family annotations.

The port's copy of `butd_detr_tpu/data/joint_dataset.py` (reference
`src/joint_det_dataset.py`, Joint3DDataset:36). The data layout on disk is
the reference's (refer_it_3d CSVs, ScanRefer JSONs, span-predictor JSONs,
GroupFree detected-box .npy files, the {split}_v3scans.pkl scan cache,
meta_data/ TSV+txt files); a sample has the JAX package's keys, shapes,
dtypes and values:

  * every sample is a dict of fixed-shape numpy arrays (MAX_NUM_OBJ = 132
    boxes, 256 token bins);
  * randomness is an explicit per-sample RandomState, seeded by the loader
    from (seed, epoch, index), so a sample is the same in whichever process
    it is made;
  * tokenization happens here, on the host: samples carry `text_ids` /
    `text_mask` and the utterance for the evaluator.

With `use_multiview` each point also carries its 128 ENet features
(`scanrefer_2d_feats/enet_feats_maxpool.hdf5`, one dataset a scan, rows
aligned with the loaded cloud), read through `h5py` with one open handle
a process and appended after the colour and height channels, unaugmented,
as the JAX package does.
"""

import csv
import json
import os
import os.path as osp
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from butd_detr_tpu_torch.data.augment import (
    MEAN_RGB,
    augment_pointcloud,
    corrupt_detected_boxes,
    transform_boxes,
)
from butd_detr_tpu_torch.data.positive_map import (
    NUM_BINS,
    normalize_caption,
    token_positive_map,
)
from butd_detr_tpu_torch.data.scan import load_scan_cache, save_scan_cache
from butd_detr_tpu_torch.data.scannet_config import (
    ScannetDatasetConfig,
    allow_rotation_nr3d,
    find_rel,
    is_view_dep,
    read_label_mapping,
    view_dep_rels,
)

NUM_CLASSES = 485
MAX_NUM_OBJ = 132


def _fit_rows(a: np.ndarray, width: int) -> np.ndarray:
    """Pad (with zeros) or truncate axis 0 to `width`."""
    if a.shape[0] == width:
        return a
    if a.shape[0] > width:
        return a[:width]
    pad = [(0, width - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


DET18_NAMES = (
    "cabinet", "bed", "chair", "couch", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "other furniture",
)


class JointGroundingDataset:
    """Map-style dataset; `get(index, rng)` returns one sample dict.

    dataset_dict: {'sr3d': 1, 'scannet': 10} style repetition counts
    (train_dist_mod.py:44-45). Supported datasets: sr3d, sr3d+, nr3d,
    scanrefer, scannet.
    """

    def __init__(
        self,
        dataset_dict: Optional[Dict[str, int]] = None,
        test_dataset: str = "sr3d",
        split: str = "train",
        overfit: bool = False,
        data_path: str = "./",
        use_color: bool = False,
        use_height: bool = False,
        use_multiview: bool = False,
        detect_intermediate: bool = False,
        butd: bool = False,
        butd_gt: bool = False,
        butd_cls: bool = False,
        augment_det: bool = False,
        tokenizer=None,
        max_text_len: int = 256,
        scans: Optional[Dict] = None,
        max_num_obj: int = MAX_NUM_OBJ,
        max_det_boxes: Optional[int] = None,
        spatial_sort: bool = True,
    ):
        if dataset_dict is None:
            dataset_dict = {"sr3d": 1, "scannet": 10}
        self.dataset_dict = dataset_dict
        self.test_dataset = test_dataset
        self.split = split
        self.overfit = overfit
        self.data_path = data_path
        self.use_color = use_color
        self.use_height = use_height
        self.use_multiview = use_multiview
        self._multiview_files: Dict[int, object] = {}
        self.detect_intermediate = detect_intermediate
        self.butd = butd
        self.butd_gt = butd_gt
        self.butd_cls = butd_cls
        self.augment = split == "train"
        self.augment_det = augment_det
        self.max_text_len = max_text_len
        # GT/scene box pad width. The reference hard-pads to
        # MAX_NUM_OBJ=132 (joint_det_dataset.py:33); smaller values shrink
        # the matcher/criterion working set for datasets whose scenes have
        # fewer objects (and the tests' compile graphs). Annotations /
        # detections past the pad are truncated. `max_det_boxes` sets the
        # detected-box stream width separately (default: same).
        self.max_num_obj = max_num_obj
        self.max_det_boxes = (
            max_det_boxes if max_det_boxes is not None else max_num_obj
        )
        self.joint_det = (
            "scannet" in dataset_dict
            and len(dataset_dict) > 1
            and split == "train"
        )

        self.mean_rgb = MEAN_RGB
        self.dc = ScannetDatasetConfig(NUM_CLASSES)
        self.dc18 = ScannetDatasetConfig(18)

        meta = osp.join(data_path, "meta_data")
        self.meta_dir = meta
        tsv = osp.join(meta, "scannetv2-labels.combined.tsv")
        self.label_map = read_label_mapping(tsv, "raw_category", "id")
        self.label_map18 = read_label_mapping(tsv, "raw_category", "nyu40id")
        self.label_mapclass = read_label_mapping(
            tsv, "raw_category", "nyu40class"
        )

        if tokenizer is None:
            from butd_detr_tpu_torch.lang.tokenizer import get_tokenizer

            tokenizer = get_tokenizer(max_len=max_text_len)
        self.tokenizer = tokenizer

        cls_results_path = osp.join(data_path, "cls_results.json")
        self.cls_results = None
        if osp.exists(cls_results_path):
            with open(cls_results_path) as f:
                self.cls_results = json.load(f)

        # scans (pickle cache; built on demand like the reference,
        # joint_det_dataset.py:96-100)
        if scans is not None:
            self.scans = scans
        else:
            cache = osp.join(data_path, f"{split}_v3scans.pkl")
            if not osp.exists(cache):
                save_scan_cache(
                    cache, split, data_path, spatial_sort=spatial_sort
                )
            self.scans = load_scan_cache(cache, meta_dir=meta)
            # each pickled Scan records the order it was built with; a
            # cache built with the other spatial_sort setting is still
            # correct (point sets are order-free) but not in the order
            # asked for: warn
            stale = [
                s.scan_id for s in self.scans.values()
                if getattr(s, "spatial_sort", False) != spatial_sort
            ]
            if stale:
                import warnings

                warnings.warn(
                    f"{cache} was built with spatial_sort="
                    f"{not spatial_sort} but this run requests "
                    f"spatial_sort={spatial_sort}; delete the cache to "
                    f"rebuild ({len(stale)} scans, e.g. {stale[0]}). "
                    "Results stay exact either way; the points' order "
                    "(and the neighbour kernels' memory locality) is what "
                    "changes."
                )

        if split != "train":
            self.annos = self.load_annos(test_dataset)
        else:
            self.annos = []
            for dset, cnt in dataset_dict.items():
                if cnt > 0:
                    self.annos += self.load_annos(dset) * cnt

    # ------------------------------------------------------------------
    # annotation loaders (joint_det_dataset.py:112-310)
    # ------------------------------------------------------------------

    def load_annos(self, dset: str) -> List[Dict]:
        loaders = {
            "nr3d": self.load_nr3d_annos,
            "sr3d": self.load_sr3d_annos,
            "sr3d+": lambda: self.load_sr3d_annos(dset="sr3d+"),
            "scanrefer": self.load_scanrefer_annos,
            "scannet": self.load_scannet_annos,
        }
        annos = loaders[dset]()
        if self.overfit:
            annos = annos[:128]
        return annos

    def _read_csv(self, path: str):
        with open(path) as f:
            reader = csv.reader(f)
            headers = {h: i for i, h in enumerate(next(reader))}
            for line in reader:
                yield headers, line

    def load_sr3d_annos(self, dset: str = "sr3d") -> List[Dict]:
        """refer_it_3d/{sr3d,sr3d+}.csv + predicted spans
        (joint_det_dataset.py:129-161)."""
        split = "test" if self.split == "val" else self.split
        with open(osp.join(self.meta_dir, f"sr3d_{split}_scans.txt")) as f:
            scan_ids = set(eval(f.read()))
        with open(osp.join(self.data_path, "sr3d_pred_spans.json")) as f:
            pred_spans = json.load(f)
        annos = []
        for i, (h, line) in enumerate(
            self._read_csv(osp.join(self.data_path, "refer_it_3d", f"{dset}.csv"))
        ):
            if line[h["scan_id"]] not in scan_ids:
                continue
            if str(line[h["mentions_target_class"]]).lower() != "true":
                continue
            annos.append({
                "scan_id": line[h["scan_id"]],
                "target_id": int(line[h["target_id"]]),
                "distractor_ids": eval(line[h["distractor_ids"]]),
                "utterance": line[h["utterance"]],
                "target": line[h["instance_type"]],
                "anchors": eval(line[h["anchors_types"]]),
                "anchor_ids": eval(line[h["anchor_ids"]]),
                "dataset": dset,
                "pred_pos_map": pred_spans[i]["span"],
                "span_utterance": pred_spans[i]["utterance"],
            })
        return annos

    def load_nr3d_annos(self) -> List[Dict]:
        """refer_it_3d/nr3d.csv (joint_det_dataset.py:163-210)."""
        split = "test" if self.split == "val" else self.split
        with open(osp.join(self.meta_dir, f"nr3d_{split}_scans.txt")) as f:
            scan_ids = set(eval(f.read()))
        with open(osp.join(self.data_path, "nr3d_pred_spans.json")) as f:
            pred_spans = json.load(f)
        annos = []
        for i, (h, line) in enumerate(
            self._read_csv(osp.join(self.data_path, "refer_it_3d", "nr3d.csv"))
        ):
            if line[h["scan_id"]] not in scan_ids:
                continue
            if str(line[h["mentions_target_class"]]).lower() != "true":
                continue
            if (
                split == "test"
                and str(line[h["correct_guess"]]).lower() != "true"
            ):
                continue
            annos.append({
                "scan_id": line[h["scan_id"]],
                "target_id": int(line[h["target_id"]]),
                "target": line[h["instance_type"]],
                "utterance": line[h["utterance"]],
                "anchor_ids": [],
                "anchors": [],
                "dataset": "nr3d",
                "pred_pos_map": pred_spans[i]["span"],
                "span_utterance": pred_spans[i]["utterance"],
            })
        for anno in annos:
            scan = self.scans[anno["scan_id"]]
            anno["distractor_ids"] = [
                ind
                for ind in range(len(scan.three_d_objects))
                if scan.get_object_instance_label(ind) == anno["target"]
                and ind != anno["target_id"]
            ]
        return annos

    def load_scanrefer_annos(self) -> List[Dict]:
        """ScanRefer_filtered_{split}.json (joint_det_dataset.py:212-278)."""
        base = osp.join(self.data_path, "scanrefer", "ScanRefer_filtered")
        split = "val" if self.split in ("val", "test") else self.split
        with open(f"{base}_{split}.txt") as f:
            scan_ids = {line.strip() for line in f if line.strip()}
        with open(f"{base}_{split}.json") as f:
            reader = json.load(f)
        with open(
            osp.join(self.data_path, f"scanrefer_pred_spans_{split}.json")
        ) as f:
            pred_spans = json.load(f)
        annos = [
            {
                "scan_id": a["scene_id"],
                "target_id": int(a["object_id"]),
                "distractor_ids": [],
                "utterance": " ".join(a["token"]),
                "target": " ".join(str(a["object_name"]).split("_")),
                "anchors": [],
                "anchor_ids": [],
                "dataset": "scanrefer",
                "pred_pos_map": pred_spans[i]["span"],
                "span_utterance": pred_spans[i]["utterance"],
            }
            for i, a in enumerate(reader)
            if a["scene_id"] in scan_ids
        ]

        def labels18(scan):
            return [
                self.dc18.type2class.get(
                    self.label_mapclass[scan.get_object_instance_label(ind)],
                    17,
                )
                for ind in range(len(scan.three_d_objects))
            ]

        scene2obj = defaultdict(list)
        sceneobj2used = defaultdict(set)
        for anno in annos:
            labels = labels18(self.scans[anno["scan_id"]])
            anno["distractor_ids"] = [
                ind
                for ind in range(len(labels))
                if labels[ind] == labels[anno["target_id"]]
                and ind != anno["target_id"]
            ][:32]
            if anno["target_id"] not in sceneobj2used[anno["scan_id"]]:
                sceneobj2used[anno["scan_id"]].add(anno["target_id"])
                scene2obj[anno["scan_id"]].append(labels[anno["target_id"]])
        for anno in annos:
            labels = labels18(self.scans[anno["scan_id"]])
            anno["unique"] = (
                np.array(scene2obj[anno["scan_id"]])
                == labels[anno["target_id"]]
            ).sum() == 1
        return annos

    def load_scannet_annos(self) -> List[Dict]:
        """Detection-prompt annotations over whole scans
        (joint_det_dataset.py:280-310)."""
        split = "train" if self.split == "train" else "val"
        with open(osp.join(self.meta_dir, f"scannetv2_{split}.txt")) as f:
            scan_ids = [line.rstrip() for line in f if line.strip()]
        annos = []
        for scan_id in scan_ids:
            if scan_id not in self.scans:
                continue
            scan = self.scans[scan_id]
            keep = any(
                self.label_map[scan.get_object_instance_label(ind)]
                in self.dc.nyu40id2class
                for ind in range(len(scan.three_d_objects))
            )
            if keep:
                annos.append({
                    "scan_id": scan_id,
                    "target_id": [],
                    "distractor_ids": [],
                    "utterance": "",
                    "target": [],
                    "anchors": [],
                    "anchor_ids": [],
                    "dataset": "scannet",
                })
        if self.split == "train":
            # two corrupted scans skipped by index in the reference (:305-309)
            annos = [a for i, a in enumerate(annos) if i not in (965, 977)]
        return annos

    # ------------------------------------------------------------------
    # per-sample assembly (joint_det_dataset.py:626-790)
    # ------------------------------------------------------------------

    def __len__(self):
        return len(self.annos)

    def _sample_classes(self, scan_id: str, random_utt: bool, rng):
        """Detection-utterance classes (joint_det_dataset.py:312-334)."""
        scan = self.scans[scan_id]
        present = {
            self.label_map[scan.get_object_instance_label(ind)]
            for ind in range(len(scan.three_d_objects))
        }
        present = list(present & set(self.dc.nyu40id2class))
        if self.split == "train" and random_utt:
            if len(present) > 10:
                idx = rng.choice(len(present), 10, replace=False)
                present = [present[i] for i in idx]
            ret = [
                self.dc.class2type[self.dc.nyu40id2class[i]] for i in present
            ]
            rng.shuffle(ret)
            return ret
        return list(DET18_NAMES)

    def _create_scannet_utterance(
        self, sampled_classes: List[str], random_utt: bool, rng
    ) -> str:
        """' . '-joined detection prompt, mixed with negatives when random
        (joint_det_dataset.py:336-348)."""
        if self.split == "train" and random_utt:
            neg = []
            while len(neg) < 10:
                cand = self.dc.class2type[rng.randint(0, len(self.dc.class2type))]
                if cand not in neg and cand not in sampled_classes:
                    neg.append(cand)
            mixed = sorted(set(sampled_classes + neg))
            rng.shuffle(mixed)
        else:
            mixed = sampled_classes
        return " . ".join(mixed)

    def _get_pc(self, anno: Dict, scan, rng):
        """Assemble the per-point feature matrix + augment
        (joint_det_dataset.py:404-452)."""
        # f32 from here on: the model consumes f32, and augmentation in
        # f32 is ~2x the host throughput of the f64 the Scan stores
        # (alignment and subsampling stay f64, as the reference's; the
        # cast costs <1e-7 relative, far below the 5e-3 augmentation
        # noise). The JAX package casts at the same place.
        pc = scan.orig_pc.astype(np.float32)
        rel_name = (
            find_rel(anno["utterance"])
            if anno["dataset"].startswith("sr3d")
            else "none"
        )
        color = None
        if self.use_color:
            color = (scan.color - self.mean_rgb).astype(np.float32)
        height = None
        if self.use_height:
            floor = np.percentile(pc[:, 2], 0.99)
            height = (pc[:, 2] - floor)[:, None]
        multiview = None
        if self.use_multiview:
            multiview = self._load_multiview(anno["scan_id"])

        augmentations: Dict = {}
        if self.augment:
            rotate = (
                (
                    anno["dataset"] in ("nr3d", "scanrefer")
                    and allow_rotation_nr3d(anno["utterance"])
                )
                or (
                    anno["dataset"].startswith("sr3d")
                    and rel_name not in view_dep_rels()
                )
                or anno["dataset"] == "scannet"
            )
            pc, color, augmentations = augment_pointcloud(
                pc, color, rotate, rng
            )

        feats = [pc]
        if color is not None:
            feats.append(color)
        if height is not None:
            feats.append(height)
        if multiview is not None:
            feats.append(multiview)
        point_cloud = np.concatenate(feats, axis=1)
        return point_cloud, pc, augmentations, rel_name

    def _load_multiview(self, scan_id: str) -> np.ndarray:
        """Per-point 2D ENet features from the ScanRefer HDF5 file
        (reference joint_det_dataset.py:84-88, 350-356), opened lazily
        once a process."""
        import h5py

        pid = os.getpid()
        if pid not in self._multiview_files:
            self._multiview_files[pid] = h5py.File(
                osp.join(self.data_path, "scanrefer_2d_feats",
                         "enet_feats_maxpool.hdf5"), "r", libver="latest")
        return np.asarray(self._multiview_files[pid][scan_id])

    def __getstate__(self):
        # a loader worker opens its own handle: an HDF5 handle does not
        # pickle
        return dict(self.__dict__, _multiview_files={})

    @staticmethod
    def _object_bbox(scan, object_id: int, pc: np.ndarray) -> np.ndarray:
        """AABB [min, max] of one object's points in the AUGMENTED cloud.

        The reference re-assigns `scan.pc = pc` after augmentation
        (joint_det_dataset.py:441-442) so `scan.get_object_bbox` (→
        visual_data_handlers.py:224-230, min/max over `self.pc[points]`)
        yields boxes in the augmented frame. We keep `Scan` immutable and
        thread the augmented cloud in explicitly instead."""
        pts = pc[scan.three_d_objects[object_id]["points"], :3]
        return np.concatenate([pts.min(axis=0), pts.max(axis=0)])

    def _get_target_boxes(self, anno: Dict, scan, pc: np.ndarray, rng):
        """GT boxes + per-point instance labels
        (joint_det_dataset.py:496-522). `pc` is the augmented xyz cloud;
        boxes are AABBs of the augmented object points, matching the
        reference (see _object_bbox)."""
        bboxes = np.zeros((self.max_num_obj, 6))
        if isinstance(anno["target_id"], list):
            tids = anno["target_id"]
        else:
            tids = [anno["target_id"]]
            if self.detect_intermediate:
                tids = tids + list(anno.get("anchor_ids", []))
        # truncate past the pad width (the reference's 132 always fits;
        # a narrow max_num_obj must truncate, per the __init__ contract)
        tids = tids[: self.max_num_obj]
        point_instance_label = -np.ones(len(pc))
        for t, tid in enumerate(tids):
            point_instance_label[scan.three_d_objects[tid]["points"]] = t

        if tids:
            corner = np.stack(
                [self._object_bbox(scan, tid, pc) for tid in tids]
            )  # (n, 6) min/max
            bboxes[: len(tids)] = np.concatenate(
                [(corner[:, :3] + corner[:, 3:]) / 2,
                 corner[:, 3:] - corner[:, :3]],
                axis=1,
            )
        if self.augment:  # box jitter (joint_det_dataset.py:516)
            bboxes[: len(tids)] *= (
                0.95 + 0.1 * rng.random_sample((len(tids), 6))
            )
        bboxes[len(tids):, :3] = 1000
        box_label_mask = np.zeros(self.max_num_obj)
        box_label_mask[: len(tids)] = 1
        return bboxes, box_label_mask, point_instance_label, tids

    def _get_scene_objects(self, scan, pc: np.ndarray, rng):
        """All annotated scene boxes (joint_det_dataset.py:524-561), AABBs
        in the augmented frame like the reference (see _object_bbox)."""
        n = len(scan.three_d_objects)
        keep_ = np.array([
            self.label_map[scan.get_object_instance_label(ind)]
            in self.dc.nyu40id2class
            for ind in range(n)
        ])[:self.max_num_obj]
        keep = np.zeros(self.max_num_obj, bool)
        keep[: len(keep_)] = True

        class_ids = np.zeros(self.max_num_obj)
        class_ids[: len(keep_)] = [
            self.dc.nyu40id2class[
                self.label_map[scan.get_object_instance_label(k)]
            ]
            if keep_[k]
            else 325  # the 'object' class
            for k in range(len(keep_))
        ]

        all_bboxes = np.zeros((self.max_num_obj, 6))
        corner = np.stack(
            [self._object_bbox(scan, k, pc) for k in range(len(keep_))]
        )
        all_bboxes[: len(keep_)] = np.concatenate(
            [(corner[:, :3] + corner[:, 3:]) / 2,
             corner[:, 3:] - corner[:, :3]],
            axis=1,
        )
        if self.augment:
            all_bboxes *= 0.95 + 0.1 * rng.random_sample(all_bboxes.shape)
        return class_ids, all_bboxes, keep

    def _get_detected_objects(self, scan_id: str, augmentations: Dict, rng):
        """GroupFree detected-box stream (joint_det_dataset.py:563-624)."""
        boxes = np.zeros((self.max_det_boxes, 6))
        mask = np.zeros(self.max_det_boxes, bool)
        class_ids = np.zeros(self.max_det_boxes)
        logits = np.zeros((self.max_det_boxes, NUM_CLASSES), np.float32)

        path = osp.join(
            self.data_path,
            f"group_free_pred_bboxes_{self.split}",
            f"{scan_id}.npy",
        )
        det = np.load(path, allow_pickle=True).item()
        corner = np.asarray(det["box"])
        if len(det["class"]) != corner.shape[0]:
            raise ValueError(f"{path}: {len(det['class'])} classes for "
                             f"{corner.shape[0]} boxes")
        # truncate to the pad width (the reference's 132 always fits a
        # GroupFree detector's output; a narrow pad must truncate)
        n = min(len(det["class"]), self.max_det_boxes)
        boxes[:n] = np.concatenate(
            [(corner[:n, :3] + corner[:n, 3:]) / 2,
             corner[:n, 3:] - corner[:n, :3]],
            axis=1,
        )
        mask[:n] = True
        class_ids[:n] = [
            self.dc.nyu40id2class[self.label_map[c]]
            for c in det["class"][:n]
        ]
        logits[:n] = np.asarray(det["logits"])[:n]

        if self.augment and augmentations:
            boxes = transform_boxes(boxes, augmentations)
        if self.augment_det and self.split == "train":
            boxes, class_ids = corrupt_detected_boxes(
                boxes, class_ids, len(self.dc.nyu40ids), rng
            )
        return boxes, mask, class_ids, logits

    def get(self, index: int, rng: Optional[np.random.RandomState] = None):
        """One sample. `rng` drives augmentation + scannet prompt sampling;
        defaults to a fresh RandomState(index) for determinism."""
        if rng is None:
            rng = np.random.RandomState(index)
        anno = dict(self.annos[index])
        scan = self.scans[anno["scan_id"]]

        random_utt = False
        if anno["dataset"] == "scannet":
            random_utt = self.joint_det and rng.random_sample() > 0.5
            sampled_classes = self._sample_classes(
                anno["scan_id"], random_utt, rng
            )
            anno["utterance"] = self._create_scannet_utterance(
                sampled_classes, random_utt, rng
            )
            n_obj = len(scan.three_d_objects)
            if not random_utt:  # 18-class detection prompt
                anno["target_id"] = [
                    ind
                    for ind in range(min(n_obj, self.max_num_obj))
                    if self.label_map18[scan.get_object_instance_label(ind)]
                    in self.dc18.nyu40id2class
                ]
                anno["target"] = [
                    self.dc18.class2type[self.dc18.nyu40id2class[
                        self.label_map18[scan.get_object_instance_label(ind)]
                    ]]
                    if self.label_map18[scan.get_object_instance_label(ind)]
                    != 39
                    else "other furniture"
                    for ind in anno["target_id"]
                ]
            else:  # random 485-class prompt
                anno["target_id"] = [
                    ind
                    for ind in range(min(n_obj, self.max_num_obj))
                    if self.label_map[scan.get_object_instance_label(ind)]
                    in self.dc.nyu40id2class
                    and self.dc.class2type[self.dc.nyu40id2class[
                        self.label_map[scan.get_object_instance_label(ind)]
                    ]]
                    in sampled_classes
                ]
                anno["target"] = [
                    self.dc.class2type[self.dc.nyu40id2class[
                        self.label_map[scan.get_object_instance_label(ind)]
                    ]]
                    for ind in anno["target_id"]
                ]

        point_cloud, raw_pc, augmentations, rel_name = self._get_pc(
            anno, scan, rng
        )
        gt_bboxes, box_label_mask, point_instance_label, tids = (
            self._get_target_boxes(anno, scan, raw_pc, rng)
        )

        # positive map: span-predictor output for grounding datasets,
        # token map of category names for scannet (:689-695)
        if anno["dataset"] == "scannet":
            cat_names = (
                anno["target"]
                if isinstance(anno["target"], list)
                else [anno["target"]]
            )
            if self.detect_intermediate:
                cat_names = cat_names + list(anno["anchors"])
            _, positive_map = token_positive_map(
                self.tokenizer, anno["utterance"], cat_names, self.max_num_obj
            )
        else:
            if anno["utterance"] != anno["span_utterance"]:
                raise ValueError(
                    f"span-predictor row of {anno['dataset']} scan "
                    f"{anno['scan_id']} is for {anno['span_utterance']!r}, "
                    f"not {anno['utterance']!r}")
            positive_map = np.zeros((self.max_num_obj, NUM_BINS), np.float32)
            pm = np.asarray(anno["pred_pos_map"]).reshape(-1, NUM_BINS)
            pm = pm[: self.max_num_obj]  # truncate to the pad width
            positive_map[: len(pm)] = pm
        # Truncation guard: the model only sees max_text_len tokens
        # (host-side tokenization; the reference tokenizes unbounded
        # in-forward, bdetr.py:164-167). A positive bin past that length
        # would silently drop out of the soft-token and contrastive losses
        # and of cross-attention — fail loudly instead.
        overflow = positive_map[:, self.max_text_len:].sum()
        if overflow > 0:
            raise ValueError(
                f"positive-map span past max_text_len={self.max_text_len} "
                f"for scan {anno['scan_id']} (dataset {anno['dataset']}, "
                f"utterance {anno['utterance'][:80]!r}...): raise "
                "--max_text_len"
            )

        class_ids, all_bboxes, all_bbox_label_mask = self._get_scene_objects(
            scan, raw_pc, rng
        )

        D = self.max_det_boxes
        if self.butd:
            (
                det_boxes, det_mask, det_class_ids, det_logits
            ) = self._get_detected_objects(anno["scan_id"], augmentations, rng)
        else:
            det_boxes = np.zeros((D, 6))
            det_mask = np.zeros(D, bool)
            det_class_ids = np.zeros(D)
            det_logits = np.zeros((D, NUM_CLASSES), np.float32)

        if self.butd_gt:  # perfect detector (joint_det_dataset.py:712-716)
            det_boxes = _fit_rows(all_bboxes, D)
            det_mask = _fit_rows(all_bbox_label_mask, D)
            det_class_ids = _fit_rows(class_ids, D)
        if self.butd_cls:  # perfect proposals (joint_det_dataset.py:718-729)
            det_boxes = _fit_rows(all_bboxes, D)
            det_mask = _fit_rows(all_bbox_label_mask, D)
            det_class_ids = np.zeros(D)
            classes = np.array(self.cls_results[anno["scan_id"]])
            classes[classes == -1] = 325
            k = min(int(all_bbox_label_mask.sum()), D)
            det_class_ids[:k] = classes[:k]

        # 18-class labels for detection eval (joint_det_dataset.py:731-739)
        labels = np.zeros(self.max_num_obj)
        if isinstance(anno["target_id"], list) and not random_utt:
            labels[: len(tids)] = [
                self.dc18.nyu40id2class[
                    self.label_map18[scan.get_object_instance_label(ind)]
                ]
                for ind in tids
            ]

        utterance = (
            normalize_caption(anno["utterance"]) + " . not mentioned"
        )
        tok = self.tokenizer([utterance], max_len=self.max_text_len)

        root_id = (
            anno["target_id"]
            if isinstance(anno["target_id"], int)
            else (anno["target_id"][0] if anno["target_id"] else 0)
        )
        return {
            # GT for losses
            "box_label_mask": box_label_mask.astype(np.float32),
            "center_label": gt_bboxes[:, :3].astype(np.float32),
            "sem_cls_label": labels.astype(np.int64),
            "size_gts": gt_bboxes[:, 3:].astype(np.float32),
            "positive_map": positive_map.astype(np.float32),
            "point_instance_label": point_instance_label.astype(np.int64),
            # model inputs
            "point_clouds": point_cloud.astype(np.float32),
            "text_ids": tok.ids[0],
            "text_mask": tok.attention_mask[0],
            "det_boxes": det_boxes.astype(np.float32),
            "det_bbox_label_mask": det_mask,
            "det_class_ids": det_class_ids.astype(np.int64),
            # reference-named aliases + eval metadata
            "scan_ids": anno["scan_id"],
            "utterances": utterance,
            "relation": rel_name,
            "target_name": scan.get_object_instance_label(root_id),
            "target_id": root_id,
            "all_bboxes": all_bboxes.astype(np.float32),
            "all_bbox_label_mask": all_bbox_label_mask.astype(bool),
            "all_class_ids": class_ids.astype(np.int64),
            "all_detected_boxes": det_boxes.astype(np.float32),
            "all_detected_bbox_label_mask": det_mask,
            "all_detected_class_ids": det_class_ids.astype(np.int64),
            "all_detected_logits": det_logits,
            "distractor_ids": np.array(
                list(anno["distractor_ids"])[:32]
                + [-1] * max(0, 32 - len(anno["distractor_ids"]))
            ).astype(np.int64),
            "anchor_ids": np.array(
                list(anno["anchor_ids"])[:32]
                + [-1] * max(0, 32 - len(anno["anchor_ids"]))
            ).astype(np.int64),
            "is_view_dep": is_view_dep(anno["utterance"]),
            "is_hard": len(anno["distractor_ids"]) > 1,
            "is_unique": len(anno["distractor_ids"]) == 0,
            "target_cid": int(class_ids[root_id]) if root_id < self.max_num_obj
            else 0,
        }

    def __getitem__(self, index: int):
        return self.get(index)

"""Data pipeline of the port: ScanNet scans, augmentation, the grounding
datasets, positive maps, synthetic batches and data roots, and the
batching loader. Imports numpy and the host C++ runtime (`native.py`)
only, never torch: the loader's worker processes import this package."""

from butd_detr_tpu_torch.data.augment import (
    MEAN_RGB,
    augment_pointcloud,
    box2points,
    corrupt_detected_boxes,
    points2box,
    rot_x,
    rot_y,
    rot_z,
    transform_boxes,
)
from butd_detr_tpu_torch.data.joint_dataset import (
    MAX_NUM_OBJ,
    NUM_CLASSES,
    JointGroundingDataset,
)
from butd_detr_tpu_torch.data.loader import DataLoader, collate
from butd_detr_tpu_torch.data.positive_map import (
    find_char_spans,
    get_positive_map,
    normalize_caption,
    token_positive_map,
)
from butd_detr_tpu_torch.data.scan import (
    Scan,
    ScanNetMappings,
    hilbert_code,
    load_scan_cache,
    load_scans_parallel,
    read_ply,
    save_scan_cache,
)
from butd_detr_tpu_torch.data.scannet_config import (
    ScannetDatasetConfig,
    find_rel,
    is_view_dep,
    read_label_mapping,
    scannet_classes,
    valid_test_classes_485,
    view_dep_rels,
)
from butd_detr_tpu_torch.data.synthetic import (
    SyntheticGroundingDataset,
    make_fake_multiview,
    make_fake_scannet,
    make_rich_scannet,
    make_trainval_root,
    synthetic_batch,
)

__all__ = [
    "DataLoader",
    "JointGroundingDataset",
    "MAX_NUM_OBJ",
    "MEAN_RGB",
    "NUM_CLASSES",
    "Scan",
    "ScanNetMappings",
    "ScannetDatasetConfig",
    "SyntheticGroundingDataset",
    "augment_pointcloud",
    "box2points",
    "collate",
    "corrupt_detected_boxes",
    "find_char_spans",
    "find_rel",
    "get_positive_map",
    "hilbert_code",
    "is_view_dep",
    "load_scan_cache",
    "load_scans_parallel",
    "make_fake_multiview",
    "make_fake_scannet",
    "make_rich_scannet",
    "make_trainval_root",
    "normalize_caption",
    "points2box",
    "read_label_mapping",
    "read_ply",
    "rot_x",
    "rot_y",
    "rot_z",
    "save_scan_cache",
    "scannet_classes",
    "synthetic_batch",
    "token_positive_map",
    "transform_boxes",
    "valid_test_classes_485",
    "view_dep_rels",
]

"""ScanNet class / relation vocabulary and dataset config.

The port's copy of `butd_detr_tpu/data/scannet_config.py` (reference
`data/model_util_scannet.py:15-35` ScannetDatasetConfig,
`data/scannet_utils.py:20-32` read_label_mapping and
`src/scannet_classes.py:801-945`, the relation vocabulary). The class lists
and nyu40-id tables are dataset facts, stored as a JSON resource
(`resources/scannet_vocab.json`, the same file as the JAX package's).
"""

import csv
import functools
import json
import os
from typing import Dict, List

import numpy as np

_RESOURCE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "resources", "scannet_vocab.json",
)


@functools.lru_cache()
def _vocab() -> Dict:
    with open(_RESOURCE) as f:
        return json.load(f)


def scannet_classes(num_class: int = 485) -> List[str]:
    return list(_vocab()[f"classes_{num_class}"])


def relations() -> List[str]:
    return list(_vocab()["relations"])


def view_dep_rels() -> List[str]:
    return list(_vocab()["view_dep_rels"])


def rel_aliases() -> Dict[str, str]:
    return dict(_vocab()["rel_aliases"])


def valid_test_classes_485() -> List[int]:
    """485-class ids that appear in val (utils/eval_det.py:28)."""
    return list(_vocab()["valid_test_classes_485"])


class ScannetDatasetConfig:
    """485-class (grounding) or 18-class (detection) ScanNet config
    (model_util_scannet.py:15-35)."""

    def __init__(self, num_class: int = 485, agnostic: bool = False):
        self.num_class = num_class if not agnostic else 1
        self.num_heading_bin = 1
        self.num_size_cluster = num_class
        names = scannet_classes(num_class)
        self.type2class = {n: i for i, n in enumerate(names)}
        self.class2type = {i: n for i, n in enumerate(names)}
        self.nyu40ids = np.array(_vocab()[f"nyu40ids_{num_class}"])
        self.nyu40id2class = {
            int(n): i for i, n in enumerate(self.nyu40ids.tolist())
        }


def read_label_mapping(
    filename: str, label_from: str = "raw_category", label_to: str = "nyu40id"
) -> Dict:
    """Read a column->column mapping from the scannetv2 labels TSV
    (scannet_utils.py:20-32); int-like values (and keys) are cast."""

    def maybe_int(v):
        try:
            return int(v)
        except (TypeError, ValueError):
            return v

    mapping = {}
    with open(filename) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            mapping[row[label_from]] = maybe_int(row[label_to])
    if mapping and isinstance(maybe_int(next(iter(mapping))), int):
        mapping = {int(k): v for k, v in mapping.items()}
    return mapping


# Spatial relations whose meaning depends on viewpoint: rotation-augmenting
# these utterances would corrupt supervision (joint_det_dataset.py:792-824).
VIEW_DEP_WORDS = (
    "front", "behind", "back", "left", "right", "facing",
    "leftmost", "rightmost", "looking", "across",
)


def is_view_dep(utterance: str) -> bool:
    """Word-level check (joint_det_dataset.py:793-801)."""
    words = set(utterance.split())
    return any(rel in words for rel in VIEW_DEP_WORDS)


def allow_rotation_nr3d(utterance: str) -> bool:
    """Substring check used to gate augmentation for natural-language
    datasets (joint_det_dataset.py:815-824)."""
    return not any(
        f" {rel} " in (utterance + " ") for rel in VIEW_DEP_WORDS
    )


def find_rel(utterance: str) -> str:
    """Longest-alias spatial-relation lookup (joint_det_dataset.py:803-812)."""
    padded = " " + utterance.replace(",", " ,") + " "
    aliases = rel_aliases()
    for rel in sorted(aliases, key=len, reverse=True):
        if f" {rel} " in padded:
            return aliases[rel]
    return "none"

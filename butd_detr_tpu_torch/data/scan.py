"""ScanNet scan loading: PLY parsing, axis alignment, object aggregation.

The port's copy of `butd_detr_tpu/data/scan.py` (reference
`src/visual_data_handlers.py`, Scan:69 and ScanNetMappings:17). PLY files
are read by the port's host C++ reader (`native.py`), as the JAX package
reads them; the Python parser reads what the C++ rejects (ascii,
big-endian) and is the plain version the tests hold the reader against.

`Scan` keeps the JAX package's attribute names, so one scan cache serves
both packages: `load_scan_cache` reads a `{split}_v3scans.pkl` written by
either, mapping the JAX package's `Scan` class to this one and refusing any
other class of that package, so a cache never imports it.
"""

import json
import os.path as osp
import pickle
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from butd_detr_tpu_torch.native import ply_read_vertices_native

KEEP_POINTS = 50000
SUBSAMPLE_SEED = 1184
HILBERT_BITS = 10


def hilbert_code(xyz: np.ndarray, bits: int = HILBERT_BITS) -> np.ndarray:
    """3 * bits-bit 3D Hilbert index per point (Skilling's AxesToTranspose
    and interleave), used to store each scan's subsampled cloud in
    spatially local order (see Scan.load_point_cloud). Order never changes
    a result, only how local the neighbour kernels' memory reads are."""
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


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """PLY vertex reader: {property: column} of the first (vertex)
    element. binary_little_endian (the C++ reader: x, y, z as f32, the
    colour columns when any is non-zero, `label` when any is >= 0),
    binary_big_endian and ascii (the Python parser: every column as the
    header types it); all ScanNet `_vh_clean_2` files are binary
    little-endian."""
    native = ply_read_vertices_native(path)
    if native is None:
        return _read_ply_py(path)
    xyz, rgb, label = native
    out = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    if rgb.any():
        out.update({"red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]})
    if (label >= 0).any():
        out["label"] = label
    return out


_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _read_ply_py(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements = []  # [(name, count, [(prop, dtype)])]
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"unterminated PLY header: {path}")
            tokens = line.decode("ascii", "replace").split()
            if not tokens or tokens[0] == "comment":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append((tokens[4], _PLY_TYPES[tokens[2]],
                                            _PLY_TYPES[tokens[3]]))
                else:
                    elements[-1][2].append((tokens[2], _PLY_TYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        _, count, props = elements[0]
        if any(len(p) == 3 for p in props):
            raise ValueError("list property in vertex element unsupported")
        if fmt == "ascii":
            rows = np.loadtxt((f.readline() for _ in range(count)), ndmin=2)
            return {p: rows[:, i].astype(t) for i, (p, t) in enumerate(props)}
        endian = "<" if "little" in fmt else ">"
        dt = np.dtype([(p, endian + t) for p, t in props])
        data = np.frombuffer(f.read(count * dt.itemsize), dtype=dt)
        return {p: np.ascontiguousarray(data[p]) for p, _ in props}


class ScanNetMappings:
    """Dataset-level mapping tables (visual_data_handlers.py:17-66)."""

    def __init__(self, meta_dir: str):
        self.meta_dir = meta_dir
        with open(osp.join(meta_dir,
                           "scannet_idx_to_semantic_class.json")) as f:
            self.idx_to_semantic_cls_dict = json.load(f)
        self.semantic_cls_to_idx_dict = {
            v: k for k, v in self.idx_to_semantic_cls_dict.items()
        }
        with open(osp.join(
                meta_dir,
                "scannet_instance_class_to_semantic_class.json")) as f:
            self.instance_cls_to_semantic_cls_dict = json.load(f)
        with open(osp.join(meta_dir,
                           "scans_axis_alignment_matrices.json")) as f:
            self.scans_axis_alignment_mats = json.load(f)

    def idx_to_semantic_cls(self, idx) -> str:
        return self.idx_to_semantic_cls_dict[str(idx)]

    def semantic_cls_to_idx(self, cls) -> str:
        return self.semantic_cls_to_idx_dict[str(cls)]

    def instance_cls_to_semantic_cls(self, cls) -> str:
        return self.instance_cls_to_semantic_cls_dict[str(cls)]

    def get_axis_alignment_matrix(self, scan_id: str) -> np.ndarray:
        return np.array(self.scans_axis_alignment_mats[scan_id]).reshape(4, 4)


class Scan:
    """One ScanNet scene: the subsampled, axis-aligned cloud, colors,
    semantic labels, and per-object point indices + instance labels.

    Mirrors reference Scan (visual_data_handlers.py:69-258): fixed-seed
    subsample to `keep_points` points (without replacement when the scan
    has as many), stored in Hilbert order when `spatial_sort`, per-object
    indices remapped into the sampled cloud, duplicate objects dropped,
    AABBs from point min/max.
    """

    def __init__(self, scan_id: str, top_scan_dir: str,
                 load_objects: bool = True,
                 mappings: Optional[ScanNetMappings] = None,
                 meta_dir: Optional[str] = None,
                 keep_points: int = KEEP_POINTS, spatial_sort: bool = True):
        self.scan_id = scan_id
        self.top_scan_dir = top_scan_dir
        if mappings is None:
            mappings = ScanNetMappings(
                meta_dir or osp.join(top_scan_dir, "..", "meta_data"))
        self.mappings = mappings
        self.spatial_sort = spatial_sort
        self.choices = None
        self.pc, self.semantic_label_idx, self.color = \
            self.load_point_cloud(keep_points)
        self.orig_pc = np.copy(self.pc)  # augmentation never touches this
        self.three_d_objects: Optional[List[Dict]] = None
        if load_objects:
            self.load_point_clouds_of_all_objects()

    # -- loading ---------------------------------------------------------

    def _scan_file(self, suffix: str) -> str:
        return osp.join(self.top_scan_dir, self.scan_id,
                        self.scan_id + suffix)

    def load_point_cloud(self, keep_points: int = KEEP_POINTS):
        label = None
        label_path = self._scan_file("_vh_clean_2.labels.ply")
        if osp.exists(label_path):
            label = read_ply(label_path)["label"]

        data = read_ply(self._scan_file("_vh_clean_2.ply"))
        pc = np.stack([data["x"], data["y"], data["z"]],
                      axis=1).astype(np.float64)
        pc = self.align_to_axes(pc)
        color = (np.stack([data["red"], data["green"], data["blue"]], axis=1)
                 / 256.0).astype(np.float32)

        # fixed-seed subsample, as visual_data_handlers.py:113-126
        rng = np.random.RandomState(SUBSAMPLE_SEED)
        choices = rng.choice(pc.shape[0], keep_points,
                             replace=len(pc) < keep_points)
        if self.spatial_sort:
            # Hilbert order, folded into `choices` so that color, label and
            # the object remaps all stay aligned
            perm = np.argsort(hilbert_code(pc[choices]), kind="stable")
            choices = choices[perm]
        self.choices = choices
        self.new_pts = np.zeros(len(pc), int)
        self.new_pts[choices] = np.arange(len(choices), dtype=int)
        pc = pc[choices]
        if label is not None:
            label = label[choices]
        return pc, label, color[choices]

    def load_point_clouds_of_all_objects(self):
        with open(self._scan_file("_vh_clean_2.0.010000.segs.json")) as f:
            segment_indices = json.load(f)["segIndices"]
        segments = defaultdict(list)
        for i, s in enumerate(segment_indices):
            segments[s].append(i)

        with open(self._scan_file(".aggregation.json")) as f:
            aggregation = json.load(f)

        objects = []
        for info in aggregation["segGroups"]:
            points = []
            for s in info["segments"]:
                points.extend(segments[s])
            points = np.array(sorted(set(points)))
            if self.choices is not None:
                points = self.new_pts[points[np.isin(points, self.choices)]]
            objects.append({
                "object_id": int(info["objectId"]),
                "points": np.asarray(points),
                "instance_label": str(info["label"]),
            })

        # drop exact-duplicate objects (visual_data_handlers.py:163-177)
        seen = set()
        kept = []
        for obj in objects:
            key = (len(obj["points"]), obj["points"].tobytes())
            if key in seen:
                continue
            seen.add(key)
            kept.append(obj)
        self.three_d_objects = kept

    def align_to_axes(self, point_cloud: np.ndarray) -> np.ndarray:
        mat = self.mappings.get_axis_alignment_matrix(self.scan_id)
        pts = np.ones((point_cloud.shape[0], 4), point_cloud.dtype)
        pts[:, :3] = point_cloud
        return pts @ mat.T[:, :3]

    # -- accessors (visual_data_handlers.py:196-258) ----------------------

    def get_object_pc(self, object_id: int) -> np.ndarray:
        return self.pc[self.three_d_objects[object_id]["points"]]

    def get_object_color(self, object_id: int) -> np.ndarray:
        return self.color[self.three_d_objects[object_id]["points"]]

    def get_object_instance_label(self, object_id: int) -> str:
        return self.three_d_objects[object_id]["instance_label"]

    def get_object_semantic_label(self, object_id: int) -> str:
        one_point = self.three_d_objects[object_id]["points"][0]
        return self.mappings.idx_to_semantic_cls(
            self.semantic_label_idx[one_point])

    def get_object_bbox(self, object_id: int) -> np.ndarray:
        """AABB [xmin, ymin, zmin, xmax, ymax, zmax] of the object's
        points."""
        pc = self.get_object_pc(object_id)[:, :3]
        return np.concatenate([pc.min(axis=0), pc.max(axis=0)])

    def instance_occurrences(self) -> Dict[str, int]:
        res = defaultdict(int)
        for o in self.three_d_objects:
            res[o["instance_label"]] += 1
        return res

    def __getstate__(self):
        # the mapping tables are scan-independent: load_scan_cache puts one
        # copy back on every scan
        state = dict(self.__dict__)
        state["mappings"] = None
        return state


def load_scans_parallel(scan_ids: List[str], scan_dir: str, meta_dir: str,
                        num_workers: int = 4, keep_points: int = KEEP_POINTS,
                        spatial_sort: bool = True) -> Dict[str, Scan]:
    """Load many scans with a process pool (reference save_data,
    joint_det_dataset.py:1000-1029). Spawn, not fork, workers: the dataset
    builds the cache on demand inside a training process that may hold a
    CUDA context and threads."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    if num_workers <= 1:
        mappings = ScanNetMappings(meta_dir)
        return {sid: Scan(sid, scan_dir, True, mappings=mappings,
                          keep_points=keep_points, spatial_sort=spatial_sort)
                for sid in scan_ids}
    with ProcessPoolExecutor(max_workers=num_workers,
                             mp_context=mp.get_context("spawn")) as ex:
        scans = list(ex.map(_load_one, [
            (sid, scan_dir, meta_dir, keep_points, spatial_sort)
            for sid in scan_ids]))
    return dict(zip(scan_ids, scans))


def _load_one(args):
    sid, scan_dir, meta_dir, keep_points, spatial_sort = args
    return Scan(sid, scan_dir, True, meta_dir=meta_dir,
                keep_points=keep_points, spatial_sort=spatial_sort)


def save_scan_cache(filename: str, split: str, data_path: str,
                    num_workers: int = 4, keep_points: int = KEEP_POINTS,
                    spatial_sort: bool = True):
    """Pickle all scans of a split to a `{split}_v3scans.pkl`-style
    cache."""
    meta_dir = osp.join(data_path, "meta_data")
    with open(osp.join(meta_dir, f"scannetv2_{split}.txt")) as f:
        scan_ids = [line.rstrip() for line in f if line.strip()]
    scans = load_scans_parallel(
        scan_ids, osp.join(data_path, "scans"), meta_dir, num_workers,
        keep_points=keep_points, spatial_sort=spatial_sort)
    with open(filename, "wb") as f:
        pickle.dump(scans, f, protocol=pickle.HIGHEST_PROTOCOL)


# the JAX package pickles its scans under this name
_JAX_SCAN = ("butd_detr_tpu.data.scan", "Scan")


class _ScanUnpickler(pickle.Unpickler):
    """Reads a scan cache of either package into this package's `Scan`,
    and imports nothing of the JAX package."""

    def find_class(self, module, name):
        if (module, name) == _JAX_SCAN:
            return Scan
        if module == "butd_detr_tpu" or module.startswith("butd_detr_tpu."):
            raise pickle.UnpicklingError(
                f"scan cache holds {module}.{name}; only {'.'.join(_JAX_SCAN)}"
                " of the JAX package is read")
        return super().find_class(module, name)


def load_scan_cache(filename: str, meta_dir: Optional[str] = None):
    """{scan_id: Scan} from a cache written by `save_scan_cache` of either
    package; `meta_dir` puts the mapping tables back on every scan."""
    with open(filename, "rb") as f:
        scans = _ScanUnpickler(f).load()
    if meta_dir is not None:
        mappings = ScanNetMappings(meta_dir)
        for scan in scans.values():
            scan.mappings = mappings
    return scans

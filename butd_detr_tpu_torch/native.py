"""ctypes bindings for the port's host C++ runtime (`csrc/butd_native.cpp`).

The port's counterpart of the JAX package's `native.py`: the PLY reader of
the scan loader, the loader's fused augmentation pass, the greedy NMS and
the VOC matcher of the detection evaluation, and a point-in-box count. The
callers (`data/scan.py:read_ply`, `data/augment.py:augment_pointcloud`,
`eval/nms.py`, `eval/detection.py:eval_det_cls`) take these paths under
the JAX package's conditions; their numpy code is the plain version that
the tests hold the library against.

The library is built at first use with `$CXX` (`g++` when unset) and
exactly the flags of the JAX package's `csrc/Makefile` (`CXXFLAGS`): the
FMA contractions `-march=native` allows change the augmentation's last
bits, so the same flags give the JAX package's bits on one machine. The
output goes to `_build/butd_native-<hash>.so` (git-ignored); the hash
covers the source, the compiler, the flags and the host CPU, so a build
directory carried to another machine is rebuilt there. The compiler
writes a temporary file that `os.replace` moves into place, so processes
that start together (test workers, spawned loader workers) each load a
whole file. A failed build or load raises with the compiler's output:
there is no silent fallback to numpy.

Imports neither torch nor `ops/_cuda.py`: a loader worker that unpickles
a dataset runs without torch.
"""

import ctypes
import functools
import hashlib
import os
import shlex
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "butd_native.cpp"
BUILD_DIR = _PKG / "_build"
# csrc/Makefile:2 of the JAX package, flag for flag
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
            "-Wall"]

# calls of each entry point in this process (every wrapper adds one)
CALLS: Dict[str, int] = {name: 0 for name in (
    "ply_read_vertices", "greedy_nms", "voc_match", "points_in_boxes",
    "augment_fused")}


def compiler() -> List[str]:
    """The C++ compiler command: `$CXX`, or `g++` when it is unset."""
    return shlex.split(os.environ.get("CXX") or "g++")


def _cpu_identity() -> str:
    """The host CPU's model name and feature flags: what `-march=native`
    compiles for."""
    keep = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block is enough
                if line.startswith(("model name", "flags")):
                    keep.append(line.strip())
    except OSError:
        pass
    return "\n".join(keep)


def library_path(build_dir: Optional[Path] = None) -> Path:
    """Where the library of the current source, compiler, flags and CPU
    lies once built in `build_dir` (default `BUILD_DIR`)."""
    h = hashlib.sha1()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(compiler() + CXXFLAGS).encode())
    h.update(_cpu_identity().encode())
    name = f"butd_native-{h.hexdigest()[:16]}.so"
    return Path(build_dir or BUILD_DIR) / name


def build(build_dir: Optional[Path] = None) -> Path:
    """Build the library into `build_dir` (default `BUILD_DIR`) unless it
    is there already; returns its path. Raises RuntimeError with the
    compiler's output when the build fails."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".tmp",
                               dir=out.parent)
    os.close(fd)
    cmd = [*compiler(), *CXXFLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"could not run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stdout}"
            f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library, built first when this machine has no build of
    the current source."""
    lib = ctypes.CDLL(str(build()))
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_u8_p = ctypes.POINTER(ctypes.c_uint8)
    c_i32_p = ctypes.POINTER(ctypes.c_int32)
    lib.ply_vertex_count.restype = ctypes.c_long
    lib.ply_vertex_count.argtypes = [ctypes.c_char_p]
    lib.ply_read_vertices.restype = ctypes.c_long
    lib.ply_read_vertices.argtypes = [
        ctypes.c_char_p, c_float_p, c_u8_p, c_i32_p]
    lib.greedy_nms.restype = ctypes.c_long
    lib.greedy_nms.argtypes = [
        c_float_p, c_float_p, c_float_p, c_i32_p,
        ctypes.c_long, ctypes.c_int, ctypes.c_float, ctypes.c_int, c_i32_p]
    lib.voc_match.restype = ctypes.c_long
    lib.voc_match.argtypes = [
        c_float_p, c_i32_p, ctypes.c_long,
        c_float_p, c_i32_p, ctypes.c_long,
        ctypes.c_float, c_u8_p, c_u8_p]
    lib.points_in_boxes.restype = None
    lib.points_in_boxes.argtypes = [
        c_float_p, ctypes.c_long, c_float_p, ctypes.c_long, c_i32_p]
    lib.augment_fused.restype = None
    lib.augment_fused.argtypes = [
        c_float_p, ctypes.c_long, ctypes.c_long, c_float_p, c_float_p,
        c_float_p, ctypes.c_float, c_float_p, c_float_p, c_float_p]
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def ply_read_vertices_native(
        path: str) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(xyz (n, 3) f32, rgb (n, 3) u8 (zeros without colour), label (n,)
    i32 (-1 without labels)) of a binary little-endian PLY's vertex
    element, or None where the C++ reader rejects the file (ascii,
    big-endian, truncated, missing)."""
    lib = library()
    CALLS["ply_read_vertices"] += 1
    n = lib.ply_vertex_count(path.encode())
    if n <= 0:
        return None
    xyz = np.empty((n, 3), np.float32)
    rgb = np.zeros((n, 3), np.uint8)
    label = np.full((n,), -1, np.int32)
    got = lib.ply_read_vertices(
        path.encode(), _ptr(xyz, ctypes.c_float), _ptr(rgb, ctypes.c_uint8),
        _ptr(label, ctypes.c_int32))
    if got != n:
        return None
    return xyz, rgb, label


def greedy_nms_native(mins, maxs, scores, thresh, old_type=False,
                      classes=None) -> List[int]:
    """Greedy NMS over (n, d) axis-aligned boxes in f32: score descending,
    tied scores by descending index; returns the kept indices."""
    lib = library()
    CALLS["greedy_nms"] += 1
    mins = np.ascontiguousarray(mins, np.float32)
    maxs = np.ascontiguousarray(maxs, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    n, d = mins.shape
    if maxs.shape != (n, d) or scores.shape != (n,):
        raise ValueError(f"boxes {mins.shape} / {maxs.shape}, scores "
                         f"{scores.shape}")
    keep = np.empty(n, np.int32)
    cls_ptr = None
    if classes is not None:
        classes = np.ascontiguousarray(classes, np.int32)
        if classes.shape != (n,):
            raise ValueError(f"classes {classes.shape} for {n} boxes")
        cls_ptr = _ptr(classes, ctypes.c_int32)
    k = lib.greedy_nms(
        _ptr(mins, ctypes.c_float), _ptr(maxs, ctypes.c_float),
        _ptr(scores, ctypes.c_float), cls_ptr,
        n, d, float(thresh), int(old_type), _ptr(keep, ctypes.c_int32))
    return keep[:k].tolist()


def voc_match_native(det_boxes, det_img, gt_boxes, gt_img,
                     ovthresh) -> Tuple[np.ndarray, np.ndarray]:
    """The VOC greedy matcher on (nd, 6) / (ng, 6) [min, max] boxes in
    f32; detections already in descending confidence. Returns (tp, fp),
    (nd,) uint8 each."""
    lib = library()
    CALLS["voc_match"] += 1
    det_boxes = np.ascontiguousarray(det_boxes, np.float32).reshape(-1, 6)
    det_img = np.ascontiguousarray(det_img, np.int32)
    gt_boxes = np.ascontiguousarray(gt_boxes, np.float32).reshape(-1, 6)
    gt_img = np.ascontiguousarray(gt_img, np.int32)
    nd, ng = len(det_boxes), len(gt_boxes)
    if det_img.shape != (nd,) or gt_img.shape != (ng,):
        raise ValueError(f"image ids {det_img.shape} / {gt_img.shape} for "
                         f"{nd} / {ng} boxes")
    tp = np.zeros(nd, np.uint8)
    fp = np.zeros(nd, np.uint8)
    lib.voc_match(
        _ptr(det_boxes, ctypes.c_float), _ptr(det_img, ctypes.c_int32), nd,
        _ptr(gt_boxes, ctypes.c_float), _ptr(gt_img, ctypes.c_int32), ng,
        float(ovthresh), _ptr(tp, ctypes.c_uint8), _ptr(fp, ctypes.c_uint8))
    return tp, fp


def points_in_boxes_native(points, boxes) -> np.ndarray:
    """Counts of (n, 3) points inside each of (k, 6) [min, max] boxes,
    bounds included: (k,) int32."""
    lib = library()
    CALLS["points_in_boxes"] += 1
    points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 6)
    counts = np.empty(len(boxes), np.int32)
    lib.points_in_boxes(
        _ptr(points, ctypes.c_float), len(points),
        _ptr(boxes, ctypes.c_float), len(boxes),
        _ptr(counts, ctypes.c_int32))
    return counts


def augment_fused_native(pc, M, noise, shift, scale, color, cscale,
                         mean) -> None:
    """One fused pass, in place: xyz' = (M @ xyz + noise + shift) * scale
    on the first 3 columns of `pc` (C-contiguous f32 (N, >= 3)) and, when
    `color` (C-contiguous f32 (N, 3)) is given, color' = (color + mean) *
    cscale - mean."""
    if (pc.dtype != np.float32 or not pc.flags.c_contiguous
            or pc.ndim != 2 or pc.shape[1] < 3):
        raise ValueError(f"pc must be C-contiguous f32 (N, >= 3), got "
                         f"{pc.dtype} {pc.shape}")
    n, stride = pc.shape
    M = np.ascontiguousarray(M, np.float32).reshape(3, 3)
    noise = np.ascontiguousarray(noise, np.float32)
    shift = np.ascontiguousarray(shift, np.float32).reshape(3)
    if noise.shape != (n, 3):
        raise ValueError(f"noise {noise.shape} for {n} points")
    cptr = csptr = mptr = None
    if color is not None:
        if (color.dtype != np.float32 or not color.flags.c_contiguous
                or color.shape != (n, 3)):
            raise ValueError(f"color must be C-contiguous f32 ({n}, 3), "
                             f"got {color.dtype} {color.shape}")
        cscale = np.ascontiguousarray(cscale, np.float32)
        mean = np.ascontiguousarray(mean, np.float32).reshape(3)
        if cscale.shape != (n, 3):
            raise ValueError(f"cscale {cscale.shape} for {n} points")
        cptr = _ptr(color, ctypes.c_float)
        csptr = _ptr(cscale, ctypes.c_float)
        mptr = _ptr(mean, ctypes.c_float)
    lib = library()
    CALLS["augment_fused"] += 1
    lib.augment_fused(
        _ptr(pc, ctypes.c_float), n, stride, _ptr(M, ctypes.c_float),
        _ptr(noise, ctypes.c_float), _ptr(shift, ctypes.c_float),
        float(scale), cptr, csptr, mptr)


__all__ = ["BUILD_DIR", "CALLS", "CXXFLAGS", "SOURCE", "augment_fused_native",
           "build", "compiler", "greedy_nms_native", "library",
           "library_path", "ply_read_vertices_native",
           "points_in_boxes_native", "voc_match_native"]

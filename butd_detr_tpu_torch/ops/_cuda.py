"""Build, load and count the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, loaded with `ctypes`. The build
happens at the first CUDA use (or an explicit `build_all()`), all sources
at once in parallel, into `butd_detr_tpu_torch/_build/` (git-ignored). A
library's file name carries a hash of its source, headers and flags, so an
edited source is rebuilt and an unchanged one is reused.

Every C entry returns `cudaGetLastError()` after its launch; `check()`
raises if it is not 0. `LAUNCHES` counts kernel launches per kernel; a
wrapper adds one right after it launches its kernel, and nowhere else.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH = "-gencode=arch=compute_90a,code=sm_90a"
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", ARCH]
# The point-cloud kernels must not contract a*b + c into an FMA: their
# indices are held bit-equal to the JAX reference (see csrc/common.cuh).
KERNELS: Dict[str, list] = {
    "fps": ["-fmad=false"],
    "ball_query": ["-fmad=false"],
    "attention": [],
    "attention_bwd": [],
    "scatter": [],
    "gather": [],
    "group_gather": [],
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# Loaded libraries, by kernel name: a cache of what `build_all` built.
_LIBS: Dict[str, ctypes.CDLL] = {}

_VP, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_U, _ULL = ctypes.c_uint, ctypes.c_ulonglong
_STRIDED = [_VP, _LL, _LL, _LL]  # a (B, H, L, Dh) view: pointer + 3 strides
_DROPOUT = [_U, _F, _ULL]  # threshold, 1 / (1 - p), seed
_SIGNATURES = {
    "fps": {
        "fps_launch": [_VP, _I, _I, _I, _VP, _VP, _VP],
        "fps_max_smem_points": [],
    },
    "ball_query": {
        "ball_query_launch": [_VP, _VP, _I, _I, _I, _I, _F, _VP, _VP],
    },
    "attention": {
        "attention_fwd_launch": [*_STRIDED * 3, _VP, *_STRIDED,
                                 _I, _I, _I, _I, _I, _F, _I, *_DROPOUT, _VP],
        "attention_dropout_mask_launch": [_VP, _I, _I, _I, _U, _ULL, _VP],
    },
    "attention_bwd": {
        "attention_bwd_launch": [*_STRIDED * 3, _VP, *_STRIDED * 4, _VP,
                                 _I, _I, _I, _I, _I, _F, _I, *_DROPOUT, _VP],
    },
    "scatter": {
        "scatter_launch": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    },
    "gather": {
        "gather_launch": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    },
    "group_gather": {
        "group_gather_launch": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                                _I, _I, _VP],
    },
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built from csrc/ at first use"
        )
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(COMMON_FLAGS + KERNELS[name]).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Build every kernel that is not built yet (one `nvcc` per source,
    all started together) and load them. Returns the seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in KERNELS:
        if name in _LIBS:
            continue
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [_nvcc(), *COMMON_FLAGS, *KERNELS[name], "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT),
                      tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in jobs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    if failed:
        msgs = "\n".join(
            f"--- {n}\n{(BUILD_DIR / f'{n}.log').read_text()}" for n in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    for name in KERNELS:
        if name not in _LIBS:
            _LIBS[name] = _load(name, _lib_path(name))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output of the last build of `name` (ptxas -v lines:
    registers, shared memory, spills), or '' when it was not built here."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building all kernels first if
    this process has not loaded them yet."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def check(name: str, code: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if code != 0:
        msg = getattr(_LIBS[name], f"{name}_error_string")(code)
        raise RuntimeError(
            f"CUDA kernel '{name}' failed to launch: error {code} "
            f"({msg.decode() if msg else 'unknown'})"
        )


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(
            f"{what}: expected a CPU or CUDA tensor, got {t.device}"
        )

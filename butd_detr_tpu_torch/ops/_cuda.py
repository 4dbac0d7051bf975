"""Build, load, launch and count the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, loaded with `ctypes`. The build
happens at the first CUDA use (or an explicit `build_all()`), all sources
at once in parallel, into `butd_detr_tpu_torch/_build/` (git-ignored). A
library's file name carries a hash of its source, headers and flags, so an
edited source is rebuilt and an unchanged one is reused.

Every wrapper launches through `launch()`, which keeps a small kernel's
host cost near that of a PyTorch operator:
  * the arguments cross ctypes as one pointer: `launch()` packs them with
    one `struct.pack_into` into 8-byte slots of a buffer kept per entry,
    and calls the entry's `<entry>_packed` twin (`BUTD_PACKED` in
    csrc/common.cuh), which unpacks them into the typed C entry; the
    libraries are loaded as `ctypes.PyDLL`, so the GIL is held through the
    call and no other thread can refill the buffer meanwhile;
  * the stream is PyTorch's current stream of the tensors' device, read as
    a raw handle (`torch._C._cuda_getCurrentRawStream`, what Triton's
    launcher reads), so a launch inside `with torch.cuda.stream(s)` runs
    on `s`;
  * the device is an ordinal passed to the C entry, which makes it current
    only when it is not (`DeviceScope` in csrc/common.cuh): no
    `torch.cuda.device` context per call;
  * pointers are plain ints (`Tensor.data_ptr()`, 0 for none), never a
    ctypes object a call.
`_SIGNATURES` lists each typed entry's parameters (tests/test_torch_launch
holds them against the C sources); the packed layout follows from them.
Every C entry returns `cudaGetLastError()` after its launch; `launch()`
raises if it is not 0. `LAUNCHES` counts kernel launches per kernel;
`launch()` adds one right after the entry launched its kernel, and nothing
else does.
"""

import ctypes
import hashlib
import os
import shutil
import struct
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
# Every launch entry takes the device ordinal first and the stream last.
_SIGNATURES = {
    "fps": {
        "fps_launch": [_I, _VP, _I, _I, _I, _VP, _VP, _VP],
        "fps_max_resident_points": [],
        "fps_cluster_size": [_I],
        "fps_max_active_clusters": [_I, _I],
    },
    "ball_query": {
        "ball_query_launch": [_I, _VP, _VP, _I, _I, _I, _I, _F, _F, _I,
                              _VP, _VP, _VP, _VP],
    },
    "attention": {
        "attention_fwd_launch": [_I, *_STRIDED * 3, _VP, *_STRIDED,
                                 _I, _I, _I, _I, _I, _F, _I, *_DROPOUT, _VP],
        "attention_dropout_mask_launch": [_I, _VP, _I, _I, _I, _U, _ULL,
                                          _VP],
        "attention_fwd_smem_bytes": [_I],
    },
    "attention_bwd": {
        "attention_bwd_launch": [_I, *_STRIDED * 3, _VP, *_STRIDED * 4, _VP,
                                 _VP, _I, _I, _I, _I, _I, _F, _I, *_DROPOUT,
                                 _VP],
        "attention_bwd_smem_bytes": [_I],
    },
    "scatter": {
        "scatter_launch": [_I, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I,
                           _VP],
    },
    "gather": {
        "gather_launch": [_I, _VP, _VP, _I, _VP, _I, _I, _I, _I, _I, _VP],
    },
    "group_gather": {
        "group_gather_launch": [_I, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I,
                                _I, _I, _I, _I, _VP],
    },
}
# The struct format of one 8-byte slot of each parameter type.
_SLOT = {_VP: "Q", _I: "q", _U: "Q", _LL: "q", _ULL: "Q", _F: "f4x"}
# launch entry -> (kernel, packed C function, struct, buffer, its address)
_PACKED: Dict[str, tuple] = {}


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


def _load(name: str, path: Path) -> ctypes.PyDLL:
    lib = ctypes.PyDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def lib(name: str) -> ctypes.PyDLL:
    """The loaded library of kernel `name`, building all kernels first if
    this process has not loaded them yet."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def packer(entry: str) -> struct.Struct:
    """The packed layout of launch entry `entry`: one 8-byte slot a
    parameter, in `_SIGNATURES`' order."""
    kernel = _KERNEL_OF[entry]
    return struct.Struct(
        "<" + "".join(_SLOT[t] for t in _SIGNATURES[kernel][entry]))


def _packed(entry: str) -> tuple:
    kernel = _KERNEL_OF[entry]
    fn = getattr(lib(kernel), f"{entry}_packed")
    fn.argtypes = [_VP]
    fn.restype = ctypes.c_int
    layout = packer(entry)
    buf = ctypes.create_string_buffer(layout.size)
    _PACKED[entry] = (kernel, fn, layout, buf, ctypes.addressof(buf))
    return _PACKED[entry]


def launch(entry: str, device: int, *args, count: bool = True) -> None:
    """Call C entry `entry` with the device ordinal, `args` (ints, floats;
    pointers as ints, 0 for none) and the current stream of that device;
    count the launch of its kernel (unless `count` is False: the dropout
    mask writer) and raise on a CUDA error."""
    packed = _PACKED.get(entry)
    if packed is None:
        packed = _packed(entry)
    kernel, fn, layout, buf, address = packed
    layout.pack_into(buf, 0, device, *args,
                     torch._C._cuda_getCurrentRawStream(device))
    code = fn(address)
    if count:
        LAUNCHES[kernel] += 1
    if code:
        check(kernel, code)


_KERNEL_OF = {entry: kernel for kernel, entries in _SIGNATURES.items()
              for entry in entries}


def check(name: str, code: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if code != 0:
        msg = getattr(_LIBS[name], f"{name}_error_string")(code)
        raise RuntimeError(
            f"CUDA kernel '{name}' failed to launch: error {code} "
            f"({msg.decode() if msg else 'unknown'})"
        )


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(
            f"{what}: expected a CPU or CUDA tensor, got {t.device}"
        )

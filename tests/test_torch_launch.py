"""The port's launch path on the CPU: the ctypes signatures in
`ops/_cuda.py` against the C entries of `csrc/*.cu`, and the index
operand the row gathers hand their kernels.

A signature that disagrees with its C entry shows on the card only as a
crash or a wrong result, so the two are compared here, parameter by
parameter, from the sources.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from butd_detr_tpu_torch.ops import _cuda
from butd_detr_tpu_torch.ops.gather import _check, index_operand
from torch_threads import one_torch_thread  # noqa: F401

_C_TYPES = {
    "int": ctypes.c_int,
    "unsigned int": ctypes.c_uint,
    "long long": ctypes.c_longlong,
    "unsigned long long": ctypes.c_ulonglong,
    "float": ctypes.c_float,
}


def _c_entries(source: Path):
    """{entry: [ctypes type of each parameter]} of every `extern "C" int`
    function defined in `source`."""
    text = re.sub(r"//[^\n]*", "", source.read_text())
    entries = {}
    for name, params in re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)',
                                   text):
        kinds = []
        for param in filter(None, (p.strip() for p in params.split(","))):
            if "*" in param:
                kinds.append(ctypes.c_void_p)
                continue
            words = [w for w in param.split()[:-1] if w != "const"]
            kinds.append(_C_TYPES[" ".join(words)])
        entries[name] = kinds
    return entries


@pytest.mark.parametrize("kernel", sorted(_cuda.KERNELS))
def test_ctypes_signatures_match_the_c_entries(kernel):
    want = _c_entries(_cuda.CSRC / f"{kernel}.cu")
    got = _cuda._SIGNATURES[kernel]
    assert set(got) == set(want)
    for entry, params in want.items():
        assert got[entry] == params, entry
        assert _cuda._KERNEL_OF[entry] == kernel
        if entry.endswith("_launch"):  # device ordinal first, stream last
            assert params[0] is ctypes.c_int
            assert params[-1] is ctypes.c_void_p
            # launch() calls the packed twin: one 8-byte slot a parameter
            assert f"BUTD_PACKED({entry})" in (
                _cuda.CSRC / f"{kernel}.cu").read_text()
            assert _cuda.packer(entry).size == 8 * len(params)


def test_packed_slots_hold_each_parameter_type():
    """The slot layout the C side reads (csrc/common.cuh:PackedSlot): an
    integer or pointer as 8 little-endian bytes (an int's low 4 bytes are
    the int, negatives included), a float in the low 4 bytes."""
    layout = _cuda.packer("attention_bwd_launch")
    args = [3, 2 ** 40 + 16, -5, 7, 11] + [0] * (len(
        _cuda._SIGNATURES["attention_bwd"]["attention_bwd_launch"]) - 5)
    kinds = _cuda._SIGNATURES["attention_bwd"]["attention_bwd_launch"]
    fi = kinds.index(ctypes.c_float)
    args[fi] = 0.125
    blob = layout.pack(*args)
    slot = lambda i: blob[8 * i:8 * i + 8]
    assert int.from_bytes(slot(0)[:4], "little", signed=True) == 3
    assert int.from_bytes(slot(1), "little") == 2 ** 40 + 16
    assert int.from_bytes(slot(2), "little", signed=True) == -5
    assert ctypes.c_float.from_buffer_copy(slot(fi)[:4]).value == 0.125


def test_every_source_is_a_kernel_with_signatures():
    sources = {p.stem for p in _cuda.CSRC.glob("*.cu")}
    assert sources == set(_cuda.KERNELS) == set(_cuda._SIGNATURES)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_index_operand_passes_int32_and_int64_as_they_are(dtype):
    idx = torch.arange(12, dtype=dtype).reshape(3, 4)
    got, is64 = index_operand(idx, idx.get_device())
    assert got is idx
    assert is64 == (dtype == torch.int64)
    strided = idx.t()
    got, _ = index_operand(strided, idx.get_device())
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, strided)


@pytest.mark.parametrize("dtype", [torch.int16, torch.int8, torch.uint8])
def test_index_operand_casts_other_integer_types_to_int32(dtype):
    idx = torch.arange(12, dtype=dtype).reshape(3, 4)
    got, is64 = index_operand(idx, idx.get_device())
    assert got.dtype == torch.int32 and not is64
    assert torch.equal(got, idx.to(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bool])
def test_gathers_refuse_an_index_that_is_not_integer(dtype):
    src = torch.zeros(1, 5, 3)
    with pytest.raises(ValueError, match="integer"):
        _check(src, torch.zeros(1, 2, dtype=dtype), 2, "gather_rows")

"""The port's launch path on the CPU: the ctypes signatures in
`ops/_cuda.py` against the C entries of `csrc/*.cu`, the index operand
the row gathers hand their kernels, `launch`'s count and its wording of
an entry's refusal, and the assignment kernel's plan mirrored in Python.

A signature that disagrees with its C entry shows on the card only as a
crash or a wrong result, so the two are compared here, parameter by
parameter, from the sources.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from butd_detr_tpu_torch.ops import _cuda, assignment, gather
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


def _constant(source: Path, name: str) -> int:
    """The value of `constexpr ... name = <integer expression>;`."""
    m = re.search(rf"constexpr\s+[\w ]+\b{name}\s*=\s*([^;]+);",
                  source.read_text())
    assert m, name
    return int(eval(m.group(1), {}))  # products of integer literals


def test_assignment_plan_constants_are_the_kernels():
    source = _cuda.CSRC / "assignment.cu"
    assert _constant(source, "kWarps") == assignment.WARPS
    assert _constant(source, "kMaxSmem") == assignment.MAX_SMEM
    assert _constant(source, "kMaxColumns") == assignment.MAX_COLUMNS


@pytest.mark.parametrize("G,Q,rows,slice_bytes", [
    (132, 256, 52, 57616),  # the loss at every path of the butd_cls model
    (16, 32, 16, 2624),  # the probe's and the study's 32 queries
    (5, 1000, 5, 28832),  # 32 columns a lane: rows of 1,025 floats
    (300, 256, 50, 57552),  # more targets than queries: 256 rows
    (1024, 1024, 8, 57376),  # the widest matrix the kernel takes
])
def test_assignment_plan_sizes_the_warps_slices(G, Q, rows, slice_bytes):
    """csrc/assignment.cu:slice, worked by hand: a lane holds K = ceil(Q /
    32) columns up to a power of two, P = 32 K; a warp's state is path and
    row4col (P each) and u, col4row, the visited rows and their spc (min(G,
    Q) each), every part 16-byte aligned; R = (232448 / 4 - state - 16) //
    (4 (P + 1)) rows of costs, at most min(G, Q)."""
    plan = assignment.assignment_plan(G, Q)
    assert plan["rows_staged"] == rows and plan["slice_bytes"] == slice_bytes
    assert 4 * slice_bytes <= 232448


@pytest.mark.parametrize("M,warps", [(1, 1), (56, 1), (132, 1), (133, 2),
                                     (168, 2), (400, 4), (10000, 4)])
def test_assignment_plan_spreads_a_call_over_the_sms(M, warps):
    """As few matrices a block as spread M over 132 SMs, at most 4: B = 8's
    56 matrices one a block, B = 24's 168 two."""
    plan = assignment.assignment_plan(132, 256, M)
    assert plan["warps"] == warps
    assert plan["smem_bytes"] == warps * plan["slice_bytes"]


class _FakeEntry:
    """A packed C entry that returns `code` without touching a device."""

    def __init__(self, code):
        self.code, self.calls = code, 0

    def __call__(self, address):
        self.calls += 1
        return self.code


# entry -> (the wrapper's refusal message, a call's arguments, its words)
_REFUSALS = {
    "gather_launch": (gather._too_large, (16, 32, 0, 48, 70000, 9, 7, 12),
                      "gather_rows: batch 70000, source rows 9 or row "
                      "bytes 12 exceed"),
    "assignment_launch": (assignment._refused,
                          (16, 1, 1, 1, 32, 0, 48, 3, 2, 1025),
                          r"at most 1024 columns .* \(G, Q\) = \(2, 1025\): "
                          "12345 bytes a matrix"),
}


@pytest.mark.parametrize("entry", [None, "gather_launch",
                                   "assignment_launch"])
@pytest.mark.parametrize("code", [0, 1, 2, _cuda.REFUSED])
def test_launch_counts_launches_and_words_refusals(monkeypatch, code,
                                                   entry):
    """`launch` counts a launch only when the entry returned 0 and raises
    the CUDA error on any other code, cudaErrorInvalidValue (1) included;
    an entry's `REFUSED` (-1), its refusal of a size, raises the wrapper's
    ValueError made from the call's arguments where the wrapper passes
    `invalid=` (the row gather's and the assignment's), the CUDA error
    otherwise."""
    invalid, args, words = _REFUSALS[entry or "gather_launch"]
    name = entry or "gather_launch"
    kernel = _cuda._KERNEL_OF[name]
    fake = _FakeEntry(code)
    layout = _cuda.packer(name)
    buf = ctypes.create_string_buffer(layout.size)
    monkeypatch.setitem(_cuda._PACKED, name, (
        kernel, fake, layout, buf, ctypes.addressof(buf)))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 0, raising=False)
    monkeypatch.setitem(_cuda._LIBS, kernel, type("Lib", (), {
        f"{kernel}_error_string": staticmethod(lambda c: b"an error"),
        "assignment_slice_bytes": staticmethod(lambda g, q: 12345)}))
    monkeypatch.setitem(_cuda.LAUNCHES, kernel, 5)
    kwargs = {} if entry is None else {"invalid": invalid}
    if code == 0:
        _cuda.launch(name, 0, *args, **kwargs)
        assert _cuda.LAUNCHES[kernel] == 6
    elif code == _cuda.REFUSED and entry is not None:
        with pytest.raises(ValueError, match=words):
            _cuda.launch(name, 0, *args, **kwargs)
        assert _cuda.LAUNCHES[kernel] == 5
    else:
        with pytest.raises(RuntimeError, match="an error"):
            _cuda.launch(name, 0, *args, **kwargs)
        assert _cuda.LAUNCHES[kernel] == 5
    assert fake.calls == 1
    assert layout.unpack(buf.raw)[1:-1] == args


def test_assignment_refusal_names_the_columns_and_the_shared_bytes(
        monkeypatch):
    """The message reads a matrix's shared bytes from the kernel's own C
    entry, `assignment_slice_bytes`."""
    monkeypatch.setitem(_cuda._LIBS, "assignment", type("Lib", (), {
        "assignment_slice_bytes": staticmethod(lambda g, q: 4096 + q)}))
    msg = assignment._refused(0, 1, 1, 1, 0, 0, 0, 3, 2, 1025)
    assert "at most 1024 columns" in msg and "(2, 1025)" in msg
    assert "5121 bytes a matrix" in msg


def test_refused_is_the_c_entries_constant():
    """`launch` tells a refusal by csrc/common.cuh:kRefused, a value no
    CUDA error takes (they are all non-negative)."""
    assert _constant(_cuda.CSRC / "common.cuh", "kRefused") == _cuda.REFUSED
    assert _cuda.REFUSED < 0

"""Row gathers: the CUDA kernels (csrc/gather.cu, csrc/group_gather.cu)
and their plain PyTorch versions.

Counterparts of two TPU kernels:

* `butd_detr_tpu/ops/pallas_scatter.py:gather_rows_pallas`

      gather_rows(src, idx):   out[b, m, :] = src[b, idx[b, m], :]

* `butd_detr_tpu/ops/pallas_window_gather.py:_window_extract_pallas`
  (through `windowed_group_points`, and for two payloads under one index
  preparation `ops/pointcloud.py:_group_points_split_vjp`)

      group_rows(points, idx):          out[b, j, k, :] = points[b, idx[b, j, k], :]
      group_rows_split(xyz, feats, idx): the same for two payloads at once,
                                         each in its own dtype

  and, with the centre subtraction, radius scale, concatenation and cast
  that XLA fuses beside that call on the TPU, the set-abstraction MLP's
  bf16 input in one pass:

      group_rows_mlp_input(xyz, new_xyz, feats, idx, inv_r):
          out[b, j, k, :3] = bf16((xyz[b, i] - new_xyz[b, j]) * inv_r)
          out[b, j, k, 3:] = feats[b, i]                  (i = idx[b, j, k])

The copies are bit-exact: f32 and bf16 sources keep their dtype, any other
dtype is widened to f32 first (as the TPU wrapper does). An index outside
[0, N) gives a zero row. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises. Their gradient is the row
scatter-add (ops/scatter.py), wired in ops/pointcloud.py.
"""

from typing import Tuple

import torch

from butd_detr_tpu_torch.ops import _cuda

_MAX_GRID_Y = 65535  # the grouped copy kernel's batch limit


def _payload(t: torch.Tensor) -> torch.Tensor:
    """f32 and bf16 pass; everything else is widened to f32."""
    return t if t.dtype in (torch.float32, torch.bfloat16) else t.float()


def _check(src: torch.Tensor, idx: torch.Tensor, idx_dims: int,
           what: str) -> None:
    if src.dim() != 3 or idx.dim() != idx_dims or idx.shape[0] != src.shape[0]:
        raise ValueError(
            f"{what}: source {tuple(src.shape)} and index {tuple(idx.shape)} "
            f"do not form (B, N, C), (B, {'m, ns' if idx_dims == 3 else 'M'})")
    if idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise ValueError(f"{what}: the index must be an integer tensor, got "
                         f"{idx.dtype}")


# ------------------------------------------------------------ plain versions

def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M) int -> (B, M, C); rows of an index outside [0, N)
    are zero. The rows are gathered as integers of the element's width, so
    that no backend's floating-point path touches a NaN's bits."""
    src = _payload(src)
    N, C = src.shape[1:]
    if N == 0:
        return src.new_zeros(*idx.shape, C)
    bits = src.contiguous().view(
        torch.int32 if src.element_size() == 4 else torch.int16)
    j = idx.long()
    inside = (j >= 0) & (j < N)
    rows = torch.gather(bits, 1, j.clamp(0, N - 1)[..., None]
                        .expand(-1, -1, C))
    return torch.where(inside[..., None], rows,
                       torch.zeros_like(rows)).view(src.dtype)


def group_rows_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, m, ns) int -> (B, m, ns, C)."""
    B, m, ns = idx.shape
    return gather_rows_plain(points, idx.reshape(B, m * ns)).reshape(
        B, m, ns, -1)


def group_rows_split_plain(xyz: torch.Tensor, feats: torch.Tensor,
                           idx: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gather of the concatenation [xyz, feats] in xyz's dtype, the
    feature leg cast back: (B, m, ns, 3) and (B, m, ns, Cf). bf16 -> f32 ->
    bf16 returns every value's bits except a NaN's payload, which the cast
    back may replace by the canonical NaN."""
    xyz, feats = _payload(xyz), _payload(feats)
    c = xyz.shape[-1]
    g = group_rows_plain(torch.cat([xyz, feats.to(xyz.dtype)], dim=-1), idx)
    return g[..., :c], g[..., c:].to(feats.dtype)


_BF16_NAN = 0x7FC0  # c10's scalar rule (round_to_nearest_even) for a NaN


def bf16_rn(y: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 rounded to nearest even, every NaN to 0x7FC0 (c10's
    scalar `round_to_nearest_even`), whatever the device. `.to(bfloat16)`
    alone gives a NaN 0xFFFF in PyTorch's vectorized CPU cast and 0x7FFF
    on the card, so the NaN is pinned here to one value."""
    bits = y.to(torch.bfloat16).view(torch.int16)
    return torch.where(y.isnan(), _BF16_NAN, bits).view(torch.bfloat16)


def group_rows_mlp_input_plain(xyz: torch.Tensor, new_xyz: torch.Tensor,
                               feats: torch.Tensor, idx: torch.Tensor,
                               inv_r: float) -> torch.Tensor:
    """The eager chain the kernel replaces: gather, subtract the centre and
    multiply by `inv_r` in f32, round to bf16 (`bf16_rn`), and put the
    gathered bf16 features beside it, their bits copied. (B, N, 3),
    (B, m, 3), (B, N, C), (B, m, ns) -> (B, m, ns, 3 + C) bf16."""
    gx = group_rows_plain(xyz.float(), idx)
    gf = group_rows_plain(feats.to(torch.bfloat16), idx)
    y = (gx - new_xyz.float()[:, :, None, :]) * inv_r
    return torch.cat([bf16_rn(y), gf], dim=-1)


# ------------------------------------------------------------------- kernels

def copy_unit(row_bytes: int, *addresses: int) -> int:
    """The widest unit (16, 4 or 2 bytes) in which a kernel may copy rows
    of `row_bytes` bytes between buffers at `addresses`: it must divide the
    row and every address."""
    bits = row_bytes
    for a in addresses:
        bits |= a
    return 16 if bits % 16 == 0 else 4 if bits % 4 == 0 else 2


def _units(src: torch.Tensor, out: torch.Tensor) -> Tuple[int, int]:
    """(units a row, bytes a unit) for copying rows of `src` into `out`."""
    row_bytes = src.shape[-1] * src.element_size()
    unit = copy_unit(row_bytes, src.data_ptr(), out.data_ptr())
    return row_bytes // unit, unit


def index_operand(idx: torch.Tensor, device: int
                  ) -> Tuple[torch.Tensor, bool]:
    """(index, is int64) as the kernels read it: int32 and int64 pass in
    their own type (the kernels are instantiated for both, so no cast
    kernel runs), any other integer type is cast to int32; the result is
    contiguous and on CUDA device `device` (an index on the host is copied
    there: `three_nn`'s callers may hand one over)."""
    dtype = idx.dtype
    if dtype is not torch.int64 and dtype is not torch.int32:
        if dtype.is_floating_point or dtype is torch.bool:
            raise ValueError(f"the index must be an integer tensor, got "
                             f"{dtype}")
        idx = idx.to(torch.int32)
    if idx.get_device() != device:
        idx = idx.to(torch.device("cuda", device))
    if not idx.is_contiguous():
        idx = idx.contiguous()
    return idx, dtype is torch.int64


def _check_sizes(what: str, batch: int, n: int, threads: int) -> None:
    if batch > _MAX_GRID_Y or n >= 2 ** 31 or threads >= 2 ** 31:
        raise ValueError(
            f"{what}: batch {batch}, source rows {n} or copy units per "
            f"batch element {threads} exceed what the kernel indexes "
            f"(65535, 2^31, 2^31)")


def _too_large(src_ptr, idx_ptr, idx64, out_ptr, batch, n, m, row_bytes):
    """The message of the row gather's C entry refusing a call."""
    return (f"gather_rows: batch {batch}, source rows {n} or row bytes "
            f"{row_bytes} exceed what the kernel indexes (65535, 2^63, a "
            "row that fits a block's 227 KB of shared memory)")


_F32, _BF16, _I32, _I64 = torch.float32, torch.bfloat16, torch.int32, \
    torch.int64


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m] = src[b, idx[b, m]]: (B, N, C) f32 or bf16 (other dtypes
    widened to f32), (B, M) integer -> (B, M, C) in the source's dtype."""
    dev = src.get_device()  # -1 off the card
    if dev < 0 or not src.is_cuda:
        _check(src, idx, 2, "gather_rows")
        if src.device.type == "cpu":
            return gather_rows_plain(src, idx)
        _cuda.require_cuda(src, "gather_rows")
    # the common case costs a few attribute reads; _check words the error,
    # and the C entry makes the integer work (the copy granule, the tile,
    # the size limits)
    shape, ishape = src.shape, idx.shape
    if len(shape) != 3 or len(ishape) != 2 or ishape[0] != shape[0]:
        _check(src, idx, 2, "gather_rows")
    dtype = src.dtype
    if dtype is _F32:
        size = 4
    elif dtype is _BF16:
        size = 2
    else:
        src, dtype, size = src.float(), _F32, 4
    if not src.is_contiguous():
        src = src.contiguous()
    idx_dtype = idx.dtype
    if ((idx_dtype is _I64 or idx_dtype is _I32) and idx.get_device() == dev
            and idx.is_contiguous()):
        idx64 = idx_dtype is _I64  # as it is: the common case
    else:
        idx, idx64 = index_operand(idx, dev)
    B, N, C = shape
    M = ishape[1]
    out = torch.empty(B, M, C, dtype=dtype, device=src.device)
    if B and M and C:
        _cuda.launch("gather_launch", dev, src.data_ptr(), idx.data_ptr(),
                     idx64, out.data_ptr(), B, N, M, C * size,
                     invalid=_too_large)
    return out


def _group_launch(what, a, p, idx):
    """One launch of the grouped gather for payload `a` and, when `p` is
    not None, payload `p` under the same (B, m, ns) index."""
    B, N = a.shape[:2]
    _, m, ns = idx.shape
    dev = a.get_device()
    idx, idx64 = index_operand(idx, dev)
    out_a = torch.empty(B, m, ns, a.shape[-1], dtype=a.dtype, device=a.device)
    out_p = None if p is None else torch.empty(
        B, m, ns, p.shape[-1], dtype=p.dtype, device=a.device)
    units_a, unit_a = _units(a, out_a) if out_a.numel() else (0, 2)
    units_p, unit_p = (0, 2) if p is None or not out_p.numel() else \
        _units(p, out_p)
    if B * m * ns * (units_a + units_p) == 0:
        return out_a, out_p
    _check_sizes(what, B, N, m * ns * (units_a + units_p))
    _cuda.launch("group_gather_launch", dev, a.data_ptr(),
                 p.data_ptr() if units_p else 0, idx.data_ptr(), idx64,
                 out_a.data_ptr(), out_p.data_ptr() if units_p else 0,
                 B, N, m * ns, units_a, unit_a, units_p, unit_p)
    return out_a, out_p


def group_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, j, k] = points[b, idx[b, j, k]]: (B, N, C) f32 or bf16,
    (B, m, ns) integer -> (B, m, ns, C) in the source's dtype."""
    _check(points, idx, 3, "group_rows")
    if points.device.type == "cpu":
        return group_rows_plain(points, idx)
    _cuda.require_cuda(points, "group_rows")
    return _group_launch("group_rows", _payload(points).contiguous(), None,
                         idx)[0]


def group_rows_split(xyz: torch.Tensor, feats: torch.Tensor,
                     idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both payloads of a grouping from one read of the index:
    (B, N, 3) xyz, (B, N, Cf) features, (B, m, ns) integer ->
    (B, m, ns, 3) in xyz's dtype and (B, m, ns, Cf) in the features'."""
    _check(xyz, idx, 3, "group_rows_split")
    if feats.shape[:2] != xyz.shape[:2] or feats.dim() != 3:
        raise ValueError(f"group_rows_split: xyz {tuple(xyz.shape)} and "
                         f"features {tuple(feats.shape)} are not two "
                         "payloads of one point set")
    if xyz.device.type == "cpu":
        return group_rows_split_plain(xyz, feats, idx)
    _cuda.require_cuda(xyz, "group_rows_split")
    if feats.device != xyz.device:
        raise ValueError(f"group_rows_split: xyz on {xyz.device}, features "
                         f"on {feats.device}")
    return _group_launch("group_rows_split", _payload(xyz).contiguous(),
                         _payload(feats).contiguous(), idx)


def _check_mlp_input(xyz, new_xyz, feats, idx) -> None:
    _check(xyz, idx, 3, "group_rows_mlp_input")
    B, m, _ = idx.shape
    if (xyz.shape[-1] != 3 or tuple(new_xyz.shape) != (B, m, 3)
            or feats.dim() != 3 or feats.shape[:2] != xyz.shape[:2]
            or feats.shape[-1] < 1):
        raise ValueError(
            f"group_rows_mlp_input: xyz {tuple(xyz.shape)}, centres "
            f"{tuple(new_xyz.shape)}, features {tuple(feats.shape)} and "
            f"index {tuple(idx.shape)} do not form (B, N, 3), (B, m, 3), "
            "(B, N, C >= 1), (B, m, ns)")
    if new_xyz.device != xyz.device or feats.device != xyz.device:
        raise ValueError(f"group_rows_mlp_input: xyz on {xyz.device}, "
                         f"centres on {new_xyz.device}, features on "
                         f"{feats.device}")


def group_rows_mlp_input(xyz: torch.Tensor, new_xyz: torch.Tensor,
                         feats: torch.Tensor, idx: torch.Tensor,
                         inv_r: float) -> torch.Tensor:
    """A set-abstraction tier's MLP input in one pass: (B, N, 3) xyz (f32,
    any row stride), (B, m, 3) centres, (B, N, C) features (cast to bf16),
    (B, m, ns) integer index -> (B, m, ns, 3 + C) bf16 with
    out[..., :3] = bf16((xyz[b, i] - new_xyz[b, j]) * inv_r) and
    out[..., 3:] = feats[b, i]; bit-equal to
    `group_rows_mlp_input_plain`."""
    if not xyz.is_cuda:
        _check_mlp_input(xyz, new_xyz, feats, idx)
        if xyz.device.type == "cpu":
            return group_rows_mlp_input_plain(xyz, new_xyz, feats, idx,
                                              inv_r)
        _cuda.require_cuda(xyz, "group_rows_mlp_input")
    # the common case costs a few attribute reads; _check_mlp_input words
    # the error
    shape, cshape, fshape, ishape = xyz.shape, new_xyz.shape, feats.shape, \
        idx.shape
    if (len(shape) != 3 or len(ishape) != 3 or len(fshape) != 3
            or shape[2] != 3 or cshape != (ishape[0], ishape[1], 3)
            or fshape[:2] != shape[:2] or ishape[0] != shape[0]
            or fshape[2] < 1 or not new_xyz.is_cuda or not feats.is_cuda
            or idx.dtype.is_floating_point):
        _check_mlp_input(xyz, new_xyz, feats, idx)
    if xyz.dtype is not torch.float32:
        xyz = xyz.float()
    if xyz.stride(2) != 1:
        xyz = xyz.contiguous()
    if new_xyz.dtype is not torch.float32:
        new_xyz = new_xyz.float()
    if not new_xyz.is_contiguous():
        new_xyz = new_xyz.contiguous()
    if feats.dtype is not torch.bfloat16:
        feats = feats.to(torch.bfloat16)
    if not feats.is_contiguous():
        feats = feats.contiguous()
    B, m, ns = ishape
    N, C = fshape[1], fshape[2]
    dev = xyz.get_device()
    if feats.get_device() != dev or new_xyz.get_device() != dev:
        _check_mlp_input(xyz, new_xyz, feats, idx)
    idx_dtype = idx.dtype
    if ((idx_dtype is torch.int64 or idx_dtype is torch.int32)
            and idx.get_device() == dev and idx.is_contiguous()):
        idx64 = idx_dtype is torch.int64  # as it is: the common case
    else:
        idx, idx64 = index_operand(idx, dev)
    out = torch.empty(B, m, ns, 3 + C, dtype=torch.bfloat16,
                      device=xyz.device)
    if not (B and m and ns):
        return out
    if B * m * ns >= 2 ** 31 or N >= 2 ** 31:
        raise ValueError(f"group_rows_mlp_input: {B * m * ns} rows or "
                         f"{N} source rows exceed 2^31")
    _cuda.launch("group_mlp_input_launch", dev, xyz.data_ptr(),
                 xyz.stride(0), xyz.stride(1), new_xyz.data_ptr(),
                 feats.data_ptr(), idx.data_ptr(), idx64, out.data_ptr(),
                 B, N, m, ns, C, inv_r)
    return out

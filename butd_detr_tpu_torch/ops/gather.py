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

All are bit-exact copies of rows: f32 and bf16 sources keep their dtype,
any other dtype is widened to f32 first (as the TPU wrapper does). An index
outside [0, N) gives a zero row. A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises. Their gradient is the row
scatter-add (ops/scatter.py), wired in ops/pointcloud.py.
"""

from typing import Tuple

import torch

from butd_detr_tpu_torch.ops import _cuda

_MAX_GRID_Y = 65535


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
    there: `three_nn`'s callers or the matcher may hand one over)."""
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


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, m] = src[b, idx[b, m]]: (B, N, C) f32 or bf16 (other dtypes
    widened to f32), (B, M) integer -> (B, M, C) in the source's dtype."""
    if not src.is_cuda:
        _check(src, idx, 2, "gather_rows")
        if src.device.type == "cpu":
            return gather_rows_plain(src, idx)
        _cuda.require_cuda(src, "gather_rows")
    # the common case costs a few attribute reads; _check words the error
    shape, ishape = src.shape, idx.shape
    if len(shape) != 3 or len(ishape) != 2 or ishape[0] != shape[0]:
        _check(src, idx, 2, "gather_rows")
    dtype = src.dtype
    if dtype is not torch.float32 and dtype is not torch.bfloat16:
        src, dtype = src.float(), torch.float32
    if not src.is_contiguous():
        src = src.contiguous()
    dev = src.get_device()
    idx_dtype = idx.dtype
    if ((idx_dtype is torch.int64 or idx_dtype is torch.int32)
            and idx.get_device() == dev and idx.is_contiguous()):
        idx64 = idx_dtype is torch.int64  # as it is: the common case
    else:
        idx, idx64 = index_operand(idx, dev)
    B, N, C = shape
    M = ishape[1]
    out = torch.empty(B, M, C, dtype=dtype, device=src.device)
    if not (B and M and C):
        return out
    src_ptr, out_ptr = src.data_ptr(), out.data_ptr()
    row_bytes = C * src.element_size()
    unit = copy_unit(row_bytes, src_ptr, out_ptr)
    units = row_bytes // unit
    if B > _MAX_GRID_Y or N >= 2 ** 31 or M * units >= 2 ** 31:
        _check_sizes("gather_rows", B, N, M * units)
    _cuda.launch("gather_launch", dev, src_ptr, idx.data_ptr(), idx64,
                 out_ptr, B, N, M, units, unit)
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

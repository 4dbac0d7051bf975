"""Row scatter-add: the CUDA kernel (csrc/scatter.cu) and its plain
PyTorch version.

Counterpart of the TPU kernel `butd_detr_tpu/ops/pallas_scatter.py:
scatter_rows_add_pallas`:

    out[b, j, :] = sum over m with idx[b, m] == j of g[b, m, :]

accumulated and returned in f32; entries with idx >= n or idx < 0 are
dropped. It is the backward of the row gathers in `ops/pointcloud.py`.
Both versions add each output row's rows in ascending m: the plain
version's `index_add_` does so on the CPU, and the kernel sorts each
segment of its inverse map before it adds. So the kernel's sums are the
same from run to run and equal, bit for bit, to the plain version run on
the CPU (`index_add_` on the card adds with atomics, in no fixed order).
"""

import torch

from butd_detr_tpu_torch.ops import _cuda
from butd_detr_tpu_torch.ops.gather import index_operand


def scatter_rows_add_plain(g: torch.Tensor, idx: torch.Tensor,
                           n: int) -> torch.Tensor:
    """(B, M, C) rows, (B, M) int indices -> (B, n, C) float32."""
    B, M, C = g.shape
    # one spare row per batch element takes the dropped entries
    j = idx.long()
    j = torch.where((j < 0) | (j > n), n, j)
    rows = j + (n + 1) * torch.arange(B, device=g.device)[:, None]
    out = torch.zeros(B * (n + 1), C, dtype=torch.float32, device=g.device)
    out.index_add_(0, rows.reshape(-1), g.reshape(B * M, C).float())
    return out.view(B, n + 1, C)[:, :n]


def scatter_rows_add(g: torch.Tensor, idx: torch.Tensor,
                     n: int) -> torch.Tensor:
    """out[b, j] = sum of the rows g[b, m] with idx[b, m] == j, in f32.

    g: (B, M, C) float32 or bfloat16 (bf16 rows are widened on load);
    idx: (B, M) integer, entries >= n or < 0 ignored (int32 and int64 are
    read as they are). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (or raises)."""
    if g.dim() != 3 or idx.shape != g.shape[:2]:
        raise ValueError(f"g {tuple(g.shape)} and idx {tuple(idx.shape)} do "
                         "not form (B, M, C), (B, M)")
    if g.device.type == "cpu":
        return scatter_rows_add_plain(g, idx, n)
    _cuda.require_cuda(g, "scatter_rows_add")
    B, M, C = g.shape
    if g.dtype not in (torch.float32, torch.bfloat16):
        g = g.float()
    if not g.is_contiguous() or g.data_ptr() % 16:
        g = g.contiguous() if not g.is_contiguous() else g.clone()
    dev = g.get_device()
    idx_dtype = idx.dtype
    if ((idx_dtype is torch.int64 or idx_dtype is torch.int32)
            and idx.get_device() == dev and idx.is_contiguous()):
        idx64 = idx_dtype is torch.int64  # as it is: the common case
    else:
        idx, idx64 = index_operand(idx, dev)
    if B * M >= 2 ** 31 or B * n >= 2 ** 31:
        raise ValueError(f"scatter_rows_add: {B} x {M} rows or {B} x {n} "
                         "output rows exceed what the kernel indexes")
    out = torch.empty(B, n, C, dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    # segment ends and the CSR (csrc/scatter.cu)
    scratch = torch.empty(B * (n + M), dtype=torch.int32, device=g.device)
    _cuda.launch("scatter_launch", dev, g.data_ptr(), idx.data_ptr(),
                 idx64, scratch.data_ptr(), out.data_ptr(), B, M, C, n,
                 int(g.dtype == torch.bfloat16))
    return out

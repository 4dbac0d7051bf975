"""Row scatter-add: the CUDA kernel (csrc/scatter.cu) and its plain
PyTorch version.

Counterpart of the TPU kernel `butd_detr_tpu/ops/pallas_scatter.py:
scatter_rows_add_pallas`:

    out[b, j, :] = sum over m with idx[b, m] == j of g[b, m, :]

accumulated and returned in f32; entries with idx >= n are dropped. It is
the backward of the row gathers in `ops/pointcloud.py`. The kernel adds
with atomics, whose order is not fixed: two runs may differ in the last
bits of an f32 sum (the plain version's `index_add_` on the card has the
same property; on the CPU it is sequential).
"""

import torch

from butd_detr_tpu_torch.ops import _cuda


def scatter_rows_add_plain(g: torch.Tensor, idx: torch.Tensor,
                           n: int) -> torch.Tensor:
    """(B, M, C) rows, (B, M) int indices -> (B, n, C) float32."""
    B, M, C = g.shape
    # one spare row per batch element takes the dropped entries
    rows = idx.long().clamp(max=n) + (n + 1) * torch.arange(
        B, device=g.device)[:, None]
    out = torch.zeros(B * (n + 1), C, dtype=torch.float32, device=g.device)
    out.index_add_(0, rows.reshape(-1), g.reshape(B * M, C).float())
    return out.view(B, n + 1, C)[:, :n]


def scatter_rows_add(g: torch.Tensor, idx: torch.Tensor,
                     n: int) -> torch.Tensor:
    """out[b, j] = sum of the rows g[b, m] with idx[b, m] == j, in f32.

    g: (B, M, C) float32 or bfloat16 (bf16 rows are widened on load);
    idx: (B, M) integer, entries >= n ignored. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    if g.dim() != 3 or idx.shape != g.shape[:2]:
        raise ValueError(f"g {tuple(g.shape)} and idx {tuple(idx.shape)} do "
                         "not form (B, M, C), (B, M)")
    if g.device.type == "cpu":
        return scatter_rows_add_plain(g, idx, n)
    _cuda.require_cuda(g, "scatter_rows_add")
    B, M, C = g.shape
    if g.dtype not in (torch.float32, torch.bfloat16):
        g = g.float()
    g = g.contiguous()
    idx = idx.to(device=g.device, dtype=torch.int32).contiguous()
    out = torch.zeros(B, n, C, dtype=torch.float32, device=g.device)
    if g.numel() == 0:
        return out
    _cuda.launch("scatter_launch", g.get_device(), g.data_ptr(),
                 idx.data_ptr(), out.data_ptr(), B, M, C, n,
                 int(g.dtype == torch.bfloat16))
    return out

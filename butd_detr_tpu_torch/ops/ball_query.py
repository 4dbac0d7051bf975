"""Ball query: the CUDA kernels (csrc/ball_query.cu) and their plain
PyTorch version.

Counterpart of `butd_detr_tpu/ops/pointcloud.py:_ball_query_scan` and of
the TPU kernel `ops/pallas_ball_query.py:ball_query_select_pallas`: for
each center, the first `nsample` candidates in index order with
d^2 < r^2; a short row is padded with its first hit; a row with no hit is
all 0. `r2` is the float32 of the double `radius * radius`.

A CUDA call takes one of two kernels by shape (`ball_query_path`), as the
JAX package does (`ops/pointcloud.py:752-754`): the hashed grid for large
clouds (sa1), the index-order scan for the rest. Both give the same bits.
"""

from typing import Tuple

import numpy as np
import torch

from butd_detr_tpu_torch.ops import _cuda


def _r2(radius: float) -> float:
    # the value the reference compares against: f32(double r * r)
    return float(np.float32(float(radius) * float(radius)))


def ball_query_plain(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, m, 3) -> (B, m, nsample) int32, centers in chunks so
    the (chunk, N) distance block stays small."""
    xyz = xyz.float()
    new_xyz = new_xyz.float()
    B, N, _ = xyz.shape
    m = new_xyz.shape[1]
    r2 = _r2(radius)
    k = min(nsample, N)
    keys = torch.arange(N, device=xyz.device)
    chunk = max(1, (1 << 22) // max(1, B * N))
    out = torch.zeros(B, m, nsample, dtype=torch.int32, device=xyz.device)
    for c0 in range(0, m, chunk):
        cen = new_xyz[:, c0:c0 + chunk]
        dx = cen[:, :, None, 0] - xyz[:, None, :, 0]
        dy = cen[:, :, None, 1] - xyz[:, None, :, 1]
        dz = cen[:, :, None, 2] - xyz[:, None, :, 2]
        d2 = (dx * dx + dy * dy) + dz * dz  # the reference's order
        hit = d2 < r2
        # the k smallest hit indices, ascending; misses sort after all hits
        first_k = torch.topk(torch.where(hit, keys, N), k, dim=-1,
                             largest=False, sorted=True).values
        nfound = hit.sum(-1, keepdim=True).clamp(max=nsample)
        if k < nsample:
            first_k = torch.cat(
                [first_k, first_k.new_full((*first_k.shape[:2],
                                            nsample - k), N)], -1)
        slot = torch.arange(nsample, device=xyz.device)
        first = torch.where(nfound > 0, first_k[..., :1],
                            torch.zeros_like(first_k[..., :1]))
        out[:, c0:c0 + chunk] = torch.where(
            slot < nfound, first_k, first).to(torch.int32)
    return out


# The JAX package's shape split for its pruned kernel
# (ops/pointcloud.py:752-754), and the hits a warp of the grid kernel holds
GRID_MIN_POINTS = 16384
GRID_MIN_CENTERS = 64
GRID_MAX_NSAMPLE = 512  # csrc/ball_query.cu: kCap


def ball_query_path(radius: float, nsample: int, n: int, m: int) -> str:
    """The kernel a CUDA call runs: "grid" (the hashed grid,
    csrc/ball_query.cu ball_query_grid_*_kernel) for N >= 16384 points and
    m >= 64 centers, else "scan" (the index-order warp scan)."""
    if (n >= GRID_MIN_POINTS and m >= GRID_MIN_CENTERS
            and nsample <= GRID_MAX_NSAMPLE and 0.0 < radius < float("inf")):
        return "grid"
    return "scan"


def grid_table_bits(n: int) -> int:
    """log2 of the grid's hash-table slots a cloud: a power of two >= 2N
    (and >= 2^15, so that each thread of its 32 scan tiles takes a
    multiple of 4 slots)."""
    return max(15, (2 * n - 1).bit_length())


def grid_scratch_bytes(batch: int, n: int) -> int:
    """The grid kernel's scratch: sorted float4 points, slot counts and
    ends, 32 tile totals, per cloud; fixed by (B, N, T)."""
    return batch * (16 * n + 8 * (1 << grid_table_bits(n)) + 4 * 32)


def _inv_edge(radius: float) -> float:
    # cells a little larger than r, so that rounding cannot put a hit two
    # cells away (csrc/ball_query.cu)
    return float(np.float32(1.0 / (float(radius) * (1.0 + 2.0 ** -10))))


def _launch(radius: float, nsample: int, xyz: torch.Tensor,
            new_xyz: torch.Tensor, stats: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, str]:
    _cuda.require_cuda(xyz, "ball_query")
    if new_xyz.device != xyz.device:
        raise ValueError("xyz and new_xyz must be on the same device")
    if xyz.dim() != 3 or new_xyz.dim() != 3 or xyz.shape[0] != \
            new_xyz.shape[0] or xyz.shape[-1] != 3 or new_xyz.shape[-1] != 3:
        raise ValueError(
            f"expected (B, N, 3) and (B, m, 3), got {tuple(xyz.shape)} and "
            f"{tuple(new_xyz.shape)}")
    xyz = xyz.float().contiguous()
    new_xyz = new_xyz.float().contiguous()
    B, N, _ = xyz.shape
    m = new_xyz.shape[1]
    out = torch.empty(B, m, nsample, dtype=torch.int32, device=xyz.device)
    counts = torch.empty(B, m, 2, dtype=torch.int32, device=xyz.device) \
        if stats else None
    path = ball_query_path(radius, nsample, N, m)
    scratch = torch.empty(grid_scratch_bytes(B, N), dtype=torch.uint8,
                          device=xyz.device) if path == "grid" else None
    _cuda.launch("ball_query_launch", xyz.get_device(), xyz.data_ptr(),
                 new_xyz.data_ptr(), B, N, m, nsample, _r2(radius),
                 _inv_edge(radius) if scratch is not None else 0.0,
                 grid_table_bits(N), 0 if scratch is None
                 else scratch.data_ptr(), 0 if counts is None
                 else counts.data_ptr(), out.data_ptr())
    return out, counts, path


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """Fixed-radius neighbour search with first-k-in-index-order
    semantics: (B, N, 3), (B, m, 3) -> (B, m, nsample) int32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    if xyz.device.type == "cpu":
        return ball_query_plain(radius, nsample, xyz, new_xyz)
    return _launch(radius, nsample, xyz, new_xyz, stats=False)[0]


def ball_query_stats(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, str]:
    """The CUDA call of `ball_query` with what it did, for the smoke
    report and the card tests: (indices, (B, m, 2) int32 counts of the
    candidates each center tested and whether it took the grid kernel's
    exactness guard, the path "grid" or "scan")."""
    return _launch(radius, nsample, xyz, new_xyz, stats=True)

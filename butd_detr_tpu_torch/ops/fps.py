"""Furthest-point sampling: the CUDA kernel (csrc/fps.cu) and its plain
PyTorch version.

Counterpart of `butd_detr_tpu/ops/pointcloud.py:furthest_point_sample_xla`
and of the TPU kernel `ops/pallas_fps.py:furthest_point_sample_pallas`,
with the reference's quirks: index 0 first, running distance from 1e10,
|p|^2 <= 1e-3 never chosen, distance (dx^2 + dy^2) + dz^2, ties to the
lower index.
"""

import torch

from butd_detr_tpu_torch.ops import _cuda


def _sqnorm3(dx, dy, dz):
    # separate, rounded products and sums in the reference's order
    return (dx * dx + dy * dy) + dz * dz


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int
                                ) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32, one tensor step per selection."""
    xyz = xyz.float()
    B, N, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    valid = _sqnorm3(x, y, z) > 1e-3
    # invalid points score -1 forever: min(-1, d >= 0) == -1, so they win
    # only when no point is valid (then argmax's first index, 0)
    temp = torch.where(valid, torch.full_like(x, 1e10),
                       torch.full_like(x, -1.0))
    out = torch.zeros(B, npoint, dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    old = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        c = xyz[rows, old]  # (B, 3)
        d = _sqnorm3(x - c[:, 0:1], y - c[:, 1:2], z - c[:, 2:3])
        temp = torch.minimum(temp, d)
        old = torch.argmax(temp, dim=1)  # first maximal index
        out[:, j] = old.to(torch.int32)
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative furthest-point sampling: (B, N, 3) -> (B, npoint) int32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    _cuda.require_cuda(xyz, "furthest_point_sample")
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    if npoint < 1:
        raise ValueError(f"npoint must be >= 1, got {npoint}")
    xyz = xyz.float().contiguous()
    B, N, _ = xyz.shape
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    # coordinates and running distances stay on chip (one block, or a
    # cluster of blocks) up to fps_max_resident_points; beyond, the
    # distances live in this scratch row
    scratch = None
    if N > _cuda.lib("fps").fps_max_resident_points():
        scratch = torch.empty(B, N, dtype=torch.float32, device=xyz.device)
    _cuda.launch("fps_launch", xyz.get_device(), xyz.data_ptr(), B, N,
                 npoint, out.data_ptr(),
                 0 if scratch is None else scratch.data_ptr())
    return out

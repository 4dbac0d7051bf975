"""Point-cloud ops in plain PyTorch (forward only), channels-last.

Counterparts of `butd_detr_tpu/ops/pointcloud.py`, with the reference's
quirks (pointnet2 `_ext_src`). FPS and ball query dispatch to the CUDA
kernels for CUDA tensors (ops/fps.py, ops/ball_query.py); the gathers are
plain indexing. The scatter-add backward of the gathers comes with the
training slice.
"""

import torch

from butd_detr_tpu_torch.ops.ball_query import ball_query
from butd_detr_tpu_torch.ops.fps import furthest_point_sample

__all__ = [
    "ball_query",
    "furthest_point_sample",
    "gather_points",
    "group_points",
    "group_points_split",
    "three_interpolate",
    "three_nn",
]


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, j] = points[b, idx[b, j]]: (B, N, C), (B, M) -> (B, M, C)."""
    C = points.shape[-1]
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, C))


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, j, k] = points[b, idx[b, j, k]]: (B, N, C), (B, m, ns) ->
    (B, m, ns, C)."""
    B, m, ns = idx.shape
    return gather_points(points, idx.reshape(B, m * ns)).reshape(
        B, m, ns, -1)


def group_points_split(xyz: torch.Tensor, feats: torch.Tensor,
                       idx: torch.Tensor):
    """Group xyz (kept in its own dtype, f32) and features (e.g. bf16)
    with one shared index: ONE gather of the concatenation, the features
    leg cast back — the JAX package's default path
    (pointcloud.py:871-878)."""
    cat = torch.cat([xyz, feats.to(xyz.dtype)], dim=-1)
    g = group_points(cat, idx)
    return g[..., :3], g[..., 3:].to(feats.dtype)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """Three nearest known points of each unknown point: (B, n, 3),
    (B, m, 3) -> (l2 distances (B, n, 3) f32, indices (B, n, 3) int32).
    Distances are NOT squared; ties go to the lower index (stable sort)."""
    u = unknown.float()
    k = known.float()
    dx = u[:, :, None, 0] - k[:, None, :, 0]
    dy = u[:, :, None, 1] - k[:, None, :, 1]
    dz = u[:, :, None, 2] - k[:, None, :, 2]
    d2 = (dx * dx + dy * dy) + dz * dz  # (B, n, m)
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    dist = torch.sqrt(torch.clamp_min(vals[..., :3], 0.0))
    return dist, idx[..., :3].to(torch.int32)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """out[b, j] = sum_t weight[b, j, t] * features[b, idx[b, j, t]]:
    (B, m, C), (B, n, 3), (B, n, 3) -> (B, n, C) in features' dtype."""
    g = group_points(features, idx)  # (B, n, 3, C)
    return torch.einsum("bnt,bntc->bnc", weight.to(g.dtype), g)

"""Point-cloud ops, channels-last.

Counterparts of `butd_detr_tpu/ops/pointcloud.py`, with the reference's
quirks (pointnet2 `_ext_src`). For CUDA tensors every op that the JAX
package gave a TPU kernel launches its CUDA kernel: FPS and ball query
(ops/fps.py, ops/ball_query.py), the row gathers forward (ops/gather.py:
`gather_points`, `group_points` and so `three_interpolate` through the row
gather kernel, `group_points_split` and the large `group_points` through
the grouped gather kernel) and the row scatter-add as their backward
(ops/scatter.py), accumulated in f32 and cast back to the cotangent's
dtype, as the JAX package's custom VJPs do (pointcloud.py:142-151, 837-848,
885-897). CPU tensors take the plain versions. Indices get no gradient.
"""

import torch

from butd_detr_tpu_torch.ops.ball_query import ball_query
from butd_detr_tpu_torch.ops.fps import furthest_point_sample
from butd_detr_tpu_torch.ops.gather import (
    gather_rows,
    group_rows,
    group_rows_split,
)
from butd_detr_tpu_torch.ops.scatter import scatter_rows_add

__all__ = [
    "ball_query",
    "furthest_point_sample",
    "gather_points",
    "group_points",
    "group_points_split",
    "three_interpolate",
    "three_nn",
]


def _scatter_back(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Gradient of a row gather: (B, ..., C) cotangent rows added into the
    (B, n, C) source, in the cotangent's dtype."""
    B, C = g.shape[0], g.shape[-1]
    return scatter_rows_add(g.reshape(B, -1, C), idx.reshape(B, -1),
                            n).to(g.dtype)


def _is_large_grouping(n: int, m: int, ns: int) -> bool:
    """The groupings the JAX package hands to its windowed gather
    (pointcloud.py:804-811): the first set-abstraction tier."""
    return n >= 16384 and m >= 512 and ns >= 32


class _GatherRows(torch.autograd.Function):
    """out[b, ...] = points[b, idx[b, ...]] for (B, N, C) and a (B, M) or
    (B, m, ns) index, in the source's dtype."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        B, n, C = points.shape
        ctx.n = n
        if idx.dim() == 3 and _is_large_grouping(n, *idx.shape[1:]):
            out = group_rows(points, idx)
        else:
            out = gather_rows(points, idx.reshape(B, -1)).reshape(
                *idx.shape, C)
        return out.to(points.dtype)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _scatter_back(g, idx, ctx.n), None


class _GroupSplit(torch.autograd.Function):
    """xyz and features grouped by a shared (B, m, ns) index, each in its
    own dtype; each source gets its own scatter-add, and only if it needs
    a gradient."""

    @staticmethod
    def forward(ctx, xyz, feats, idx):
        ctx.save_for_backward(idx)
        ctx.n = xyz.shape[1]
        gx, gf = group_rows_split(xyz, feats, idx)
        return gx.to(xyz.dtype), gf.to(feats.dtype)

    @staticmethod
    def backward(ctx, gx, gf):
        (idx,) = ctx.saved_tensors
        grad_x = grad_f = None
        if ctx.needs_input_grad[0]:
            grad_x = _scatter_back(gx, idx, ctx.n)
        if ctx.needs_input_grad[1]:
            grad_f = _scatter_back(gf, idx, ctx.n)
        return grad_x, grad_f, None


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, j] = points[b, idx[b, j]]: (B, N, C), (B, M) -> (B, M, C)."""
    return _GatherRows.apply(points, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, j, k] = points[b, idx[b, j, k]]: (B, N, C), (B, m, ns) ->
    (B, m, ns, C)."""
    return _GatherRows.apply(points, idx)


def group_points_split(xyz: torch.Tensor, feats: torch.Tensor,
                       idx: torch.Tensor):
    """Group xyz (kept in its own dtype, f32) and features (e.g. bf16)
    with one shared index, read once for both:
    (B, N, 3), (B, N, Cf), (B, m, ns) -> (B, m, ns, 3), (B, m, ns, Cf)."""
    return _GroupSplit.apply(xyz, feats, idx)


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
    (B, m, C), (B, n, 3), (B, n, 3) -> (B, n, C) in features' dtype. The
    feature gradient is the row scatter-add; the weight gradient is
    autograd's."""
    g = group_points(features, idx)  # (B, n, 3, C)
    return torch.einsum("bnt,bntc->bnc", weight.to(g.dtype), g)

"""PointNet++ set abstraction and feature propagation, channels-last.

Counterpart of `butd_detr_tpu/nn/pointnet2.py` (reference
pointnet2_modules.py PointnetSAModuleVotes and PointnetFPModule): FPS ->
ball query -> group -> shared MLP -> max pool, and 3-NN inverse-distance
interpolation + skip + MLP. FPS and ball query run as CUDA kernels for
CUDA tensors.
"""

from typing import Sequence

import torch
from torch import nn

from butd_detr_tpu_torch.nn.mlp import SharedMLP
from butd_detr_tpu_torch.ops import (
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
    group_points_split,
    three_interpolate,
    three_nn,
)


class QueryAndGroup(nn.Module):
    """Ball-query grouping with center subtraction and optional radius
    normalization; returns ((B, npoint, nsample, 3 [+C]), grouped_xyz).

    `dtype` is the consuming MLP's compute dtype: with bf16 the feature
    leg is gathered in bf16 (the MLP casts to bf16 anyway, so the result is
    the same) while xyz stays f32 for the center subtraction."""

    def __init__(self, radius: float, nsample: int, use_xyz: bool = True,
                 normalize_xyz: bool = False, dtype=torch.float32):
        super().__init__()
        self.radius = radius
        self.nsample = nsample
        self.use_xyz = use_xyz
        self.normalize_xyz = normalize_xyz
        self.dtype = dtype

    def forward(self, xyz, new_xyz, features=None):
        idx = ball_query(self.radius, self.nsample, xyz, new_xyz)
        if features is None:
            if not self.use_xyz:
                raise ValueError("need features or use_xyz")
            grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
            if self.normalize_xyz:
                grouped_xyz = grouped_xyz / self.radius
            return grouped_xyz, grouped_xyz
        if self.dtype == torch.bfloat16:
            gx, grouped_features = group_points_split(
                xyz, features.to(torch.bfloat16), idx)
        else:
            grouped = group_points(torch.cat([xyz, features], dim=-1), idx)
            gx, grouped_features = grouped[..., :3], grouped[..., 3:]
        grouped_xyz = gx - new_xyz[:, :, None, :]
        if self.normalize_xyz:
            grouped_xyz = grouped_xyz / self.radius
        if self.use_xyz:
            # mixed dtypes promote to f32, as jnp.concatenate does
            return torch.cat([grouped_xyz, grouped_features], dim=-1), \
                grouped_xyz
        return grouped_features, grouped_xyz


class PointnetSAModuleVotes(nn.Module):
    """Single-scale set abstraction with max pooling. `mlp` lists the
    hidden and output channels; the input is `in_channels` features (+3
    with use_xyz)."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channels: int, mlp: Sequence[int], use_xyz: bool = True,
                 normalize_xyz: bool = False, dtype=torch.float32):
        super().__init__()
        self.npoint = npoint
        self.grouper = QueryAndGroup(radius, nsample, use_xyz=use_xyz,
                                     normalize_xyz=normalize_xyz,
                                     dtype=dtype)
        cin = in_channels + (3 if use_xyz else 0)
        self.mlp_module = SharedMLP([cin, *mlp], dtype=dtype)

    def forward(self, xyz, features=None):
        """(B, N, 3), (B, N, C) or None -> new_xyz (B, npoint, 3),
        new_features (B, npoint, mlp[-1]), inds (B, npoint) int32."""
        inds = furthest_point_sample(xyz, self.npoint)
        new_xyz = gather_points(xyz.float(), inds)
        grouped, _ = self.grouper(xyz, new_xyz, features)
        new_features = self.mlp_module(grouped).amax(dim=2)
        return new_xyz, new_features, inds


class PointnetFPModule(nn.Module):
    """Feature propagation: weights 1/(d + 1e-8) normalized over the 3
    nearest known points; channels [interpolated, skip]."""

    def __init__(self, mlp: Sequence[int], dtype=torch.float32):
        super().__init__()
        self.mlp = SharedMLP(mlp, dtype=dtype)

    def forward(self, unknown, known, unknown_feats, known_feats):
        dist, idx = three_nn(unknown, known)
        dist_recip = 1.0 / (dist + 1e-8)
        weight = dist_recip / dist_recip.sum(dim=-1, keepdim=True)
        interpolated = three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            new_features = torch.cat([interpolated, unknown_feats], dim=-1)
        else:
            new_features = interpolated
        return self.mlp(new_features)

"""PointNet++ set abstraction and feature propagation, channels-last.

Counterpart of `butd_detr_tpu/nn/pointnet2.py` (reference
pointnet2_modules.py): FPS -> ball query -> group -> shared MLP -> pool
(`PointnetSAModuleVotes`, with max, avg or rbf pooling), its multi-scale
form (`PointnetSAModuleMSG`, `PointnetSAModule`; `GroupAll` when there is
no npoint), 3-NN inverse-distance interpolation + skip + MLP
(`PointnetFPModule`) and the learnable multi-scale propagation
(`PointnetLFPModuleMSG`). FPS, the ball query and the gathers run as
CUDA kernels for CUDA tensors.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from butd_detr_tpu_torch.nn.mlp import SharedMLP
from butd_detr_tpu_torch.ops import (
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
    group_points_mlp_input,
    group_points_split,
    three_interpolate,
    three_nn,
)
from butd_detr_tpu_torch.utils.numerics import reciprocal_f32


class QueryAndGroup(nn.Module):
    """Ball-query grouping with center subtraction and optional radius
    normalization; returns ((B, npoint, nsample, 3 [+C]), grouped_xyz).

    Normalization multiplies by `inv_r`, the f32 reciprocal of the radius:
    the JAX package divides by the radius under `jax.jit`, which XLA
    compiles to this multiply.

    `dtype` is the consuming MLP's compute dtype. With bf16 and `use_xyz`
    one op (`group_points_mlp_input`, one kernel launch on the card)
    gathers, centers, scales and casts the rows into the MLP's bf16 input
    (B, npoint, nsample, 3 + C), and grouped_xyz is its xyz channels, in
    bf16. Otherwise the result is f32, as the JAX module's concatenation
    promotes it."""

    def __init__(self, radius: float, nsample: int, use_xyz: bool = True,
                 normalize_xyz: bool = False, dtype=torch.float32):
        super().__init__()
        self.radius = radius
        self.inv_r = reciprocal_f32(radius)
        self.nsample = nsample
        self.use_xyz = use_xyz
        self.normalize_xyz = normalize_xyz
        self.dtype = dtype

    def _center(self, gx, new_xyz):
        grouped_xyz = gx - new_xyz[:, :, None, :]
        if self.normalize_xyz:
            grouped_xyz = grouped_xyz * self.inv_r
        return grouped_xyz

    def forward(self, xyz, new_xyz, features=None):
        idx = ball_query(self.radius, self.nsample, xyz, new_xyz)
        if features is None:
            if not self.use_xyz:
                raise ValueError("need features or use_xyz")
            grouped_xyz = self._center(group_points(xyz, idx), new_xyz)
            return grouped_xyz, grouped_xyz
        if self.dtype == torch.bfloat16:
            if self.use_xyz:
                grouped = group_points_mlp_input(
                    xyz, new_xyz, features, idx,
                    self.inv_r if self.normalize_xyz else 1.0)
                return grouped, grouped[..., :3]
            gx, grouped_features = group_points_split(
                xyz, features.to(torch.bfloat16), idx)
        else:
            grouped = group_points(torch.cat([xyz, features], dim=-1), idx)
            gx, grouped_features = grouped[..., :3], grouped[..., 3:]
        grouped_xyz = self._center(gx, new_xyz)
        if self.use_xyz:
            # mixed dtypes promote to f32, as jnp.concatenate does
            return torch.cat([grouped_xyz, grouped_features], dim=-1), \
                grouped_xyz
        return grouped_features, grouped_xyz


class PointnetSAModuleVotes(nn.Module):
    """Single-scale set abstraction. `mlp` lists the hidden and output
    channels; the input is `in_channels` features (+3 with use_xyz).
    `pooling` over each ball: max, avg, or rbf (the MLP outputs weighted by
    exp(-|x - c|^2 / (2 sigma^2)), summed and divided by nsample; sigma
    defaults to radius / 2)."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channels: int, mlp: Sequence[int], use_xyz: bool = True,
                 normalize_xyz: bool = False, pooling: str = "max",
                 sigma: Optional[float] = None, dtype=torch.float32):
        super().__init__()
        if pooling not in ("max", "avg", "rbf"):
            raise ValueError(f"unknown pooling {pooling}")
        self.npoint = npoint
        self.nsample = nsample
        self.pooling = pooling
        self.sigma = radius / 2 if sigma is None else sigma
        self.grouper = QueryAndGroup(radius, nsample, use_xyz=use_xyz,
                                     normalize_xyz=normalize_xyz,
                                     dtype=dtype)
        cin = in_channels + (3 if use_xyz else 0)
        self.mlp_module = SharedMLP([cin, *mlp], dtype=dtype)

    def forward(self, xyz, features=None, inds=None):
        """(B, N, 3), (B, N, C) or None, (B, npoint) or None -> new_xyz
        (B, npoint, 3), new_features (B, npoint, mlp[-1]), inds (B,
        npoint) int32: FPS's unless `inds` is given."""
        if inds is None:
            inds = furthest_point_sample(xyz, self.npoint)
        new_xyz = gather_points(xyz.float(), inds)
        grouped, grouped_xyz = self.grouper(xyz, new_xyz, features)
        new_features = self.mlp_module(grouped)
        if self.pooling == "max":
            return new_xyz, new_features.amax(dim=2), inds
        if self.pooling == "avg":
            return new_xyz, new_features.mean(dim=2), inds
        # the JAX module divides by constants under jax.jit: XLA multiplies
        # by their f32 reciprocals
        rbf = torch.exp(-(grouped_xyz.float() ** 2).sum(-1)
                        * reciprocal_f32(self.sigma ** 2) * 0.5)
        pooled = (new_features * rbf[..., None]).sum(dim=2)
        return new_xyz, pooled * reciprocal_f32(self.nsample), inds


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


class GroupAll(nn.Module):
    """Every point in one ball (reference pointnet2_utils.GroupAll):
    (B, N, 3), (B, N, C) -> ((B, 1, N, 3 [+C]), grouped_xyz (B, 1, N, 3)),
    the coordinates not centred."""

    def __init__(self, use_xyz: bool = True):
        super().__init__()
        self.use_xyz = use_xyz

    def forward(self, xyz, new_xyz=None, features=None):
        grouped_xyz = xyz[:, None]
        if features is None:
            return grouped_xyz, grouped_xyz
        grouped = features[:, None]
        if self.use_xyz:
            grouped = torch.cat([grouped_xyz, grouped], dim=-1)
        return grouped, grouped_xyz


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale set abstraction (reference pointnet2_modules.py:78-124):
    one FPS, then for each (radius, nsample, mlp) a grouping, a shared MLP
    and a max pool, concatenated along channels. `npoint=None` groups
    every point (`GroupAll`, a global pool, new_xyz None). `mlps` exclude
    the input, `in_channels` features (+3 with use_xyz); the groupings
    are f32, as the JAX module's."""

    def __init__(self, npoint: Optional[int], radii: Sequence[float],
                 nsamples: Sequence[int], in_channels: int,
                 mlps: Sequence[Sequence[int]], use_xyz: bool = True,
                 dtype=torch.float32):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps):
            raise ValueError("radii, nsamples and mlps differ in length")
        self.npoint = npoint
        self.groupers = nn.ModuleList(
            QueryAndGroup(r, ns, use_xyz=use_xyz) if npoint is not None
            else GroupAll(use_xyz) for r, ns in zip(radii, nsamples))
        cin = in_channels + (3 if use_xyz else 0)
        self.mlps = nn.ModuleList(SharedMLP([cin, *mlp], dtype=dtype)
                                  for mlp in mlps)

    def forward(self, xyz, features=None, inds=None):
        """-> new_xyz (B, npoint, 3) or None, features (B, npoint or 1,
        sum of mlps[i][-1]), inds (B, npoint) int32 or None."""
        new_xyz = None
        if self.npoint is not None:
            if inds is None:
                inds = furthest_point_sample(xyz, self.npoint)
            new_xyz = gather_points(xyz.float(), inds)
        outs = [mlp(grouper(xyz, new_xyz, features)[0]).amax(dim=2)
                for grouper, mlp in zip(self.groupers, self.mlps)]
        return new_xyz, torch.cat(outs, dim=-1), inds


class PointnetSAModule(PointnetSAModuleMSG):
    """Single-scale set abstraction (reference pointnet2_modules.py:
    127-160): `PointnetSAModuleMSG` with one scale."""

    def __init__(self, mlp: Sequence[int], in_channels: int,
                 npoint: Optional[int] = None, radius: Optional[float] = None,
                 nsample: Optional[int] = None, use_xyz: bool = True,
                 dtype=torch.float32):
        super().__init__(npoint, (radius,), (nsample,), in_channels,
                         (tuple(mlp),), use_xyz=use_xyz, dtype=dtype)


class PointnetLFPModuleMSG(nn.Module):
    """Learnable multi-scale feature propagation from xyz1 onto xyz2
    (reference pointnet2_modules.py:418-497): for each scale, xyz1's
    `in_channels` features grouped around the xyz2 centres, a shared MLP
    and a max pool, the skip features2 (`skip_channels`) appended, then
    one post-MLP shared by every scale; the scales concatenated."""

    def __init__(self, radii: Sequence[float], nsamples: Sequence[int],
                 in_channels: int, mlps: Sequence[Sequence[int]],
                 post_mlp: Sequence[int], skip_channels: int = 0,
                 use_xyz: bool = True, dtype=torch.float32):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps):
            raise ValueError("radii, nsamples and mlps differ in length")
        if len({mlp[-1] for mlp in mlps}) != 1:
            raise ValueError("the post-MLP is shared: every scale's mlp "
                             "must end in the same width")
        self.groupers = nn.ModuleList(
            QueryAndGroup(r, ns, use_xyz=use_xyz)
            for r, ns in zip(radii, nsamples))
        cin = in_channels + (3 if use_xyz else 0)
        self.mlps = nn.ModuleList(SharedMLP([cin, *mlp], dtype=dtype)
                                  for mlp in mlps)
        self.post_mlp = SharedMLP([mlps[0][-1] + skip_channels, *post_mlp],
                                  dtype=dtype)

    def forward(self, xyz2, xyz1, features2, features1):
        """(B, N2, 3), (B, N1, 3), (B, N2, C2) or None, (B, N1, C1) ->
        (B, N2, len(radii) * post_mlp[-1])."""
        outs = []
        for grouper, mlp in zip(self.groupers, self.mlps):
            out = mlp(grouper(xyz1, xyz2, features1)[0]).amax(dim=2)
            if features2 is not None:
                out = torch.cat([out, features2.to(out.dtype)], dim=-1)
            outs.append(self.post_mlp(out[:, :, None, :])[:, :, 0, :])
        return torch.cat(outs, dim=-1)

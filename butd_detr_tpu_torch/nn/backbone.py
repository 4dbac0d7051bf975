"""PointNet++ visual backbone with the reference hyperparameters
(models/backbone_module.py; JAX counterpart butd_detr_tpu/nn/backbone.py):
4 SA layers (npoint 2048/1024/512/256, radius 0.2/0.4/0.8/1.2, nsample
64/32/16/16, normalize_xyz) and 2 FP layers back to 1024 seeds x
output_dim, channels-last, with the same end-point keys."""

from typing import Dict

import torch
from torch import nn

from butd_detr_tpu_torch.nn.pointnet2 import (
    PointnetFPModule,
    PointnetSAModuleVotes,
)


class Pointnet2Backbone(nn.Module):
    """`input_feature_dim` counts the per-point channels after xyz.
    `dtype` is the compute dtype of the MLP stacks (bf16 by default in the
    serving config); geometry stays f32 and features leave as f32."""

    def __init__(self, input_feature_dim: int = 0, width: int = 1,
                 depth: int = 2, output_dim: int = 288,
                 npoints=(2048, 1024, 512, 256), radii=(0.2, 0.4, 0.8, 1.2),
                 nsamples=(64, 32, 16, 16), dtype=torch.float32):
        super().__init__()
        w, d = width, depth
        cfg = dict(use_xyz=True, normalize_xyz=True, dtype=dtype)
        self.sa1 = PointnetSAModuleVotes(
            npoints[0], radii[0], nsamples[0], input_feature_dim,
            [64 * w] * d + [128 * w], **cfg)
        self.sa2 = PointnetSAModuleVotes(
            npoints[1], radii[1], nsamples[1], 128 * w,
            [128 * w] * d + [256 * w], **cfg)
        self.sa3 = PointnetSAModuleVotes(
            npoints[2], radii[2], nsamples[2], 256 * w,
            [128 * w] * d + [256 * w], **cfg)
        self.sa4 = PointnetSAModuleVotes(
            npoints[3], radii[3], nsamples[3], 256 * w,
            [128 * w] * d + [256 * w], **cfg)
        self.fp1 = PointnetFPModule([512 * w, 256 * w, 256 * w], dtype=dtype)
        self.fp2 = PointnetFPModule([512 * w, 256 * w, output_dim],
                                    dtype=dtype)

    def forward(self, pointcloud: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, N, 3 + input_feature_dim), xyz first -> end points."""
        xyz = pointcloud[..., :3].float()
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None
        ep = {}
        xyz1, feat1, inds1 = self.sa1(xyz, features)
        ep.update(sa1_inds=inds1, sa1_xyz=xyz1, sa1_features=feat1)
        xyz2, feat2, inds2 = self.sa2(xyz1, feat1)
        ep.update(sa2_inds=inds2, sa2_xyz=xyz2, sa2_features=feat2)
        xyz3, feat3, _ = self.sa3(xyz2, feat2)
        ep.update(sa3_xyz=xyz3, sa3_features=feat3)
        xyz4, feat4, _ = self.sa4(xyz3, feat3)
        ep.update(sa4_xyz=xyz4, sa4_features=feat4)
        feat3_up = self.fp1(xyz3, xyz4, feat3, feat4)
        ep["fp2_features"] = self.fp2(xyz2, xyz3, feat2, feat3_up)
        ep["fp2_xyz"] = xyz2
        ep["fp2_inds"] = inds1[:, :xyz2.shape[1]]
        return {k: (v.float() if v.is_floating_point() else v)
                for k, v in ep.items()}

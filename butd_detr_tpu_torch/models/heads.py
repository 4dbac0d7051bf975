"""Prediction heads and query selection (reference models/modules.py;
JAX counterpart butd_detr_tpu/models/heads.py), channels-last with the
reference's Conv1d weight shapes. The convs compute in `dtype`, the
BatchNorms in f32 with f32 outputs (`dtype=jnp.float32` there)."""

from typing import Dict

import torch
from torch import nn

from butd_detr_tpu_torch.nn.dropout import Dropout
from butd_detr_tpu_torch.nn.mlp import BatchNorm, PointwiseConv
from butd_detr_tpu_torch.ops import gather_points


class PointsObjClsModule(nn.Module):
    """Per-seed objectness logits: (conv+BN+ReLU) x2 + conv(1); the convs
    keep their bias, as in the reference."""

    def __init__(self, d_model: int = 288, dtype=torch.float32):
        super().__init__()
        self.conv1 = PointwiseConv(d_model, d_model, dtype=dtype)
        self.bn1 = BatchNorm(d_model, dtype=torch.float32)
        self.conv2 = PointwiseConv(d_model, d_model, dtype=dtype)
        self.bn2 = BatchNorm(d_model, dtype=torch.float32)
        self.conv3 = PointwiseConv(d_model, 1, dtype=dtype)

    def forward(self, seed_features):
        """(B, K, F) -> (B, K)."""
        x = self.bn1(self.conv1(seed_features)).relu()
        x = self.bn2(self.conv2(x)).relu()
        return self.conv3(x)[..., 0]


def general_sampling(xyz, features, sample_inds):
    """Gather (xyz, features) at sample_inds (GeneralSamplingModule)."""
    return (gather_points(xyz, sample_inds),
            gather_points(features, sample_inds), sample_inds)


class ThreeLayerMLP(nn.Module):
    """conv(no bias)+BN+ReLU+Dropout x2 + conv(out); keys net.{0,1,4,5,8}."""

    def __init__(self, dim: int, out_dim: int, dtype=torch.float32):
        super().__init__()
        f32 = torch.float32
        self.net = nn.Sequential(
            PointwiseConv(dim, dim, bias=False, dtype=dtype),
            BatchNorm(dim, dtype=f32), nn.ReLU(), Dropout(0.3),
            PointwiseConv(dim, dim, bias=False, dtype=dtype),
            BatchNorm(dim, dtype=f32), nn.ReLU(), Dropout(0.3),
            PointwiseConv(dim, out_dim, dtype=dtype),
        )

    def forward(self, x):
        return self.net(x)


class ClsAgnosticPredictHead(nn.Module):
    """Center residual (added to base_xyz), size and 256-way soft-token
    scores."""

    def __init__(self, num_class: int = 256, seed_feat_dim: int = 288,
                 dtype=torch.float32):
        super().__init__()
        self.center_residual_head = ThreeLayerMLP(seed_feat_dim, 3, dtype)
        self.size_pred_head = ThreeLayerMLP(seed_feat_dim, 3, dtype)
        self.sem_cls_scores_head = ThreeLayerMLP(seed_feat_dim, num_class,
                                                 dtype)

    def forward(self, features, base_xyz) -> Dict:
        return {
            "base_xyz": base_xyz,
            "center": base_xyz + self.center_residual_head(features),
            "pred_size": self.size_pred_head(features),
            "sem_cls_scores": self.sem_cls_scores_head(features),
        }

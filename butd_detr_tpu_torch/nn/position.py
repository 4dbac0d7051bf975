"""Learned absolute position embedding (reference models/modules.py
PositionEmbeddingLearned; JAX counterpart butd_detr_tpu/nn/position.py):
Conv1d(in -> F) + BN + ReLU + Conv1d(F -> F), both convs with bias, over
channels-last coordinates. Keys `position_embedding_head.{0,1,3}`. The
convs compute in `dtype`, the BatchNorm in f32 with an f32 output, as the
JAX module's `nn.BatchNorm(dtype=jnp.float32)`."""

import torch
from torch import nn

from butd_detr_tpu_torch.nn.mlp import BatchNorm, PointwiseConv


class PositionEmbeddingLearned(nn.Module):
    def __init__(self, input_channel: int, num_pos_feats: int = 288,
                 dtype=torch.float32):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            PointwiseConv(input_channel, num_pos_feats, dtype=dtype),
            BatchNorm(num_pos_feats, dtype=torch.float32),
            nn.ReLU(),
            PointwiseConv(num_pos_feats, num_pos_feats, dtype=dtype),
        )

    def forward(self, xyz):
        """(B, N, input_channel) -> (B, N, num_pos_feats) in `dtype`."""
        return self.position_embedding_head(xyz)

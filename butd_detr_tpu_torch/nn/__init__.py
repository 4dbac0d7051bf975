"""Neural-network modules of the port (channels-last, reference names)."""

from butd_detr_tpu_torch.nn.attention import MultiheadAttention
from butd_detr_tpu_torch.nn.backbone import Pointnet2Backbone
from butd_detr_tpu_torch.nn.mlp import (
    BatchNorm,
    ConvBNRelu1d,
    PointwiseConv,
    SharedMLP,
)
from butd_detr_tpu_torch.nn.pointnet2 import (
    GroupAll,
    PointnetFPModule,
    PointnetLFPModuleMSG,
    PointnetSAModule,
    PointnetSAModuleMSG,
    PointnetSAModuleVotes,
    QueryAndGroup,
)
from butd_detr_tpu_torch.nn.position import PositionEmbeddingLearned

__all__ = [
    "BatchNorm",
    "ConvBNRelu1d",
    "GroupAll",
    "MultiheadAttention",
    "Pointnet2Backbone",
    "PointnetFPModule",
    "PointnetLFPModuleMSG",
    "PointnetSAModule",
    "PointnetSAModuleMSG",
    "PointnetSAModuleVotes",
    "PointwiseConv",
    "PositionEmbeddingLearned",
    "QueryAndGroup",
    "SharedMLP",
]

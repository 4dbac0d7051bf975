"""Point-cloud and attention ops of the port: plain PyTorch, with CUDA
kernels for FPS, ball query and the attention forward."""

from butd_detr_tpu_torch.ops.attention import attention, attention_plain
from butd_detr_tpu_torch.ops.ball_query import ball_query, ball_query_plain
from butd_detr_tpu_torch.ops.fps import (
    furthest_point_sample,
    furthest_point_sample_plain,
)
from butd_detr_tpu_torch.ops.pointcloud import (
    gather_points,
    group_points,
    group_points_split,
    three_interpolate,
    three_nn,
)

__all__ = [
    "attention",
    "attention_plain",
    "ball_query",
    "ball_query_plain",
    "furthest_point_sample",
    "furthest_point_sample_plain",
    "gather_points",
    "group_points",
    "group_points_split",
    "three_interpolate",
    "three_nn",
]

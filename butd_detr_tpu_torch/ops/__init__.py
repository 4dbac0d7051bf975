"""Point-cloud and attention ops of the port: plain PyTorch, with CUDA
kernels for FPS, ball query, attention (forward with dropout, backward),
the row gathers (one payload, or xyz and features under one index) and the
row scatter-add behind the gathers' gradients."""

from butd_detr_tpu_torch.ops.attention import (
    attention,
    attention_backward,
    attention_backward_plain,
    attention_plain,
    dropout_keep_mask,
    dropout_keep_mask_plain,
)
from butd_detr_tpu_torch.ops.ball_query import (
    ball_query,
    ball_query_plain,
    ball_query_stats,
)
from butd_detr_tpu_torch.ops.fps import (
    furthest_point_sample,
    furthest_point_sample_plain,
)
from butd_detr_tpu_torch.ops.gather import (
    gather_rows,
    gather_rows_plain,
    group_rows,
    group_rows_plain,
    group_rows_split,
    group_rows_split_plain,
)
from butd_detr_tpu_torch.ops.pointcloud import (
    gather_points,
    group_points,
    group_points_split,
    three_interpolate,
    three_nn,
)
from butd_detr_tpu_torch.ops.scatter import (
    scatter_rows_add,
    scatter_rows_add_plain,
)

__all__ = [
    "attention",
    "attention_backward",
    "attention_backward_plain",
    "attention_plain",
    "ball_query",
    "ball_query_plain",
    "ball_query_stats",
    "dropout_keep_mask",
    "dropout_keep_mask_plain",
    "furthest_point_sample",
    "furthest_point_sample_plain",
    "gather_points",
    "gather_rows",
    "gather_rows_plain",
    "group_points",
    "group_points_split",
    "group_rows",
    "group_rows_plain",
    "group_rows_split",
    "group_rows_split_plain",
    "scatter_rows_add",
    "scatter_rows_add_plain",
    "three_interpolate",
    "three_nn",
]

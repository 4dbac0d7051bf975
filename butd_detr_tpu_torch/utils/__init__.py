"""Process helpers, logging and shared float rules of the port."""

from butd_detr_tpu_torch.utils.dist import (
    allreduce_dict,
    is_main_process,
    process_count,
    process_index,
)
from butd_detr_tpu_torch.utils.logging import setup_logger
from butd_detr_tpu_torch.utils.numerics import reciprocal_f32

__all__ = [
    "allreduce_dict",
    "is_main_process",
    "process_count",
    "process_index",
    "reciprocal_f32",
    "setup_logger",
]

"""Process helpers and logging of the port."""

from butd_detr_tpu_torch.utils.dist import (
    allreduce_dict,
    is_main_process,
    process_count,
    process_index,
)
from butd_detr_tpu_torch.utils.logging import setup_logger

__all__ = [
    "allreduce_dict",
    "is_main_process",
    "process_count",
    "process_index",
    "setup_logger",
]

"""Training of the port: optimizer, schedules and the train/eval steps."""

from butd_detr_tpu_torch.train.optimizer import (
    clip_by_global_norm_,
    make_optimizer,
    make_schedule,
)
from butd_detr_tpu_torch.train.step import (
    INPUT_KEYS,
    METRIC_KEYS,
    TARGET_KEYS,
    Trainer,
    build_model,
    criterion_config,
)

__all__ = [
    "INPUT_KEYS",
    "METRIC_KEYS",
    "TARGET_KEYS",
    "Trainer",
    "build_model",
    "clip_by_global_norm_",
    "criterion_config",
    "make_optimizer",
    "make_schedule",
]

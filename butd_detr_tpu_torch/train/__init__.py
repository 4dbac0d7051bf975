"""Training of the port: optimizer, schedules, the train/eval steps,
checkpoints, pretrained initialisation and the epoch harness."""

from butd_detr_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from butd_detr_tpu_torch.train.harness import (
    TrainTester,
    detection_token_map,
)
from butd_detr_tpu_torch.train.optimizer import (
    clip_by_global_norm_,
    make_optimizer,
    make_schedule,
)
from butd_detr_tpu_torch.train.pretrained import apply_pretrained_init
from butd_detr_tpu_torch.train.step import (
    INPUT_KEYS,
    METRIC_KEYS,
    TARGET_KEYS,
    Trainer,
    build_model,
    criterion_config,
    metrics_to_host,
)

__all__ = [
    "INPUT_KEYS",
    "METRIC_KEYS",
    "TARGET_KEYS",
    "TrainTester",
    "Trainer",
    "apply_pretrained_init",
    "build_model",
    "clip_by_global_norm_",
    "criterion_config",
    "detection_token_map",
    "latest_checkpoint",
    "load_checkpoint",
    "make_optimizer",
    "make_schedule",
    "metrics_to_host",
    "save_checkpoint",
]

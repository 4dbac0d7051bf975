"""The train and eval steps of the port.

Counterpart of `butd_detr_tpu/train/step.py`. `Trainer.train_step` runs
forward in train mode -> 7-prefix Hungarian loss (matching on the host, one
copy) -> backward -> global-norm clip -> 3-group AdamW step, on `cuda`
unless the caller passes `device="cpu"`. The JAX package compiles this
into one program over a device mesh; here it is eager PyTorch on one
device, with the TPU kernels' counterparts (FPS, ball query, attention
forward and backward, row scatter-add) as CUDA kernels.
"""

from typing import Dict, Optional

import torch

from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.init import init_weights_
from butd_detr_tpu_torch.lang.roberta import RobertaConfig, \
    roberta_base_config
from butd_detr_tpu_torch.losses import CriterionConfig, \
    compute_hungarian_loss
from butd_detr_tpu_torch.predict import (
    build_model,
    load_state_dict,
    resolve_device,
)
from butd_detr_tpu_torch.train.optimizer import (
    clip_by_global_norm_,
    make_optimizer,
    make_schedule,
)

# GT keys the criterion reads from the batch
TARGET_KEYS = (
    "center_label",
    "size_gts",
    "sem_cls_label",
    "positive_map",
    "box_label_mask",
    "point_instance_label",
    "text_mask",
)

# model input keys
INPUT_KEYS = (
    "point_clouds",
    "text_ids",
    "text_mask",
    "det_boxes",
    "det_class_ids",
    "det_bbox_label_mask",
)

METRIC_KEYS = (
    "loss",
    "loss_ce",
    "loss_bbox",
    "loss_giou",
    "loss_contrastive_align",
    "query_points_generation_loss",
)


def criterion_config(cfg: Config) -> CriterionConfig:
    return CriterionConfig(
        eos_coef=cfg.eos_coef,
        temperature=0.07,
        cost_class=1.0,
        cost_bbox=0.0,
        cost_giou=2.0,
        use_contrastive_align=cfg.use_contrastive_align,
        use_soft_token=cfg.use_soft_token_loss,
    )


class Trainer:
    """The model, its optimizer and the step counter.

    cfg: model, loss and optimizer flags (`config.butd_cls_config()` for
        the SR3D butd_cls setup).
    steps_per_epoch: converts the schedule's epochs into steps.
    state_dict: reference-named weights; None fills the model with seeded
        random weights from `seed`.
    model: a model built by the caller (`build_model`), used instead of
        building one from `roberta_config` and `backbone_npoints`.
    device: `cuda` unless given.
    seed: also seeds the trainer's `torch.Generator` (on the host), from
        which each step draws the seed of its dropout masks.
    """

    def __init__(self, cfg: Config, steps_per_epoch: int = 1, *,
                 roberta_config: Optional[RobertaConfig] = None,
                 backbone_npoints=(2048, 1024, 512, 256), state_dict=None,
                 model=None, device=None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            model = build_model(cfg, roberta_config or roberta_base_config(),
                                backbone_npoints)
        if state_dict is None:
            init_weights_(model, seed)
        else:
            load_state_dict(model, state_dict)
        self.model = model.to(self.device)
        self.criterion = criterion_config(cfg)
        self.optimizer = make_optimizer(cfg, self.model.named_parameters())
        self.schedules = {
            g["name"]: make_schedule(g["base_lr"], steps_per_epoch, cfg)
            for g in self.optimizer.param_groups}
        self.generator = torch.Generator().manual_seed(seed)
        self.step = 0

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch's arrays (numpy or tensors) on the trainer's device."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """The model's end points for a batch on the device, with the
        batch's targets added for the criterion."""
        end_points = self.model(
            {k: batch[k] for k in INPUT_KEYS if k in batch})
        for k in TARGET_KEYS:
            if k in batch:
                end_points[k] = batch[k]
        return end_points

    def loss(self, end_points: Dict[str, torch.Tensor]):
        """(loss, end_points with the losses added)."""
        return compute_hungarian_loss(
            end_points, self.cfg.num_decoder_layers, self.criterion,
            self.cfg.query_points_obj_topk)

    def begin_step(self) -> None:
        """Train mode, this step's dropout seed and learning rates, and
        cleared gradients."""
        self.model.train()
        self.model.rng.seed(int(torch.randint(
            0, 2 ** 62, (1,), generator=self.generator)))
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedules[group["name"]](self.step)
        self.optimizer.zero_grad(set_to_none=True)

    def apply_gradients(self) -> torch.Tensor:
        """Clip the gradients' global norm, take the optimizer step;
        returns the norm before clipping (on the device)."""
        params = [p for g in self.optimizer.param_groups
                  for p in g["params"]]
        for p in params:
            if p.grad is None:  # unused this step: still decays, as optax
                p.grad = torch.zeros_like(p)
        grad_norm = clip_by_global_norm_([p.grad for p in params],
                                         self.cfg.clip_norm)
        self.optimizer.step()
        self.step += 1
        return grad_norm

    def train_step_on_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One optimizer step on `batch`; returns the losses under
        METRIC_KEYS and the gradients' global norm before clipping
        (`grad_norm`) as 0-d tensors on the device, not read back."""
        batch = self.to_device(batch)
        self.begin_step()
        loss, end_points = self.loss(self.forward(batch))
        loss.backward()
        grad_norm = self.apply_gradients()
        named = {k: torch.as_tensor(end_points[k], dtype=torch.float32,
                                    device=grad_norm.device).detach()
                 for k in METRIC_KEYS if k in end_points}
        named["grad_norm"] = grad_norm
        return named

    def train_step(self, batch: Dict) -> Dict[str, float]:
        """`train_step_on_device`, its metrics read back in one copy."""
        return metrics_to_host(self.train_step_on_device(batch))

    @torch.no_grad()
    def eval_step(self, batch: Dict, with_loss: bool = True
                  ) -> Dict[str, torch.Tensor]:
        """The eval-mode end points of `batch`, with the losses added when
        `with_loss` (the batch then carries the TARGET_KEYS)."""
        batch = self.to_device(batch)
        self.model.eval()
        end_points = self.forward(batch)
        return self.loss(end_points)[1] if with_loss else end_points


def metrics_to_host(named: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-d tensors on one device -> floats, in one copy."""
    values = torch.stack([v.float() for v in named.values()]).cpu()
    return dict(zip(named, values.tolist()))


__all__ = ["INPUT_KEYS", "METRIC_KEYS", "TARGET_KEYS", "Trainer",
           "build_model", "criterion_config", "metrics_to_host"]

"""Optimizer and LR schedules: 3-group AdamW with warmup and step or
cosine decay.

Counterpart of `butd_detr_tpu/train/optimizer.py` (reference
main_utils.get_optimizer and utils/lr_scheduler.py):
  * parameter groups by name: `backbone_net` -> lr_backbone, `text_encoder`
    -> text_encoder_lr, everything else -> lr; parameters that do not
    require a gradient (the frozen text tower) are in no group: no update
    and no weight decay;
  * AdamW (0.9, 0.999, eps 1e-8) with decoupled weight decay on every
    parameter of a group, as optax's `adamw`;
  * the global gradient norm is clipped BEFORE the update
    (`clip_by_global_norm_`, optax's rule: scale by max_norm / norm when
    norm >= max_norm);
  * per-iteration schedules: MultiStep (rate ^ milestones crossed) or
    cosine to 1e-6, optionally behind the multiplier-100 gradual warmup
    lr(t) = base / m * ((m - 1) t / T + 1).
"""

import math
from typing import Callable, Dict, Iterable, List, Optional

import torch

from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.parallel.collectives import reduce_from_group

GROUPS = ("main", "backbone", "text")


def make_schedule(base_lr: float, steps_per_epoch: int,
                  cfg: Config) -> Callable[[int], float]:
    """step (0 for the first update) -> learning rate, as get_scheduler
    (lr_scheduler.py:70-92) at iteration granularity. Evaluated in double
    precision on the host (the JAX package evaluates the same expressions
    in float32 inside its compiled step)."""
    warmup_epochs = max(cfg.warmup_epoch, 0)
    warmup_steps = warmup_epochs * steps_per_epoch

    if "cosine" in cfg.lr_scheduler:
        t_max = max((cfg.max_epoch - warmup_epochs) * steps_per_epoch, 1)
        eta_min = 1e-6

        def after(step):
            frac = min(max(step / t_max, 0.0), 1.0)
            return eta_min + (base_lr - eta_min) * 0.5 * (
                1 + math.cos(math.pi * frac))

    elif "step" in cfg.lr_scheduler:
        milestones = [(m - warmup_epochs) * steps_per_epoch
                      for m in cfg.lr_decay_epochs]

        def after(step):
            crossed = sum(step >= m for m in milestones)
            return base_lr * cfg.lr_decay_rate ** crossed

    else:
        raise NotImplementedError(cfg.lr_scheduler)

    if warmup_steps > 0:
        m = float(cfg.warmup_multiplier)

        def schedule(step):
            if step > warmup_steps:
                return after(step - warmup_steps)
            return base_lr / m * ((m - 1.0) * step / warmup_steps + 1.0)

        return schedule
    return after


def param_group_label(name: str) -> str:
    """backbone / text / main, by the parameter's name."""
    if "backbone_net" in name:
        return "backbone"
    if "text_encoder" in name:
        return "text"
    return "main"


def make_optimizer(cfg: Config, named_parameters: Iterable
                   ) -> torch.optim.AdamW:
    """AdamW over up to three named groups (`group["name"]` in GROUPS,
    `group["base_lr"]` its configured rate). Set each group's `lr` from its
    schedule before every step (`Trainer` does)."""
    base = {"main": cfg.lr, "backbone": cfg.lr_backbone,
            "text": cfg.text_encoder_lr}
    members: Dict[str, List[torch.nn.Parameter]] = {g: [] for g in GROUPS}
    for name, p in named_parameters:
        if p.requires_grad:
            members[param_group_label(name)].append(p)
    groups = [dict(params=members[g], name=g, base_lr=base[g], lr=base[g])
              for g in GROUPS if members[g]]
    return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Optional[torch.Tensor] = None,
                         group=None) -> torch.Tensor:
    """Scale `grads` in place so that their global L2 norm is at most
    `max_norm`; returns the norm before clipping (a 0-d tensor on the
    gradients' device, no host synchronisation).

    Under tensor parallelism `sharded` (a bool tensor on the gradients'
    device, one entry a gradient) marks the gradients that are this
    rank's shard of a parameter split over the mp `group`: their
    squares are summed over the group, the replicated ones' counted
    once, so every rank clips by the one-process norm."""
    norms = torch.stack(torch._foreach_norm(grads))
    if group is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        mask = sharded
        squares = norms * norms
        split = reduce_from_group(
            torch.where(mask, squares, torch.zeros_like(squares)).sum(),
            group)
        norm = torch.sqrt(split + torch.where(
            mask, torch.zeros_like(squares), squares).sum())
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm

"""Checkpoint save/load with `torch.save`.

Counterpart of `butd_detr_tpu/train/checkpoint.py` (reference
main_utils.py:122-160): a checkpoint carries {model, optimizer, step,
generator_state, epoch} at `log_dir/ckpt_epoch_{E}.pth`; restore returns
`start_epoch = epoch + 1`. The schedule is a pure function of the step
count, so "scheduler state" is just the step; `reduce_lr` (a manual LR
drop) therefore restores the parameters and BatchNorm buffers only and
leaves optimizer, step and generator as they are. The frozen text tower is
saved like the rest. `generator_state` is the trainer's host generator, from
which every step draws its dropout seed, so a resumed run repeats the
uninterrupted one.
"""

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"ckpt_epoch_(\d+)\.pth$")


def _ckpt_path(log_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(log_dir), f"ckpt_epoch_{epoch}.pth")


def save_checkpoint(log_dir: str, epoch: int, trainer) -> str:
    """Write `log_dir/ckpt_epoch_{E}.pth` (reference save_checkpoint,
    main_utils.py:144-160); returns the path."""
    path = _ckpt_path(log_dir, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "model": trainer.model.state_dict(),
        "optimizer": trainer.optimizer.state_dict(),
        "step": int(trainer.step),
        "generator_state": trainer.generator.get_state(),
        "epoch": int(epoch),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader sees the whole file or none
    return path


def load_checkpoint(path: str, trainer, reduce_lr: bool = False) -> int:
    """Restore `trainer` in place from `path`; returns start_epoch.

    With `reduce_lr` only the parameters and buffers are restored
    (main_utils.py:122-141: optimizer and scheduler skipped)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    trainer.model.load_state_dict(payload["model"])
    if not reduce_lr:
        trainer.optimizer.load_state_dict(payload["optimizer"])
        trainer.step = int(payload["step"])
        trainer.generator.set_state(payload["generator_state"])
    return int(payload["epoch"]) + 1


def latest_checkpoint(log_dir: str) -> Optional[str]:
    """The checkpoint of the highest epoch under `log_dir`, or None."""
    if not os.path.isdir(log_dir):
        return None
    epochs = [int(m.group(1)) for m in map(_NAME.match, os.listdir(log_dir))
              if m]
    return _ckpt_path(log_dir, max(epochs)) if epochs else None

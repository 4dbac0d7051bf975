"""The configuration fields the port reads.

A counterpart of `butd_detr_tpu/train/config.py:Config` (same field names
and defaults), kept here so the port imports nothing of the JAX package:
the model and input fields of serving, and the loss, optimizer and schedule
fields of the train step. Data-loading and IO fields come with their
slices.
"""

from dataclasses import dataclass, field
from typing import List


@dataclass
class Config:
    # model
    num_target: int = 256
    num_encoder_layers: int = 3
    num_decoder_layers: int = 6
    self_position_embedding: str = "loc_learned"
    self_attend: bool = False

    # loss
    query_points_obj_topk: int = 4
    eos_coef: float = 0.1  # soft-token "no object" weight
    use_contrastive_align: bool = False
    use_soft_token_loss: bool = False
    joint_det: bool = False

    # data
    use_height: bool = False
    use_color: bool = False
    butd: bool = False
    butd_gt: bool = False
    butd_cls: bool = False

    # training
    max_epoch: int = 400
    weight_decay: float = 0.0005
    lr: float = 1e-3
    lr_backbone: float = 1e-4
    text_encoder_lr: float = 1e-5
    lr_scheduler: str = "step"  # step | cosine
    lr_decay_epochs: List[int] = field(default_factory=lambda: [280, 340])
    lr_decay_rate: float = 0.1
    clip_norm: float = 0.1
    warmup_epoch: int = -1
    warmup_multiplier: int = 100

    # fixed shapes
    max_text_len: int = 64
    num_points: int = 50000
    max_num_obj: int = 132
    max_det_boxes: int = 132
    # bf16 compute for the PointNet++ MLP stacks only (default on, as in
    # the JAX package); geometry, BN statistics and the rest stay f32
    backbone_bf16: bool = True
    # f32 attention kernels instead of bf16 operands with f32 accumulation
    attn_precise: bool = False
    # the reference freezes the text tower unconditionally; False trains it
    # with `text_encoder_lr`
    freeze_text_encoder: bool = True
    # synthetic clouds arrive in Hilbert (spatially local) order, as the
    # data pipeline stores real scans; a point set is order-free
    spatial_sort: bool = True

    def __post_init__(self):
        if self.joint_det and self.max_text_len < 128:
            self.max_text_len = 128

    @property
    def input_feature_dim(self) -> int:
        """Per-point channels after xyz."""
        return 3 * self.use_color + self.use_height

    @property
    def use_butd(self) -> bool:
        return self.butd or self.butd_gt or self.butd_cls


def butd_cls_config(**overrides) -> Config:
    """The flags of scripts/train_test_cls.sh (the SR3D `butd_cls` setup):
    --use_color --butd_cls --self_attend --use_contrastive_align
    --use_soft_token_loss --joint_det --num_decoder_layers 6
    --weight_decay 0.0005 --lr 1e-4 --lr_backbone 1e-3
    --lr_decay_epochs 30 35."""
    kw = dict(use_color=True, butd_cls=True, self_attend=True,
              use_contrastive_align=True, use_soft_token_loss=True,
              joint_det=True, num_decoder_layers=6, weight_decay=0.0005,
              lr=1e-4, lr_backbone=1e-3, lr_decay_epochs=[30, 35])
    kw.update(overrides)
    return Config(**kw)

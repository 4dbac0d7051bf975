"""The configuration fields the serving slice reads.

A small counterpart of `butd_detr_tpu/train/config.py:Config` (same field
names and defaults), kept here so the port imports nothing of the JAX
package. Training, data and IO fields come with their slices.
"""

from dataclasses import dataclass


@dataclass
class Config:
    num_target: int = 256
    num_encoder_layers: int = 3
    num_decoder_layers: int = 6
    self_position_embedding: str = "loc_learned"
    self_attend: bool = False
    use_contrastive_align: bool = False
    joint_det: bool = False
    use_height: bool = False
    use_color: bool = False
    butd: bool = False
    butd_gt: bool = False
    butd_cls: bool = False
    max_text_len: int = 64
    num_points: int = 50000
    max_det_boxes: int = 132
    # bf16 compute for the PointNet++ MLP stacks only (default on, as in
    # the JAX package); geometry, BN statistics and the rest stay f32
    backbone_bf16: bool = True
    # f32 attention kernel instead of bf16 operands with f32 accumulation
    attn_precise: bool = False

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
    --joint_det --num_decoder_layers 6."""
    kw = dict(use_color=True, butd_cls=True, self_attend=True,
              use_contrastive_align=True, joint_det=True,
              num_decoder_layers=6)
    kw.update(overrides)
    return Config(**kw)

"""Training/eval configuration of the port.

The port's own copy of `butd_detr_tpu/train/config.py` (so that it imports
nothing of the JAX package): every field of that dataclass under the same
name and default, a mirror of the reference's argparse surface
(main_utils.py:31-119), and a CLI that accepts the same flag names, adds
`--no-<flag>` for booleans and ignores unknown flags, like the reference's
`parse_known_args`. Fields whose slice of the port is not written yet
(`mp`, `profile_dir`, `pp_checkpoint`, ...) are kept so that a command line
parses alike in both packages; the harness refuses the ones it cannot
honour.
"""

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Config:
    # Model (main_utils.py:35-46)
    num_target: int = 256
    sampling: str = "kps"
    num_encoder_layers: int = 3
    num_decoder_layers: int = 6
    self_position_embedding: str = "loc_learned"
    self_attend: bool = False

    # Loss (main_utils.py:48-52)
    query_points_obj_topk: int = 4
    eos_coef: float = 0.1  # soft-token "no object" weight
    use_contrastive_align: bool = False
    use_soft_token_loss: bool = False
    detect_intermediate: bool = False
    joint_det: bool = False

    # Data (main_utils.py:55-70)
    batch_size: int = 8
    dataset: List[str] = field(default_factory=lambda: ["sr3d"])
    test_dataset: str = "sr3d"
    data_root: str = "./"
    use_height: bool = False
    use_color: bool = False
    use_multiview: bool = False
    butd: bool = False
    butd_gt: bool = False
    butd_cls: bool = False
    augment_det: bool = False
    num_workers: int = 4

    # Training (main_utils.py:73-92)
    start_epoch: int = 1
    max_epoch: int = 400
    optimizer: str = "adamW"
    weight_decay: float = 0.0005
    lr: float = 1e-3
    lr_backbone: float = 1e-4
    text_encoder_lr: float = 1e-5
    lr_scheduler: str = "step"  # step | cosine
    lr_decay_epochs: List[int] = field(default_factory=lambda: [280, 340])
    lr_decay_rate: float = 0.1
    clip_norm: float = 0.1
    bn_momentum: float = 0.1
    syncbn: bool = False
    warmup_epoch: int = -1
    warmup_multiplier: int = 100

    # IO (main_utils.py:95-101)
    checkpoint_path: Optional[str] = None
    log_dir: str = "log"
    print_freq: int = 10
    save_freq: int = 10
    val_freq: int = 5

    # Others (main_utils.py:104-115)
    ap_iou_thresholds: List[float] = field(default_factory=lambda: [0.25, 0.5])
    rng_seed: int = 0
    debug: bool = False
    eval: bool = False
    eval_train: bool = False
    pp_checkpoint: Optional[str] = None
    reduce_lr: bool = False

    # Pretrained-init sources (the reference hardcodes these: bdetr.py:73-92)
    roberta_checkpoint: Optional[str] = None
    class_embeddings_path: Optional[str] = None

    # ---- additions of the JAX package, kept under their names
    # Fixed token length (host-side tokenization); joint_det prompts mix up
    # to 20 multi-word class names and can exceed 64 RoBERTa tokens, so
    # joint_det configs are bumped to 128 in __post_init__
    max_text_len: int = 64
    num_points: int = 50000
    max_num_obj: int = 132  # MAX_NUM_OBJ (joint_det_dataset.py:33)
    max_det_boxes: int = 132
    dp: Optional[int] = None  # data-parallel size (None = all devices)
    mp: int = 1
    profile_dir: Optional[str] = None
    profile_steps: int = 5
    use_bf16: bool = False
    # bf16 compute for the PointNet++ MLP stacks only (default on, as in
    # the JAX package); geometry, BN statistics and the rest stay f32
    backbone_bf16: bool = True
    # f32 attention kernels instead of bf16 operands with f32 accumulation
    attn_precise: bool = False
    # the reference freezes the text tower unconditionally; False trains it
    # with `text_encoder_lr`
    freeze_text_encoder: bool = True
    # clouds arrive in Hilbert (spatially local) order, as the data
    # pipeline stores real scans; a point set is order-free
    spatial_sort: bool = True

    def __post_init__(self):
        if self.joint_det and self.max_text_len < 128:
            self.max_text_len = 128

    @property
    def input_feature_dim(self) -> int:
        """Per-point channels after xyz (joint_det_dataset logic)."""
        return 3 * self.use_color + self.use_height + 128 * self.use_multiview

    @property
    def use_butd(self) -> bool:
        return self.butd or self.butd_gt or self.butd_cls

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


_LIST_TYPES = {List[int]: int, List[float]: float, List[str]: str}
_SCALAR_TYPES = {int: int, float: float, str: str, Optional[str]: str,
                 Optional[int]: int}


def parse_config(argv: Optional[List[str]] = None,
                 description: Optional[str] = None) -> Config:
    """Parse CLI flags with the reference's names (`--lr_backbone` or
    `--lr-backbone`); unknown flags are ignored. Booleans take the
    reference's positive flag (`--butd_cls`) and `--no-<flag>`, so the
    True-by-default options can be turned off. `--eval_train` implies
    `--eval`. `description` heads `--help`."""
    parser = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        alt = "--" + f.name.replace("_", "-")
        names = [name] if name == alt else [name, alt]
        if f.type is bool:
            parser.add_argument(*names,
                                action=argparse.BooleanOptionalAction,
                                default=f.default)
        elif f.type in _LIST_TYPES:
            parser.add_argument(*names, type=_LIST_TYPES[f.type], nargs="+",
                                default=f.default_factory())
        else:
            parser.add_argument(*names, type=_SCALAR_TYPES[f.type],
                                default=f.default)
    args, _ = parser.parse_known_args(argv)
    cfg = Config(**{f.name: getattr(args, f.name)
                    for f in dataclasses.fields(Config)})
    return dataclasses.replace(cfg, eval=cfg.eval or cfg.eval_train)


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

#!/usr/bin/env python
"""Train / evaluate the PyTorch + CUDA port of BUTD-DETR on one GPU.

The port's counterpart of `train.py`, with the same flags (the
reference's, main_utils.py:31-119; `--help` lists them): `parse_config`
-> `TrainTester.main`, which builds the two grounding datasets from
`--data_root` (a ScanNet-format root; `prepare_data_torch.py` pre-builds
its scan caches), trains `--max_epoch` epochs with `--num_workers` loader
workers, saves a checkpoint and evaluates every `--val_freq` epochs. Runs
on `cuda` and raises when no GPU is present. Imports only the port.

Examples (the flags of scripts/train_test_cls.sh):
  python train_torch.py --num_decoder_layers 6 --use_color \\
      --weight_decay 0.0005 --data_root ./data --val_freq 5 \\
      --batch_size 24 --lr_backbone 1e-3 --lr 1e-4 --dataset sr3d \\
      --test_dataset sr3d --detect_intermediate --joint_det \\
      --use_soft_token_loss --use_contrastive_align --butd_cls \\
      --self_attend --log_dir ./logs/bdetr_cls
  python train_torch.py --eval --checkpoint_path logs/ckpt_epoch_40.pth ...
"""

import os


def main():
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")

    from butd_detr_tpu_torch.config import parse_config

    cfg = parse_config()
    from butd_detr_tpu_torch.train import TrainTester

    TrainTester(cfg).main()


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Train / evaluate the PyTorch + CUDA port of BUTD-DETR on GPUs.

The port's counterpart of `train.py`, with the same flags (the
reference's, main_utils.py:31-119; `--help` lists them): `parse_config`
-> `TrainTester.main`, which builds the two grounding datasets from
`--data_root` (a ScanNet-format root; `prepare_data_torch.py` pre-builds
its scan caches), trains `--max_epoch` epochs with `--num_workers` loader
workers, saves a checkpoint and evaluates every `--val_freq` epochs. Runs
on `cuda` and raises when no GPU is present. Imports only the port.

Under `torchrun` every process is a rank of a `(dp, mp)` mesh on
`cuda:LOCAL_RANK`, joined over NCCL: `--batch_size` is the batch of one
step across the `--dp` shards (each rank loads B/dp rows of it), `--mp`
splits the transformer's heads and FFN columns, `--dp` defaults to the
number of processes / `--mp`. BatchNorm statistics are global over the
dp shards whether or not `--syncbn` is given.

Examples (the flags of scripts/train_test_cls.sh):
  python train_torch.py --num_decoder_layers 6 --use_color \\
      --weight_decay 0.0005 --data_root ./data --val_freq 5 \\
      --batch_size 24 --lr_backbone 1e-3 --lr 1e-4 --dataset sr3d \\
      --test_dataset sr3d --detect_intermediate --joint_det \\
      --use_soft_token_loss --use_contrastive_align --butd_cls \\
      --self_attend --log_dir ./logs/bdetr_cls
  torchrun --standalone --nproc_per_node 4 train_torch.py <the flags> \\
      --dp 4
  python train_torch.py --eval --checkpoint_path logs/ckpt_epoch_40.pth ...
"""

import os


def main():
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")

    from butd_detr_tpu_torch.config import parse_config

    cfg = parse_config(description=__doc__)
    import torch
    import torch.distributed as dist

    from butd_detr_tpu_torch.train import TrainTester
    from butd_detr_tpu_torch.utils.dist import (
        init_distributed,
        launched_by_torchrun,
        local_rank,
    )

    if not launched_by_torchrun():
        TrainTester(cfg).main()
        return
    device = torch.device("cuda", local_rank())
    torch.cuda.set_device(device)
    init_distributed("nccl")
    try:
        TrainTester(cfg, device=device).main()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

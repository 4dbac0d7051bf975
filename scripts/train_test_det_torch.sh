#!/bin/bash
# Detection-stream grounding setup (scripts/train_test_det.sh's flags) for
# the PyTorch port: one process a GPU under torchrun, over NCCL. The port's
# --dp defaults to the world's size. Run from the repository's root;
# NPROC_PER_NODE overrides the GPU count, and a flag given after the
# script's own wins.
torchrun --standalone \
    --nproc_per_node "${NPROC_PER_NODE:-$(nvidia-smi -L | wc -l)}" \
    train_torch.py --num_decoder_layers 6 \
    --use_color \
    --weight_decay 0.0005 \
    --data_root "${DATA_ROOT:-./data}" \
    --val_freq 5 --batch_size 24 --save_freq 5 --print_freq 1000 \
    --lr_backbone 1e-3 --lr 1e-4 \
    --dataset sr3d --test_dataset sr3d \
    --detect_intermediate --joint_det \
    --use_soft_token_loss --use_contrastive_align \
    --log_dir ./logs/bdetr \
    --lr_decay_epochs 25 26 \
    --butd --self_attend --augment_det "$@"

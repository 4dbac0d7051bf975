#!/usr/bin/env python3
"""Train-to-accuracy study of the port on a learnable synthetic grounding
dataset (`make_rich_scannet`: every scene holds objects of distinct
classes, 'the <class> in the room' annotations, clean detected boxes).

On the card, the nt32 study (80 epochs, B = 24, 20,000 points):
    python3 scripts/accuracy_study_torch.py --out studies/cls_r5_nt32_torch \
        --butd_cls --trainable_text --small_text \
        --text_init studies/attrib_r5/text_init.npz --eos_coef 0.02 \
        --num_target 32 --eval_train_split --joint_det --epochs 80 \
        --val_freq 5 --lr_decay_epochs 55 70 --num_points 20000
A CPU smoke run (a tiny model, 1024 points):
    python3 scripts/accuracy_study_torch.py --tiny --device cpu \
        --n_train 2 --n_val 1 --epochs 1 --out /tmp/study_tiny

Writes the data root under `<out>/data` when it is missing, the harness's
log and checkpoints under `<out>/log`, one `history.jsonl` row an
evaluation and one `invocation.json` line a run. A run into an `--out`
that holds checkpoints continues from the latest; `--resume PATH` names
the checkpoint (or the directory) to continue from. The flags are those of
the JAX package's `scripts/accuracy_study.py`, plus `--device`
(butd_detr_tpu_torch/train/study.py).
"""

import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

if __name__ == "__main__":
    # imported here, not above: the loader's spawned workers import this
    # file as their main module, and need only the data package
    from butd_detr_tpu_torch.train.study import main

    main()

#!/usr/bin/env python3
"""Post-hoc TRAIN-split grounding accuracy of each checkpoint of a port study.

    python3 scripts/train_split_eval_torch.py --study accuracy_study \
        [--small_text] [--batch N] [--device cuda]

The port's counterpart of the JAX package's `scripts/train_split_eval.py`.
The accuracy study (`scripts/accuracy_study_torch.py`) evaluates its val
scenes (its train scenes under `--eval_train_split`); this script replays
the study's saved checkpoints against the TRAIN scenes, unaugmented (the
test split of `make_trainval_root`). For each
`<study>/log/ckpt_epoch_E.pth`, in epoch order, it restores the weights
into the model of `<study>/log/config.json` (the tiny text tower when the
study's clouds are below 5,000 points, the small one with `--small_text`,
as `scripts/diag_grounding_torch.py`), runs `TrainTester.evaluate_one_epoch`
and appends one row to `<study>/train_split_eval.jsonl`:
`{"epoch", "acc@{0.25,0.5}_top{1,5}_{bbs,bbf}"}`, the JAX script's keys;
for a `--butd_cls` study, whose GT evaluator has no IoU threshold or
top-k, `{"epoch", "acc_{last_,proposal_}{bbs,bbf}"}`, the keys of the
study's own `history.jsonl`. The evaluation logs under
`<study>/log_traineval`. Runs on `cuda` unless `--device cpu`; the last
line printed is the JSON list of the rows.
"""

import argparse
import dataclasses
import json
import os
import os.path as osp
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def checkpoint_epochs(study):
    """The epochs of `<study>/log/ckpt_epoch_E.pth`, ascending."""
    return sorted(int(name[len("ckpt_epoch_"):-len(".pth")])
                  for name in os.listdir(osp.join(study, "log"))
                  if name.startswith("ckpt_epoch_")
                  and name.endswith(".pth"))


def evaluation(study, small_text=False, batch=None, device="cuda"):
    """(tester, loader, trainer) of a study's train-split evaluation: a
    `StudyTrainTester` with the study's config (logging under
    `<study>/log_traineval`), the loader of its train-scene test split
    and a `Trainer` of its model."""
    from butd_detr_tpu_torch.config import Config
    from butd_detr_tpu_torch.data import DataLoader
    from butd_detr_tpu_torch.train import Trainer
    from butd_detr_tpu_torch.train.study import StudyTrainTester

    with open(osp.join(study, "log", "config.json")) as f:
        raw = json.load(f)
    raw["log_dir"] = osp.join(study, "log_traineval")
    if batch:
        raw["batch_size"] = batch
    fields = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in raw.items() if k in fields})
    args = SimpleNamespace(tiny=cfg.num_points < 5000, small_text=small_text,
                           text_init=None, eval_train_split=True, out=study)
    tester = StudyTrainTester(cfg, args, osp.join(study, "data"),
                              device=device)
    _, test_dataset = tester.get_datasets()
    loader = DataLoader(test_dataset, batch_size=cfg.batch_size,
                        shuffle=False, drop_last=False, seed=cfg.rng_seed,
                        num_workers=cfg.num_workers)
    trainer = Trainer(cfg, model=tester.get_model(), device=tester.device)
    return tester, loader, trainer


def evaluate_checkpoint(tester, loader, trainer, study, epoch):
    """Restore `<study>/log/ckpt_epoch_{epoch}.pth` and evaluate: the
    row of `train_split_eval.jsonl`."""
    from butd_detr_tpu_torch.train.checkpoint import load_checkpoint
    from butd_detr_tpu_torch.train.harness import TrainTester
    from butd_detr_tpu_torch.train.study import accuracy_row

    load_checkpoint(osp.join(study, "log", f"ckpt_epoch_{epoch}.pth"),
                    trainer)
    # the harness's evaluation, without the study's history row
    ev = TrainTester.evaluate_one_epoch(tester, epoch, loader, trainer)
    return {"epoch": epoch, **accuracy_row(tester.cfg, ev)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--study", default="accuracy_study",
                    help="the study's --out directory")
    ap.add_argument("--small_text", action="store_true",
                    help="the study ran with --small_text")
    ap.add_argument("--batch", type=int, default=None,
                    help="the evaluation's batch (default: the study's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    epochs = checkpoint_epochs(args.study)
    print(f"checkpoints: {epochs}", flush=True)
    tester, loader, trainer = evaluation(args.study, args.small_text,
                                         args.batch, args.device)
    print(f"train-split eval annotations: {len(loader.dataset)}",
          flush=True)
    rows = []
    try:
        for epoch in epochs:
            t0 = time.time()
            row = evaluate_checkpoint(tester, loader, trainer, args.study,
                                      epoch)
            rows.append(row)
            print(f"TRAINEVAL {json.dumps(row)} ({time.time() - t0:.0f}s)",
                  flush=True)
            with open(osp.join(args.study, "train_split_eval.jsonl"),
                      "a") as f:
                f.write(json.dumps(row) + "\n")
    finally:
        loader.close()
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()

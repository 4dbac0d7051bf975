#!/usr/bin/env python3
"""Single-batch overfit probe of the port: does training on one fixed
batch drive the matched query's soft-token loss down?

    python3 scripts/overfit_probe_torch.py --data studies/cls_r4/data \
        --overfit 12 --steps 220 --probe_freq 15 --num_points 5000 \
        --small_text --text_init studies/attrib_r5/text_init.npz \
        --eos_coef 0.02 --num_target 32 --out studies/attrib_r5_torch_b12_nt32

Takes `--overfit` unaugmented samples of the train scenes (the test split
of `make_trainval_root`, sr3d rows, GT-proposal boxes) as one collated
batch and runs the port's `Trainer` on it for `--steps` steps at a
constant learning rate (scripts/train_test_cls.sh's three AdamW groups,
the text group trainable). Every `--probe_freq` steps and after the last,
an eval-mode forward is reduced by `train/study.py:probe_row` and appended
to `<out>/probe.jsonl`; `<out>/invocation.json` records the command. The
last line printed is one JSON object: the steps taken, the training
seconds a step, and the kernel launches of the training steps and of the
probe forwards. When `--data` holds no data root, one is written with
`make_rich_scannet`'s study defaults (96 + 24 scenes, 5 objects, 20,000
points a scan). Runs on `cuda` unless `--device cpu`.
"""

import argparse
import json
import os
import os.path as osp
import sys
import time

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=osp.join(REPO, "studies", "cls_r4",
                                               "data"))
    ap.add_argument("--out", default=osp.join(REPO, "studies",
                                              "attrib_r5_torch"))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--overfit", type=int, default=24)
    ap.add_argument("--num_points", type=int, default=20000)
    ap.add_argument("--probe_freq", type=int, default=25)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lr_backbone", type=float, default=1e-3)
    ap.add_argument("--lr_text", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small_text", action="store_true",
                    help="the 4-layer, 128-d text encoder")
    ap.add_argument("--num_target", type=int, default=256,
                    help="the number of queries")
    ap.add_argument("--eos_coef", type=float, default=0.1,
                    help="the soft-token no-object weight")
    ap.add_argument("--text_init", default=None,
                    help="npz of a text trunk under flax paths to start "
                    "the text encoder from")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    with open(osp.join(args.out, "invocation.json"), "w") as f:
        json.dump({"argv": [sys.argv[0], *(sys.argv[1:] if argv is None
                                           else argv)],
                   "args": vars(args)}, f, indent=1)

    import numpy as np
    import torch

    from butd_detr_tpu_torch.config import Config
    from butd_detr_tpu_torch.convert import load_text_init
    from butd_detr_tpu_torch.data import collate, make_rich_scannet
    from butd_detr_tpu_torch.lang import (
        SimpleTokenizer,
        roberta_base_config,
        small_text_roberta_config,
    )
    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.predict import build_model
    from butd_detr_tpu_torch.train import INPUT_KEYS, TARGET_KEYS, Trainer
    from butd_detr_tpu_torch.train.study import (
        append_row,
        build_dataset,
        probe_row,
    )

    if not osp.exists(osp.join(args.data, "refer_it_3d", "sr3d.csv")):
        t0 = time.time()
        make_rich_scannet(args.data, n_train=96, n_val=24,
                          objects_per_scan=5, points_per_scan=20000)
        print(f"# wrote the data root {args.data} in {time.time() - t0:.0f}s",
              flush=True)

    cfg = Config(
        dataset=["sr3d"], test_dataset="sr3d", data_root=args.data,
        use_color=True, butd=False, butd_cls=True, self_attend=True,
        use_soft_token_loss=True, use_contrastive_align=True,
        batch_size=args.overfit, num_points=args.num_points,
        max_num_obj=16, max_det_boxes=16, max_text_len=32,
        lr=args.lr, lr_backbone=args.lr_backbone, weight_decay=5e-4,
        freeze_text_encoder=False, text_encoder_lr=args.lr_text,
        lr_decay_epochs=[10 ** 6],  # a constant learning rate
        num_target=args.num_target, eos_coef=args.eos_coef,
        log_dir=args.out)

    tok = SimpleTokenizer(max_len=cfg.max_text_len)
    ds = build_dataset(args.data, tok, "val", joint_det=False,
                       num_points=args.num_points, eval_train=True)
    batch_np = collate([ds[i] for i in range(args.overfit)])
    batch = {k: batch_np[k] for k in (*INPUT_KEYS, *TARGET_KEYS)
             if k in batch_np}

    roberta = (small_text_roberta_config() if args.small_text
               else roberta_base_config())
    t0 = time.time()
    trainer = Trainer(cfg, steps_per_epoch=10 ** 6,
                      model=build_model(cfg, roberta), device=args.device,
                      seed=args.seed)
    print(f"# trainer built in {time.time() - t0:.0f}s", flush=True)
    if args.text_init:
        load_text_init(args.text_init, trainer.model)
        print(f"# text_encoder initialized from {args.text_init}",
              flush=True)
    batch = trainer.to_device(batch)
    inputs = {k: batch[k] for k in INPUT_KEYS if k in batch}
    probe_path = osp.join(args.out, "probe.jsonl")
    cuda = trainer.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(trainer.device)

    def launches_since(before):
        return {k: v - before[k] for k, v in _cuda.LAUNCHES.items()}

    probe_launches = dict.fromkeys(_cuda.LAUNCHES, 0)
    probe_seconds, probes = 0.0, 0

    def run_probe(step):
        nonlocal probe_seconds, probes
        probes += 1
        sync()
        t = time.perf_counter()
        before = dict(_cuda.LAUNCHES)
        ep = trainer.eval_step(inputs, with_loss=False)
        for k, n in launches_since(before).items():
            probe_launches[k] += n
        preds = {
            prefix: (
                ep[f"{prefix}sem_cls_scores"].float().cpu().numpy(),
                torch.cat([ep[f"{prefix}center"], ep[f"{prefix}pred_size"]],
                          -1).float().cpu().numpy())
            for prefix in ("proposal_", "last_")}
        append_row(probe_row(preds, batch_np, step), probe_path)
        probe_seconds += time.perf_counter() - t

    start = dict(_cuda.LAUNCHES)
    sync()
    t0 = time.perf_counter()
    for step in range(args.steps):
        if step % args.probe_freq == 0:
            run_probe(step)
        metrics = trainer.train_step_on_device(batch)
        if step % 10 == 0:
            m = {k: round(float(v), 3) for k, v in metrics.items()}
            per = (time.perf_counter() - t0) / max(step, 1)
            print(f"step {step} {m} ({per:.2f}s/step)", flush=True)
    sync()
    seconds = time.perf_counter() - t0 - probe_seconds
    run_probe(args.steps)
    train_launches = {k: n - probe_launches[k]
                      for k, n in launches_since(start).items()}
    print(json.dumps({
        "steps": args.steps, "train_seconds": seconds,
        "seconds_per_step": seconds / max(args.steps, 1),
        "train_launches": train_launches, "probes": probes,
        "probe_launches": probe_launches,
        "finite": bool(np.isfinite([float(v) for v in metrics.values()])
                       .all()) if args.steps else True}), flush=True)


if __name__ == "__main__":
    main()

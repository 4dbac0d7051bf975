#!/usr/bin/env python3
"""Where does a study's grounding accuracy break? A diagnostic of one
checkpoint of the port's accuracy study.

    python3 scripts/diag_grounding_torch.py studies/cls_r5_nt32_torch \
        [--epoch 50] [--batch 8] [--small_text] [--device cuda] [--json PATH]

Restores `<study>/log/ckpt_epoch_{E}.pth` (the latest without `--epoch`)
into the model of `<study>/log/config.json`, runs one eval-mode forward of
the first `--batch` train-scene samples (unaugmented, the test split of
`make_trainval_root`) and reports per prefix:
  * the matched query's span CE (-log of its probability mass on the root
    target's span bins) beside the mean no-object CE over all queries:
    eos collapse shows as a matched CE far above an eos CE near 0;
  * per sample: the Hungarian-matched query q of the root target (the
    port's matcher), its span mass, its argmax bin against the span bins
    (does it land on the true bin, or on the no-object bin 255?), the rank
    of q by span score, q's box IoU with the target, how many queries pass
    the GT evaluator's IoU > 0.25 gate, the evaluator's chosen query and
    whether its snap hits the target.
`--small_text` when the study ran with it (a checkpoint below 5,000 points
is taken as `--tiny`). Runs on `cuda` unless `--device cpu`. The last line
printed is one JSON object with the per-prefix summary (also written to
`--json PATH`).
"""

import argparse
import dataclasses
import json
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("study")
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--small_text", action="store_true",
                    help="the study ran with --small_text")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", default=None,
                    help="also write the summary to this path")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from butd_detr_tpu_torch.config import Config
    from butd_detr_tpu_torch.data import collate
    from butd_detr_tpu_torch.lang import (
        SimpleTokenizer,
        roberta_base_config,
        small_text_roberta_config,
        tiny_roberta_config,
    )
    from butd_detr_tpu_torch.losses.boxes import (
        box_cxcyczwhd_to_xyzxyz,
        pairwise_iou3d,
    )
    from butd_detr_tpu_torch.losses.matcher import hungarian_match
    from butd_detr_tpu_torch.predict import build_model
    from butd_detr_tpu_torch.train import INPUT_KEYS, Trainer, \
        criterion_config
    from butd_detr_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
    )
    from butd_detr_tpu_torch.train.study import TINY_NPOINTS, build_dataset

    log_dir = osp.join(args.study, "log")
    with open(osp.join(log_dir, "config.json")) as f:
        raw = json.load(f)
    fields = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in raw.items() if k in fields})

    ds = build_dataset(osp.join(args.study, "data"),
                       SimpleTokenizer(max_len=cfg.max_text_len), "val",
                       butd_cls=cfg.butd_cls, joint_det=False,
                       num_points=cfg.num_points, eval_train=True)
    B = args.batch
    batch = collate([ds[i] for i in range(B)])

    if cfg.num_points < 5000:
        model = build_model(cfg, tiny_roberta_config(), TINY_NPOINTS)
    else:
        model = build_model(cfg, small_text_roberta_config()
                            if args.small_text else roberta_base_config())
    trainer = Trainer(cfg, model=model, device=args.device)
    ckpt = (osp.join(log_dir, f"ckpt_epoch_{args.epoch}.pth")
            if args.epoch is not None else latest_checkpoint(log_dir))
    epoch = load_checkpoint(ckpt, trainer) - 1
    print(f"# restored {ckpt} (epoch {epoch}, step {trainer.step})")

    ep = trainer.eval_step({k: batch[k] for k in INPUT_KEYS if k in batch},
                           with_loss=False)
    dev = trainer.device
    pmap = torch.as_tensor(batch["positive_map"], device=dev).float()
    gt = torch.as_tensor(np.concatenate(
        [batch["center_label"][..., :3], batch["size_gts"]], -1),
        device=dev).float()
    mask = torch.as_tensor(batch["box_label_mask"], device=dev)
    all_boxes = batch["all_bboxes"]
    all_mask = batch["all_bbox_label_mask"].astype(bool)
    crit = criterion_config(cfg)
    summary = {"checkpoint": ckpt, "epoch": epoch, "step": trainer.step,
               "batch": B}

    for prefix in ("proposal_", "last_"):
        logits = ep[f"{prefix}sem_cls_scores"].float()
        pred_t = torch.cat([ep[f"{prefix}center"], ep[f"{prefix}pred_size"]],
                           -1).float()
        assignment = hungarian_match(
            logits, pred_t, pmap, gt, mask, crit.cost_class,
            crit.cost_bbox, crit.cost_giou).cpu().numpy()
        probs = torch.softmax(logits, -1).cpu().numpy()
        logp = torch.log_softmax(logits, -1).cpu().numpy()
        pred = pred_t.cpu().numpy()
        corners = lambda x: box_cxcyczwhd_to_xyzxyz(  # noqa: E731
            torch.from_numpy(np.ascontiguousarray(x, np.float32)))
        iou_all = pairwise_iou3d(corners(all_boxes), corners(pred))[0] \
            .numpy()
        iou_all = np.where(all_mask[:, :, None], iou_all, 0.0)
        is_correct = iou_all.max(axis=1) > 0.25  # (B, Q)
        pm, gtn = pmap.cpu().numpy(), gt.cpu().numpy()

        ce_m, rows = [], []
        for b in range(B):
            q = int(assignment[b, 0])
            span = np.nonzero(pm[b, 0])[0]
            mass = float(probs[b, q, span].sum())
            ce_m.append(-np.log(max(mass, 1e-9)))
            sc = probs[b] @ pm[b, 0]
            iou_t = pairwise_iou3d(corners(gtn[b, :1]),
                                   corners(pred[b, q:q + 1]))[0]
            top = int((sc * is_correct[b]).argmax())
            snap = int(np.where(all_mask[b], iou_all[b, :, top],
                                -1.0).argmax())
            argmax = int(probs[b, q].argmax())
            rows.append(dict(
                q=q, p_span=round(mass, 3), argmax_bin=argmax,
                span=span.tolist(), argmax_on_span=argmax in span,
                rank_of_q=int((sc > sc[q]).sum()),
                iou_vs_target=round(float(iou_t.ravel()[0]), 3),
                q_is_correct=bool(is_correct[b, q]),
                n_correct=int(is_correct[b].sum()), top_query=top,
                top_is_q=top == q,
                hit=bool((all_boxes[b, snap] == gtn[b, 0]).all())))
        eos = float(-logp[..., -1].mean())
        print(f"== {prefix} matched-CE {np.mean(ce_m):.3f}  "
              f"unmatched(eos)-CE {eos:.3f}")
        for row in rows:
            print("  ", row)
        summary[prefix] = dict(
            matched_ce=float(np.mean(ce_m)), eos_ce=eos,
            argmax_on_span=sum(r["argmax_on_span"] for r in rows) / B,
            argmax255=sum(r["argmax_bin"] == probs.shape[-1] - 1
                          for r in rows) / B,
            hits=sum(r["hit"] for r in rows) / B)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()

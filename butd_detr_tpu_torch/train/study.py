"""The accuracy study of the port: a learnable synthetic grounding task,
the harness that trains and evaluates on it, and the probe metrics.

Counterpart of the JAX package's study tooling, which lives in its
scripts (`scripts/accuracy_study.py`, `scripts/probe_common.py`); the port
keeps its own copy here, and `scripts/accuracy_study_torch.py`,
`scripts/overfit_probe_torch.py` and `scripts/diag_grounding_torch.py` are
its command lines.
  * `build_dataset`: the probe's dataset (sr3d rows of a
    `make_rich_scannet` root, plus scannet x10 prompts under `joint_det`);
  * `probe_row`: reduces a forward's logits and boxes to the probe's
    numbers with scipy's Hungarian matching under the reference's matcher
    weights (class 1, L1 0, GIoU 2), independent of the port's matcher;
  * `StudyTrainTester`: `TrainTester` on the study's data root, with the
    tiny or small text trunk, `--text_init` and one `history.jsonl` row
    an evaluation;
  * `study_arg_parser` / `study_config` / `main`: the study's command line,
    the flags of the JAX package's `accuracy_study.py` plus `--device`.

Everything runs on `cuda` unless the caller passes `--device cpu`.
"""

import argparse
import json
import os
import os.path as osp
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.convert import load_text_init
from butd_detr_tpu_torch.data import (
    JointGroundingDataset,
    load_scans_parallel,
    make_rich_scannet,
    make_trainval_root,
)
from butd_detr_tpu_torch.lang import (
    SimpleTokenizer,
    small_text_roberta_config,
    tiny_roberta_config,
)
from butd_detr_tpu_torch.losses.boxes import (
    box_cxcyczwhd_to_xyzxyz,
    generalized_box_iou3d,
    pairwise_iou3d,
)
from butd_detr_tpu_torch.predict import build_model
from butd_detr_tpu_torch.train.checkpoint import latest_checkpoint
from butd_detr_tpu_torch.train.harness import TrainTester

# a cut-down model for the CPU (`--tiny`)
TINY_NPOINTS = (256, 128, 64, 32)
TINY_SCAN_POINTS = 1500
TINY_NUM_POINTS = 1024


def read_scan_ids(root: str, split: str) -> List[str]:
    """The scan ids listed in `meta_data/scannetv2_{split}.txt`."""
    with open(osp.join(root, "meta_data", f"scannetv2_{split}.txt")) as f:
        return [line.strip() for line in f if line.strip()]


def build_dataset(root: str, tok, split: str, butd_cls: bool = True,
                  joint_det: bool = True, num_points: int = 50000,
                  eval_train: bool = False):
    """The probe's dataset: the train scans of `root`, sr3d rows (plus
    scannet detection prompts x10 on the train split under `joint_det`),
    GT-proposal boxes under `butd_cls`; with `eval_train` the test split
    lists the train scans (`make_trainval_root`)."""
    scans = load_scans_parallel(
        read_scan_ids(root, "train"), osp.join(root, "scans"),
        osp.join(root, "meta_data"), num_workers=1, keep_points=num_points)
    ddict = {"sr3d": 1}
    if joint_det and split == "train":
        ddict["scannet"] = 10
    return JointGroundingDataset(
        split=split, dataset_dict=ddict, test_dataset="sr3d",
        data_path=make_trainval_root(root) if eval_train else root,
        scans=scans, tokenizer=tok, use_color=True, butd=not butd_cls,
        butd_cls=butd_cls, butd_gt=False,
        detect_intermediate=joint_det and split == "train",
        max_text_len=32, max_num_obj=16, max_det_boxes=16)


def probe_row(pred_by_prefix: Dict, batch_np: Dict, step: int) -> Dict:
    """pred_by_prefix: {prefix: (logits (B, Q, C), boxes (B, Q, 6)
    cxcyczwhd)} as numpy; batch_np: a collated batch. Per prefix:
      matched_ce: -log of the Hungarian-matched query's probability mass
        on the root target's span bins (mean over the batch);
      eos_ce: mean -log p(no-object bin) over every query;
      p_span: that matched query's span mass;
      argmax255: the share of matched queries whose argmax is the
        no-object bin;
      acc: the GT evaluator's exact-match hit rate (the top span-scored
        query among those within IoU 0.25 of a scene box, snapped to its
        nearest scene box)."""
    def corners(x):
        return box_cxcyczwhd_to_xyzxyz(torch.from_numpy(
            np.ascontiguousarray(x, np.float32)))

    pmap = np.asarray(batch_np["positive_map"], np.float32)
    gt = np.concatenate(
        [batch_np["center_label"][..., :3], batch_np["size_gts"]], -1)
    all_boxes = np.asarray(batch_np["all_bboxes"], np.float32)
    all_mask = np.asarray(batch_np["all_bbox_label_mask"], bool)
    B = pmap.shape[0]

    row = {"step": step}
    for prefix, (logits, pred) in pred_by_prefix.items():
        logits = np.asarray(logits, np.float32)
        pred = np.asarray(pred, np.float32)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        logp = np.log(np.maximum(probs, 1e-12))

        ce_m, p_span, arg255, hits = [], [], 0, 0
        for b in range(B):
            valid = np.asarray(batch_np["box_label_mask"][b], bool)
            tgt = gt[b][valid]
            tpm = pmap[b][valid]
            cost_class = -(probs[b] @ tpm.T)
            giou = generalized_box_iou3d(corners(pred[b]),
                                         corners(tgt)).numpy()
            # the reference matcher's weights: class 1, L1 0, GIoU 2
            qi, ti = linear_sum_assignment(1 * cost_class + 2 * -giou)
            q = int(qi[list(ti).index(0)])
            span = np.nonzero(pmap[b, 0])[0]
            mass = float(probs[b, q, span].sum())
            ce_m.append(-np.log(max(mass, 1e-9)))
            p_span.append(mass)
            arg255 += int(probs[b, q].argmax() == probs.shape[-1] - 1)

            iou_all = pairwise_iou3d(corners(all_boxes[b]),
                                     corners(pred[b]))[0].numpy()
            iou_all = np.where(all_mask[b][:, None], iou_all, 0.0)
            correct = iou_all.max(0) > 0.25
            sc = (probs[b] @ pmap[b, 0]) * correct
            top = int(sc.argmax())
            snap = int(np.where(all_mask[b], iou_all[:, top], -1).argmax())
            hits += int((all_boxes[b, snap] == gt[b, 0]).all())

        row[f"{prefix}matched_ce"] = round(float(np.mean(ce_m)), 3)
        row[f"{prefix}eos_ce"] = round(float(-logp[..., -1].mean()), 4)
        row[f"{prefix}p_span"] = round(float(np.mean(p_span)), 4)
        row[f"{prefix}argmax255"] = arg255 / B
        row[f"{prefix}acc"] = round(hits / B, 3)
    return row


def append_row(row: Dict, out_path: str) -> None:
    with open(out_path, "a") as f:
        f.write(json.dumps(row) + "\n")
    print("PROBE", json.dumps(row), flush=True)


class StudyTrainTester(TrainTester):
    """`TrainTester` on the study's data root.

    args: the study's parsed flags (`study_arg_parser`); root: its data
    root. Evaluates the train scenes through `make_trainval_root` under
    `--eval_train_split`, builds the tiny (`--tiny`) or small
    (`--small_text`) text trunk, loads `--text_init` after the pretrained
    sources, and appends one row an evaluation to `<out>/history.jsonl`."""

    def __init__(self, cfg: Config, args, root: str, device=None):
        super().__init__(cfg, device=device)
        self.args = args
        self.root = root
        self.history: List[Dict] = []

    def get_datasets(self):
        c, root = self.cfg, self.root
        scans = load_scans_parallel(
            read_scan_ids(root, "train") + read_scan_ids(root, "val"),
            osp.join(root, "scans"), osp.join(root, "meta_data"),
            num_workers=c.num_workers or 1, keep_points=c.num_points)
        # the spans were made with SimpleTokenizer: tokenize with it
        tok = SimpleTokenizer(max_len=c.max_text_len)
        ddict = {"sr3d": 1}
        if c.joint_det:
            ddict["scannet"] = 10
        common = dict(
            dataset_dict=ddict, test_dataset="sr3d", data_path=root,
            scans=scans, tokenizer=tok, use_color=c.use_color, butd=c.butd,
            butd_cls=c.butd_cls, butd_gt=c.butd_gt,
            detect_intermediate=c.detect_intermediate,
            max_text_len=c.max_text_len, max_num_obj=c.max_num_obj,
            max_det_boxes=c.max_det_boxes)
        train_ds = JointGroundingDataset(split="train", **common)
        if self.args.eval_train_split:
            common["data_path"] = make_trainval_root(root)
        return train_ds, JointGroundingDataset(split="val", **common)

    def _roberta_config(self):
        if self.args.tiny:
            return tiny_roberta_config()
        if self.args.small_text:
            return small_text_roberta_config()
        return super()._roberta_config()

    def get_model(self):
        if self.args.tiny:
            return build_model(self.cfg, self._roberta_config(),
                               backbone_npoints=TINY_NPOINTS)
        return super().get_model()

    def init_pretrained(self, trainer):
        report = super().init_pretrained(trainer)
        if self.args.text_init:
            load_text_init(self.args.text_init, trainer.model)
            report["text_init"] = "loaded"
            self.logger.info(
                f"text_encoder initialized from {self.args.text_init}")
        return report

    def evaluate_one_epoch(self, epoch, test_loader, trainer):
        ev = super().evaluate_one_epoch(epoch, test_loader, trainer)
        row = {"epoch": epoch, "step": int(trainer.step)}
        if self.cfg.butd_cls:
            # the GT evaluator: exact-match accuracy by (prefix, mode)
            for mode in ("bbs", "bbf"):
                for prefix in ("last_", "proposal_"):
                    row[f"acc_{prefix}{mode}"] = round(
                        ev.accuracy(prefix, mode), 4)
        else:
            for t in (0.25, 0.5):
                for k in (1, 5):
                    for mode in ("bbs", "bbf"):
                        row[f"acc@{t}_top{k}_{mode}"] = round(
                            ev.accuracy("last_", t, k, mode), 4)
        self.history.append(row)
        self.logger.info(f"STUDY {json.dumps(row)}")
        with open(osp.join(self.args.out, "history.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")
        return ev


def study_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Train and evaluate the port on a learnable synthetic "
        "grounding dataset (make_rich_scannet), one history.jsonl row an "
        "evaluation.")
    ap.add_argument("--out", default="accuracy_study")
    ap.add_argument("--n_train", type=int, default=96)
    ap.add_argument("--n_val", type=int, default=24)
    ap.add_argument("--objects", type=int, default=5)
    ap.add_argument("--scan_points", type=int, default=20000)
    ap.add_argument("--num_points", type=int, default=None,
                    help="model input cloud size (default 50000; the scans "
                    "carry --scan_points, so more points repeat some)")
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--val_freq", type=int, default=10)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--tiny", action="store_true",
                    help="a tiny model and cloud (1024 points, batch 8, "
                    "one encoder and one decoder layer, 16 queries), one "
                    "device; with --device cpu a CPU smoke run")
    ap.add_argument("--trainable_text", action="store_true",
                    help="train the text encoder (text_encoder_lr 1e-4)")
    ap.add_argument("--small_text", action="store_true",
                    help="a 4-layer, 128-d text encoder "
                    "(small_text_roberta_config) instead of roberta-base's "
                    "shape")
    ap.add_argument("--num_target", type=int, default=None,
                    help="the number of queries (default 256)")
    ap.add_argument("--eos_coef", type=float, default=None,
                    help="the soft-token no-object weight (default 0.1)")
    ap.add_argument("--text_init", default=None,
                    help="npz of a text trunk under flax paths "
                    "(scripts/pretrain_text.py) to start the text encoder "
                    "from")
    ap.add_argument("--freeze_text", action="store_true",
                    help="keep the text trunk frozen (with --text_init)")
    ap.add_argument("--eval_train_split", action="store_true",
                    help="evaluate on the TRAIN scenes, unaugmented, "
                    "instead of the held-out val scenes")
    ap.add_argument("--joint_det", action="store_true",
                    help="mix scannet detection prompts x10 into training, "
                    "with their anchors as targets (detect_intermediate)")
    ap.add_argument("--lr_decay_epochs", type=int, nargs="*", default=None,
                    help="step-decay milestones (x0.1); default 280 340")
    ap.add_argument("--resume", default=None,
                    help="a checkpoint (ckpt_epoch_E.pth), or a directory "
                    "whose latest checkpoint is taken, to continue from: "
                    "parameters, optimizer, step, generator and epoch")
    ap.add_argument("--butd_cls", action="store_true",
                    help="the GT-proposal classification setup "
                    "(scripts/train_test_cls.sh)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def study_config(args, root: str) -> Config:
    """The harness's Config for the study's flags."""
    resume = args.resume
    if resume and osp.isdir(resume):
        resume = latest_checkpoint(resume)
        if resume is None:
            raise FileNotFoundError(f"no checkpoint under {args.resume}")
    kw = dict(
        dataset=["sr3d"], test_dataset="sr3d", data_root=root,
        use_color=True, butd=not args.butd_cls, butd_cls=args.butd_cls,
        self_attend=True, use_soft_token_loss=True,
        use_contrastive_align=True,
        batch_size=8 if args.tiny else args.batch,
        num_points=(TINY_NUM_POINTS if args.tiny
                    else args.num_points or 50000),
        max_num_obj=16, max_det_boxes=16, max_text_len=32,
        max_epoch=args.epochs, val_freq=args.val_freq, print_freq=10,
        num_workers=0 if args.tiny else 2, dp=1,
        log_dir=osp.join(args.out, "log"))
    if args.butd_cls:  # scripts/train_test_cls.sh's rates
        kw.update(lr=1e-4, lr_backbone=1e-3, weight_decay=5e-4)
    if args.trainable_text and not args.freeze_text:
        kw.update(freeze_text_encoder=False, text_encoder_lr=1e-4)
    if args.lr_decay_epochs:
        kw.update(lr_decay_epochs=list(args.lr_decay_epochs))
    if args.joint_det:
        kw.update(joint_det=True, detect_intermediate=True)
    if args.tiny:
        kw.update(num_encoder_layers=1, num_decoder_layers=1, num_target=16)
    elif args.num_target is not None:
        kw.update(num_target=args.num_target)
    if resume:
        kw.update(checkpoint_path=resume)
    if args.eos_coef is not None:
        kw.update(eos_coef=args.eos_coef)
    return Config(**kw)


def main(argv: Optional[List[str]] = None) -> StudyTrainTester:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = study_arg_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    with open(osp.join(args.out, "invocation.json"), "a") as f:
        f.write(json.dumps({"argv": [sys.argv[0], *argv], "args": vars(args),
                            "cwd": os.getcwd()}) + "\n")

    root = osp.join(args.out, "data")
    if not osp.exists(osp.join(root, "refer_it_3d", "sr3d.csv")):
        t0 = time.time()
        make_rich_scannet(
            root, n_train=args.n_train, n_val=args.n_val,
            objects_per_scan=args.objects,
            points_per_scan=(TINY_SCAN_POINTS if args.tiny
                             else args.scan_points))
        print(f"generated {args.n_train}+{args.n_val} scenes in "
              f"{time.time() - t0:.0f}s", flush=True)

    tester = StudyTrainTester(study_config(args, root), args, root,
                              device=args.device)
    tester.main()
    print(json.dumps(tester.history, indent=1))
    return tester


__all__ = ["StudyTrainTester", "append_row", "build_dataset", "main",
           "probe_row", "read_scan_ids", "study_arg_parser", "study_config"]

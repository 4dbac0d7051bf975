#!/usr/bin/env python
"""Ground an utterance to 3D boxes in a ScanNet scene with the PyTorch +
CUDA port of BUTD-DETR.

The port's counterpart of `predict.py`, with the same flags, `--device`
in place of `--platform`:

    python predict_torch.py --checkpoint_path logs/ckpt_epoch_40.pth \\
        --data_root ./data --scan_id scene0025_00 \\
        --utterance "the chair near the table" --phrase chair \\
        --use_color --butd_cls --self_attend --use_contrastive_align

reads the scan from `--data_root` (`data/scan.py:Scan`), loads the weights
of `--checkpoint_path` (a `.pth` file: the port's `ckpt_epoch_E.pth` or a
reference checkpoint) with `GroundingPredictor.from_checkpoint` and prints
the top-k grounded boxes (cxcyczwhd) and their scores as one JSON object.
Model flags (`--butd_cls`, `--use_color`, ...) are those of
`train_torch.py`. Runs on `cuda` unless `--device cpu`. Imports only the
port.
"""

import argparse
import json
import os
import sys


def main(argv=None):
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda",
                        help="the torch device to run on (cuda or cpu)")
    parser.add_argument("--scan_id", required=True)
    parser.add_argument("--utterance", required=True)
    parser.add_argument("--phrase", default=None,
                        help="target phrase inside the utterance "
                             "(default: the whole utterance)")
    parser.add_argument("--mode", default="bbf", choices=["bbf", "bbs"])
    parser.add_argument("--top_k", type=int, default=10)
    parser.add_argument("--backbone_npoints", type=int, nargs=4,
                        default=(2048, 1024, 512, 256),
                        help="SA sampling schedule (small scenes/tests)")
    parser.add_argument("--tiny_roberta", action="store_true",
                        help="tiny random-vocab text trunk (tests)")
    args, rest = parser.parse_known_args(argv)

    import numpy as np

    from butd_detr_tpu_torch.config import parse_config
    from butd_detr_tpu_torch.data.scan import Scan
    from butd_detr_tpu_torch.lang import (
        SimpleTokenizer,
        get_tokenizer,
        roberta_base_config,
        tiny_roberta_config,
    )
    from butd_detr_tpu_torch.predict import GroundingPredictor

    cfg = parse_config(rest)
    scan = Scan(args.scan_id, f"{cfg.data_root}/scans",
                meta_dir=f"{cfg.data_root}/meta_data")
    cloud = np.concatenate([scan.orig_pc, scan.color], axis=1)
    if args.tiny_roberta:
        roberta = tiny_roberta_config()
        tokenizer = SimpleTokenizer(max_len=cfg.max_text_len)
    else:
        roberta = roberta_base_config()
        tokenizer = get_tokenizer(max_len=cfg.max_text_len)
    pred = GroundingPredictor.from_checkpoint(
        cfg, cfg.checkpoint_path, tokenizer, roberta_config=roberta,
        backbone_npoints=tuple(args.backbone_npoints), device=args.device)
    print(f"predict_torch: compute dtype {pred.model.dtype} "
          f"(--use_bf16 {cfg.use_bf16})", file=sys.stderr)
    out = pred.predict(cloud, args.utterance, phrase=args.phrase,
                       mode=args.mode, top_k=args.top_k)
    print(json.dumps({
        "scan_id": args.scan_id,
        "utterance": args.utterance,
        "phrase": args.phrase,
        "mode": args.mode,
        "boxes_cxcyczwhd": out["boxes"].tolist(),
        "scores": out["scores"].tolist(),
    }))


if __name__ == "__main__":
    sys.exit(main())

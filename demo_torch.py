#!/usr/bin/env python
"""Quickstart of the PyTorch + CUDA port: synthetic mini-ScanNet -> train
-> predict.

The port's counterpart of `demo.py`, with `--device` in place of
`--platform`. No ScanNet download is needed: it writes a small
schema-exact dataset (8 scans of 1,500 points), trains the tiny
configuration for `--epochs` epochs through the port's `TrainTester`
(checkpoint and grounding evaluation included), then grounds "the chair
near the table" with `GroundingPredictor` and prints the top boxes and
`[demo] OK`. Runs on `cuda` unless `--device cpu`. Imports only the port.

    python demo_torch.py                  # on a GPU host
    python demo_torch.py --device cpu     # anywhere, the plain versions
"""

import argparse
import json
import os.path as osp
import sys
import tempfile


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="the torch device to run on (cuda or cpu)")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--epochs", type=int, default=1)
    args = parser.parse_args(argv)

    import numpy as np

    from butd_detr_tpu_torch.config import Config
    from butd_detr_tpu_torch.data import JointGroundingDataset
    from butd_detr_tpu_torch.data.scan import Scan, load_scans_parallel
    from butd_detr_tpu_torch.data.synthetic import make_fake_scannet
    from butd_detr_tpu_torch.lang import SimpleTokenizer, tiny_roberta_config
    from butd_detr_tpu_torch.predict import (
        GroundingPredictor,
        build_model,
        resolve_device,
    )
    from butd_detr_tpu_torch.train.harness import TrainTester

    device = resolve_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="butd_demo_")
    data_root = osp.join(work, "data")
    print(f"[demo] workdir: {work}")
    make_fake_scannet(
        data_root,
        scan_ids=[f"scene{i:04d}_00" for i in range(8)],
        points_per_scan=1500,
    )
    roberta = tiny_roberta_config()
    npoints = (64, 32, 16, 8)

    cfg = Config(
        dataset=["sr3d"], test_dataset="sr3d", data_root=data_root,
        batch_size=8, num_encoder_layers=1, num_decoder_layers=1,
        num_target=16, max_text_len=12, num_points=256, use_color=True,
        max_num_obj=8, max_det_boxes=8,
        use_soft_token_loss=True, use_contrastive_align=True,
        self_attend=True, butd_cls=True,
        max_epoch=args.epochs, val_freq=args.epochs, print_freq=1,
        num_workers=0, log_dir=osp.join(work, "log"),
    )

    class DemoTrainTester(TrainTester):
        KEEP_POINTS = 256

        def get_datasets(self):
            with open(
                osp.join(data_root, "meta_data", "scannetv2_train.txt")
            ) as f:
                ids = [line.strip() for line in f if line.strip()]
            scans = load_scans_parallel(
                ids, osp.join(data_root, "scans"),
                osp.join(data_root, "meta_data"),
                num_workers=1, keep_points=self.KEEP_POINTS,
            )
            tok = SimpleTokenizer(vocab_size=roberta.vocab_size,
                                  max_len=cfg.max_text_len)
            common = dict(
                dataset_dict={"sr3d": 1}, test_dataset="sr3d",
                data_path=data_root, scans=scans, tokenizer=tok,
                use_color=True, butd_cls=True,
                max_text_len=cfg.max_text_len,
                max_num_obj=cfg.max_num_obj,
            )
            return (
                JointGroundingDataset(split="train", **common),
                JointGroundingDataset(split="val", **common),
            )

        def _roberta_config(self):
            return roberta

        def init_pretrained(self, trainer):
            return {}  # random weights: no pretrained source fits

        def get_model(self):
            return build_model(cfg, roberta, backbone_npoints=npoints)

    print("[demo] training ...")
    trainer = DemoTrainTester(cfg, device=device).main()
    print(f"[demo] trained {trainer.step} steps; checkpoint in "
          f"{cfg.log_dir}")

    print("[demo] inference ...")
    scan = Scan("scene0000_00", osp.join(data_root, "scans"),
                meta_dir=osp.join(data_root, "meta_data"),
                keep_points=256)
    cloud = np.concatenate([scan.orig_pc, scan.color], axis=1)
    pred = GroundingPredictor(
        cfg, SimpleTokenizer(vocab_size=roberta.vocab_size,
                             max_len=cfg.max_text_len),
        trainer.model.state_dict(), roberta_config=roberta,
        backbone_npoints=npoints, device=device,
    )
    out = pred.predict(
        cloud, "the chair near the table", phrase="chair", top_k=3,
    )
    if not (np.isfinite(out["boxes"]).all()
            and np.isfinite(out["scores"]).all()):
        raise SystemExit("[demo] non-finite boxes or scores")
    print("[demo] top boxes (cxcyczwhd):")
    print(json.dumps({
        "boxes": np.round(out["boxes"], 3).tolist(),
        "scores": np.round(out["scores"], 4).tolist(),
    }, indent=2))
    print("[demo] OK")


if __name__ == "__main__":
    sys.exit(main())

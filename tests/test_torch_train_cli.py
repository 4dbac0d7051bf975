"""The port's training slice end to end on the CPU, the way a user starts
it: `TrainTester.main` through the real `get_datasets` and `get_loaders`
(`JointGroundingDataset` from a `make_fake_scannet` root, joint detection
prompts mixed in, 2 spawned loader workers), one training epoch, a
checkpoint and the evaluation epochs; only the model is the tests' small
one. Again with `--use_multiview` (the port's `make_fake_multiview`
features, 128 a point) and the profiler window (`--profile_dir`). Also
`train_torch.py --help` and `prepare_data_torch.py --help`.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from butd_detr_tpu_torch.config import parse_config
from butd_detr_tpu_torch.data import (
    load_scan_cache,
    make_fake_multiview,
    make_fake_scannet,
    save_scan_cache,
)
from butd_detr_tpu_torch.lang import RobertaConfig
from butd_detr_tpu_torch.predict import build_model
from butd_detr_tpu_torch.train import TrainTester

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# joint_det raises max_text_len to 128: position embeddings for 128 + 2
ROBERTA = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=96,
               max_position_embeddings=132)
NPOINTS = (64, 32, 16, 8)
# the flags of scripts/train_test_cls.sh at the tests' width and batch
FLAGS = ["--num_decoder_layers", "2", "--use_color", "--weight_decay",
         "0.0005", "--lr_backbone", "1e-3", "--lr", "1e-4", "--dataset",
         "sr3d", "--test_dataset", "sr3d", "--detect_intermediate",
         "--joint_det", "--use_soft_token_loss", "--use_contrastive_align",
         "--butd_cls", "--self_attend", "--batch_size", "4",
         "--max_epoch", "1", "--val_freq", "1", "--num_workers", "2",
         "--print_freq", "1", "--num_target", "16", "--num_encoder_layers",
         "1", "--max_num_obj", "8", "--max_det_boxes", "8", "--num_points",
         "256", "--no-backbone_bf16", "--attn_precise"]


class SmallModelTester(TrainTester):
    """Everything of the harness but the model, which is the tests' small
    one; the evaluators are kept for the test to read."""

    evaluators = None

    def _roberta_config(self):
        return RobertaConfig(**ROBERTA)

    def get_model(self):
        return build_model(self.cfg, self._roberta_config(), NPOINTS)

    def evaluate_one_epoch(self, epoch, test_loader, trainer):
        ev = super().evaluate_one_epoch(epoch, test_loader, trainer)
        self.evaluators.append(ev)
        return ev


def test_train_and_evaluate_from_a_scannet_root(tmp_path):
    root = make_fake_scannet(str(tmp_path / "data"), points_per_scan=600)
    for split in ("train", "val"):  # caches at the model's 256 points
        save_scan_cache(os.path.join(root, f"{split}_v3scans.pkl"), split,
                        root, num_workers=1, keep_points=256)
    log_dir = tmp_path / "log"
    cfg = parse_config(FLAGS + [
        "--data_root", root, "--log_dir", str(log_dir),
        "--roberta_checkpoint", str(tmp_path / "none.pth")])
    assert cfg.max_text_len == 128 and cfg.num_workers == 2
    tester = SmallModelTester(cfg, device="cpu")
    tester.evaluators = []
    trainer = tester.main()

    # 2 sr3d rows + 10 detection prompts a scene: 22 samples, 5 steps of 4
    assert trainer.step == 5
    assert (log_dir / "ckpt_epoch_1.pth").is_file()
    text = (log_dir / "log.txt").read_text()
    losses = [line for line in text.splitlines() if "Train: [1][" in line]
    assert len(losses) == 5
    for line in losses:
        fields = line.split("] ", 2)[-1].split()
        values = dict(zip(fields[::2], map(float, fields[1::2])))
        assert "loss" in values and all(map(math.isfinite, values.values()))
    stats = [json.loads(line.split("epoch stats ", 1)[1])
             for line in text.splitlines() if "epoch stats " in line]
    assert [s["phase"] for s in stats] == ["train", "eval", "eval"]
    assert stats[0]["batches"] == 5 and stats[0]["scenes"] == 20
    assert len(stats[0]["batch_seconds"]) == 5
    assert 0 <= stats[0]["loader_wait_share"] <= 1
    assert stats[1]["scenes"] == 2 and stats[1]["batches"] == 1
    assert stats[0]["peak_memory_bytes"] is None  # no card here

    assert len(tester.evaluators) == 2  # the val_freq epoch and the last
    for ev in tester.evaluators:
        for p in tester.prefixes():
            for m in ("bbs", "bbf"):
                assert ev.gts[(p, m)] == 2.0
                assert 0.0 <= ev.accuracy(p, m) <= 1.0
    assert "last_ Box given span (contrastive) Acc:" in text
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


def test_train_with_multiview_features_and_the_profiler_window(tmp_path):
    root = make_fake_scannet(str(tmp_path / "data"), points_per_scan=600)
    scans = {}
    for split in ("train", "val"):
        cache = os.path.join(root, f"{split}_v3scans.pkl")
        save_scan_cache(cache, split, root, num_workers=1, keep_points=256)
        scans.update(load_scan_cache(cache,
                                     meta_dir=os.path.join(root, "meta_data")))
    make_fake_multiview(root, scans, dim=128)
    log_dir, prof = tmp_path / "log", tmp_path / "prof"
    cfg = parse_config(FLAGS + [
        "--data_root", root, "--log_dir", str(log_dir),
        "--roberta_checkpoint", str(tmp_path / "none.pth"),
        "--use_multiview", "--profile_dir", str(prof), "--profile_steps",
        "2", "--max_epoch", "2", "--val_freq", "5", "--num_workers", "0"])
    assert cfg.input_feature_dim == 3 + 128
    tester = SmallModelTester(cfg, device="cpu")
    tester.evaluators = []
    trainer = tester.main()
    assert trainer.step == 10  # two epochs of 5 steps
    sa1 = trainer.model.backbone_net.sa1.mlp_module.layer0.conv.weight
    assert sa1.shape[1] == 3 + 3 + 128  # xyz and the 131 feature channels
    text = (log_dir / "log.txt").read_text()
    # batches 1 and 2 of the first epoch, once a run
    assert text.count(f"profiler trace (2 steps) written to {prof}") == 1
    trace = json.loads((prof / "trace_rank0.json").read_text())
    assert trace["traceEvents"]
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


@pytest.mark.parametrize("script", ["train_torch.py", "prepare_data_torch.py"])
def test_entry_point_help(script):
    out = subprocess.run([sys.executable, script, "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--data_root" in out.stdout and "--num_workers" in out.stdout
    if script == "train_torch.py":
        assert "torchrun --standalone --nproc_per_node" in out.stdout

"""Grounding from a weights file: `GroundingPredictor.from_checkpoint`
and the command line `predict_torch.py`, on the CPU.

- `from_checkpoint` restores exactly the tensors that `save_checkpoint`
  wrote, reads a reference-style `.pth` (a DDP `module.` prefix, an
  `argparse.Namespace` config) or a bare state dict, and raises
  `ValueError` on a directory (the JAX package's orbax format);
- `predict_torch.py --device cpu` prints the JSON object of `predict.py`
  with the boxes and scores of an in-process `from_checkpoint(...)
  .predict` on the same scan, exactly;
- `predict_torch.py` and the JAX package's `predict.py`, both driven
  in-process, load the same `.pth` (written by the port's
  `save_checkpoint` after a training step, so that BatchNorm's running
  statistics are not their initial values) under `--tiny_roberta
  --attn_precise --no-backbone_bf16`, on a `make_fake_scannet` scan (the
  predictors' answers recorded as the CLIs run): where the two top-k
  lists name the same query, the boxes agree within 1e-3 + 5e-3 * std
  (the bound of tests/test_torch_model.py); the scores agree within the
  same bound at every rank, and a rank held by different queries must be
  a near-tie (its JAX score within twice the bound of a neighbouring
  rank's), at most two such ranks. The JAX predictor divides in
  `contrast_scores` where the port multiplies by the f32 reciprocal
  (ROADMAP section 3), so the last bits of `bbf` scores may differ.
  Observed: the same queries in both modes, boxes within 1.4e-6, scores
  within 6e-8.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

import predict as jax_cli
import predict_torch as cli
from butd_detr_tpu.predict import GroundingPredictor as JGroundingPredictor
from butd_detr_tpu_torch.config import parse_config
from butd_detr_tpu_torch.data import SyntheticGroundingDataset, collate, \
    make_fake_scannet
from butd_detr_tpu_torch.data.scan import Scan
from butd_detr_tpu_torch.lang import SimpleTokenizer, tiny_roberta_config
from butd_detr_tpu_torch.predict import GroundingPredictor
from butd_detr_tpu_torch.train import Trainer, save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

NPOINTS = ["64", "32", "16", "8"]
MODEL_FLAGS = [
    "--use_color", "--butd_cls", "--self_attend", "--use_contrastive_align",
    "--use_soft_token_loss", "--num_target", "16", "--num_encoder_layers",
    "2", "--num_decoder_layers", "2", "--max_text_len", "16",
    "--num_points", "1024", "--max_num_obj", "8", "--max_det_boxes", "8",
    "--attn_precise", "--no-backbone_bf16",
]
REQUEST = ["--scan_id", "scene0001_00", "--utterance",
           "the chair near the brown table", "--phrase", "chair",
           "--top_k", "5", "--tiny_roberta", "--backbone_npoints", *NPOINTS]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """A `make_fake_scannet` root and a checkpoint that the port's
    `save_checkpoint` wrote after one training step of the flags'
    model."""
    tmp = tmp_path_factory.mktemp("predict_cli")
    root = make_fake_scannet(str(tmp / "data"),
                             scan_ids=["scene0000_00", "scene0001_00"],
                             points_per_scan=3000)
    cfg = parse_config(MODEL_FLAGS)
    trainer = Trainer(cfg, steps_per_epoch=1,
                      roberta_config=tiny_roberta_config(),
                      backbone_npoints=tuple(map(int, NPOINTS)),
                      device="cpu", seed=3)
    data = SyntheticGroundingDataset(
        2, seed=4, num_points=1024, max_text_len=16, max_num_obj=8,
        max_det_boxes=8, n_true_objects=3, n_true_tokens=6, n_true_det=4,
        vocab_size=1024)
    trainer.train_step(collate([data.get(0), data.get(1)]))
    path = save_checkpoint(str(tmp / "log"), 1, trainer)
    return dict(root=root, path=path, tmp=tmp, cfg=cfg,
                state=trainer.model.state_dict())


def _argv(written, *extra):
    return [*REQUEST, *MODEL_FLAGS, "--data_root", written["root"],
            "--checkpoint_path", written["path"], *extra]


def _run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    return json.loads(lines[-1])


def _predictor(written, path=None):
    return GroundingPredictor.from_checkpoint(
        written["cfg"], path or written["path"],
        SimpleTokenizer(max_len=16), roberta_config=tiny_roberta_config(),
        backbone_npoints=tuple(map(int, NPOINTS)), device="cpu")


def _assert_same_weights(model, state):
    got = model.state_dict()
    assert set(got) == set(state)
    for k, v in state.items():
        assert torch.equal(got[k], v), k


# ------------------------------------------------------ from_checkpoint

def test_from_checkpoint_restores_the_saved_tensors(written):
    state = written["state"]
    assert any(k.endswith("running_mean") and v.abs().sum() > 0
               for k, v in state.items())  # a step moved BatchNorm's stats
    _assert_same_weights(_predictor(written).model, state)


def test_from_checkpoint_reads_a_reference_pth(written):
    """The reference's checkpoint: {config: Namespace, model: DDP
    `module.` keys, ...}; and a bare state dict."""
    state = written["state"]
    ref = written["tmp"] / "reference.pth"
    torch.save({"config": argparse.Namespace(lr=1e-4, butd_cls=True),
                "model": {f"module.{k}": v for k, v in state.items()},
                "optimizer": {}, "epoch": 7}, ref)
    _assert_same_weights(_predictor(written, str(ref)).model, state)
    bare = written["tmp"] / "bare.pth"
    torch.save(state, bare)
    _assert_same_weights(_predictor(written, str(bare)).model, state)


def test_from_checkpoint_refuses_a_directory(written):
    with pytest.raises(ValueError, match="orbax"):
        _predictor(written, str(written["tmp"]))


# ---------------------------------------------------- the command line

@pytest.mark.parametrize("mode", ["bbf", "bbs"])
def test_cli_prints_what_the_predictor_returns(written, mode, capsys):
    out = _run(cli.main, _argv(written, "--device", "cpu", "--mode", mode),
               capsys)
    assert set(out) == {"scan_id", "utterance", "phrase", "mode",
                        "boxes_cxcyczwhd", "scores"}
    assert (out["scan_id"], out["phrase"], out["mode"]) == \
        ("scene0001_00", "chair", mode)
    scan = Scan("scene0001_00", os.path.join(written["root"], "scans"),
                meta_dir=os.path.join(written["root"], "meta_data"))
    want = _predictor(written).predict(
        np.concatenate([scan.orig_pc, scan.color], axis=1),
        "the chair near the brown table", phrase="chair", mode=mode,
        top_k=5)
    boxes = np.asarray(out["boxes_cxcyczwhd"])
    assert boxes.shape == (5, 6) and np.isfinite(boxes).all()
    np.testing.assert_array_equal(boxes, want["boxes"].astype(np.float64))
    np.testing.assert_array_equal(out["scores"],
                                  want["scores"].astype(np.float64))


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(written):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(_argv(written))


@pytest.mark.parametrize("mode", ["bbf", "bbs"])
def test_cli_matches_the_jax_cli_on_the_same_pth(written, mode, capsys,
                                                 monkeypatch):
    answers = {}

    def recording(predict, name):
        def wrapped(self, *a, **kw):
            answers[name] = out = predict(self, *a, **kw)
            return out
        return wrapped

    for name, cls in (("got", GroundingPredictor),
                      ("want", JGroundingPredictor)):
        monkeypatch.setattr(cls, "predict", recording(cls.predict, name))
    got = _run(cli.main, _argv(written, "--device", "cpu", "--mode", mode),
               capsys)
    want = _run(jax_cli.main, _argv(written, "--mode", mode), capsys)
    fields = ("scan_id", "utterance", "phrase", "mode")
    assert [got[k] for k in fields] == [want[k] for k in fields]
    for out, answer in ((got, answers["got"]), (want, answers["want"])):
        np.testing.assert_array_equal(out["boxes_cxcyczwhd"],
                                      answer["boxes"].astype(np.float64))
        np.testing.assert_array_equal(out["scores"],
                                      answer["scores"].astype(np.float64))
    gi, wi = answers["got"]["query_index"], answers["want"]["query_index"]
    gb, wb = answers["got"]["boxes"], answers["want"]["boxes"]
    gs, ws = answers["got"]["scores"], answers["want"]["scores"]
    box_lim = 1e-3 + 5e-3 * float(np.std(wb))
    score_lim = 1e-3 + 5e-3 * float(np.std(ws))
    same = gi == wi
    assert same.sum() >= len(same) - 2, (gi, wi)
    err = np.abs(gb[same].astype(np.float64) - wb[same]).max()
    assert err <= box_lim, (err, box_lim)
    # every rank's score agrees, whichever query holds it; a rank held by
    # another query is a near-tie with a neighbouring rank
    assert np.abs(gs.astype(np.float64) - ws).max() <= score_lim, (gs, ws)
    for r in np.where(~same)[0]:
        near = [abs(float(ws[r]) - float(ws[q])) for q in (r - 1, r + 1)
                if 0 <= q < len(ws)]
        assert min(near) <= 2 * score_lim, (r, gi, wi, ws)

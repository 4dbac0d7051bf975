"""`TrainTester.main` across processes, on the CPU over gloo: two ranks
with `--dp 2 --syncbn`, and two with `--mp 2`, at the small model and the
synthetic scenes of test_torch_harness.py (10 test scenes at B = 4: the
tail batch holds 2 real rows, all of them on dp shard 0).

Each world trains an epoch, writes its checkpoints once (the first
process), evaluates, and then evaluates freshly seeded weights; those
counters must equal one process's, every scene counted once. The
log names the backend and the world, and logs `--syncbn` as the JAX
harness does; a checkpoint of either world loads into one process.
"""

import pytest

import torch_ranks
from butd_detr_tpu_torch.data import DataLoader
from butd_detr_tpu_torch.train import load_checkpoint

ROBERTA = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=96,
               max_position_embeddings=40)
NPOINTS = (64, 32, 16, 8)
CFG = dict(use_color=True, butd_cls=True, self_attend=True,
           use_contrastive_align=True, use_soft_token_loss=True,
           num_target=16, num_encoder_layers=2, num_decoder_layers=2,
           max_text_len=12, num_points=1024, max_num_obj=8, max_det_boxes=8,
           backbone_bf16=False, attn_precise=True, batch_size=4,
           num_workers=0, print_freq=1, max_epoch=1, val_freq=1,
           # no pretrained text trunk: a missing file keeps the seeded
           # weights without importing `transformers`
           roberta_checkpoint="/nonexistent/roberta.pth")
SCENES = dict(num_points=1024, max_text_len=12, max_num_obj=8,
              max_det_boxes=8, n_true_objects=3, n_true_tokens=6,
              n_true_det=4, vocab_size=128)


def _world(tmp_path, world_size, **flags):
    cfg = dict(CFG, log_dir=str(tmp_path / "log"), **flags)
    ranks = torch_ranks.run_ranks(torch_ranks.harness_world, world_size,
                                  cfg, ROBERTA, NPOINTS, SCENES)
    return cfg, ranks


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    cfg = dict(CFG, log_dir=str(tmp_path_factory.mktemp("one") / "log"))
    return torch_ranks.harness_world(0, cfg, ROBERTA, NPOINTS, SCENES)


@pytest.mark.parametrize("flags", [dict(dp=2, syncbn=True), dict(mp=2)],
                         ids=["dp2", "mp2"])
def test_two_ranks_train_save_and_evaluate_as_one_process(
        flags, one, tmp_path):
    cfg, ranks = _world(tmp_path, 2, **flags)
    dp = flags.get("dp", 1)
    for rank in ranks:
        assert rank["step"] == one["step"] == 2  # 8 scenes at B = 4
        # equal counts; each rank's evaluator starts its breakdown counts
        # at 1e-14 (a zero guard), which the merge sums
        assert rank["dets"] == pytest.approx(one["dets"], rel=0, abs=1e-13)
        assert rank["gts"] == pytest.approx(one["gts"], rel=0, abs=1e-13)
    # the loader's shard: B / dp rows a batch, the tail's real rows
    # counted for the whole batch
    assert ranks[0]["rows"] == [4 // dp] * 3
    assert ranks[0]["valid"] == ranks[1]["valid"] == [None, None, 2]

    log_dir = tmp_path / "log"
    text = (log_dir / "log.txt").read_text()
    assert (f"process group: backend gloo, world size 2, dp {dp}, "
            f"mp {3 - dp}; rank 0 on cpu") in text
    assert ("--syncbn: BatchNorm statistics are global" in text) == \
        (dp == 2)
    assert "rank 1 on cpu" in (log_dir / "log.txt.rank1").read_text()
    assert sorted(p.name for p in log_dir.glob("ckpt_epoch_*")) == [
        "ckpt_epoch_1.pth"]
    tester = torch_ranks.synthetic_tester(
        dict(CFG, log_dir=str(tmp_path / "again")), ROBERTA, NPOINTS,
        SCENES)
    trainer = tester.get_trainer(2)
    assert load_checkpoint(str(log_dir / "ckpt_epoch_1.pth"), trainer) == 2
    assert trainer.step == 2


def test_a_world_that_does_not_match_the_mesh_raises(tmp_path):
    for flags, msg in ((dict(mp=2), "--mp 2 does not divide the world "
                        "size 1"),
                       (dict(dp=2), r"--dp 2 x --mp 1 = 2 ranks, but the "
                        "world size is 1")):
        cfg = dict(CFG, log_dir=str(tmp_path / "log"), **flags)
        with pytest.raises(ValueError, match=msg):
            torch_ranks.synthetic_tester(cfg, ROBERTA, NPOINTS, SCENES)
    with pytest.raises(ValueError, match="--batch_size 3 does not split "
                       "over --dp 2"):
        DataLoader([], 3, dp_size=2)

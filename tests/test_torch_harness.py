"""The evaluation slice as a whole, and what carries it, at a small size on
the CPU:

(a) one set of weights (through `state_dict_from_jax`) and the same
    scenes through the JAX package's loader + `make_eval_step` +
    `GroundingGTEvaluator` and through the port's
    `TrainTester.evaluate_one_epoch`, with a padded tail batch: integer end
    points equal, floats within the bound of tests/test_torch_model.py
    (|err| <= 1e-3 + 5e-3 * std(reference)), every evaluator counter equal.
    Two cases: synthetic scenes through the `get_datasets` seam, and the
    val split of a `make_fake_scannet` root through the port's own
    `get_datasets` beside the JAX package's `JointGroundingDataset`;
(b) checkpoints: save -> load into a fresh trainer, `reduce_lr`,
    `latest_checkpoint`, and a resumed run against the uninterrupted one,
    bit for bit with dropout on;
(c) `parse_config` against the JAX package's, field by field, and the
    loader's index order, per-sample seeds and `__valid__`;
(d) `TrainTester.main`: train, save, evaluate, resume, `--eval`.

Both packages run strict f32 (no bf16 backbone, the precise attention mode).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from butd_detr_tpu.data import JointGroundingDataset as JDataset
from butd_detr_tpu.data.loader import DataLoader as JDataLoader
from butd_detr_tpu.data.scan import load_scans_parallel as j_load_scans
from butd_detr_tpu.lang.tokenizer import SimpleTokenizer as JTokenizer
from butd_detr_tpu.eval import GroundingGTEvaluator as JGTEvaluator
from butd_detr_tpu.lang.roberta import RobertaConfig as JRobertaConfig
from butd_detr_tpu.train.config import (
    Config as JConfig,
    parse_config as j_parse_config,
)
from butd_detr_tpu.train.step import (
    INPUT_KEYS as J_INPUT_KEYS,
    TARGET_KEYS as J_TARGET_KEYS,
    TrainState,
    build_model as j_build_model,
    make_eval_step,
)
from butd_detr_tpu_torch.config import Config, butd_cls_config, parse_config
from butd_detr_tpu_torch.convert import state_dict_from_jax
from butd_detr_tpu_torch.data import (
    DataLoader,
    SyntheticGroundingDataset,
    collate,
    make_fake_scannet,
    save_scan_cache,
)
from butd_detr_tpu_torch.lang import RobertaConfig
from butd_detr_tpu_torch.train import (
    TrainTester,
    Trainer,
    build_model,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from butd_detr_tpu_torch.train.harness import EVALUATOR_KEYS
from torch_threads import one_torch_thread  # noqa: F401

ROBERTA = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=96,
               max_position_embeddings=40)
NPOINTS = (64, 32, 16, 8)
CFG = dict(use_color=True, butd_cls=True, self_attend=True,
           use_contrastive_align=True, use_soft_token_loss=True,
           num_target=16, num_encoder_layers=2, num_decoder_layers=2,
           max_text_len=12, num_points=1024, max_num_obj=8, max_det_boxes=8,
           backbone_bf16=False, attn_precise=True, batch_size=4,
           num_workers=0, print_freq=1)
SCENES = dict(num_points=1024, max_text_len=12, max_num_obj=8,
              max_det_boxes=8, n_true_objects=3, n_true_tokens=6,
              n_true_det=4, vocab_size=128)


class SyntheticTrainTester(TrainTester):
    """The harness over seeded synthetic scenes and the tests' small model,
    through the `get_datasets` seam."""

    n_train, n_test = 8, 10
    state_dict = None
    roberta = ROBERTA

    def get_datasets(self):
        return (SyntheticGroundingDataset(self.n_train, seed=11, **SCENES),
                SyntheticGroundingDataset(self.n_test, seed=12, **SCENES))

    def _roberta_config(self):
        return RobertaConfig(**self.roberta)

    def get_model(self):
        return build_model(self.cfg, self._roberta_config(), NPOINTS)

    def get_trainer(self, steps_per_epoch):
        trainer = super().get_trainer(steps_per_epoch)
        if self.state_dict is not None:
            trainer.model.load_state_dict(
                {k: torch.as_tensor(v) for k, v in self.state_dict.items()})
        return trainer


class ScanNetTrainTester(SyntheticTrainTester):
    """The tests' small model over a ScanNet-format root, through the
    port's own `get_datasets`; the text tower takes `get_tokenizer`'s
    hashed 1024-word vocabulary."""

    roberta = dict(ROBERTA, vocab_size=1024)
    get_datasets = TrainTester.get_datasets


def _scannet_root(tmp):
    """A `make_fake_scannet` root of 5 scenes with its scan caches built at
    the model's 1024 points: sr3d+'s val split has 10 rows."""
    root = make_fake_scannet(str(tmp / "root"), points_per_scan=2000,
                             scan_ids=[f"scene{i:04d}_00" for i in range(5)])
    for split in ("train", "val"):
        save_scan_cache(os.path.join(root, f"{split}_v3scans.pkl"), split,
                        root, num_workers=1, keep_points=1024)
    return root


def _tester(tmp_path, **overrides):
    cfg = Config(**dict(CFG, log_dir=str(tmp_path / "log"), **overrides))
    return SyntheticTrainTester(cfg, device="cpu")


# ------------------------------------------------ (a) the evaluation epoch

@pytest.fixture(scope="module", params=["synthetic", "scannet"])
def epoch(request, tmp_path_factory):
    """10 scenes at B = 4 (two full batches and a tail of 2) through both
    packages, with one set of weights: synthetic scenes, or sr3d+'s val
    split of a ScanNet-format root (the JAX side on the JAX package's own
    dataset and scans)."""
    tmp = tmp_path_factory.mktemp("epoch")
    if request.param == "synthetic":
        tester = _tester(tmp)
        _, test_set = tester.get_datasets()
        jkw = CFG
    else:
        root = _scannet_root(tmp)
        jkw = dict(CFG, data_root=root, test_dataset="sr3d+")
        tester = ScanNetTrainTester(Config(**dict(jkw, log_dir=str(
            tmp / "log"))), device="cpu")
        assert type(tester.get_datasets()[1].tokenizer).__name__ == \
            "SimpleTokenizer"
        meta = os.path.join(root, "meta_data")
        with open(os.path.join(meta, "scannetv2_val.txt")) as f:
            scan_ids = f.read().split()
        test_set = JDataset(
            dataset_dict={"sr3d": 1}, test_dataset="sr3d+", split="val",
            data_path=root, use_color=True, butd_cls=True, max_text_len=12,
            max_num_obj=8, max_det_boxes=8,
            tokenizer=JTokenizer(vocab_size=1024, max_len=12),
            scans=j_load_scans(scan_ids, os.path.join(root, "scans"), meta,
                               num_workers=1, keep_points=1024))

    jcfg = JConfig(**dict(jkw, log_dir=str(tmp / "jlog")))
    jm = j_build_model(jcfg, roberta_config=JRobertaConfig(**tester.roberta),
                       backbone_npoints=NPOINTS)
    jloader = JDataLoader(test_set, batch_size=4, shuffle=False,
                          drop_last=False, seed=jcfg.rng_seed)
    first = next(iter(jloader))
    variables = jax.jit(jm.init)(
        jax.random.PRNGKey(0),
        {k: jnp.asarray(first[k]) for k in J_INPUT_KEYS})
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=None)
    eval_step = jax.jit(make_eval_step(jm, jcfg, with_loss=False))
    prefixes = ["last_", "proposal_", "0head_"]
    want_ev = JGTEvaluator(prefixes=prefixes)
    want_eps, valids = [], []
    for batch in jloader:
        valid = batch.pop("__valid__", 4)
        ep = dict(eval_step(state, {
            k: jnp.asarray(batch[k]) for k in (*J_INPUT_KEYS, *J_TARGET_KEYS)
            if k in batch}))
        for k in EVALUATOR_KEYS:
            if k in batch:
                ep[k] = batch[k]
        ep = {k: np.asarray(v)[:valid] if np.ndim(v) >= 1
              and np.shape(v)[0] == 4 else v for k, v in ep.items()}
        want_ev.evaluate(ep)
        want_eps.append({k: np.asarray(v) for k, v in ep.items()})
        valids.append(valid)

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tester.state_dict = state_dict_from_jax(to_np(variables["params"]),
                                            to_np(variables["batch_stats"]))
    _, test_loader = tester.get_loaders()
    trainer = tester.get_trainer(1)
    got_ev = tester.evaluate_one_epoch(1, test_loader, trainer)
    got_eps = [{k: (v.numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in ep.items()}
               for _, ep in tester._eval_batches(test_loader, trainer)]
    return dict(tester=tester, prefixes=prefixes, valids=valids,
                want_ev=want_ev, got_ev=got_ev, want_eps=want_eps,
                got_eps=got_eps)


def test_epoch_end_points_match_the_jax_eval_step(epoch):
    assert epoch["valids"] == [4, 4, 2]
    assert epoch["tester"].prefixes() == epoch["prefixes"]
    assert len(epoch["got_eps"]) == 3
    bad = []
    for i, (got, want) in enumerate(zip(epoch["got_eps"],
                                        epoch["want_eps"])):
        assert set(want) <= set(got)
        assert "loss" not in got  # butd_cls evaluates without the loss
        for k, w in want.items():
            g = got[k]
            assert g.shape == w.shape, (i, k, g.shape, w.shape)
            assert g.shape[:1] in ((), (epoch["valids"][i],)), (i, k)
            if w.dtype.kind in "iub":
                np.testing.assert_array_equal(g, w, err_msg=f"{i} {k}")
                continue
            err = float(np.abs(g.astype(np.float64) - w).max())
            lim = 1e-3 + 5e-3 * float(np.std(w))
            if err > lim:
                bad.append((i, k, err, lim))
    assert not bad, bad


def test_epoch_counters_equal_the_jax_evaluators(epoch):
    got, want = epoch["got_ev"], epoch["want_ev"]
    assert set(got.dets) == set(want.dets)
    for k in want.dets:
        assert got.dets[k] == want.dets[k], k
        assert got.gts[k] == want.gts[k], k
    for p in epoch["prefixes"]:
        for m in ("bbs", "bbf"):
            assert got.gts[(p, m)] == 10.0  # the tail's padding is not counted
            assert 0.0 <= got.accuracy(p, m) <= 1.0
    assert 0 < got.dets[("last_", "bbf")] < 10  # hits and misses both occur


def test_eval_loss_running_mean_weights_the_tail_by_its_valid_rows(tmp_path):
    """Without butd_cls the eval step carries the loss; the logged running
    mean weights a padded tail by valid / B (harness.py:380-387 of the JAX
    package)."""
    lines = []
    tester = _tester(tmp_path, butd_cls=False, butd=True)
    tester.n_test = 6
    tester.logger = type("L", (), {"info": staticmethod(lines.append)})
    _, loader = tester.get_loaders()
    trainer = tester.get_trainer(1)
    losses = [float(ep["loss"]) for _, ep in
              tester._eval_batches(loader, trainer)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    mean = (losses[0] * 1.0 + losses[1] * 0.5) / 1.5
    last = dict(zip(lines[-1].split()[2::2],
                    map(float, lines[-1].split()[3::2])))
    assert lines[-1].startswith("Eval: [2/2]")
    assert last["loss"] == pytest.approx(mean, abs(mean) * 1e-4)
    ev = tester.evaluate_one_epoch(1, loader, trainer)
    assert ev.gts[("last_", 0.25, 1, "bbf")] == 6.0
    assert type(ev).__name__ == "GroundingEvaluator"


# ------------------------------------------------------- (b) checkpoints

def _trainer(seed=0, **overrides):
    kw = dict(CFG, num_points=256, backbone_bf16=True, attn_precise=False)
    kw.update(overrides)
    return Trainer(Config(**kw), steps_per_epoch=2,
                   roberta_config=RobertaConfig(**ROBERTA),
                   backbone_npoints=NPOINTS, device="cpu", seed=seed)


def _batches(n):
    data = SyntheticGroundingDataset(4 * n, seed=5,
                                     **dict(SCENES, num_points=256))
    return [collate([data.get(4 * i + j) for j in range(4)])
            for i in range(n)]


def _assert_same_training_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert set(oa["state"]) == set(ob["state"]) and oa["state"]
    for i, st in oa["state"].items():
        for name, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(ob["state"][i][name])), name
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_checkpoint_round_trip_restores_everything(tmp_path):
    batches = _batches(2)
    a = _trainer(seed=1)
    for batch in batches:
        a.train_step(batch)
    path = save_checkpoint(str(tmp_path), 7, a)
    assert path == str(tmp_path / "ckpt_epoch_7.pth") and os.path.isfile(path)
    b = _trainer(seed=2)  # other weights, fresh optimizer
    assert load_checkpoint(path, b) == 8
    _assert_same_training_state(a, b)
    assert any(k.startswith("text_encoder.") for k in
               torch.load(path, weights_only=True)["model"])


def test_reduce_lr_restores_the_weights_only(tmp_path):
    a = _trainer(seed=1)
    a.train_step(_batches(1)[0])
    path = save_checkpoint(str(tmp_path), 3, a)
    b = _trainer(seed=2)
    gen_before = b.generator.get_state().clone()
    assert load_checkpoint(path, b, reduce_lr=True) == 4
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k  # BN buffers too
    assert b.step == 0 and not b.optimizer.state_dict()["state"]
    assert torch.equal(b.generator.get_state(), gen_before)


def test_latest_checkpoint_takes_the_highest_epoch(tmp_path):
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for name in ("ckpt_epoch_5.pth", "ckpt_epoch_10.pth", "ckpt_epoch_9.pth",
                 "ckpt_epoch_x.pth", "ckpt_epoch_99.pth.123.tmp", "log.txt"):
        (tmp_path / name).write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == str(
        tmp_path / "ckpt_epoch_10.pth")


def test_resumed_run_repeats_the_uninterrupted_one_bit_for_bit(tmp_path):
    """2 steps + save + load into a fresh trainer + 2 steps == 4 steps, with
    dropout on: the step's dropout seed comes from the saved generator."""
    batches = _batches(4)
    straight = _trainer(seed=3)
    want = [straight.train_step(b) for b in batches]
    first = _trainer(seed=3)
    got = [first.train_step(b) for b in batches[:2]]
    path = save_checkpoint(str(tmp_path), 1, first)
    resumed = _trainer(seed=99)
    load_checkpoint(path, resumed)
    got += [resumed.train_step(b) for b in batches[2:]]
    assert got == want
    assert want[2] != want[0]
    _assert_same_training_state(straight, resumed)


# ------------------------------------------- (c) configuration and loader

SCRIPT_FLAGS = [
    "--num_decoder_layers", "6", "--use_color", "--weight_decay", "0.0005",
    "--data_root", "./data", "--val_freq", "5", "--batch_size", "24",
    "--save_freq", "5", "--print_freq", "1000", "--lr_backbone", "1e-3",
    "--lr", "1e-4", "--dataset", "sr3d", "--test_dataset", "sr3d",
    "--detect_intermediate", "--joint_det", "--use_soft_token_loss",
    "--use_contrastive_align", "--log_dir", "./logs/bdetr_cls",
    "--lr_decay_epochs", "30", "35", "--butd_cls", "--self_attend",
]


@pytest.mark.parametrize("argv", [
    [],
    SCRIPT_FLAGS,  # scripts/train_test_cls.sh
    SCRIPT_FLAGS + ["--no-backbone_bf16", "--eval_train", "--unknown", "7",
                    "--lr-scheduler", "cosine", "--checkpoint_path", "a.pth",
                    "--dataset", "sr3d", "nr3d", "--ap_iou_thresholds",
                    "0.3", "--dp", "2"],
])
def test_parse_config_gives_the_jax_packages_values(argv):
    got, want = parse_config(argv), j_parse_config(argv)
    got_fields = {f.name: (f.type, f.default) for f in
                  dataclasses.fields(Config) if f.default
                  is not dataclasses.MISSING}
    want_fields = {f.name: (f.type, f.default) for f in
                   dataclasses.fields(JConfig) if f.default
                   is not dataclasses.MISSING}
    assert got_fields == want_fields
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_json() == want.to_json()
    assert got.input_feature_dim == want.input_feature_dim


def test_butd_cls_config_is_the_scripts_model_and_optimizer_flags():
    script = parse_config(SCRIPT_FLAGS)
    preset = butd_cls_config()
    for f in ("use_color", "butd_cls", "self_attend", "joint_det",
              "use_contrastive_align", "use_soft_token_loss",
              "num_decoder_layers", "weight_decay", "lr", "lr_backbone",
              "lr_decay_epochs", "max_text_len"):
        assert getattr(preset, f) == getattr(script, f), f
    assert Config(use_multiview=True, use_height=True).input_feature_dim == 129


class _Indexed:
    """A dataset that reports which index and which seed it was asked
    for."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, index, rng):
        return {"index": np.int64(index),
                "draw": np.float32(rng.rand()),
                "scan_ids": f"scene{index:04d}"}


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, drop_last=True, seed=3),
    dict(shuffle=False, drop_last=False, seed=0),
    dict(shuffle=True, drop_last=False, seed=7, process_index=1,
         process_count=2),
])
def test_loader_yields_the_jax_loaders_batches(kw):
    data = _Indexed(23)
    got_loader = DataLoader(data, batch_size=4, **kw)
    want_loader = JDataLoader(data, batch_size=4, **kw)
    assert len(got_loader) == len(want_loader)
    for ep in (0, 3):
        got_loader.set_epoch(ep)
        want_loader.set_epoch(ep)
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == len(got_loader)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert g.get("__valid__") == w.get("__valid__")
            assert g["scan_ids"] == w["scan_ids"]
            assert g["index"].dtype == np.int32
            np.testing.assert_array_equal(g["index"], w["index"])
            np.testing.assert_array_equal(g["draw"], w["draw"])
    if not kw["drop_last"]:
        assert "__valid__" in got[-1] and "__valid__" not in got[0]


def test_synthetic_dataset_has_the_evaluators_extras():
    data = SyntheticGroundingDataset(5, seed=1, **SCENES)
    again = SyntheticGroundingDataset(5, seed=1, **SCENES)
    assert len(data) == 5
    s = data.get(3)
    assert s["point_clouds"].shape == (1024, 6)
    assert s["all_bboxes"].shape == (8, 6)
    own = np.concatenate([s["center_label"], s["size_gts"]], -1)
    assert {tuple(r) for r in s["all_bboxes"]} == {tuple(r) for r in own}
    assert any(not np.array_equal(data.get(i)["all_bboxes"][0],
                                  np.concatenate([data.get(i)["center_label"],
                                                  data.get(i)["size_gts"]],
                                                 -1)[0]) for i in range(5))
    np.testing.assert_array_equal(s["all_bbox_label_mask"],
                                  s["box_label_mask"] > 0)
    assert {"is_view_dep", "is_hard", "is_unique"} <= set(s)
    for k, v in s.items():
        np.testing.assert_array_equal(v, again.get(3)[k], err_msg=k)
    with pytest.raises(IndexError):
        data.get(5)


# ----------------------------------------------------- (d) TrainTester.main

def test_main_trains_saves_evaluates_and_resumes(tmp_path):
    tester = _tester(tmp_path, max_epoch=2, val_freq=1)
    trainer = tester.main()
    log_dir = tmp_path / "log"
    assert trainer.step == 4  # 2 epochs of 8 scenes at B = 4
    assert sorted(p.name for p in log_dir.glob("ckpt_epoch_*.pth")) == [
        "ckpt_epoch_1.pth", "ckpt_epoch_2.pth"]
    assert (log_dir / "config.json").read_text() == tester.cfg.to_json()
    text = (log_dir / "log.txt").read_text()
    assert "Train: [2][2/2]" in text and "Analysis" in text
    assert "last_ Box given span (contrastive) Acc:" in text

    # a third epoch resumes from the latest checkpoint
    again = _tester(tmp_path, max_epoch=3, val_freq=5)
    resumed = again.main()
    assert resumed.step == 6
    assert "start_epoch=3" in (log_dir / "log.txt").read_text()

    # --eval: restore the named checkpoint, evaluate, train nothing
    ev = _tester(tmp_path, eval=True,
                 checkpoint_path=str(log_dir / "ckpt_epoch_2.pth"))
    evaluated = ev.main()
    assert evaluated.step == 4
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(evaluated.model.state_dict()[k], v), k


def test_every_train_flag_is_taken_and_cuda_is_the_default(tmp_path):
    cfg = Config(**dict(CFG, log_dir=str(tmp_path / "log")))
    # one process: the mesh is 1 x 1, and a mesh of more ranks says why not
    for kw in (dict(dp=1, mp=1, syncbn=True), dict(profile_dir="p"),
               dict(use_multiview=True)):
        tester = TrainTester(dataclasses.replace(cfg, **kw), device="cpu")
        assert (tester.mesh.dp, tester.mesh.mp) == (1, 1)
    with pytest.raises(ValueError, match="--mp 2 does not divide the "
                       "world size 1"):
        TrainTester(dataclasses.replace(cfg, mp=2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TrainTester(cfg)
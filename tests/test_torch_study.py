"""The accuracy-study path of the port against the JAX package's, on the
CPU, at small sizes:

(a) the tiny and small text configs equal the JAX package's, field for
    field (the JAX configs' two dropout rates excepted: both packages run
    the text tower without dropout);
(b) the small text tower loaded by `convert.load_text_init` from
    `studies/attrib_r5/text_init.npz` equals JAX `RobertaModel` with the
    params of `scripts/probe_common.py:load_text_init` on the same ids
    (atol 1e-5); a missing key, an extra key and a wrong shape each raise,
    naming the key;
(c) `make_trainval_root` on a `make_fake_scannet` root makes the JAX
    function's tree: the same entries, links to the same targets and the
    same file bytes;
(d) `train/study.py:probe_row` equals `scripts/probe_common.py:probe_row`
    on the same seeded logits, boxes and batch (1e-6);
(e) the port's `Trainer` follows the jitted JAX train step for 3 steps on
    the probe's fixed batch (tiny text tower, trainable; dropout 0
    everywhere; strict f32; the same weights through `convert.py`; the
    three groups' rates 1e-5): loss to rel 1e-4 at step 1, 1e-3 at step 2
    and 1e-2 at step 3. At the study's 1e-4 / 1e-3 Adam's first updates
    (about lr * sign(g) for every entry) make the path chaotic: the port
    against itself with a rounding-level change moves the loss 1 % at step
    2 and 12 % at step 3. At 1e-5 that spread is 1e-4; what is left at
    step 3 (5e-3 measured) is the JAX side's: at the weights after step 1
    the jitted JAX train step's set-abstraction gradients differ from the
    eager gradient of the same flax function, which the port's equal
    (ROADMAP.md section 3). The text encoder's gradients at the first
    step's weights to 2e-3 * max|g| + 1e-6, in eval mode as
    `test_torch_train_step.py` holds every other parameter's: in train
    mode they differ by up to 0.5 % of max|g| (flax differentiates its
    batch variance as E[x^2] - E[x]^2, torch's batch_norm the centred
    form: the port with flax's form comes within 0.24 %);
    torch keeps its default thread count here: with one thread the
    objectness top-k of step 1 resolves a near-tie otherwise (one query
    of 16), and the loss moves 1 %;
(f) the port's study (`--tiny --device cpu`): 2 epochs in one run equal,
    bit for bit in parameters and history, 1 epoch and a `--resume`d one.
"""

import dataclasses
import json
import os
import os.path as osp
import types

import numpy as np
import pytest
import torch

from butd_detr_tpu.lang import roberta as j_roberta
from butd_detr_tpu_torch.convert import load_text_init
from butd_detr_tpu_torch.lang import (
    RobertaModel,
    SimpleTokenizer,
    small_text_roberta_config,
    tiny_roberta_config,
)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TEXT_INIT = osp.join(ROOT, "studies", "attrib_r5", "text_init.npz")
UTTERANCES = ["the chair in the room", "the sofa in the room",
              "find the cabinet beside the door near the window"]


@pytest.fixture
def one_torch_thread():
    """Torch on one thread for (f): the suite runs several test processes
    side by side, and torch's default of a thread per core in each of
    them slowed (f) 25-fold."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("name", ["tiny_roberta_config",
                                  "small_text_roberta_config"])
def test_roberta_config_is_the_jax_packages(name):
    import butd_detr_tpu_torch.lang as port_lang

    got = dataclasses.asdict(getattr(port_lang, name)())
    want = dataclasses.asdict(getattr(j_roberta, name)())
    assert got == want


# ------------------------------------------------------------------ (b)

def _port_tower(path=TEXT_INIT):
    model = types.SimpleNamespace(
        text_encoder=RobertaModel(small_text_roberta_config(),
                                  precise=True).eval())
    load_text_init(path, model)
    return model.text_encoder


def test_text_init_tower_matches_the_jax_tower():
    import jax
    import jax.numpy as jnp

    from scripts.probe_common import load_text_init as j_load_text_init

    enc = SimpleTokenizer(max_len=32)(UTTERANCES)
    ids, mask = enc.ids, enc.attention_mask
    jm = j_roberta.RobertaModel(j_roberta.small_text_roberta_config())
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(ids),
                              jnp.asarray(mask))["params"]
    params = j_load_text_init(TEXT_INIT, {"text_encoder": params})
    want = np.asarray(jm.apply({"params": params["text_encoder"]},
                               jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = _port_tower()(torch.from_numpy(ids),
                            torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (3, 32, 128)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _edited_npz(tmp_path, edit):
    data = dict(np.load(TEXT_INIT))
    edit(data)
    path = str(tmp_path / "text_init.npz")
    np.savez(path, **data)
    return path


@pytest.mark.parametrize("case,key,error", [
    ("missing", "encoder.layer.3.attention.self.query.weight", KeyError),
    ("extra", "layer_4/attention/q_proj/kernel", KeyError),
    ("shape", "layer_1/intermediate/kernel", ValueError),
])
def test_text_init_refuses_a_mismatched_trunk(tmp_path, case, key, error):
    def edit(data):
        if case == "missing":
            del data["layer_3/attention/q_proj/kernel"]
        elif case == "extra":
            data[key] = data["layer_3/attention/q_proj/kernel"]
        else:
            data[key] = data[key][:, :128]

    path = _edited_npz(tmp_path, edit)
    with pytest.raises(error, match=key.replace(".", r"\.")):
        _port_tower(path)


# ------------------------------------------------------------------ (c)

def _tree(root):
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            p = osp.join(dirpath, name)
            rel = osp.relpath(p, root)
            if osp.islink(p):
                out[rel] = ("link", osp.relpath(os.readlink(p),
                                                osp.dirname(root)))
            elif osp.isfile(p):
                with open(p, "rb") as f:
                    out[rel] = ("file", f.read())
        dirnames[:] = [d for d in dirnames
                       if not osp.islink(osp.join(dirpath, d))]
    return out


def test_make_trainval_root_is_the_jax_functions(tmp_path):
    from butd_detr_tpu_torch.data import make_fake_scannet, \
        make_trainval_root
    from scripts.train_split_eval import make_trainval_root as j_make

    trees = []
    for name, fn in (("port", make_trainval_root), ("jax", j_make)):
        root = str(tmp_path / name / "data")
        make_fake_scannet(root, points_per_scan=500)
        alt = fn(root)
        assert alt == root + "_trainval"
        assert fn(root) == alt  # made once
        trees.append(_tree(alt))
    assert trees[0] == trees[1]
    meta = trees[0]
    assert meta["meta_data/sr3d_test_scans.txt"] == \
        meta["meta_data/sr3d_train_scans.txt"]
    assert any(kind == "link" for kind, _ in meta.values())


# ------------------------------------------------------------------ (d)

@pytest.fixture(scope="module")
def probe_batch(tmp_path_factory):
    """The probe's fixed batch: 4 unaugmented train-scene samples of a
    small `make_rich_scannet` root, through the port's `build_dataset`."""
    from butd_detr_tpu_torch.data import collate, make_rich_scannet
    from butd_detr_tpu_torch.train.study import build_dataset

    root = str(tmp_path_factory.mktemp("probe") / "data")
    make_rich_scannet(root, n_train=2, n_val=1, points_per_scan=1500)
    ds = build_dataset(root, SimpleTokenizer(max_len=32), "val",
                       joint_det=False, num_points=1024, eval_train=True)
    return collate([ds[i] for i in range(4)])


def test_probe_row_is_the_jax_probe_row(probe_batch):
    from butd_detr_tpu_torch.train.study import probe_row
    from scripts.probe_common import probe_row as j_probe_row

    batch = probe_batch
    rng = np.random.RandomState(7)
    Q = 16
    preds = {}
    for prefix in ("proposal_", "last_"):
        logits = rng.randn(4, Q, 256).astype(np.float32) * 3
        # half the queries near a scene box, so some pass IoU 0.25
        boxes = np.concatenate([rng.rand(4, Q, 3) * 4,
                                rng.rand(4, Q, 3) + 0.2], -1)
        pick = rng.randint(0, 4, (4, Q // 2))
        near = np.take_along_axis(batch["all_bboxes"], pick[..., None], 1)
        boxes[:, :Q // 2] = near + rng.randn(4, Q // 2, 6) * 0.05
        preds[prefix] = (logits, boxes.astype(np.float32))
    for step in (0, 15):
        got = probe_row(preds, batch, step)
        want = j_probe_row(preds, batch, step)
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, abs=1e-6), k
    assert 0 < want["last_acc"] or 0 < want["proposal_acc"]


# ------------------------------------------------------------------ (e)

NPOINTS = (256, 128, 64, 32)
PROBE_CFG = dict(
    dataset=["sr3d"], test_dataset="sr3d", use_color=True, butd=False,
    butd_cls=True, self_attend=True, use_soft_token_loss=True,
    use_contrastive_align=True, batch_size=4, num_points=1024,
    max_num_obj=16, max_det_boxes=16, max_text_len=32, lr=1e-5,
    lr_backbone=1e-5, weight_decay=5e-4, freeze_text_encoder=False,
    text_encoder_lr=1e-5, lr_decay_epochs=[10 ** 6], num_target=16,
    eos_coef=0.02, num_encoder_layers=1, num_decoder_layers=1,
    backbone_bf16=False, attn_precise=True)


def _no_dropout(model):
    from butd_detr_tpu_torch.nn.attention import MultiheadAttention
    from butd_detr_tpu_torch.nn.dropout import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
        elif isinstance(m, MultiheadAttention):
            m.dropout = 0.0


def test_trainable_text_trajectory_matches_the_jax_train_step(
        probe_batch, monkeypatch):
    import flax.linen
    import jax
    import jax.numpy as jnp

    from butd_detr_tpu.losses import compute_hungarian_loss as j_loss
    from butd_detr_tpu.train.config import Config as JConfig
    from butd_detr_tpu.train.optimizer import make_optimizer as j_optimizer
    from butd_detr_tpu.train.step import (
        INPUT_KEYS as J_INPUT_KEYS,
        TARGET_KEYS as J_TARGET_KEYS,
        build_model as j_build_model,
        criterion_config as j_criterion_config,
        init_state,
        make_train_step,
    )
    from butd_detr_tpu_torch.config import Config
    from butd_detr_tpu_torch.convert import (
        named_arrays_from_jax,
        state_dict_from_jax,
    )
    from butd_detr_tpu_torch.train import INPUT_KEYS, TARGET_KEYS, Trainer

    # dropout 0 everywhere: the JAX model's rates are fixed at 0.1
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    keys = [k for k in (*INPUT_KEYS, *TARGET_KEYS) if k in probe_batch]
    batch = {k: probe_batch[k] for k in keys}
    jcfg = JConfig(**PROBE_CFG)
    jm = j_build_model(jcfg, roberta_config=j_roberta.tiny_roberta_config(),
                       backbone_npoints=NPOINTS)
    optimizer = j_optimizer(jcfg, steps_per_epoch=10 ** 6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(0)
    state = init_state(jm, optimizer, jbatch, rng)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    state_dict = state_dict_from_jax(to_np(state.params),
                                     to_np(state.batch_stats))

    def loss_fn(params):
        ep = jm.apply(
            {"params": params, "batch_stats": state.batch_stats},
            {k: jbatch[k] for k in J_INPUT_KEYS if k in jbatch},
            train=False)
        for k in J_TARGET_KEYS:
            ep[k] = jbatch[k]
        return j_loss(ep, jcfg.num_decoder_layers, j_criterion_config(jcfg),
                      jcfg.query_points_obj_topk)[0]

    want_grads = named_arrays_from_jax(
        {"text_encoder": to_np(jax.jit(jax.grad(loss_fn))(
            state.params)["text_encoder"])})
    train_step = jax.jit(make_train_step(jm, jcfg, optimizer))
    want = []
    for _ in range(3):
        state, metrics = train_step(state, jbatch, rng)
        want.append(float(metrics["loss"]))

    trainer = Trainer(Config(**PROBE_CFG), steps_per_epoch=10 ** 6,
                      roberta_config=tiny_roberta_config(),
                      backbone_npoints=NPOINTS, device="cpu",
                      state_dict=state_dict)
    _no_dropout(trainer.model)
    trainer.model.eval()
    loss, _ = trainer.loss(trainer.forward(trainer.to_device(batch)))
    loss.backward()
    got_grads = {n: p.grad.numpy().copy()
                 for n, p in trainer.model.named_parameters()
                 if n.startswith("text_encoder.")}
    got = [trainer.train_step(batch)["loss"] for _ in range(3)]

    assert set(got_grads) == set(want_grads)
    for name, g in got_grads.items():
        w = want_grads[name]
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-3 * np.abs(w).max() + 1e-6,
                                   err_msg=name)
    for g, w, rel in zip(got, want, (1e-4, 1e-3, 1e-2)):
        assert g == pytest.approx(w, rel=rel)
    assert got[2] < got[1] < got[0]


# ------------------------------------------------------------------ (f)

STUDY_FLAGS = ["--tiny", "--device", "cpu", "--n_train", "1", "--n_val",
               "1", "--val_freq", "1", "--butd_cls", "--trainable_text",
               "--eval_train_split", "--joint_det", "--eos_coef", "0.02",
               "--lr_decay_epochs", "1"]


def _history(out):
    rows = {}
    with open(osp.join(out, "history.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            assert rows.setdefault(row["epoch"], row) == row
    return rows


def test_study_resumed_equals_uninterrupted(tmp_path, one_torch_thread):
    from butd_detr_tpu_torch.data import make_rich_scannet
    from butd_detr_tpu_torch.train.study import main

    data = str(tmp_path / "data")
    make_rich_scannet(data, n_train=1, n_val=1, points_per_scan=1500)
    runs = {}
    for name in ("whole", "chunked"):
        out = str(tmp_path / name)
        os.makedirs(out)
        os.symlink(data, osp.join(out, "data"))
        if name == "whole":
            tester = main(STUDY_FLAGS + ["--out", out, "--epochs", "2"])
        else:
            main(STUDY_FLAGS + ["--out", out, "--epochs", "1"])
            ckpt = osp.join(out, "log", "ckpt_epoch_1.pth")
            tester = main(STUDY_FLAGS + ["--out", out, "--epochs", "2",
                                         "--resume", ckpt])
        runs[name] = (_history(out), torch.load(
            osp.join(out, "log", "ckpt_epoch_2.pth"), weights_only=True))
    (h_whole, c_whole), (h_chunk, c_chunk) = runs["whole"], runs["chunked"]
    assert sorted(h_whole) == [1, 2] and h_whole == h_chunk
    assert h_whole[2]["step"] == 2 * h_whole[1]["step"] > 0
    assert c_whole["step"] == c_chunk["step"] == h_whole[2]["step"]
    for k, v in c_whole["model"].items():
        assert torch.equal(v, c_chunk["model"][k]), k
    groups = [g["name"] for g in c_whole["optimizer"]["param_groups"]]
    assert "text" in groups
    assert groups == [g["name"] for g in c_chunk["optimizer"]
                      ["param_groups"]]
    for i, st in c_whole["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, c_chunk["optimizer"]["state"][i][k])
    assert torch.equal(c_whole["generator_state"], c_chunk["generator_state"])
    assert tester.history[-1] == h_chunk[2]

"""Pretrained initialisation, and `--use_bf16` at every entry point, on
the CPU.

The port's `train/pretrained.py:apply_pretrained_init` against the JAX
package's on one set of weights (moved across by
`convert.state_dict_from_jax`), at a small size (2-layer text tower,
narrow widths): after both run on the same sources, the port's parameters
equal the JAX ones mapped by `convert.py`, bit for bit, and the two
`report`s are equal. Sources: the repo's class-name table
`studies/attrib_r5/ref/data/class_embeddings3d.npy`, found by default under
`data_root` or named by `--class_embeddings_path`; a `--pp_checkpoint`
written from the port's own backbone (one tensor left out, wrapped as a
DDP checkpoint), behind the reference's `input_feature_dim == 3` gate; an
HF-named RoBERTa file; and a RoBERTa source that does not exist (the
"skipped" path keeps the random init).
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from butd_detr_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from butd_detr_tpu.lang.roberta import RobertaConfig as JRobertaConfig
from butd_detr_tpu.train.config import Config as JConfig
from butd_detr_tpu.train.pretrained import (
    apply_pretrained_init as j_apply_pretrained_init,
)
from butd_detr_tpu.train.step import (
    INPUT_KEYS as J_INPUT_KEYS,
    TrainState,
    build_model as j_build_model,
)
from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.convert import state_dict_from_jax
from butd_detr_tpu_torch.data import SyntheticGroundingDataset
from butd_detr_tpu_torch.lang import RobertaConfig
from butd_detr_tpu_torch.predict import (
    GroundingPredictor,
    build_model,
    load_state_dict,
)
from butd_detr_tpu_torch.train import TrainTester, Trainer
from butd_detr_tpu_torch.train.pretrained import (
    apply_pretrained_init,
    roberta_state_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE_DIR = os.path.join(ROOT, "studies", "attrib_r5", "ref", "data")
TABLE = os.path.join(TABLE_DIR, "class_embeddings3d.npy")
ROBERTA = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=96,
               max_position_embeddings=40)
NPOINTS = (64, 32, 16, 8)
CFG = dict(use_color=True, butd_cls=True, self_attend=True,
           use_contrastive_align=True, use_soft_token_loss=True,
           num_target=16, num_encoder_layers=1, num_decoder_layers=2,
           max_text_len=12, num_points=256, max_num_obj=8, max_det_boxes=8,
           backbone_bf16=False, attn_precise=True, batch_size=4,
           num_workers=0, print_freq=1)
DROPPED = "sa1.mlp_module.layer0.conv.weight"


@pytest.fixture(scope="module")
def weights():
    """The JAX state (shapes from `eval_shape`, distinct seeded values so
    that an untouched leaf stays recognisable) and its port state dict."""
    jm = j_build_model(JConfig(**CFG), roberta_config=JRobertaConfig(
        **ROBERTA), backbone_npoints=NPOINTS)
    batch = j_synthetic_batch(batch_size=2, num_points=256, max_text_len=12,
                              max_num_obj=8, max_det_boxes=8,
                              n_true_objects=3, n_true_tokens=6,
                              n_true_det=4, vocab_size=128)
    inputs = {k: jnp.asarray(batch[k]) for k in J_INPUT_KEYS if k in batch}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), inputs))
    rng = np.random.default_rng(42)
    variables = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype)
        if np.issubdtype(s.dtype, np.floating) else np.zeros(s.shape,
                                                             s.dtype),
        shapes)
    state = TrainState(step=np.zeros((), np.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=None)
    return state, state_dict_from_jax(variables["params"],
                                      variables["batch_stats"])


def _port_model(cfg, sd):
    model = build_model(cfg, RobertaConfig(**ROBERTA), NPOINTS)
    assert load_state_dict(model, sd) == []
    return model


@pytest.fixture(scope="module")
def sources(tmp_path_factory, weights):
    """An HF-named RoBERTa file ('roberta.' prefixed, with a pooler the
    model lacks) and a GroupFree-style backbone checkpoint written from
    the port's own backbone, one tensor left out."""
    tmp = tmp_path_factory.mktemp("sources")
    model = _port_model(Config(**CFG), weights[1])
    rng = np.random.default_rng(7)

    def noise(t):
        return torch.from_numpy(rng.standard_normal(tuple(t.shape))
                                .astype(np.float32))

    text = {f"roberta.{k}": noise(v)
            for k, v in model.text_encoder.state_dict().items()}
    text["roberta.pooler.dense.weight"] = torch.zeros(64, 64)
    torch.save(text, str(tmp / "roberta.pth"))
    backbone = {f"module.{k}": noise(v) if v.is_floating_point() else v
                for k, v in model.backbone_net.state_dict().items()
                if k != DROPPED}
    torch.save({"model": backbone}, str(tmp / "gf.pth"))
    return tmp


CASES = {
    # the reference's default: the table under --data_root, no flag
    "default_table": lambda t: dict(data_root=TABLE_DIR),
    "table_by_flag": lambda t: dict(data_root=str(t),
                                    class_embeddings_path=TABLE),
    "all_sources": lambda t: dict(data_root=TABLE_DIR,
                                  roberta_checkpoint=str(t / "roberta.pth"),
                                  pp_checkpoint=str(t / "gf.pth")),
    # no colour: input_feature_dim 0, the backbone file is not read
    "feature_dim_gate": lambda t: dict(data_root=str(t), use_color=False,
                                       pp_checkpoint=str(t / "gf.pth")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_pretrained_init_matches_the_jax_package(weights, sources,
                                                       case):
    state, sd = weights
    kw = dict(CFG, roberta_checkpoint=str(sources / "nope.pth"))
    kw.update(CASES[case](sources))
    model = _port_model(Config(**CFG), sd)  # the flags change no shape
    report = apply_pretrained_init(model, Config(**kw),
                                   roberta_config=RobertaConfig(**ROBERTA))
    j_state, j_report = j_apply_pretrained_init(
        state, JConfig(**kw), roberta_config=JRobertaConfig(**ROBERTA))
    assert report == j_report
    want = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, j_state.params),
        jax.tree_util.tree_map(np.asarray, j_state.batch_stats))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    table = np.load(TABLE)
    emb = got["butd_class_embeddings.weight"].numpy()
    if case == "feature_dim_gate":
        assert report["butd_class_embeddings"].startswith("skipped (no file")
        assert report["backbone_net"] == (
            "skipped (input_feature_dim 0 != 3, reference gate bdetr.py:68)")
        np.testing.assert_array_equal(
            emb, sd["butd_class_embeddings.weight"].numpy())
    else:
        assert report["butd_class_embeddings"] == "loaded"
        np.testing.assert_array_equal(emb, table)
    if case == "all_sources":
        assert report["text_encoder"] == "loaded"
        n = sum(not k.endswith("num_batches_tracked")
                for k in model.backbone_net.state_dict())
        assert report["backbone_net"] == f"loaded {n - 1} leaves, 1 kept"
        assert torch.equal(got[f"backbone_net.{DROPPED}"],
                           sd[f"backbone_net.{DROPPED}"])
        saved = torch.load(str(sources / "roberta.pth"))
        assert torch.equal(
            got["text_encoder.embeddings.word_embeddings.weight"],
            saved["roberta.embeddings.word_embeddings.weight"])
    else:
        # a source that does not exist keeps the random init, loudly
        assert report["text_encoder"].startswith(
            "skipped (FileNotFoundError")
        for k in got:
            if k.startswith("text_encoder."):
                assert torch.equal(got[k], sd[k]), k


def test_roberta_state_dict_raises_without_transformers(monkeypatch):
    """The default source is a local `transformers` cache; where the
    package is absent (as on the card) the call raises, and the harness
    keeps the random init."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        roberta_state_dict(None)


class _Tester(TrainTester):
    def get_datasets(self):
        scenes = SyntheticGroundingDataset(
            4, seed=3, num_points=256, max_text_len=12, max_num_obj=8,
            max_det_boxes=8, n_true_objects=3, n_true_tokens=6,
            n_true_det=4, vocab_size=128)
        return scenes, scenes

    def _roberta_config(self):
        return RobertaConfig(**ROBERTA)

    def get_model(self):
        return build_model(self.cfg, self._roberta_config(), NPOINTS)


def test_train_tester_loads_the_default_table_before_a_restore(tmp_path):
    """`TrainTester.main` initialises from the pretrained sources after it
    builds the trainer (the JAX harness's `init_pretrained`): with the
    table under `--data_root` and no flag, the model evaluates with it."""
    cfg = Config(**dict(CFG, data_root=TABLE_DIR, eval=True,
                        roberta_checkpoint=str(tmp_path / "nope.pth"),
                        log_dir=str(tmp_path / "log")))
    trainer = _Tester(cfg, device="cpu").main()
    np.testing.assert_array_equal(
        trainer.model.butd_class_embeddings.weight.detach().numpy(),
        np.load(TABLE))
    log = (tmp_path / "log" / "log.txt").read_text()
    assert "pretrained butd_class_embeddings: loaded" in log


@pytest.mark.parametrize("entry", ["build_model", "Trainer",
                                   "GroundingPredictor", "TrainTester"])
def test_use_bf16_is_honoured_by_every_entry_point(tmp_path, entry):
    """`--use_bf16` builds the bf16-compute model at every entry point: f32
    parameters, bf16 out of its heads (tests/test_torch_bf16*.py hold it
    against the JAX model); the same config without the flag, f32 out."""
    roberta = RobertaConfig(**ROBERTA)
    feats = torch.randn(1, 5, 288)
    base = torch.rand(1, 5, 3)
    for use_bf16, dtype in ((True, torch.bfloat16), (False, torch.float32)):
        cfg = Config(**dict(CFG, use_bf16=use_bf16,
                            log_dir=str(tmp_path / f"log{use_bf16}")))
        model = {
            "build_model": lambda: build_model(cfg, roberta, NPOINTS),
            "Trainer": lambda: Trainer(
                cfg, roberta_config=roberta, backbone_npoints=NPOINTS,
                device="cpu").model,
            "GroundingPredictor": lambda: GroundingPredictor(
                cfg, roberta_config=roberta, backbone_npoints=NPOINTS,
                device="cpu").model,
            "TrainTester": lambda: _Tester(cfg, device="cpu").get_trainer(
                1).model,
        }[entry]().eval()
        assert model.dtype is dtype
        assert {p.dtype for p in model.parameters()} == {torch.float32}
        with torch.no_grad():
            heads = model.prediction_heads[-1](feats, base.to(dtype))
            logits = model.points_obj_cls(feats)
        assert {v.dtype for v in heads.values()} == {dtype}, entry
        assert logits.dtype is dtype

"""The port's class-embedding table and text-trunk pretraining against the
JAX package's, on the CPU.

- `generate_class_embeddings` within 1e-5 of the JAX function on the same
  RoBERTa weights (`convert.named_arrays_from_jax`), the port's attention
  in its precise mode; `gen_class_embeddings_torch.py` in process (a torch
  state dict through `--params`) equals the in-process function and loads
  through `init_class_embeddings`; with no weights it exits with the JAX
  script's message.
- `scripts/pretrain_text_torch.py` draws the JAX script's batches (every
  draw of the seeded `RandomState` and every tokenized batch equal), its
  npz has the flax trunk's keys and shapes and loads through
  `convert.load_text_init`, and one step of its optimizer
  (`torch.optim.AdamW`, lr 1e-3, weight decay 1e-4) equals optax's `adamw`
  within 1e-5 * max|g| of the update.
"""

import os.path as osp
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from butd_detr_tpu.lang.class_embeddings import (
    generate_class_embeddings as j_generate,
)
from butd_detr_tpu.lang.roberta import RobertaModel as JRobertaModel
from butd_detr_tpu.lang.roberta import tiny_roberta_config as j_tiny
from butd_detr_tpu.lang.tokenizer import SimpleTokenizer as JSimpleTokenizer
from butd_detr_tpu_torch.convert import load_text_init, named_arrays_from_jax
from butd_detr_tpu_torch.data.scannet_config import scannet_classes
from butd_detr_tpu_torch.lang import (
    RobertaModel,
    SimpleTokenizer,
    small_text_roberta_config,
    tiny_roberta_config,
)
from butd_detr_tpu_torch.lang.class_embeddings import (
    generate_class_embeddings,
)
from butd_detr_tpu_torch.train.pretrained import init_class_embeddings
from torch_threads import one_torch_thread  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _jax_tower(seed=0):
    jm = JRobertaModel(j_tiny())
    ids = jnp.ones((1, 16), jnp.int32)
    params = jm.init(jax.random.PRNGKey(seed), ids, ids)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_tower(params):
    arrays = named_arrays_from_jax({"text_encoder": params})
    m = RobertaModel(tiny_roberta_config(), precise=True)
    m.load_state_dict({k[len("text_encoder."):]: torch.from_numpy(v.copy())
                       for k, v in arrays.items()})
    return m.eval()


def test_class_embeddings_match_jax():
    params = _jax_tower(0)
    names = scannet_classes(485)[:100]
    want = j_generate(j_tiny(), params, JSimpleTokenizer(max_len=16), names)
    got = generate_class_embeddings(_port_tower(params),
                                    SimpleTokenizer(max_len=16), names)
    assert got.shape == want.shape == (100, 64)
    assert np.abs(got - want).max() <= 1e-5


def test_gen_class_embeddings_cli_in_process(tmp_path):
    import gen_class_embeddings_torch

    params = _jax_tower(1)
    tower = _port_tower(params)
    weights = str(tmp_path / "roberta.pth")
    torch.save(tower.state_dict(), weights)
    out = str(tmp_path / "table.npy")
    gen_class_embeddings_torch.main(
        ["--output", out, "--params", weights, "--device", "cpu",
         "--tiny_roberta"])
    table = np.load(out)
    assert table.shape == (485, 64) and np.isfinite(table).all()
    # the script's tower runs the default attention mode (bf16 operands)
    tower.encoder.layer.apply(lambda m: setattr(m, "precise", False)
                              if hasattr(m, "precise") else None)
    want = generate_class_embeddings(tower, SimpleTokenizer(max_len=16),
                                     scannet_classes(485))
    assert np.array_equal(table, want)
    model = types.SimpleNamespace(
        butd_class_embeddings=torch.nn.Embedding(485, 64))
    assert init_class_embeddings(model, out)
    assert np.array_equal(model.butd_class_embeddings.weight.detach()
                          .numpy(), table)


def test_gen_class_embeddings_without_weights_exits(tmp_path):
    import gen_class_embeddings_torch

    with pytest.raises(SystemExit) as e:
        gen_class_embeddings_torch.main(
            ["--output", str(tmp_path / "t.npy"), "--device", "cpu",
             "--tiny_roberta", "--params", str(tmp_path / "missing.pth")])
    assert str(e.value).startswith("no RoBERTa weights available (")
    assert str(e.value).endswith("); pass --params")


# ------------------------------------------------------------- pretraining

class _Recorder(np.random.RandomState):
    """A RandomState that logs each draw's arguments and result."""

    log = None

    def _draw(self, name, *a):
        out = getattr(super(), name)(*a)
        self.log.append((name, a, np.asarray(out).tolist()))
        return out

    def randint(self, *a):
        return self._draw("randint", *a)

    def rand(self, *a):
        return self._draw("rand", *a)


def _pretrain_module():
    sys.path.insert(0, osp.join(ROOT, "scripts"))
    try:
        import pretrain_text_torch
    finally:
        sys.path.pop(0)
    return pretrain_text_torch


@pytest.fixture(scope="module")
def jax_pretrain_run(tmp_path_factory):
    """The JAX script's run (2 steps of 8) with its draws and tokenized
    batches recorded."""
    import butd_detr_tpu.lang.tokenizer as j_tok

    out = str(tmp_path_factory.mktemp("jax_pretrain") / "text_init.npz")
    draws, batches = [], []
    call = j_tok.SimpleTokenizer.__call__

    def spy(self, texts, max_len=None):
        enc = call(self, texts, max_len)
        batches.append((list(texts), enc.ids.copy(),
                        enc.attention_mask.copy()))
        return enc

    class Recorder(_Recorder):
        log = draws

    mp = pytest.MonkeyPatch()
    mp.setattr(j_tok.SimpleTokenizer, "__call__", spy)
    mp.setattr(np.random, "RandomState", Recorder)
    mp.setattr(sys, "argv", ["pretrain_text.py", "--out", out, "--steps",
                             "2", "--batch", "8"])
    sys.path.insert(0, osp.join(ROOT, "scripts"))
    try:
        import pretrain_text

        pretrain_text.main()
    finally:
        sys.path.pop(0)
        mp.undo()
    return out, draws, batches


def test_pretrain_batches_equal_the_jax_scripts(jax_pretrain_run):
    _, draws, batches = jax_pretrain_run
    pt = _pretrain_module()
    log = []

    class Recorder(_Recorder):
        pass

    Recorder.log = log
    rng = Recorder(0)
    tok = SimpleTokenizer(max_len=32)
    classes = scannet_classes(485)
    from butd_detr_tpu_torch.data.scannet_config import relations

    got = [pt.make_batch(rng, tok, classes, relations(), 8)
           for _ in range(3)]  # the init's batch, then 2 steps
    assert log == draws
    for (texts, ids, mask), (g_ids, g_mask, _) in zip(batches[:3], got):
        assert np.array_equal(g_ids, ids) and np.array_equal(g_mask, mask)


def test_pretrain_script_writes_the_flax_trunk(jax_pretrain_run, tmp_path):
    jax_out, _, _ = jax_pretrain_run
    pt = _pretrain_module()
    out = str(tmp_path / "text_init_torch.npz")
    pt.main(["--out", out, "--steps", "2", "--batch", "8", "--device",
             "cpu"])
    got, want = np.load(out), np.load(jax_out)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape, k
    model = types.SimpleNamespace(text_encoder=RobertaModel(
        small_text_roberta_config()))
    load_text_init(out, model)
    sd = model.text_encoder.state_dict()
    assert np.array_equal(
        sd["encoder.layer.0.attention.self.query.weight"].numpy(),
        got["layer_0/attention/q_proj/kernel"].T)


def test_adamw_step_matches_optax():
    rng = np.random.RandomState(3)
    params = {"w": rng.randn(9, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    grads = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
             for k, v in params.items()}
    tx = optax.adamw(1e-3, weight_decay=1e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    upd, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                       tx.init(jp), jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = torch.optim.AdamW(tp.values(), 1e-3, weight_decay=1e-4)
    for k, prm in tp.items():
        prm.grad = torch.from_numpy(grads[k])
    opt.step()
    gmax = max(np.abs(g).max() for g in grads.values())
    for k, prm in tp.items():
        got = prm.detach().numpy().astype(np.float64) - params[k]
        want = np.asarray(upd[k], np.float64)
        assert np.abs(got - want).max() <= 1e-5 * gmax, k

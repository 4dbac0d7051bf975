"""The span predictor of the port against the JAX package's, on the CPU.

Weights move across with `convert.span_state_dict_from_jax`; inputs are
numpy-seeded; both sides run strict f32 (the port's attention in its
precise mode, the JAX tower on its plain CPU path, TF32 off).

- RoBERTa's train mode: at p 0 it equals eval mode bit for bit; at p 0.1
  each attention call takes its own seed, the kept share of every mask is
  within 3 sigma of 0.9, and the backward regenerates the forward's mask.
- `SpanPredictor`'s eval logits within 1e-5 + 1e-5 * max|JAX|.
- `span_bce_loss`, masked and unmasked, within 1e-6 relative;
  `scores_to_pred_spans` bit-equal, the empty-row fallback included.
- The train step's gradient at p 0 (flax's `Dropout` patched out) within
  1e-5 * max|g|; the trainer's optimizer (`torch.optim.Adam`, betas
  (0, 0.9)) on given gradients equal to `optax.adam(b1=0.0, b2=0.9)` over
  3 steps within 1e-7 * max|p|.
- `SpanTextDataset` and `batch_iter` give the JAX package's annotations,
  ids, masks and positive maps bit for bit on a `make_fake_scannet` root,
  for sr3d, nr3d and scanrefer, training and store modes.
- `eval_accuracy` equal, the `store_spans` JSON within 1e-6.
- `span_cls_torch.py` (train, `--eval`, `--store`) in process on the CPU,
  and the port's grounding dataset reading the stored spans.
"""

import csv
import importlib
import json
import os.path as osp

import numpy as np
import flax
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from butd_detr_tpu.data.synthetic import make_fake_scannet
from butd_detr_tpu.lang import span_trainer as j_span_trainer
from butd_detr_tpu.lang.roberta import tiny_roberta_config as j_tiny
from butd_detr_tpu.lang.span_predictor import (
    SpanPredictor as JSpanPredictor,
    scores_to_pred_spans as j_scores_to_pred_spans,
    span_bce_loss as j_span_bce_loss,
)
from butd_detr_tpu.lang.tokenizer import SimpleTokenizer as JSimpleTokenizer
from butd_detr_tpu_torch.convert import span_state_dict_from_jax
from butd_detr_tpu_torch.lang import SimpleTokenizer, tiny_roberta_config
from butd_detr_tpu_torch.lang import span_trainer
from butd_detr_tpu_torch.lang.roberta import RobertaModel
from butd_detr_tpu_torch.lang.span_predictor import (
    SpanPredictor,
    scores_to_pred_spans,
    span_bce_loss,
)
from torch_threads import one_torch_thread  # noqa: F401

# the module (the package exports its function under the same name)
ops_attention = importlib.import_module("butd_detr_tpu_torch.ops.attention")

L = 32


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("span_root")
    return make_fake_scannet(str(root), points_per_scan=500)


def _tokens(seed, b=3, length=L):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 1024, (b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    ids[1, 20:], mask[1, 20:] = 1, 0
    ids[2, 9:], mask[2, 9:] = 1, 0
    return ids, mask


def _jax_predictor(seed=0):
    ids, mask = _tokens(seed)
    jm = JSpanPredictor(j_tiny())
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(ids),
                     jnp.asarray(mask))["params"]
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _port_predictor(params):
    pm = SpanPredictor(tiny_roberta_config(), precise=True)
    pm.load_state_dict(span_state_dict_from_jax(params))
    return pm


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------ RoBERTa train mode

def test_train_mode_at_p0_is_eval_mode_bit_for_bit():
    torch.manual_seed(0)
    cfg = tiny_roberta_config(hidden_dropout=0.0, attention_dropout=0.0)
    m = RobertaModel(cfg, precise=True)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.1)
    ids, mask = _tokens(1)
    ids, mask = _t(ids).long(), _t(mask)
    with torch.no_grad():
        assert torch.equal(m(ids, mask, train=True),
                           m(ids, mask, train=False))


def test_dropout_seeds_keep_rates_and_the_backward_mask(monkeypatch):
    p = 0.1
    m = RobertaModel(tiny_roberta_config(), precise=True)
    for prm in m.parameters():
        torch.nn.init.normal_(prm, std=0.1)
    m.rng.seed(1234)
    ids, mask = _tokens(2)
    fwd, bwd, kept = [], [], []
    attention, backward = ops_attention.attention, \
        ops_attention.attention_backward

    def attention_spy(q, k, v, pad, **kw):
        if kw["dropout_p"] > 0:
            fwd.append(kw["seed"])
        return attention(q, k, v, pad, **kw)

    def backward_spy(*a, **kw):
        bwd.append(kw["seed"])
        return backward(*a, **kw)

    import butd_detr_tpu_torch.lang.roberta as roberta
    import butd_detr_tpu_torch.nn.attention as nn_attention

    dropout = roberta.dropout

    def dropout_spy(x, prob, rng):
        y = dropout(x, prob, rng)
        kept.append(float((y != 0).float().mean()))
        return y

    monkeypatch.setattr(nn_attention, "attention", attention_spy)
    monkeypatch.setattr(ops_attention, "attention_backward", backward_spy)
    monkeypatch.setattr(roberta, "dropout", dropout_spy)
    out = m(_t(ids).long(), _t(mask), train=True)
    out.square().sum().backward()

    layers = len(m.encoder.layer)
    assert len(fwd) == layers and len(set(fwd)) == layers
    assert sorted(bwd) == sorted(fwd)
    B, H = ids.shape[0], m.config.num_attention_heads
    n = B * H * L * L
    for seed in fwd:
        share = float(ops_attention.dropout_keep_mask_plain(
            seed, B, H, L, L, p).float().mean())
        assert abs(share - (1 - p)) <= 3 * (p * (1 - p) / n) ** 0.5
    assert len(kept) == 1 + 2 * layers
    n = ids.size * m.config.hidden_size
    for share in kept:
        assert abs(share - (1 - p)) <= 3 * (p * (1 - p) / n) ** 0.5


def test_attention_backward_regenerates_the_forward_mask():
    rng = np.random.RandomState(3)
    q, k, v = (_t(rng.randn(2, 4, L, 16).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    dout = _t(rng.randn(2, 4, L, 16).astype(np.float32))
    seed, p = 987654321, 0.1
    out = ops_attention.attention(q, k, v, None, sm_scale=0.25,
                                  dropout_p=p, seed=seed, precise=True)
    out.backward(dout)
    keep = ops_attention.dropout_keep_mask_plain(seed, 2, 4, L, L, p)
    want = ops_attention.attention_plain(q, k, v, None, sm_scale=0.25,
                                         precise=True, keep_mask=keep,
                                         dropout_p=p)
    assert torch.equal(out, want)
    grads = ops_attention.attention_backward_plain(
        q.detach(), k.detach(), v.detach(), dout, None, sm_scale=0.25,
        precise=True, keep_mask=keep, dropout_p=p)
    for got, g in zip((q.grad, k.grad, v.grad), grads):
        assert torch.equal(got, g)


# ----------------------------------------------------------- the predictor

def test_span_predictor_eval_logits_match_jax():
    jm, params = _jax_predictor(0)
    ids, mask = _tokens(4)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                               jnp.asarray(mask)))
    pm = _port_predictor(params).eval()
    with torch.no_grad():
        got = pm(_t(ids).long(), _t(mask)).numpy()
    assert got.shape == (3, L)
    assert np.abs(got - want).max() <= 1e-5 + 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("masked", [False, True])
def test_span_bce_loss(masked):
    rng = np.random.RandomState(5)
    z = (rng.randn(4, L) * 3).astype(np.float32)
    t = (rng.rand(4, L) < 0.2).astype(np.float32)
    _, mask = _tokens(6, b=4)
    m = mask if masked else None
    want = float(j_span_bce_loss(jnp.asarray(z), jnp.asarray(t),
                                 None if m is None else jnp.asarray(m)))
    got = float(span_bce_loss(_t(z), _t(t), None if m is None else _t(m)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_scores_to_pred_spans_bit_equal():
    rng = np.random.RandomState(7)
    scores = rng.randn(5, L).astype(np.float32)
    scores[1] = -np.abs(scores[1]) - 0.1  # no positive bin: argmax one-hot
    scores[3] = -1.0  # every score tied
    got = scores_to_pred_spans(scores)
    want = j_scores_to_pred_spans(scores)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_train_step_gradient_at_p0_matches_jax(monkeypatch):
    jm, params = _jax_predictor(1)
    ids, mask = _tokens(8)
    pmap = np.zeros((3, 256), np.float32)
    pmap[0, 3:5] = pmap[1, 7] = pmap[2, 1:4] = 1.0

    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, *a, **k: x)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids),
                          jnp.asarray(mask), train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return j_span_bce_loss(logits, jnp.asarray(pmap)[:, :L])

    want_loss, want = jax.value_and_grad(loss_fn)(params)
    want = span_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           want))

    cfg = tiny_roberta_config(hidden_dropout=0.0, attention_dropout=0.0)
    pm = SpanPredictor(cfg, precise=True)
    pm.load_state_dict(span_state_dict_from_jax(params))
    pm.projector[2].p = 0.0
    logits = pm(_t(ids).long(), _t(mask), train=True)
    loss = span_bce_loss(logits, _t(pmap)[:, :L])
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) \
        <= 1e-6 * float(want_loss)
    gmax = max(float(g.abs().max()) for g in want.values())
    for name, prm in pm.named_parameters():
        err = float((prm.grad - want[name]).abs().max())
        assert err <= 1e-5 * gmax, (name, err, gmax)


def test_adam_matches_optax_adam_b1_0():
    rng = np.random.RandomState(9)
    params = {"a": rng.randn(7, 5).astype(np.float32),
              "b": rng.randn(11).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 10 ** rng.uniform(-3, 1))
              .astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = optax.adam(1e-2, b1=0.0, b2=0.9)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v.copy())) for k, v in params.items()}
    made = span_trainer.SpanTrainer(tiny_roberta_config(), max_len=L,
                                    device="cpu").optimizer
    d = made.defaults
    opt = type(made)(tp.values(), 1e-2, betas=d["betas"], eps=d["eps"],
                     weight_decay=d["weight_decay"])
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, prm in tp.items():
            prm.grad = _t(g[k])
        opt.step()
    for k, prm in tp.items():
        want = np.asarray(jp[k])
        assert np.abs(prm.detach().numpy() - want).max() \
            <= 1e-7 * np.abs(want).max(), k


# ------------------------------------------------- dataset and the trainer

@pytest.mark.parametrize("dataset", ["sr3d", "nr3d", "scanrefer"])
@pytest.mark.parametrize("store", [False, True])
def test_dataset_and_batches_match_jax(fake_root, dataset, store):
    kw = dict(data_path=fake_root, store=store, max_len=L)
    want_ds = j_span_trainer.SpanTextDataset(
        dataset, "train", tokenizer=JSimpleTokenizer(max_len=L), **kw)
    got_ds = span_trainer.SpanTextDataset(
        dataset, "train", tokenizer=SimpleTokenizer(max_len=L), **kw)
    assert len(want_ds) > 0 and got_ds.annos == want_ds.annos
    for shuffle in (False, True):
        want = list(j_span_trainer.batch_iter(want_ds, 2, shuffle, seed=3))
        got = list(span_trainer.batch_iter(got_ds, 2, shuffle, seed=3))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k],
                                                                   w[k]), k


def test_eval_accuracy_and_store_match_jax(fake_root, tmp_path):
    ds_kw = dict(data_path=fake_root, store=True, max_len=L)
    jds = j_span_trainer.SpanTextDataset(
        "sr3d", "train", tokenizer=JSimpleTokenizer(max_len=L), **ds_kw)
    pds = span_trainer.SpanTextDataset(
        "sr3d", "train", tokenizer=SimpleTokenizer(max_len=L), **ds_kw)
    jt = j_span_trainer.SpanTrainer(j_tiny(), max_len=L)
    jt.init(next(j_span_trainer.batch_iter(jds, 2, False)))
    pt = span_trainer.SpanTrainer(tiny_roberta_config(), max_len=L,
                                  device="cpu", precise=True)
    pt.model.load_state_dict(span_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.state.params)))
    batches = list(span_trainer.batch_iter(pds, 2, False))
    assert pt.eval_accuracy(batches) == jt.eval_accuracy(batches)
    utts = [a["utterance"] for a in pds.annos]
    got = pt.store_spans(batches, utts, str(tmp_path / "port.json"))
    want = jt.store_spans(batches, utts, str(tmp_path / "jax.json"))
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == got
    assert [r["utterance"] for r in got] == [r["utterance"] for r in want]
    assert np.abs(np.array([r["span"] for r in got])
                  - np.array([r["span"] for r in want])).max() <= 1e-6


def test_trainer_overfits_a_batch_and_round_trips(fake_root, tmp_path):
    ds = span_trainer.SpanTextDataset(
        "sr3d", "train", fake_root, tokenizer=SimpleTokenizer(max_len=L),
        max_len=L)
    trainer = span_trainer.SpanTrainer(tiny_roberta_config(), max_len=L,
                                       lr=3e-3, device="cpu")
    batch = next(span_trainer.batch_iter(ds, 2, False))
    losses = [float(trainer.train_step(batch)) for _ in range(30)]
    assert np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0]
    assert trainer.step == 30
    path = str(tmp_path / "span.pth")
    trainer.save(path)
    other = span_trainer.SpanTrainer(tiny_roberta_config(), max_len=L,
                                     device="cpu", seed=1)
    other.load(path)
    assert torch.equal(trainer.score_step(batch), other.score_step(batch))


def test_span_cls_cli_then_the_grounding_dataset_reads_the_spans(
        tmp_path, monkeypatch):
    import span_cls_torch
    from butd_detr_tpu_torch.data import JointGroundingDataset

    root = make_fake_scannet(str(tmp_path / "root"), points_per_scan=500)
    monkeypatch.chdir(root)
    argv = ["--data_root", root, "--device", "cpu", "--tiny_roberta",
            "--epochs", "1", "--batch_size", "2", "--max_len", str(L),
            "--checkpoint_path", str(tmp_path / "ck")]
    span_cls_torch.main(argv)
    assert osp.exists(tmp_path / "ck" / "sr3d.pth")
    span_cls_torch.main(argv + ["--eval"])
    span_cls_torch.main(argv + ["--store"])
    with open(osp.join(root, "sr3d_pred_spans.json")) as f:
        stored = json.load(f)
    ds = JointGroundingDataset(
        dataset_dict={"sr3d": 1}, split="train", data_path=root, scans={},
        tokenizer=SimpleTokenizer(max_len=L), max_text_len=L)
    # the dataset indexes the spans by the csv row (every row is stored)
    with open(osp.join(root, "meta_data", "sr3d_train_scans.txt")) as f:
        train_scans = set(eval(f.read()))
    with open(osp.join(root, "refer_it_3d", "sr3d.csv")) as f:
        rows = list(csv.DictReader(f))
    assert len(stored) == len(rows)
    raw = [i for i, r in enumerate(rows) if r["scan_id"] in train_scans
           and r["mentions_target_class"].lower() == "true"]
    assert len(ds.annos) == len(raw) > 0
    for i, anno in zip(raw, ds.annos):
        assert anno["pred_pos_map"] == stored[i]["span"]
        assert anno["span_utterance"] == stored[i]["utterance"]

"""Tensor parallelism of the port (`--mp 2`) against the JAX package, on
the CPU over gloo. Strict f32, the tiny model of test_torch_train_step.py
(d 288, 8 heads, FFN 256), weights through `state_dict_from_jax`.

(a) The sharding rules: `parallel/tp.py:param_spec` on the port's names
    shards exactly the parameters that the JAX package's `param_pspec`
    shards under `state_shardings` (read through `convert.py`'s name
    map), along the same dimension, at mp 2, 4 and 8, with the
    divisibility fallback (a hand-made layer whose width mp does not
    divide).
(b) Two `--mp 2` ranks: the eval forward against the JAX forward on one
    device (XLA's sharding is exact) within the bound of
    test_torch_model.py (|err| <= 1e-3 + 5e-3 * std, integer end points
    equal); one eval-mode gradient, gathered from the shards, against the
    one-process port's to 2e-3 * max|g| + 1e-6, and the clip's global norm
    to 1e-5 relative; three train steps with dropout 0.1 keep every
    replicated parameter and buffer bit-equal across the ranks; the
    checkpoint that the ranks write holds the one-process weights, loads
    into one process and gives the two ranks' outputs, and loads back
    into two ranks, each taking its shard.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_ranks
from butd_detr_tpu.lang.roberta import RobertaConfig as JRobertaConfig
from butd_detr_tpu.parallel import make_mesh as j_make_mesh
from butd_detr_tpu.parallel import state_shardings
from butd_detr_tpu.train.config import Config as JConfig
from butd_detr_tpu.train.step import (
    INPUT_KEYS as J_INPUT_KEYS,
    TARGET_KEYS as J_TARGET_KEYS,
    build_model as j_build_model,
)
from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.convert import (
    named_arrays_from_jax,
    state_dict_from_jax,
)
from butd_detr_tpu_torch.data import synthetic_batch
from butd_detr_tpu_torch.lang import RobertaConfig
from butd_detr_tpu_torch.parallel import param_spec, unshard_state_dicts
from butd_detr_tpu_torch.predict import build_model
from butd_detr_tpu_torch.train import load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

ROBERTA = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=96,
               max_position_embeddings=40)
NPOINTS = (64, 32, 16, 8)
CFG = dict(use_color=True, butd_cls=True, self_attend=True,
           use_contrastive_align=True, use_soft_token_loss=True,
           num_target=16, num_encoder_layers=2, num_decoder_layers=2,
           max_text_len=12, num_points=1024, max_num_obj=8, max_det_boxes=8,
           backbone_bf16=False, attn_precise=True)
BATCH = dict(batch_size=2, num_points=1024, max_text_len=12, max_num_obj=8,
             max_det_boxes=8, n_true_objects=3, n_true_tokens=6,
             n_true_det=4, vocab_size=128)


def _jax_model():
    return j_build_model(JConfig(**CFG),
                         roberta_config=JRobertaConfig(**ROBERTA),
                         backbone_npoints=NPOINTS)


def _port_specs_of_jax(params, mp):
    """{port name: dim} of what the JAX package shards over mp, read
    through the converter: each JAX leaf is filled with 1 + the dimension
    it shards (0: replicated), then mapped onto the port's names and
    layouts (a kernel's dimensions swap in the torch weight)."""
    mesh = j_make_mesh(dp=1, mp=mp)
    shardings = state_shardings(mesh, params)

    def code(leaf, sharding):
        spec = tuple(sharding.spec)
        dims = [d for d, axis in enumerate(spec) if axis == "mp"]
        return np.full(leaf.shape, 1 + dims[0] if dims else 0, np.float32)

    codes = named_arrays_from_jax(jax.tree_util.tree_map(
        code, params, shardings))
    out = {}
    for name, arr in codes.items():
        c = {int(v) for v in np.unique(arr)}
        assert len(c) == 1, name  # q, k and v shard alike
        (c,) = c
        if c:
            out[name] = c - 1 if arr.ndim == 1 else arr.ndim - c
    return out


@pytest.mark.parametrize("mp", [2, 4, 8])
def test_sharding_rules_equal_the_jax_packages(mp):
    batch = synthetic_batch(**BATCH, seed=0)
    inputs = {k: jnp.asarray(batch[k]) for k in J_INPUT_KEYS}
    shapes = jax.eval_shape(_jax_model().init, jax.random.PRNGKey(0),
                            inputs)["params"]
    want = _port_specs_of_jax(shapes, mp)
    model = build_model(Config(**CFG), RobertaConfig(**ROBERTA), NPOINTS)
    got = {}
    for name, p in model.named_parameters():
        spec = param_spec(name, tuple(p.shape), mp)
        if spec is not None:
            got[name] = spec[0]
    assert got == want
    # 3 entries an attention, 3 an FFN: 2 encoder layers of 5 + 2, 2
    # decoder layers of 4 + 1
    assert len(got) == 3 * (2 * 7 + 2 * 5)


def test_sharding_rules_fall_back_where_mp_does_not_divide():
    # a decoder layer 12 wide (attention: 12 % 8) with an FFN of 16
    d, f = 12, 16
    dense = lambda i, o: {"kernel": np.zeros((i, o)), "bias": np.zeros(o)}
    layer = {"self_attn": {p: dense(d, d) for p in
                           ("q_proj", "k_proj", "v_proj", "out_proj")},
             "ffn": {"Dense_0": dense(d, f), "Dense_1": dense(f, d)}}
    params = {"decoder_0": layer}
    want = _port_specs_of_jax(params, 8)
    assert want == {"decoder.0.ffn.0.weight": 0, "decoder.0.ffn.0.bias": 0,
                    "decoder.0.ffn.3.weight": 1}
    arrays = named_arrays_from_jax(params)
    got = {n: param_spec(n, a.shape, 8)[0] for n, a in arrays.items()
           if param_spec(n, a.shape, 8) is not None}
    assert got == want
    assert param_spec("decoder.0.self_attn.in_proj_weight", (3 * d, d),
                      4) == (0, 3)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two `--mp 2` ranks (one spawned world, running while this
    process jits the JAX forward), the JAX forward and one process's
    gradient."""
    batch = synthetic_batch(**BATCH, seed=5)
    batch = {k: batch[k] for k in (*J_INPUT_KEYS, *J_TARGET_KEYS)
             if k in batch}
    jm = _jax_model()
    inputs = {k: jnp.asarray(batch[k]) for k in J_INPUT_KEYS}
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), inputs)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    state_dict = state_dict_from_jax(to_np(variables["params"]),
                                     to_np(variables["batch_stats"]))
    ckpt_dir = str(tmp_path_factory.mktemp("tp_ckpt"))
    args = (CFG, ROBERTA, NPOINTS, state_dict, batch)
    ranks = torch_ranks.start_ranks(torch_ranks.tp_world, 2, *args,
                                    ckpt_dir)
    want = jax.jit(lambda v, i: jm.apply(v, i, train=False))(variables,
                                                             inputs)
    one = torch_ranks.make_trainer(*args[:4])
    _, grads, _ = torch_ranks.gradient_step(one, batch, train=False)
    from butd_detr_tpu_torch.train.optimizer import clip_by_global_norm_

    norm = float(clip_by_global_norm_([p.grad for p in one._params()],
                                      float("inf")))
    ranks = ranks.join()
    return dict(want={k: np.asarray(v) for k, v in want.items()},
                ranks=ranks, grads=grads, norm=norm, batch=batch,
                args=args)


def test_two_mp_ranks_forward_as_the_jax_model(world):
    want = world["want"]
    for rank in world["ranks"]:
        got = rank["forward"]
        assert set(got) == set(want)
        bad = []
        for k, w in want.items():
            if w.dtype.kind in "ib":
                np.testing.assert_array_equal(got[k], w, err_msg=k)
                continue
            err = float(np.abs(got[k].astype(np.float64) - w).max())
            lim = 1e-3 + 5e-3 * float(np.std(w))
            if err > lim:
                bad.append((k, err, lim))
        assert not bad, bad


def test_two_mp_ranks_gradient_gathers_to_one_processs(world):
    r0, r1 = world["ranks"]
    assert r0["specs"] == r1["specs"] and len(r0["specs"]) == 72
    full = unshard_state_dicts([r0["grads"], r1["grads"]], r0["specs"])
    want = world["grads"]
    assert set(full) == set(want)
    for name, w in want.items():
        lim = 2e-3 * float(w.abs().max()) + 1e-6
        assert float((full[name] - w).abs().max()) <= lim, name
        if name not in r0["specs"]:  # a replicated parameter's gradient
            assert torch.equal(r0["grads"][name], r1["grads"][name]), name
    for rank in world["ranks"]:
        assert rank["norm"] == pytest.approx(world["norm"], rel=1e-5)


def test_replicated_parameters_stay_bit_equal_with_dropout(world):
    r0, r1 = world["ranks"]
    assert all(np.isfinite(r0["losses"]))
    assert r0["losses"] == r1["losses"]
    for name, v in r0["after"].items():
        if name in r0["specs"]:
            assert not torch.equal(v, r1["after"][name]), name
        else:
            assert torch.equal(v, r1["after"][name]), name


def test_mp_checkpoint_loads_into_one_process_and_back(world):
    r0, r1 = world["ranks"]
    path = r0["checkpoint"]
    assert path == r1["checkpoint"] and os.path.exists(path)
    assert r0["restored"] and r1["restored"] and r0["restored_step"] == 3
    saved = torch.load(path, map_location="cpu", weights_only=True)
    full = unshard_state_dicts([r0["after"], r1["after"]], r0["specs"])
    assert set(saved["model"]) == set(full)
    for name, v in full.items():
        assert torch.equal(saved["model"][name], v), name
    one = torch_ranks.make_trainer(*world["args"][:4])
    assert load_checkpoint(path, one) == 4 and one.step == 3
    got = torch_ranks.eval_end_points(one, world["batch"])
    for k, w in r0["after_forward"].items():
        if w.dtype.kind in "ib":
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(w).max()),
                                       err_msg=k)

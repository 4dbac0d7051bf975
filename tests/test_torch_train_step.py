"""The training slice as a whole, at a small size on the CPU.

(a) Gradients, with dropout out of the way. The JAX model's dropout rates
are fixed, so both sides run without it: `jax.grad` of the Hungarian loss
of `model.apply(train=False)` against the port's model in `eval()` mode
with gradients enabled. Same weights (through `state_dict_from_jax`), same
`synthetic_batch`, strict f32 on both sides (`backbone_dtype=None`, the
precise attention mode). Loss to 1e-4 relative; every parameter's gradient
to 2e-3 * max|g| + 1e-6, the names matched through
`convert.named_arrays_from_jax`.

(b) `Trainer.train_step` in `train()` mode with a fixed seed: finite loss
and gradient norm, every trainable parameter changed, the frozen text
tower unchanged, BatchNorm buffers moved, the same seed gives the same
step, and 5 steps on one batch lower the loss.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from butd_detr_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from butd_detr_tpu.lang.roberta import RobertaConfig as JRobertaConfig
from butd_detr_tpu.losses import compute_hungarian_loss as j_hungarian_loss
from butd_detr_tpu.train.config import Config as JConfig
from butd_detr_tpu.train.step import (
    INPUT_KEYS as J_INPUT_KEYS,
    METRIC_KEYS as J_METRIC_KEYS,
    TARGET_KEYS as J_TARGET_KEYS,
    build_model as j_build_model,
    criterion_config as j_criterion_config,
)
from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.convert import (
    named_arrays_from_jax,
    state_dict_from_jax,
)
from butd_detr_tpu_torch.data import synthetic_batch
from butd_detr_tpu_torch.lang import RobertaConfig
from butd_detr_tpu_torch.losses import compute_hungarian_loss
from butd_detr_tpu_torch.train import (
    INPUT_KEYS,
    METRIC_KEYS,
    TARGET_KEYS,
    Trainer,
    criterion_config,
)
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


def test_synthetic_batch_is_the_jax_packages_batch():
    for kw in (dict(BATCH, seed=3), dict(BATCH, seed=4, spatial_sort=False)):
        want = j_synthetic_batch(**kw)
        got = synthetic_batch(**kw)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_step_constants_are_the_jax_packages():
    assert INPUT_KEYS == J_INPUT_KEYS and TARGET_KEYS == J_TARGET_KEYS
    assert METRIC_KEYS == J_METRIC_KEYS
    assert tuple(criterion_config(Config(**CFG))) == tuple(
        j_criterion_config(JConfig(**CFG)))


@pytest.fixture(scope="module")
def grads():
    """Loss and gradients of both packages on one batch, without dropout."""
    batch = synthetic_batch(**BATCH, seed=1)
    jcfg = JConfig(**CFG)
    jm = j_build_model(jcfg, roberta_config=JRobertaConfig(**ROBERTA),
                       backbone_npoints=NPOINTS)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    inputs = {k: jbatch[k] for k in J_INPUT_KEYS}
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), inputs)
    stats = variables["batch_stats"]

    def loss_fn(params):
        ep = jm.apply({"params": params, "batch_stats": stats}, inputs,
                      train=False)
        for k in J_TARGET_KEYS:
            ep[k] = jbatch[k]
        loss, ep = j_hungarian_loss(ep, jcfg.num_decoder_layers,
                                    j_criterion_config(jcfg),
                                    jcfg.query_points_obj_topk)
        return loss, {k: ep[k] for k in J_METRIC_KEYS}

    (want_loss, want_metrics), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    trainer = Trainer(Config(**CFG), roberta_config=RobertaConfig(**ROBERTA),
                      backbone_npoints=NPOINTS, device="cpu",
                      state_dict=state_dict_from_jax(
                          to_np(variables["params"]), to_np(stats)))
    model = trainer.model.eval()
    tbatch = trainer.to_device(batch)
    ep = model({k: tbatch[k] for k in INPUT_KEYS})
    for k in TARGET_KEYS:
        ep[k] = tbatch[k]
    loss, ep = compute_hungarian_loss(ep, 2, trainer.criterion, 4)
    loss.backward()
    return dict(
        want_loss=float(want_loss),
        want_metrics={k: float(v) for k, v in want_metrics.items()},
        want_grads=named_arrays_from_jax(to_np(want_grads)),
        loss=float(loss.detach()),
        metrics={k: float(ep[k].detach()) for k in METRIC_KEYS},
        model=model)


def test_loss_matches_the_jax_model(grads):
    assert grads["loss"] == pytest.approx(grads["want_loss"], rel=1e-4)
    for k, want in grads["want_metrics"].items():
        assert grads["metrics"][k] == pytest.approx(want, rel=1e-4,
                                                    abs=1e-6), k


def test_every_parameters_gradient_matches_the_jax_model(grads):
    want = grads["want_grads"]
    params = dict(grads["model"].named_parameters())
    assert set(want) == set(params)
    bad, moved = [], 0
    for name, p in sorted(params.items()):
        w = want[name]
        assert tuple(p.shape) == w.shape, name
        if name.startswith("text_encoder."):
            # frozen: stop_gradient there, no gradient here
            assert p.grad is None and not np.any(w), name
            continue
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        moved += bool(np.any(w))
        err = float(np.abs(g - w).max())
        lim = 2e-3 * float(np.abs(w).max()) + 1e-6
        if err > lim:
            bad.append((name, err, lim))
    assert not bad, bad
    assert moved > 100  # the comparison is not one of zeros


def _tiny_trainer(seed=0, **overrides):
    kw = dict(CFG, num_points=256, backbone_bf16=True, attn_precise=False)
    kw.update(overrides)
    return Trainer(Config(**kw), steps_per_epoch=1,
                   roberta_config=RobertaConfig(**ROBERTA),
                   backbone_npoints=NPOINTS, device="cpu", seed=seed)


def _tiny_batch(seed=0):
    return synthetic_batch(**dict(BATCH, num_points=256, batch_size=4),
                           seed=seed)


def test_train_step_moves_what_it_should_and_lowers_the_loss():
    """The default training modes: bf16 backbone MLPs, bf16-operand
    attention, dropout live."""
    trainer = _tiny_trainer()
    model = trainer.model
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = _tiny_batch()
    metrics = [trainer.train_step(batch)]
    assert set(metrics[0]) == set(METRIC_KEYS) | {"grad_norm"}
    assert all(np.isfinite(v) for v in metrics[0].values())
    assert metrics[0]["grad_norm"] > 0 and trainer.step == 1
    assert model.training
    after = model.state_dict()
    trainable = {k for k, p in model.named_parameters() if p.requires_grad}
    for name, old in before.items():
        if name.startswith("text_encoder."):
            assert torch.equal(after[name], old), name
        elif name in trainable or name.endswith(("running_mean",
                                                 "running_var")):
            assert not torch.equal(after[name], old), name
    assert not any(k.startswith("text_encoder.") for k in trainable)
    for _ in range(4):
        metrics.append(trainer.train_step(batch))
    losses = [m["loss"] for m in metrics]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_train_step_is_a_function_of_the_seed():
    batch = _tiny_batch(2)
    a = _tiny_trainer(seed=5).train_step(batch)
    b = _tiny_trainer(seed=5).train_step(batch)
    assert a == b
    # another seed: other weights and other dropout masks
    assert _tiny_trainer(seed=6).train_step(batch)["loss"] != a["loss"]


def test_eval_step_returns_the_end_points_and_changes_nothing():
    trainer = _tiny_trainer()
    batch = _tiny_batch(1)
    before = {k: v.detach().clone()
              for k, v in trainer.model.state_dict().items()}
    ep = trainer.eval_step(batch)
    assert not trainer.model.training
    assert ep["last_center"].shape == (4, 16, 3)
    assert np.isfinite(float(ep["loss"]))
    again = trainer.eval_step(batch)
    assert float(again["loss"]) == float(ep["loss"])  # no dropout in eval
    plain = trainer.eval_step({k: batch[k] for k in INPUT_KEYS},
                              with_loss=False)
    assert "loss" not in plain
    assert torch.equal(plain["last_center"], ep["last_center"])
    for name, old in before.items():
        assert torch.equal(trainer.model.state_dict()[name], old), name


def test_unfrozen_text_tower_trains():
    trainer = _tiny_trainer(freeze_text_encoder=False)
    assert [g["name"] for g in trainer.optimizer.param_groups] == [
        "main", "backbone", "text"]
    w = trainer.model.text_encoder.embeddings.word_embeddings.weight
    old = w.detach().clone()
    m = trainer.train_step(_tiny_batch(3))
    assert np.isfinite(m["loss"]) and not torch.equal(w, old)

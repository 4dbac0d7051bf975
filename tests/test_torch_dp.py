"""Data parallelism of the port against the JAX package's dp mesh, on the
CPU over gloo.

(a) One batch of 8 and one set of weights (through `state_dict_from_jax`)
    through the JAX package's global batch under `make_mesh(dp=2)` with
    `shard_batch` (one jitted function), the port's two-rank `--dp 2`
    world (each rank 4 rows) and its one process at B = 8. Dropout 0 on
    both sides (the JAX model's rates are fixed: flax's `Dropout` is
    patched out). Strict f32.
    - Eval-mode BatchNorm: the loss (the ranks' mean) to 1e-4 relative and
      every parameter's averaged gradient to 2e-3 * max|g| + 1e-6 (the
      bound of test_torch_train_step.py): the box count, the loss's
      normalisation and the gradient average of the global batch.
    - Train mode, mutable `batch_stats`: the loss to 1e-4 relative and the
      new BatchNorm running buffers to 5e-5 * max(|buffer|, 1) (sa1's
      first variance, E[x^2] - E[x]^2 over 32,768 rows in f32, moves by
      1.5e-5 of itself with the order of the sums, in one process too).
      The train-mode gradient is not held against JAX parameter by
      parameter: the JAX package's own eager and jitted train-mode
      gradients of this model differ beyond the bound above (in eval mode
      they agree exactly), and so do the port's two ranks and one
      process, whose sums run in another order. The two ranks' gradient
      is held against one process's by its relative L2 error over all
      parameters, at most 5e-2 (observed 0.007-0.011 over two sets of
      weights; a BatchNorm whose all-reduce passed the gradient through
      unsummed gave 0.64).
(b) Global BatchNorm: each rank's rows are constant and differ by rank,
    so the per-rank variance is 0 and the global one is not; two ranks
    equal one process on the concatenated rows in output, running buffers
    and input gradient.

One spawned world runs (a)'s ranks and then (b)'s, while this process
jits the JAX step.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_ranks
from butd_detr_tpu.losses import compute_hungarian_loss as j_hungarian_loss
from butd_detr_tpu.lang.roberta import RobertaConfig as JRobertaConfig
from butd_detr_tpu.parallel import (
    commit_replicated,
    make_mesh as j_make_mesh,
    shard_batch,
)
from butd_detr_tpu.train.config import Config as JConfig
from butd_detr_tpu.train.step import (
    INPUT_KEYS as J_INPUT_KEYS,
    TARGET_KEYS as J_TARGET_KEYS,
    build_model as j_build_model,
    criterion_config as j_criterion_config,
)
from butd_detr_tpu_torch.convert import (
    named_arrays_from_jax,
    state_dict_from_jax,
)
from butd_detr_tpu_torch.data import synthetic_batch
from butd_detr_tpu_torch.nn.mlp import BatchNorm

ROBERTA = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=96,
               max_position_embeddings=40)
NPOINTS = (64, 32, 16, 8)
CFG = dict(use_color=True, butd_cls=True, self_attend=True,
           use_contrastive_align=True, use_soft_token_loss=True,
           num_target=16, num_encoder_layers=2, num_decoder_layers=2,
           max_text_len=12, num_points=1024, max_num_obj=8, max_det_boxes=8,
           backbone_bf16=False, attn_precise=True)
DRIFT = 5e-2
BATCH = dict(batch_size=8, num_points=1024, max_text_len=12, max_num_obj=8,
             max_det_boxes=8, n_true_objects=3, n_true_tokens=6,
             n_true_det=4, vocab_size=128)


# (b)'s rows: rank r's four rows are constant r + 1, so the variance is 0
# on a rank and var([1, 2]) = 0.25 over both
BN_ROWS = np.kron(np.arange(1, 3, dtype=np.float32)[:, None],
                  np.ones((4, 5), np.float32))
BN_SEED = 3


@pytest.fixture(scope="module")
def steps():
    """The JAX dp=2 step, the port's two ranks (one spawned world, which
    also runs (b)'s BatchNorm) and its one process. The world runs while
    this process jits the JAX step."""
    import flax.linen

    batch = synthetic_batch(**BATCH, seed=11)
    keys = [k for k in (*J_INPUT_KEYS, *J_TARGET_KEYS) if k in batch]
    batch = {k: batch[k] for k in keys}
    jcfg = JConfig(**CFG)
    jm = j_build_model(jcfg, roberta_config=JRobertaConfig(**ROBERTA),
                       backbone_npoints=NPOINTS)
    inputs = {k: jnp.asarray(batch[k]) for k in J_INPUT_KEYS}
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), inputs)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    state_dict = state_dict_from_jax(to_np(variables["params"]),
                                     to_np(variables["batch_stats"]))
    args = (CFG, ROBERTA, NPOINTS, state_dict, batch)
    world = torch_ranks.start_ranks(torch_ranks.dp_world, 2, *args,
                                    BN_ROWS, BN_SEED)
    mesh = j_make_mesh(dp=2, mp=1)

    def loss_fn(params, stats, jbatch, train):
        ep, mutated = jm.apply(
            {"params": params, "batch_stats": stats},
            {k: jbatch[k] for k in J_INPUT_KEYS}, train=train,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
        for k in J_TARGET_KEYS:
            ep[k] = jbatch[k]
        loss, _ = j_hungarian_loss(ep, jcfg.num_decoder_layers,
                                   j_criterion_config(jcfg),
                                   jcfg.query_points_obj_topk)
        return loss, mutated["batch_stats"]

    def both(params, stats, jbatch):
        (eval_loss, _), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, stats, jbatch, False)
        return eval_loss, grads, loss_fn(params, stats, jbatch, True)

    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen.Dropout, "__call__",
               lambda self, x, *a, **k: x)
    try:
        loss, grads, (train_loss, stats) = jax.jit(both)(
            *commit_replicated(mesh, (variables["params"],
                                      variables["batch_stats"])),
            shard_batch(mesh, batch))
    finally:
        mp.undo()

    trainer = torch_ranks.make_trainer(*args[:4])
    one = dict(eval=torch_ranks.gradient_step(trainer, batch, train=False),
               train=torch_ranks.gradient_step(trainer, batch))
    ranks = world.join()
    return dict(
        want_eval=(float(loss), named_arrays_from_jax(to_np(grads))),
        want_train=(float(train_loss), named_arrays_from_jax(to_np(stats))),
        ranks=[r["dp"] for r in ranks], bn=[r["bn"] for r in ranks],
        one=one)


def _assert_gradients(got, want):
    loss, grads, _ = got
    want_loss, want_grads = want
    assert loss == pytest.approx(want_loss, rel=1e-4)
    bad, moved = [], 0
    for name, w in want_grads.items():
        if name.startswith("text_encoder."):
            assert name not in grads, name  # frozen
            continue
        g = grads[name].numpy() if name in grads else np.zeros_like(w)
        w = np.asarray(w)
        moved += bool(np.any(w))
        err = float(np.abs(g - w).max())
        lim = 2e-3 * float(np.abs(w).max()) + 1e-6
        if err > lim:
            bad.append((name, err, lim))
    assert not bad, bad
    assert moved > 100


def _relative_l2(got, want):
    num = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items())
    return (num / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


def _assert_statistics(got, want):
    loss, _, buffers = got
    want_loss, want_buffers = want
    assert loss == pytest.approx(want_loss, rel=1e-4)
    assert set(buffers) == set(want_buffers)
    for name, w in want_buffers.items():
        err = float(np.abs(buffers[name].numpy() - w).max())
        assert err <= 5e-5 * max(float(np.abs(w).max()), 1.0), (name, err)


def test_two_dp_ranks_give_the_jax_dp_meshs_loss_and_gradients(steps):
    for rank in (*steps["ranks"], steps["one"]):
        _assert_gradients(rank["eval"], steps["want_eval"])


def test_two_dp_ranks_give_the_jax_dp_meshs_batch_statistics(steps):
    for rank in (*steps["ranks"], steps["one"]):
        _assert_statistics(rank["train"], steps["want_train"])


def test_two_dp_ranks_train_as_one_process_at_the_whole_batch(steps):
    loss, grads, buffers = steps["one"]["train"]
    for rank in steps["ranks"]:
        got_loss, got, got_buffers = rank["train"]
        assert got_loss == pytest.approx(loss, rel=1e-4)
        assert set(got) == set(grads)
        assert _relative_l2(got, grads) <= DRIFT
        for name, b in buffers.items():
            torch.testing.assert_close(got_buffers[name], b, rtol=5e-5,
                                       atol=5e-5)
    # the replicas hold the same averaged gradient, bit for bit
    (_, g0, b0), (_, g1, b1) = (r["train"] for r in steps["ranks"])
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(b0[k], b1[k]) for k in b0)


def test_batchnorm_statistics_are_global_over_the_dp_ranks(steps):
    x = BN_ROWS
    got = steps["bn"]
    bn = BatchNorm(5)
    torch.manual_seed(BN_SEED)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    xs = torch.as_tensor(x).clone().requires_grad_(True)
    y = bn.train()(xs)
    cot = torch.as_tensor(np.random.RandomState(BN_SEED).randn(*x.shape)
                          .astype(np.float32))
    (y * cot).sum().backward()
    assert float(bn.running_var[0]) == pytest.approx(0.9 + 0.1 * 0.25)
    for rank, out in enumerate(got):
        rows = slice(4 * rank, 4 * rank + 4)
        torch.testing.assert_close(out["y"], y.detach()[rows], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(out["grad"], xs.grad[rows], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(out["mean"], bn.running_mean)
        torch.testing.assert_close(out["var"], bn.running_var)

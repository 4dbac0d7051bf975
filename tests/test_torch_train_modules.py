"""The training modules of the port against the JAX package, on the same
numpy inputs: BatchNorm in train mode (outputs and running statistics
against flax), the Hungarian loss (against the torch reference's fixture
tests/golden/loss_golden.npz and against the JAX criterion), and the
schedules and the clipped 3-group AdamW (against optax).

Tolerances are stated per test.
"""

import os.path as osp

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from butd_detr_tpu.losses import (
    CriterionConfig as JCriterionConfig,
    compute_hungarian_loss as j_compute_hungarian_loss,
)
from butd_detr_tpu.losses.matcher import hungarian_match as j_hungarian_match
from butd_detr_tpu.nn.mlp import ConvBNRelu1d as JConvBNRelu1d
from butd_detr_tpu.nn.mlp import SharedMLP as JSharedMLP
from butd_detr_tpu.train.config import Config as JConfig
from butd_detr_tpu.train.optimizer import make_optimizer as j_make_optimizer
from butd_detr_tpu.train.optimizer import make_schedule as j_make_schedule
from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.losses import (
    CriterionConfig,
    compute_hungarian_loss,
    hungarian_match,
)
from butd_detr_tpu_torch.nn.mlp import (
    BNMomentumScheduler,
    ConvBNRelu1d,
    SharedMLP,
)
from butd_detr_tpu_torch.train import (
    clip_by_global_norm_,
    make_optimizer,
    make_schedule,
)
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN = osp.join(osp.dirname(osp.abspath(__file__)), "golden",
                  "loss_golden.npz")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- BatchNorm

def _load_conv_bn(layer, params, stats, i, kernel_dims):
    with torch.no_grad():
        w = np.asarray(params[f"Dense_{i}"]["kernel"]).T
        layer.conv.weight.copy_(_t(w.reshape(*w.shape, *[1] * kernel_dims)))
        bn = layer.bn.bn
        bn.weight.copy_(_t(np.asarray(params[f"BatchNorm_{i}"]["scale"])))
        bn.bias.copy_(_t(np.asarray(params[f"BatchNorm_{i}"]["bias"])))
        bn.running_mean.copy_(_t(np.asarray(stats[f"BatchNorm_{i}"]["mean"])))
        bn.running_var.copy_(_t(np.asarray(stats[f"BatchNorm_{i}"]["var"])))


def _randomized(variables, rng):
    """flax's init gives scale 1, bias 0, mean 0, var 1: draw them."""
    def draw(path, x):
        name = path[-1].key
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
        if name in ("scale", "bias", "mean"):
            return jnp.asarray(rng.normal(name == "scale", 0.1, x.shape),
                               x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.mark.parametrize("kind", ["shared_mlp", "conv_bn_relu_1d"])
def test_batchnorm_train_mode_matches_flax(kind):
    """One train-mode step: outputs and gradients agree (both normalize
    with the biased batch variance), and the running mean and variance
    equal flax's batch_stats to 1e-6 relative: the running variance takes
    the BIASED batch variance, not torch's unbiased one (n / (n - 1))."""
    rng = np.random.RandomState(0)
    if kind == "shared_mlp":
        x = (rng.randn(2, 8, 4, 6) * 2 + 0.5).astype(np.float32)  # n = 64
        jm = JSharedMLP((10, 7))
        pm = SharedMLP([6, 10, 7])
    else:
        x = (rng.randn(2, 24, 6) * 2 + 0.5).astype(np.float32)  # n = 48
        jm = JConvBNRelu1d(9)
        pm = ConvBNRelu1d(6, 9)
    variables = _randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                            rng)
    params, stats = variables["params"], variables["batch_stats"]
    if kind == "shared_mlp":
        for i in range(2):
            _load_conv_bn(getattr(pm, f"layer{i}"), params, stats, i, 2)
        bns = [pm.layer0.bn.bn, pm.layer1.bn.bn]
    else:
        _load_conv_bn(pm, params, stats, 0, 1)
        bns = [pm.bn.bn]

    ct = rng.randn(*x.shape[:-1], 7 if kind == "shared_mlp" else 9) \
        .astype(np.float32)

    def loss(p, xx):
        out, mutated = jm.apply({"params": p, "batch_stats": stats}, xx,
                                train=True, mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(ct)), (out, mutated)

    (_, (want, mutated)), want_dx = jax.value_and_grad(
        loss, argnums=1, has_aux=True)(params, jnp.asarray(x))

    xt = _t(x).requires_grad_()
    got = pm.train()(xt)
    got.backward(_t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               atol=2e-5, rtol=1e-3)
    n = int(np.prod(x.shape[:-1]))
    for i, bn in enumerate(bns):
        new = mutated["batch_stats"][f"BatchNorm_{i}"]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(new["mean"]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(new["var"]), rtol=1e-6)
        assert int(bn.num_batches_tracked) == 1
        # the unbiased variance would have moved the buffer further
        old = np.asarray(stats[f"BatchNorm_{i}"]["var"])
        moved = bn.running_var.numpy() - 0.9 * old
        assert np.all(moved * n / (n - 1) - moved > 1e-6 * moved)
    # eval mode reads the buffers and leaves them alone
    before = [bn.running_var.clone() for bn in bns]
    with torch.no_grad():
        ev = pm.eval()(_t(x))
    want_ev = jm.apply({"params": params,
                        "batch_stats": mutated["batch_stats"]},
                       jnp.asarray(x), train=False)
    np.testing.assert_allclose(ev.numpy(), np.asarray(want_ev), atol=1e-5,
                               rtol=1e-4)
    assert all(torch.equal(a, bn.running_var) for a, bn in zip(before, bns))


def test_bn_momentum_scheduler_sets_every_batchnorm():
    pm = SharedMLP([3, 4, 5])
    sched = BNMomentumScheduler(pm, lambda e: max(0.5 * 0.5 ** e, 0.01))
    assert sched.step() == 0.5 and pm.layer1.bn.bn.momentum == 0.5
    assert sched.step() == 0.25 and pm.layer0.bn.bn.momentum == 0.25
    assert sched.step(10) == 0.01 and sched.momentum == 0.01


# ------------------------------------------------------------------- losses

GOLDEN_CFG = dict(eos_coef=0.1, temperature=0.07, cost_class=1.0,
                  cost_bbox=0.0, cost_giou=2.0, use_contrastive_align=True,
                  mask_pad_tokens=False)  # exact reference behaviour


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN, allow_pickle=False))


def _golden_end_points(golden, grad_keys=()):
    ep = {}
    for k, v in golden.items():
        if k.startswith(("golden_", "grad_")) or k == "num_decoder_layers":
            continue
        t = _t(v)
        ep[k] = t.requires_grad_() if k in grad_keys else t
    return ep


def test_hungarian_loss_matches_the_torch_reference_fixture(golden):
    """The six `golden_*` values to rtol 1e-4 and every `grad_*` to rtol
    2e-3, atol 2e-4 * scale + 1e-7 (tests/test_loss_golden.py's bound)."""
    grad_keys = [k[len("grad_"):] for k in golden if k.startswith("grad_")]
    leaves = _golden_end_points(golden, grad_keys)
    ep = dict(leaves)
    # the reference's logits are (B, 1, K); the port's (B, K)
    ep["seeds_obj_cls_logits"] = ep["seeds_obj_cls_logits"][:, 0, :]
    loss, out = compute_hungarian_loss(
        ep, int(golden["num_decoder_layers"]), CriterionConfig(**GOLDEN_CFG),
        query_points_obj_topk=4)
    pairs = {
        "loss": loss, "loss_ce": out["loss_ce"],
        "loss_bbox": out["loss_bbox"], "loss_giou": out["loss_giou"],
        "loss_constrastive_align": out["loss_contrastive_align"],
        "query_points_generation_loss": out["query_points_generation_loss"],
    }
    for name, ours in pairs.items():
        assert float(ours) == pytest.approx(float(golden["golden_" + name]),
                                            rel=1e-4), name
    loss.backward()
    for k in sorted(grad_keys):
        want = golden["grad_" + k]
        scale = float(np.abs(want).max()) + 1e-8
        np.testing.assert_allclose(
            leaves[k].grad.numpy(), want, rtol=2e-3,
            atol=2e-4 * scale + 1e-7, err_msg=k)


def _seeded_end_points(seed, B=3, Q=24, G=7, L=14, K=40, N=200, layers=3):
    rng = np.random.RandomState(seed)
    n_valid = [4, 7, 1][:B]
    mask = np.zeros((B, G), np.float32)
    for b, n in enumerate(n_valid):
        mask[b, :n] = 1
    text_mask = np.zeros((B, L), np.int32)
    for b, n in enumerate([9, 14, 6][:B]):
        text_mask[b, :n] = 1
    pmap = np.zeros((B, G, 256), np.float32)
    for b in range(B):
        for g in range(G):
            s = rng.randint(1, 5)
            pmap[b, g, s:s + 2] = 0.5
    norm = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    ep = {
        "center_label": (rng.rand(B, G, 3) * 3).astype(np.float32),
        "size_gts": (rng.rand(B, G, 3) * 0.5 + 0.2).astype(np.float32),
        "sem_cls_label": rng.randint(0, 256, (B, G)).astype(np.int32),
        "box_label_mask": mask,
        "positive_map": pmap,
        "text_mask": text_mask,
        "point_instance_label": rng.randint(-1, G, (B, N)).astype(np.int32),
        "seed_inds": rng.randint(0, N, (B, K)).astype(np.int32),
        "seed_xyz": (rng.rand(B, K, 3) * 3).astype(np.float32),
        "seeds_obj_cls_logits": rng.randn(B, K).astype(np.float32),
        "proj_tokens": norm(rng.randn(B, L, 64)).astype(np.float32),
    }
    prefixes = ["proposal_"] + [f"{i}head_" for i in range(layers - 1)] \
        + ["last_"]
    for p in prefixes:
        ep[p + "center"] = (rng.rand(B, Q, 3) * 3).astype(np.float32)
        ep[p + "pred_size"] = (rng.rand(B, Q, 3) * 0.6 + 0.1) \
            .astype(np.float32)
        ep[p + "sem_cls_scores"] = rng.randn(B, Q, 256).astype(np.float32)
        ep[p + "proj_queries"] = norm(rng.randn(B, Q, 64)) \
            .astype(np.float32)
    return ep, layers


@pytest.mark.parametrize("soft_token", [True, False])
def test_hungarian_loss_matches_the_jax_criterion(soft_token):
    """The same assignment (the port's solver against the JAX package's,
    both on the CPU) and every loss to 1e-5, with the default config
    (pad tokens masked out of the contrastive normalizer)."""
    ep, layers = _seeded_end_points(3)
    jep = {k: jnp.asarray(v) for k, v in ep.items()}
    jcfg = JCriterionConfig(use_soft_token=soft_token)
    want_loss, want = j_compute_hungarian_loss(jep, layers, jcfg, 4)
    tep = {k: _t(v) for k, v in ep.items()}
    got_loss, got = compute_hungarian_loss(
        tep, layers, CriterionConfig(use_soft_token=soft_token), 4)
    keys = [k for k in want if "loss" in k]
    assert len(keys) == 6 + 4 * (layers + 1)
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)

    boxes = lambda e, cat: cat([e["last_center"], e["last_pred_size"]], -1)
    gt = lambda e, cat: cat([e["center_label"], e["size_gts"]], -1)
    labels = None if soft_token else "sem_cls_label"
    ja = j_hungarian_match(
        jep["last_sem_cls_scores"], boxes(jep, jnp.concatenate),
        jep["positive_map"], gt(jep, jnp.concatenate), jep["box_label_mask"],
        tgt_labels=None if labels is None else jep[labels])
    ta = hungarian_match(
        tep["last_sem_cls_scores"], boxes(tep, torch.cat),
        tep["positive_map"], gt(tep, torch.cat), tep["box_label_mask"],
        tgt_labels=None if labels is None else tep[labels])
    valid = ep["box_label_mask"] > 0
    np.testing.assert_array_equal(ta.numpy()[valid], np.asarray(ja)[valid])


def test_matcher_survives_nan_costs():
    ep, _ = _seeded_end_points(4)
    tep = {k: _t(v) for k, v in ep.items()}
    logits = tep["last_sem_cls_scores"].clone()
    logits[0, 3] = float("nan")
    a = hungarian_match(
        logits, torch.cat([tep["last_center"], tep["last_pred_size"]], -1),
        tep["positive_map"],
        torch.cat([tep["center_label"], tep["size_gts"]], -1),
        tep["box_label_mask"])
    assert a.shape == (3, 7) and int(a.min()) >= 0 and int(a.max()) < 24


# ---------------------------------------------------------------- optimizer

SCHEDULES = [
    dict(lr_scheduler="step", lr_decay_epochs=[2, 3], lr_decay_rate=0.1,
         warmup_epoch=1, warmup_multiplier=100),
    dict(lr_scheduler="step", lr_decay_epochs=[1, 3], lr_decay_rate=0.3,
         warmup_epoch=-1),
    dict(lr_scheduler="cosine", max_epoch=4, warmup_epoch=1,
         warmup_multiplier=100),
    dict(lr_scheduler="cosine", max_epoch=3, warmup_epoch=-1),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedule_matches_the_jax_schedule(kw):
    """20 steps of 5-step epochs: across the warmup and both milestones.
    The port evaluates the schedule in double precision, the JAX package
    in float32, whose rounding (eps 6e-8, and the cancellation in
    1 + cos near the end of the cosine) is 2e-7 of the base rate: the
    bound is 1e-7 relative plus that."""
    for base in (1e-3, 1e-4):
        want = j_make_schedule(base, 5, JConfig(**kw))
        got = make_schedule(base, 5, Config(**kw))
        for step in range(20):
            assert got(step) == pytest.approx(
                float(want(step)), rel=1e-7, abs=2e-7 * base), (kw, step)


def test_clipped_three_group_adamw_matches_optax():
    """3 updates of a small tree against the JAX package's optax chain:
    global-norm clip 0.1 before the update (the second gradient is large
    enough to be clipped, the third is not), per-group rates, decoupled
    weight decay, and a frozen `text_encoder` leaf that must not move.
    1e-6."""
    rng = np.random.RandomState(5)
    shapes = {"backbone_net.w": (4, 3), "text_encoder.w": (3,),
              "head.w": (5,), "head.b": (2,)}
    kw = dict(lr=1e-2, lr_backbone=3e-3, weight_decay=0.05,
              lr_decay_epochs=[1, 2], warmup_epoch=-1)
    values = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.5, 30.0, 0.01)]

    def tree(flat):
        out = {}
        for k, v in flat.items():
            a, b = k.split(".")
            out.setdefault(a, {})[b] = jnp.asarray(v)
        return out

    opt = j_make_optimizer(JConfig(**kw), steps_per_epoch=1)
    jparams = tree(values)
    state = opt.init(jparams)
    for g in grads:
        g = dict(g, **{"text_encoder.w": np.zeros(3, np.float32)})
        updates, state = opt.update(tree(g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    cfg = Config(**kw)
    params = {k: torch.nn.Parameter(_t(v.copy())) for k, v in values.items()}
    params["text_encoder.w"].requires_grad_(False)
    optimizer = make_optimizer(cfg, params.items())
    assert [g["name"] for g in optimizer.param_groups] == ["main",
                                                          "backbone"]
    schedules = {g["name"]: make_schedule(g["base_lr"], 1, cfg)
                 for g in optimizer.param_groups}
    norms = []
    for step, g in enumerate(grads):
        trainable = [k for k in params if params[k].requires_grad]
        for k in trainable:
            params[k].grad = _t(g[k].copy())
        norms.append(float(clip_by_global_norm_(
            [params[k].grad for k in trainable], cfg.clip_norm)))
        for group in optimizer.param_groups:
            group["lr"] = schedules[group["name"]](step)
        optimizer.step()
    assert norms[1] > cfg.clip_norm > norms[2]
    for k in shapes:
        a, b = k.split(".")
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(jparams[a][b]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(params["text_encoder.w"].numpy(),
                                  values["text_encoder.w"])

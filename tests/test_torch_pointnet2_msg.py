"""The port's remaining PointNet++ modules against the JAX package's:
`GroupAll`, `PointnetSAModuleMSG` (with npoint and, through `GroupAll`,
without), `PointnetSAModule`, `PointnetLFPModuleMSG`, and
`PointnetSAModuleVotes` with given indices and avg / rbf pooling.

Each JAX module is initialized by flax, its BatchNorm statistics
randomized, and its `{params, batch_stats}` moved across with
`convert.state_dict_from_jax` (each shared MLP placed where the converter
knows one, under `backbone_net/sa1`, then renamed to the module's keys);
both run in eval mode, f32, on the same numpy inputs. The JAX point ops
take their CPU paths, as the JAX package's own tests run them.

Tolerances: integer outputs equal; floats atol 1e-5, rtol 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from butd_detr_tpu.nn.pointnet2 import (
    GroupAll as JGroupAll,
    PointnetLFPModuleMSG as JLFP,
    PointnetSAModule as JSAModule,
    PointnetSAModuleMSG as JMSG,
    PointnetSAModuleVotes as JVotes,
)
from butd_detr_tpu_torch.convert import state_dict_from_jax
from butd_detr_tpu_torch.init import init_weights_
from butd_detr_tpu_torch.nn import (
    GroupAll,
    PointnetLFPModuleMSG,
    PointnetSAModule,
    PointnetSAModuleMSG,
    PointnetSAModuleVotes,
)
from butd_detr_tpu_torch.predict import load_state_dict
from torch_threads import one_torch_thread  # noqa: F401

ATOL, RTOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=ATOL, rtol=RTOL)


def _cloud(seed, b=2, n=512, c=4):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(b, n, 3) * 2).astype(np.float32)
    feats = rng.randn(b, n, c).astype(np.float32)
    return xyz, feats


def _randomize_stats(variables, seed):
    """Random BatchNorm running statistics, so eval mode does real work."""
    rng = np.random.RandomState(seed)

    def f(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "mean":
            return jnp.asarray(rng.randn(*shape).astype(np.float32) * 0.1)
        return jnp.asarray(rng.uniform(0.5, 1.5, shape).astype(np.float32))

    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(
                f, variables["batch_stats"])}


def _mlp_state(params, stats, name):
    """The port SharedMLP state dict of the JAX SharedMLP `name`."""
    def at(tree):
        return {"backbone_net": {"sa1": {"mlp": jax.tree_util.tree_map(
            np.asarray, tree[name])}}}

    sd = state_dict_from_jax(at(params), at(stats))
    prefix = "backbone_net.sa1.mlp_module."
    assert all(k.startswith(prefix) for k in sd)
    return {k[len(prefix):]: v for k, v in sd.items()}


def _load(module, variables, names):
    """Load the JAX SharedMLPs `names` ({flax name: port prefix})."""
    sd = {}
    for flax_name, prefix in names.items():
        for k, v in _mlp_state(variables["params"],
                               variables["batch_stats"], flax_name).items():
            sd[prefix + k] = v
    assert load_state_dict(module, sd) == []
    return module.eval()


@pytest.mark.parametrize("with_features,use_xyz",
                         [(True, True), (True, False), (False, True)])
def test_group_all(with_features, use_xyz):
    xyz, feats = _cloud(0)
    f = feats if with_features else None
    want, want_xyz = JGroupAll(use_xyz=use_xyz)(
        jnp.asarray(xyz), None, None if f is None else jnp.asarray(f))
    got, got_xyz = GroupAll(use_xyz)(_t(xyz), None,
                                     None if f is None else _t(f))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))


MSG = dict(radii=(0.2, 0.4), nsamples=(8, 16),
           mlps=((16, 16, 32), (16, 24)))


@pytest.mark.parametrize("given_inds", [False, True])
def test_sa_module_msg(given_inds):
    xyz, feats = _cloud(1)
    inds = (np.random.RandomState(2).permutation(512)[:64][None]
            .repeat(2, 0).astype(np.int32) if given_inds else None)
    jm = JMSG(npoint=64, **MSG)
    args = (jnp.asarray(xyz), jnp.asarray(feats),
            None if inds is None else jnp.asarray(inds))
    v = _randomize_stats(jm.init(jax.random.PRNGKey(0), *args), 3)
    w_xyz, w_feat, w_inds = jm.apply(v, *args)
    pm = _load(PointnetSAModuleMSG(64, in_channels=4, **MSG), v,
               {"mlp0": "mlps.0.", "mlp1": "mlps.1."})
    with torch.no_grad():
        g_xyz, g_feat, g_inds = pm(_t(xyz), _t(feats),
                                   None if inds is None else _t(inds))
    np.testing.assert_array_equal(g_inds.numpy(), np.asarray(w_inds))
    np.testing.assert_array_equal(g_xyz.numpy(), np.asarray(w_xyz))
    assert g_feat.shape == (2, 64, 32 + 24)
    _close(g_feat.numpy(), w_feat)


def test_sa_module_msg_group_all():
    xyz, feats = _cloud(4, n=128)
    jm = JMSG(npoint=None, **MSG)
    args = (jnp.asarray(xyz), jnp.asarray(feats))
    v = _randomize_stats(jm.init(jax.random.PRNGKey(1), *args), 5)
    w_xyz, w_feat, w_inds = jm.apply(v, *args)
    pm = _load(PointnetSAModuleMSG(None, in_channels=4, **MSG), v,
               {"mlp0": "mlps.0.", "mlp1": "mlps.1."})
    with torch.no_grad():
        g_xyz, g_feat, g_inds = pm(_t(xyz), _t(feats))
    assert w_xyz is None and g_xyz is None
    assert w_inds is None and g_inds is None
    assert g_feat.shape == (2, 1, 32 + 24)
    _close(g_feat.numpy(), w_feat)


@pytest.mark.parametrize("npoint", [32, None])
def test_sa_module(npoint):
    xyz, feats = _cloud(6, n=256)
    kw = dict(npoint=npoint, radius=0.3 if npoint else None,
              nsample=12 if npoint else None)
    jm = JSAModule.create(mlp=(16, 8), **kw)
    args = (jnp.asarray(xyz), jnp.asarray(feats))
    v = _randomize_stats(jm.init(jax.random.PRNGKey(2), *args), 7)
    w_xyz, w_feat, w_inds = jm.apply(v, *args)
    pm = _load(PointnetSAModule((16, 8), 4, **kw), v,
               {"mlp0": "mlps.0."})
    with torch.no_grad():
        g_xyz, g_feat, g_inds = pm(_t(xyz), _t(feats))
    if npoint:
        np.testing.assert_array_equal(g_inds.numpy(), np.asarray(w_inds))
        np.testing.assert_array_equal(g_xyz.numpy(), np.asarray(w_xyz))
    _close(g_feat.numpy(), w_feat)


@pytest.mark.parametrize("with_skip", [True, False])
def test_lfp_module_msg(with_skip):
    xyz1, feats1 = _cloud(8, n=256, c=6)
    xyz2, feats2 = _cloud(9, n=64, c=5)
    f2 = feats2 if with_skip else None
    jm = JLFP(radii=(0.3, 0.6), nsamples=(8, 16),
              mlps=((16, 16), (24, 16)), post_mlp=(32, 20))
    args = (jnp.asarray(xyz2), jnp.asarray(xyz1),
            None if f2 is None else jnp.asarray(f2), jnp.asarray(feats1))
    v = _randomize_stats(jm.init(jax.random.PRNGKey(3), *args), 10)
    want = jm.apply(v, *args)
    pm = _load(PointnetLFPModuleMSG(
        (0.3, 0.6), (8, 16), 6, ((16, 16), (24, 16)), (32, 20),
        skip_channels=5 if with_skip else 0), v,
        {"mlp0": "mlps.0.", "mlp1": "mlps.1.", "post_mlp": "post_mlp."})
    with torch.no_grad():
        got = pm(_t(xyz2), _t(xyz1), None if f2 is None else _t(f2),
                 _t(feats1))
    assert got.shape == (2, 64, 40)
    _close(got.numpy(), want)


@pytest.mark.parametrize("pooling,sigma,given_inds", [
    ("avg", None, False), ("rbf", None, False), ("rbf", 0.07, True),
    ("max", None, True)])
def test_sa_votes_pooling_and_inds(pooling, sigma, given_inds):
    xyz, feats = _cloud(11)
    inds = (np.random.RandomState(12).permutation(512)[:48][None]
            .repeat(2, 0).astype(np.int32) if given_inds else None)
    jm = JVotes(npoint=48, radius=0.25, nsample=16, mlp=(16, 32),
                normalize_xyz=True, pooling=pooling, sigma=sigma)
    args = (jnp.asarray(xyz), jnp.asarray(feats),
            None if inds is None else jnp.asarray(inds))
    v = _randomize_stats(jm.init(jax.random.PRNGKey(4), *args), 13)
    w_xyz, w_feat, w_inds = jm.apply(v, *args)
    (flax_name,) = v["params"]
    pm = _load(PointnetSAModuleVotes(48, 0.25, 16, 4, (16, 32),
                                     normalize_xyz=True, pooling=pooling,
                                     sigma=sigma), v,
               {flax_name: "mlp_module."})
    with torch.no_grad():
        g_xyz, g_feat, g_inds = pm(_t(xyz), _t(feats),
                                   None if inds is None else _t(inds))
    np.testing.assert_array_equal(g_inds.numpy(), np.asarray(w_inds))
    np.testing.assert_array_equal(g_xyz.numpy(), np.asarray(w_xyz))
    _close(g_feat.numpy(), w_feat)


def test_msg_backward_runs_through_the_gathers():
    """The MSG module is differentiable in its features (the grouped
    gather's backward, the row scatter-add on the card)."""
    xyz, feats = _cloud(14)
    pm = init_weights_(PointnetSAModuleMSG(64, in_channels=4, **MSG),
                       0).eval()
    f = _t(feats).requires_grad_(True)
    _, out, _ = pm(_t(xyz), f)
    out.square().sum().backward()
    assert f.grad is not None and torch.isfinite(f.grad).all()
    assert f.grad.abs().sum() > 0

"""The port's modules against the JAX package's, with the same weights.

Each JAX module is initialized by flax, its `{params, batch_stats}` are
moved across with `convert.state_dict_from_jax` (under the flax name the
module has inside BeaUTyDETR, whose prefix is then stripped), and both run
in eval mode on the same numpy inputs. The JAX side runs its CPU path
(unfused attention); the port runs f32 with the precise attention mode.

Tolerances: integers equal; f32 floats atol 1e-5, rtol 1e-4; the bf16
backbone within two bf16 steps (2^-7) of each end point's largest
magnitude, plus 1e-3.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from butd_detr_tpu.lang.roberta import RobertaConfig as JRobertaConfig
from butd_detr_tpu.lang.roberta import RobertaModel as JRobertaModel
from butd_detr_tpu.models.decoder import BiDecoderLayer as JDecoderLayer
from butd_detr_tpu.models.encoder import BiEncoder as JBiEncoder
from butd_detr_tpu.models.heads import (
    ClsAgnosticPredictHead as JPredictHead,
    PointsObjClsModule as JObjCls,
)
from butd_detr_tpu.nn.attention import MultiHeadAttention as JMHA
from butd_detr_tpu.nn.backbone import Pointnet2Backbone as JBackbone
from butd_detr_tpu.nn.position import PositionEmbeddingLearned as JPosEmbed
from butd_detr_tpu_torch.convert import state_dict_from_jax
from butd_detr_tpu_torch.lang.roberta import RobertaConfig, RobertaModel
from butd_detr_tpu_torch.models.decoder import BiDecoderLayer
from butd_detr_tpu_torch.models.encoder import BiEncoder
from butd_detr_tpu_torch.models.heads import (
    ClsAgnosticPredictHead,
    PointsObjClsModule,
)
from butd_detr_tpu_torch.nn import (
    MultiheadAttention,
    Pointnet2Backbone,
    PositionEmbeddingLearned,
)
from butd_detr_tpu_torch.predict import load_state_dict
from torch_threads import one_torch_thread  # noqa: F401

ATOL, RTOL = 1e-5, 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(module, variables, flax_path, torch_prefix):
    """Load JAX `variables`, placed at `flax_path` in BeaUTyDETR's tree,
    into the port `module` (whose keys lack `torch_prefix`)."""
    def nest(tree):
        for name in reversed(flax_path):
            tree = {name: tree}
        return tree

    sd = state_dict_from_jax(nest(_np_tree(variables["params"])),
                             nest(_np_tree(variables.get("batch_stats",
                                                         {}))))
    assert all(k.startswith(torch_prefix) for k in sd)
    unused = load_state_dict(
        module, {k[len(torch_prefix):]: v for k, v in sd.items()})
    assert unused == []
    return module.eval()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=atol, rtol=rtol)


def _scene(seed, b=2, n=1024):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.rand(b, n, 3) * 3, rng.rand(b, n, 3) - 0.5],
                          -1).astype(np.float32)


@pytest.mark.parametrize("bf16,channels", [(False, 6), (True, 6),
                                            (False, 3)])
def test_backbone(bf16, channels):
    pc = _scene(0)[..., :channels]  # 3: xyz only, no feature leg
    npoints = (64, 32, 16, 8)
    jm = JBackbone(npoints=npoints,
                   dtype=jnp.bfloat16 if bf16 else jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(pc))
    want = jm.apply(v, jnp.asarray(pc), train=False)
    pm = _port(Pointnet2Backbone(channels - 3, npoints=npoints,
                                 dtype=torch.bfloat16 if bf16
                                 else torch.float32),
               v, ("backbone_net",), "backbone_net.")
    with torch.no_grad():
        got = pm(_t(pc))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k].astype(jnp.float32)
                       if want[k].dtype == jnp.bfloat16 else want[k])
        g = got[k].numpy()
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif bf16:
            lim = 2.0 ** -7 * np.abs(w).max() + 1e-3
            assert np.abs(g - w).max() <= lim, (k, np.abs(g - w).max(), lim)
        else:
            _close(g, w)


def test_multihead_attention():
    rng = np.random.RandomState(1)
    q = rng.randn(2, 7, 32).astype(np.float32)
    kv = rng.randn(2, 11, 32).astype(np.float32)
    pad = np.zeros((2, 11), bool)
    pad[1, 6:] = True
    jm = JMHA(32, 4)
    args = (jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
            jnp.asarray(pad))
    v = jm.init(jax.random.PRNGKey(1), *args)
    want = jm.apply(v, *args)
    pm = _port(MultiheadAttention(32, 4, precise=True), v,
               ("decoder_0", "self_attn"), "decoder.0.self_attn.")
    with torch.no_grad():
        got = pm(_t(q), _t(kv), _t(kv), _t(pad))
    _close(got.numpy(), want)


def test_roberta():
    conf = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=48,
                max_position_embeddings=24)
    rng = np.random.RandomState(2)
    ids = rng.randint(3, 128, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int32)
    ids[1, 6:], mask[1, 6:] = 1, 0
    jm = JRobertaModel(JRobertaConfig(**conf))
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(ids), jnp.asarray(mask))
    want = jm.apply(v, jnp.asarray(ids), jnp.asarray(mask))
    pm = _port(RobertaModel(RobertaConfig(**conf), precise=True), v,
               ("text_encoder",), "text_encoder.")
    with torch.no_grad():
        got = pm(_t(ids).long(), _t(mask).long())
    _close(got.numpy(), want)


def test_encoder():
    rng = np.random.RandomState(3)
    vis = rng.randn(2, 20, 32).astype(np.float32)
    pos = rng.randn(2, 20, 32).astype(np.float32)
    vmask = np.zeros((2, 20), bool)
    txt = rng.randn(2, 9, 32).astype(np.float32)
    tmask = np.zeros((2, 9), bool)
    tmask[0, 5:] = True
    det = rng.randn(2, 6, 32).astype(np.float32)
    dmask = np.zeros((2, 6), bool)
    dmask[1, 2:] = True
    args = [vis, pos, vmask, txt, tmask, det, dmask]
    jm = JBiEncoder(num_layers=2, d_model=32, n_heads=4,
                    dim_feedforward=48, self_attend=True,
                    use_butd_enc_attn=True)
    v = jm.init(jax.random.PRNGKey(3), *map(jnp.asarray, args))
    want = jm.apply(v, *map(jnp.asarray, args))
    pm = _port(BiEncoder(2, 32, 4, 48, self_attend=True,
                         use_butd_enc_attn=True, precise=True),
               v, ("cross_encoder",), "cross_encoder.")
    with torch.no_grad():
        got = pm(*map(_t, args))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_decoder_layer():
    rng = np.random.RandomState(4)
    query = rng.randn(2, 8, 32).astype(np.float32)
    vis = rng.randn(2, 20, 32).astype(np.float32)
    lang = rng.randn(2, 9, 32).astype(np.float32)
    qpos = rng.rand(2, 8, 6).astype(np.float32)
    tmask = np.zeros((2, 9), bool)
    tmask[1, 4:] = True
    det = rng.randn(2, 6, 32).astype(np.float32)
    dmask = np.zeros((2, 6), bool)
    dmask[0, 3:] = True
    jm = JDecoderLayer(32, 4, 48, butd=True)
    jargs = (jnp.asarray(query), jnp.asarray(vis), jnp.asarray(lang),
             jnp.asarray(qpos), None, jnp.asarray(tmask), jnp.asarray(det),
             jnp.asarray(dmask))
    v = jm.init(jax.random.PRNGKey(4), *jargs)
    want = jm.apply(v, *jargs)
    pm = _port(BiDecoderLayer(32, 4, 48, butd=True, precise=True), v,
               ("decoder_0",), "decoder.0.")
    with torch.no_grad():
        got = pm(_t(query), _t(vis), _t(lang), _t(qpos), None, _t(tmask),
                 _t(det), _t(dmask))
    _close(got.numpy(), want)


def test_heads_and_position_embedding():
    rng = np.random.RandomState(5)
    feats = rng.randn(2, 12, 32).astype(np.float32)
    base = rng.rand(2, 12, 3).astype(np.float32)

    jm = JPredictHead(num_class=20, seed_feat_dim=32)
    v = jm.init(jax.random.PRNGKey(5), jnp.asarray(feats),
                jnp.asarray(base))
    want = jm.apply(v, jnp.asarray(feats), jnp.asarray(base))
    pm = _port(ClsAgnosticPredictHead(20, 32), v, ("proposal_head",),
               "proposal_head.")
    with torch.no_grad():
        got = pm(_t(feats), _t(base))
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k])

    jm = JObjCls(32)
    v = jm.init(jax.random.PRNGKey(6), jnp.asarray(feats))
    pm = _port(PointsObjClsModule(32), v, ("points_obj_cls",),
               "points_obj_cls.")
    with torch.no_grad():
        _close(pm(_t(feats)).numpy(), jm.apply(v, jnp.asarray(feats)))

    jm = JPosEmbed(32)
    v = jm.init(jax.random.PRNGKey(7), jnp.asarray(base))
    pm = _port(PositionEmbeddingLearned(3, 32), v, ("pos_embed",),
               "pos_embed.")
    with torch.no_grad():
        _close(pm(_t(base)).numpy(), jm.apply(v, jnp.asarray(base)))

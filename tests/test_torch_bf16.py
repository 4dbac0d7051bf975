"""The port's modules at `--use_bf16` (compute dtype bf16) against the JAX
package's modules at `dtype=jnp.bfloat16`, with the same weights.

Weights go through `convert.state_dict_from_jax` as in
tests/test_torch_modules.py. Every JAX `MultiHeadAttention` runs on the
Pallas kernel in interpret mode (`pallas_attention_on_cpu`): that is what
the TPU runs, and what the port's kernels follow. The JAX module's plain
CPU path differs from it under bf16: its logits are rounded to bf16, and
its padding value `finfo(float32).min` rounds to -inf in bf16, so a row
whose keys are all padding comes out NaN there.

What is held:
- the dense layer (`nn.mlp.dense`, `Dense`, `PointwiseConv`) equals flax
  `nn.Dense(dtype=bfloat16)` bit for bit, eager and under `jax.jit`:
  the product rounded to bf16, then the bias added in bf16;
- every module's outputs have the JAX module's dtypes and lie within
  eager_tol = 2^-10 * max|JAX| + 1e-5, a quarter of one bf16 rounding of
  the largest value, of the JAX module run op by op (`apply` outside
  `jax.jit`): each bf16 op rounds where the JAX program says it does (a
  rounding in the wrong place, e.g. torch's fused GELU or a bias fused
  into the product, shows as a whole one); the rest is f32 rounding;
- they lie within bf16_module_tol = 2^-7 * max|JAX| + 1e-3 of the JAX
  module under `jax.jit`, two bf16 roundings of the output's largest
  value plus the f32 bound's absolute term: XLA's fusions keep some bf16
  intermediates in f32 (e.g. a bf16 residual sum that feeds an f32
  LayerNorm is not rounded), which the op-by-op run and the port do not.
The observed errors are written beside each test.
"""

import contextlib
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from butd_detr_tpu.lang.roberta import RobertaConfig as JRobertaConfig
from butd_detr_tpu.lang.roberta import RobertaLayer as JRobertaLayer
from butd_detr_tpu.models.decoder import BiDecoderLayer as JDecoderLayer
from butd_detr_tpu.models.encoder import BiEncoderLayer as JEncoderLayer
from butd_detr_tpu.models.heads import (
    ClsAgnosticPredictHead as JPredictHead,
    PointsObjClsModule as JObjCls,
)
from butd_detr_tpu.nn import attention as jattention
from butd_detr_tpu.nn.attention import MultiHeadAttention as JMHA
from butd_detr_tpu.nn.position import PositionEmbeddingLearned as JPosEmbed
from butd_detr_tpu.ops import pallas_attention
from butd_detr_tpu_torch.lang.roberta import RobertaConfig, RobertaLayer
from butd_detr_tpu_torch.models.decoder import BiDecoderLayer
from butd_detr_tpu_torch.models.encoder import BiEncoderLayer
from butd_detr_tpu_torch.models.heads import (
    ClsAgnosticPredictHead,
    PointsObjClsModule,
)
from butd_detr_tpu_torch.nn import (
    MultiheadAttention,
    PointwiseConv,
    PositionEmbeddingLearned,
)
from butd_detr_tpu_torch.nn.mlp import Dense, dense

from test_torch_defaults import _TpuBackend
from test_torch_modules import _port, _t

BF16 = torch.bfloat16


def bf16_module_tol(want) -> float:
    """2^-7 * max|want| + 1e-3 (the module docstring)."""
    return 2.0 ** -7 * float(np.abs(np.asarray(want, np.float64)).max()) \
        + 1e-3


@contextlib.contextmanager
def pallas_attention_on_cpu(calls=None):
    """Every JAX `MultiHeadAttention` on the Pallas kernel in interpret
    mode (tests/test_torch_defaults.py's two patches); `calls` collects
    each call's `precise`."""
    fused = pallas_attention.fused_attention

    def interpret(*a, **kw):
        if calls is not None:
            calls.append(kw.get("precise"))
        return fused(*a, **dict(kw, interpret=True))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattention, "jax", _TpuBackend())
        mp.setattr(pallas_attention, "fused_attention",
                   functools.wraps(fused)(interpret))
        yield


def _f64(x):
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(np.asarray(x, np.float32), np.float64)


def _err(got, want):
    return float(np.abs(_f64(got) - _f64(want)).max())


def eager_tol(want) -> float:
    """2^-10 * max|want| + 1e-5 (the module docstring)."""
    return 2.0 ** -10 * float(np.abs(_f64(want)).max()) + 1e-5


def _held(got, want, eager, what=""):
    """`got` has the JAX outputs' dtype, lies within eager_tol of the
    op-by-op run `eager` and within bf16_module_tol of the jitted run
    `want`; returns both errors."""
    for w in (want, eager):
        assert str(got.dtype).split(".")[-1] == str(w.dtype), (
            what, got.dtype, w.dtype)
    err_e, lim_e = _err(got, eager), eager_tol(eager)
    assert err_e <= lim_e, (what, "op by op", err_e, lim_e)
    err, lim = _err(got, want), bf16_module_tol(_f64(want))
    assert err <= lim, (what, "jitted", err, lim)
    return err_e, err


def _to_jax_bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


# ------------------------------------------------------------------ dense

@pytest.mark.parametrize("shape,cin,cout", [((64,), 288, 288),
                                            ((2, 9), 768, 288),
                                            ((3, 5), 36, 1)])
def test_dense_equals_flax_bit_for_bit(shape, cin, cout):
    rng = np.random.RandomState(cin + cout)
    x = rng.randn(*shape, cin).astype(np.float32)
    jm = fnn.Dense(cout, dtype=jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # a bias of the kernel's scale, so that its rounding shows
    v = {"params": {"kernel": v["params"]["kernel"],
                    "bias": jnp.asarray(rng.randn(cout) * 0.1,
                                        jnp.float32)}}
    eager = np.asarray(jm.apply(v, jnp.asarray(x)))
    jitted = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    w = torch.from_numpy(np.asarray(v["params"]["kernel"]).T.copy())
    b = torch.from_numpy(np.array(v["params"]["bias"]))
    layer = Dense(cin, cout, dtype=BF16)
    conv = PointwiseConv(cin, cout, dtype=BF16)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
        conv.weight.copy_(w[..., None])
        conv.bias.copy_(b)
        outs = [dense(torch.from_numpy(x), w, b, BF16),
                layer(torch.from_numpy(x)), conv(torch.from_numpy(x)),
                # a bf16 input is cast to nothing new
                layer(torch.from_numpy(x).to(BF16))]
    assert jitted.dtype == eager.dtype == jnp.bfloat16
    for out in outs:
        assert out.dtype is BF16
        got = out.view(torch.int16).numpy()
        np.testing.assert_array_equal(got, eager.view(np.int16))
        np.testing.assert_array_equal(got, jitted.view(np.int16))
    # the fused form (bias inside the product) differs from flax's
    fused = torch.nn.functional.linear(torch.from_numpy(x).to(BF16),
                                       w.to(BF16), b.to(BF16))
    assert not torch.equal(fused, outs[0])


def test_parameters_stay_f32_and_load_in_either_mode():
    layer = Dense(8, 4, dtype=BF16)
    assert layer.weight.dtype is torch.float32
    f32 = Dense(8, 4)
    f32.load_state_dict(layer.state_dict())
    x = torch.randn(3, 8)
    assert f32(x).dtype is torch.float32 and layer(x).dtype is BF16
    assert torch.equal(layer(x), dense(x, f32.weight, f32.bias, BF16))


# -------------------------------------------------------------- modules

def _mha_inputs(seed=1):
    rng = np.random.RandomState(seed)
    q = rng.randn(2, 7, 32).astype(np.float32)
    kv = rng.randn(2, 11, 32).astype(np.float32)
    pad = np.zeros((2, 11), bool)
    pad[1, 6:] = True
    return q, kv, pad


def test_multihead_attention():
    """Observed: 0 op by op and jitted."""
    q, kv, pad = _mha_inputs()
    jm = JMHA(32, 4, dtype=jnp.bfloat16)
    args = (jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
            jnp.asarray(pad))
    calls = []
    with pallas_attention_on_cpu(calls):
        v = jm.init(jax.random.PRNGKey(1), *args)
        calls.clear()
        want = jax.jit(jm.apply)(v, *args)
        eager = jm.apply(v, *args)
    assert calls == [None, None]  # the Pallas kernel, bf16-operand mode
    pm = _port(MultiheadAttention(32, 4, dtype=BF16), v,
               ("decoder_0", "self_attn"), "decoder.0.self_attn.")
    with torch.no_grad():
        got = pm(_t(q), _t(kv), _t(kv), _t(pad))
    _held(got, want, eager, "mha")


def test_multihead_attention_with_a_fully_padded_row():
    """A row whose keys are all padding comes out finite, as the kernel's
    FINFO_MIN padding gives it, where the JAX plain CPU path gives NaN
    under bf16 (its padding value rounds to -inf in bf16). The other row
    is held against the Pallas kernel as above."""
    q, kv, pad = _mha_inputs(2)
    pad[0] = True
    args = (jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
            jnp.asarray(pad))
    plain_m = JMHA(32, 4, dtype=jnp.bfloat16, use_flash=False)
    v = plain_m.init(jax.random.PRNGKey(1), *args)
    plain = np.asarray(plain_m.apply(v, *args), np.float32)
    assert np.isnan(plain[0]).all() and np.isfinite(plain[1]).all()
    jm = JMHA(32, 4, dtype=jnp.bfloat16)
    with pallas_attention_on_cpu():
        want = jax.jit(jm.apply)(v, *args)
        eager = jm.apply(v, *args)
    pm = _port(MultiheadAttention(32, 4, dtype=BF16), v,
               ("decoder_0", "self_attn"), "decoder.0.self_attn.")
    with torch.no_grad():
        got = pm(_t(q), _t(kv), _t(kv), _t(pad))
    assert torch.isfinite(got[0]).all()
    _held(got[1], want[1], eager[1], "the row with real keys")


def test_position_embedding():
    """Observed: 0 op by op and jitted, f32 and bf16 boxes."""
    rng = np.random.RandomState(5)
    base = rng.rand(2, 12, 6).astype(np.float32)
    jm = JPosEmbed(32, dtype=jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(7), jnp.asarray(base))
    pm = _port(PositionEmbeddingLearned(6, 32, BF16), v,
               ("decoder_0", "self_posembed"), "decoder.0.self_posembed.")
    # f32 boxes, and bf16 ones, as the bf16 model's predicted boxes are
    for x, tx in ((jnp.asarray(base), _t(base)),
                  (_to_jax_bf16(base), _t(base).to(BF16))):
        with torch.no_grad():
            got = pm(tx)
        _held(got, jax.jit(jm.apply)(v, x), jm.apply(v, x), "pos")


def test_roberta_layer():
    """Observed: 4.8e-7 op by op (bound 2.7e-3), 7.3e-3 jitted (2.3e-2)."""
    conf = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=4, intermediate_size=48,
                max_position_embeddings=24)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 10, 32).astype(np.float32)
    pad = np.zeros((2, 10), bool)
    pad[1, 6:] = True
    jm = JRobertaLayer(JRobertaConfig(**conf), dtype=jnp.bfloat16)
    with pallas_attention_on_cpu():
        v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(pad))
        want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(pad))
        eager = jm.apply(v, jnp.asarray(x), jnp.asarray(pad))
    pm = _port(RobertaLayer(RobertaConfig(**conf), dtype=BF16), v,
               ("text_encoder", "layer_0"), "text_encoder.encoder.layer.0.")
    with torch.no_grad():
        got = pm(_t(x), _t(pad))
    _held(got, want, eager, "roberta layer")


def test_encoder_layer():
    """Observed: 4.8e-7 op by op (bounds 3.1e-3, 2.9e-3); jitted, vision
    1.5e-2 (bound 2.6e-2), text 8.5e-3 (2.4e-2)."""
    rng = np.random.RandomState(3)
    # the bf16 model's visual stream enters in bf16, the text in f32
    vis = rng.randn(2, 20, 32).astype(np.float32)
    pos = rng.randn(2, 20, 32).astype(np.float32)
    vmask = np.zeros((2, 20), bool)
    txt = rng.randn(2, 9, 32).astype(np.float32)
    tmask = np.zeros((2, 9), bool)
    tmask[0, 5:] = True
    det = rng.randn(2, 6, 32).astype(np.float32)
    dmask = np.zeros((2, 6), bool)
    dmask[1, 2:] = True
    jargs = [_to_jax_bf16(vis), _to_jax_bf16(pos), jnp.asarray(vmask),
             jnp.asarray(txt), jnp.asarray(tmask), _to_jax_bf16(det),
             jnp.asarray(dmask)]
    jm = JEncoderLayer(32, 4, 48, use_butd_enc_attn=True,
                       dtype=jnp.bfloat16)
    with pallas_attention_on_cpu():
        v = jm.init(jax.random.PRNGKey(3), *jargs)
        want = jax.jit(jm.apply)(v, *jargs)
        eager = jm.apply(v, *jargs)
    pm = _port(BiEncoderLayer(32, 4, 48, use_butd_enc_attn=True,
                              dtype=BF16),
               v, ("cross_encoder", "layer_0"), "cross_encoder.layers.0.")
    targs = [_t(vis).to(BF16), _t(pos).to(BF16), _t(vmask), _t(txt),
             _t(tmask), _t(det).to(BF16), _t(dmask)]
    with torch.no_grad():
        got = pm(*targs)
    for name, g, w, e in zip(("vision", "text"), got, want, eager):
        _held(g, w, e, name)


def test_decoder_layer():
    """Observed: 4.8e-7 op by op (bound 2.7e-3) and jitted (2.2e-2)."""
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
    jm = JDecoderLayer(32, 4, 48, butd=True, dtype=jnp.bfloat16)
    jargs = (jnp.asarray(query), jnp.asarray(vis), jnp.asarray(lang),
             _to_jax_bf16(qpos), None, jnp.asarray(tmask),
             _to_jax_bf16(det), jnp.asarray(dmask))
    with pallas_attention_on_cpu():
        v = jm.init(jax.random.PRNGKey(4), *jargs)
        want = jax.jit(jm.apply)(v, *jargs)
        eager = jm.apply(v, *jargs)
    pm = _port(BiDecoderLayer(32, 4, 48, butd=True, dtype=BF16), v,
               ("decoder_0",), "decoder.0.")
    with torch.no_grad():
        got = pm(_t(query), _t(vis), _t(lang), _t(qpos).to(BF16), None,
                 _t(tmask), _t(det).to(BF16), _t(dmask))
    _held(got, want, eager, "decoder")


def test_heads():
    """Observed: 0 op by op and jitted, every head."""
    rng = np.random.RandomState(5)
    feats = rng.randn(2, 12, 32).astype(np.float32)
    base = rng.rand(2, 12, 3).astype(np.float32)
    jm = JPredictHead(num_class=20, seed_feat_dim=32, dtype=jnp.bfloat16)
    jargs = (jnp.asarray(feats), _to_jax_bf16(base))
    v = jm.init(jax.random.PRNGKey(5), *jargs)
    want = jax.jit(jm.apply)(v, *jargs)
    eager = jm.apply(v, *jargs)
    pm = _port(ClsAgnosticPredictHead(20, 32, BF16), v, ("proposal_head",),
               "proposal_head.")
    with torch.no_grad():
        got = pm(_t(feats), _t(base).to(BF16))
    assert set(got) == set(want)
    for k in want:
        _held(got[k], want[k], eager[k], k)

    jm = JObjCls(32, dtype=jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(6), jnp.asarray(feats))
    pm = _port(PointsObjClsModule(32, BF16), v, ("points_obj_cls",),
               "points_obj_cls.")
    with torch.no_grad():
        _held(pm(_t(feats)), jax.jit(jm.apply)(v, jnp.asarray(feats)),
              jm.apply(v, jnp.asarray(feats)), "objectness")

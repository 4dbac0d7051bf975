"""The port's division by a constant and its fused grouping (CPU).

The JAX package runs its model, loss and evaluators under `jax.jit`, where
XLA turns a tensor divided by a Python constant into a multiply by the f32
reciprocal. The JAX side here therefore runs jitted: eager `jnp` divides
for real and would hide a port that divides. The one eager site is the
JAX predictor's `contrast_scores`, held against the port's predictor's
true division.

* `QueryAndGroup` (f32 and bf16 MLP, with and without features) bit-equal
  to the JAX module under jit; the temperature sites (`contrast_scores`
  of the evaluators, `loss_contrastive_align` of the train step) bit-equal
  to the JAX functions run under jit up to their softmax input, on inputs
  whose dot products are exact, so that only the scaling is compared.
* `group_rows_mlp_input_plain`, the plain version of the fused grouping
  kernel, bit-equal to the jitted JAX `QueryAndGroup(dtype=bf16)` output
  cast to bf16 at sa1- and sa2-like shapes, and to the eager chain it
  replaces (gather, subtract, scale, concatenate, cast), with indices out
  of range.
* The fused op's gradients: the features' bit-equal to autograd through
  the eager chain, xyz's and the centres' within 1e-6 relative; only the
  index is saved; on the backbone's path the cloud and the centres need no
  gradient.

The kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.extend import core as jcore

from butd_detr_tpu.eval.grounding import contrast_scores as j_contrast_scores
from butd_detr_tpu.losses.criterion import (
    loss_contrastive_align as j_loss_contrastive_align,
)
from butd_detr_tpu.nn.pointnet2 import QueryAndGroup as JQueryAndGroup
from butd_detr_tpu_torch import predict as predict_module
from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.eval.grounding import contrast_logits
from butd_detr_tpu_torch.losses.criterion import contrastive_logits
from butd_detr_tpu_torch.nn import Pointnet2Backbone, QueryAndGroup
from butd_detr_tpu_torch.nn import pointnet2 as port_pointnet2
from butd_detr_tpu_torch.ops import (
    ball_query,
    bf16_rn,
    group_points_mlp_input,
    group_points_split,
    group_rows_mlp_input,
    group_rows_mlp_input_plain,
)
from butd_detr_tpu_torch.utils import reciprocal_f32


def _bits(a) -> np.ndarray:
    """A torch tensor's or a JAX array's bits as integers."""
    if isinstance(a, torch.Tensor):
        t = a.contiguous()
        return t.view(torch.int32 if t.element_size() == 4
                      else torch.int16).numpy()
    a = jnp.asarray(a)
    return np.asarray(jax.lax.bitcast_convert_type(
        a, jnp.int32 if a.dtype.itemsize == 4 else jnp.int16))


def _scene(seed, b, n, m, c):
    """A (b, n, 3) cloud in a 2 m cube, m centres taken from it and (b, n,
    c) features."""
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(b, n, 3) * 2).astype(np.float32)
    centres = xyz[:, rng.choice(n, m, replace=False)].copy()
    feats = rng.randn(b, n, c).astype(np.float32) if c else None
    return xyz, centres, feats


def _jax_group(radius, ns, normalize, dtype, xyz, centres, feats):
    """The JAX module under jit; with a bf16 MLP its output is cast to
    bf16 there, as its SharedMLP does first."""
    mod = JQueryAndGroup(radius, ns, use_xyz=True, normalize_xyz=normalize,
                         dtype=dtype)

    def run(x, c, f):
        out, _ = mod.apply({}, x, c, f)
        return out.astype(dtype)

    return jax.jit(run)(xyz, centres, feats)


# ---------------------------------------------------------- (a) the repair

@pytest.mark.parametrize("radius,ns,c,normalize", [
    (0.2, 32, 3, True),   # fails when the port divides by the radius
    (1.2, 16, 8, True),
    (0.4, 16, 0, True),   # no features: xyz only
    (0.8, 16, 3, False),
])
def test_query_and_group_f32_bit_equal_to_jitted_jax(radius, ns, c,
                                                     normalize):
    xyz, centres, feats = _scene(int(radius * 10) + c, 2, 2048, 256, c)
    want = _jax_group(radius, ns, normalize, jnp.float32, xyz, centres,
                      feats)
    got, _ = QueryAndGroup(radius, ns, normalize_xyz=normalize)(
        torch.from_numpy(xyz), torch.from_numpy(centres),
        None if feats is None else torch.from_numpy(feats))
    assert got.dtype == torch.float32
    assert got.shape == (2, 256, ns, 3 + c)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _upto_first_div(fn, args, jit=True):
    """`fn(*args)` under jax.jit (or eagerly, op by op), stopped at the
    output of its first division: the jaxpr of `fn` cut after that
    equation, then run."""
    closed = jax.make_jaxpr(fn)(*args)
    jaxpr = closed.jaxpr
    i = next(i for i, e in enumerate(jaxpr.eqns)
             if e.primitive.name == "div")
    cut = jaxpr.replace(eqns=jaxpr.eqns[:i + 1],
                        outvars=list(jaxpr.eqns[i].outvars))
    run = jcore.jaxpr_as_fun(jcore.ClosedJaxpr(cut, closed.consts))
    if not jit:
        with jax.disable_jit():
            return np.asarray(run(*args)[0])
    return np.asarray(jax.jit(run)(*args)[0])


def _exact_projections(seed, b, q, t, d=64):
    """Query and token vectors of multiples of 1/8 in [-3/8, 3/8]: every
    dot product is a multiple of 1/64 below 2^4, exact in f32 whatever the
    order of its sum, so torch's and XLA's agree to the bit."""
    rng = np.random.RandomState(seed)
    return ((rng.randint(-3, 4, (b, q, d)) / 8).astype(np.float32),
            (rng.randint(-3, 4, (b, t, d)) / 8).astype(np.float32))


@pytest.mark.parametrize("site", ["evaluator", "criterion"])
def test_temperature_sites_bit_equal_to_jitted_jax(site):
    """The evaluators run `contrast_scores` inside `jax.jit`
    (GroundingEvaluator and GroundingGTEvaluator `_kernel`), the train step
    the criterion: both divide by 0.07 there, which XLA compiles to a
    multiply by float32(1) / float32(0.07)."""
    q, t = _exact_projections(3, 2, 64, 40)
    if site == "evaluator":
        want = _upto_first_div(
            lambda a, b: j_contrast_scores(
                {"last_proj_queries": a, "proj_tokens": b}, "last_", 256),
            (q, t))
        got = contrast_logits({"last_proj_queries": torch.from_numpy(q),
                               "proj_tokens": torch.from_numpy(t)}, "last_")
    else:
        B, G, L = 2, 3, t.shape[1]
        args = (q, t, np.ones((B, L), np.int32),
                np.zeros((B, G, 256), np.float32), np.zeros((B, G), np.int32),
                np.ones((B, G), np.float32), np.float32(3.0))
        want = _upto_first_div(j_loss_contrastive_align, args)
        got = contrastive_logits(torch.from_numpy(q), torch.from_numpy(t))
    assert want.shape == tuple(got.shape)
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))
    # a true division differs: the test sees the repair
    sim = torch.einsum("bqd,btd->bqt", torch.from_numpy(q),
                       torch.from_numpy(t))
    assert (_bits(sim / 0.07) != want.view(np.int32)).any()


def test_predictor_divides_as_the_eager_jax_predictor(monkeypatch):
    """The JAX predictor calls `contrast_scores` eagerly (predict.py:223),
    outside its jitted forward: a true division by 0.07, which the port's
    predictor repeats (`divide=True`), bit for bit; the evaluators' form
    stays the jitted multiply (the test above)."""
    q, t = _exact_projections(4, 1, 256, 24)
    want = _upto_first_div(
        lambda a, b: j_contrast_scores(
            {"last_proj_queries": a, "proj_tokens": b}, "last_", 256),
        (q, t), jit=False)
    ep = {"last_proj_queries": torch.from_numpy(q),
          "proj_tokens": torch.from_numpy(t)}
    got = contrast_logits(ep, "last_", divide=True)
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))
    jitted = contrast_logits(ep, "last_")
    assert (_bits(jitted) != want.view(np.int32)).any()
    # GroundingPredictor.predict scores `bbf` with the dividing form
    seen = []
    scores = predict_module.contrast_scores
    monkeypatch.setattr(predict_module, "contrast_scores",
                        lambda *a, **kw: seen.append(kw) or scores(*a, **kw))
    from test_torch_model import NPOINTS, ROBERTA

    pred = predict_module.GroundingPredictor(
        Config(use_color=True, butd_cls=True, use_contrastive_align=True,
               num_target=8, num_encoder_layers=1, num_decoder_layers=1,
               max_text_len=16, num_points=512),
        predict_module.SimpleTokenizer(128, 16),
        roberta_config=predict_module.RobertaConfig(**ROBERTA),
        backbone_npoints=NPOINTS, device="cpu")
    cloud = np.random.RandomState(0).rand(600, 6).astype(np.float32)
    pred.predict(cloud, "the chair by the table", phrase="chair", top_k=3)
    assert seen == [{"divide": True}]


def test_reciprocal_f32_is_the_f32_division():
    for x in (0.2, 0.4, 0.8, 1.2, 0.07, 3.0, 24.0):
        r = reciprocal_f32(x)
        assert np.float32(r) == np.float32(1) / np.float32(x)
        assert float(np.float32(r)) == r


# ------------------------------------------- (b) the fused op's plain version

# (radius, ns, n, m, c): an sa1-like grouping (6-byte bf16 feature rows)
# and an sa2-like one (256-byte rows)
SHAPES = [(0.2, 64, 4096, 128, 3), (0.4, 32, 1024, 64, 128)]


@pytest.mark.parametrize("radius,ns,n,m,c", SHAPES)
def test_mlp_input_plain_bit_equal_to_jitted_jax(radius, ns, n, m, c):
    xyz, centres, feats = _scene(ns, 2, n, m, c)
    want = _jax_group(radius, ns, True, jnp.bfloat16, xyz, centres, feats)
    tx, tc = torch.from_numpy(xyz), torch.from_numpy(centres)
    tf = torch.from_numpy(feats)
    idx = ball_query(radius, ns, tx, tc)
    got = group_rows_mlp_input_plain(tx, tc, tf, idx, reciprocal_f32(radius))
    assert got.dtype == torch.bfloat16 and got.shape == (2, m, ns, 3 + c)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the module's bf16 branch is the op
    mod_out, grouped_xyz = QueryAndGroup(
        radius, ns, normalize_xyz=True, dtype=torch.bfloat16)(tx, tc, tf)
    np.testing.assert_array_equal(_bits(mod_out), _bits(want))
    assert torch.equal(grouped_xyz, mod_out[..., :3])


def _eager_chain(xyz, centres, feats, idx, inv_r):
    """What the bf16 branch of `QueryAndGroup` ran before the fused op:
    the split gather, the subtraction and scale in f32, the concatenation
    (which promotes the features to f32) and the MLP's cast to bf16."""
    gx, gf = group_points_split(xyz, feats.to(torch.bfloat16), idx)
    grouped_xyz = (gx - centres[:, :, None, :]) * inv_r
    return torch.cat([grouped_xyz, gf], dim=-1).to(torch.bfloat16)


def _out_of_range(idx, n):
    idx = idx.clone()
    idx[0, 0, 0] = n
    idx[1, -1, -1] = -1
    idx[1, 3, :] = 2 ** 31 - 1
    return idx


@pytest.mark.parametrize("radius,ns,n,m,c", SHAPES)
def test_mlp_input_plain_is_the_eager_chain_with_indices_out_of_range(
        radius, ns, n, m, c):
    xyz, centres, feats = _scene(ns + 1, 2, n, m, c)
    tx, tc = torch.from_numpy(xyz), torch.from_numpy(centres)
    tf = torch.from_numpy(feats).to(torch.bfloat16)
    inv_r = reciprocal_f32(radius)
    idx = _out_of_range(ball_query(radius, ns, tx, tc), n)
    got = group_rows_mlp_input(tx, tc, tf, idx, inv_r)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_eager_chain(tx, tc, tf, idx, inv_r)))
    np.testing.assert_array_equal(
        _bits(got), _bits(group_rows_mlp_input(tx, tc, tf, idx.int(), inv_r)))
    # a row out of range is a zero row: features 0, xyz bf16((0 - c) / r)
    # as the jitted JAX arithmetic gives it
    zero_xyz = jax.jit(lambda c: ((0.0 - c) / radius).astype(jnp.bfloat16))(
        centres[1, 3])
    np.testing.assert_array_equal(
        _bits(got[1, 3, :, :3]),
        np.broadcast_to(_bits(zero_xyz), (ns, 3)))
    assert not got[1, 3, :, 3:].float().any()
    assert not got[0, 0, 0, 3:].float().any()


def test_bf16_rn_rounds_as_the_cpu_conversion():
    """Ties to even, denormals kept, infinities kept, as PyTorch's CPU
    cast; every NaN 0x7FC0 (c10's scalar rule), where the vectorized cast
    gives 0xFFFF and the card's 0x7FFF."""
    vals = torch.tensor([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -0.0, 1e-40,
                         -3e-39, 3.4e38, -float("inf"), float("nan")])
    raw = vals.clone()
    # a negative NaN with a payload: 0xFFC12345
    raw[-1:].view(torch.int32)[0] = int(
        np.array([0xFFC12345], np.uint32).view(np.int32)[0])
    assert raw[-1].isnan()
    got = bf16_rn(raw)
    want = raw[:-1].to(torch.bfloat16).view(torch.int16)
    assert torch.equal(got[:-1].view(torch.int16), want)
    assert got[-1:].view(torch.int16).item() == 0x7FC0
    assert got[:2].float().tolist() == [1.0, 1.0 + 2 ** -6]


# ------------------------------------------------------- (c) the gradients

@pytest.mark.parametrize("radius,ns,n,m,c", SHAPES)
@pytest.mark.parametrize("fdtype", [torch.float32, torch.bfloat16])
def test_mlp_input_gradients_match_the_eager_chain(radius, ns, n, m, c,
                                                   fdtype):
    xyz, centres, feats = _scene(ns + 2, 2, n, m, c)
    inv_r = reciprocal_f32(radius)
    idx = _out_of_range(ball_query(radius, ns, torch.from_numpy(xyz),
                                   torch.from_numpy(centres)), n)
    rng = np.random.RandomState(7)
    ct = torch.from_numpy(rng.randn(2, m, ns, 3 + c).astype(np.float32)) \
        .to(torch.bfloat16)

    def grads(fn):
        tx = torch.from_numpy(xyz).requires_grad_()
        tc = torch.from_numpy(centres).requires_grad_()
        tf = torch.from_numpy(feats).to(fdtype).requires_grad_()
        out = fn(tx, tc, tf, idx, inv_r)
        assert out.dtype == torch.bfloat16
        out.backward(ct)
        return tx.grad, tc.grad, tf.grad

    gx, gc, gf = grads(group_points_mlp_input)
    wx, wc, wf = grads(_eager_chain)
    assert gf.dtype == fdtype
    np.testing.assert_array_equal(_bits(gf), _bits(wf))
    for got, want in ((gx, wx), (gc, wc)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))


def test_mlp_input_saves_only_the_index():
    xyz, centres, feats = _scene(4, 2, 512, 32, 8)
    idx = ball_query(0.4, 16, torch.from_numpy(xyz),
                     torch.from_numpy(centres))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        group_points_mlp_input(
            torch.from_numpy(xyz).requires_grad_(), torch.from_numpy(centres),
            torch.from_numpy(feats).to(torch.bfloat16).requires_grad_(), idx,
            reciprocal_f32(0.4))
    assert len(saved) == 1 and saved[0] is idx


def test_backbone_groupings_take_the_fused_op_and_need_no_xyz_gradient(
        monkeypatch):
    """With a bf16 MLP every set-abstraction tier groups through the fused
    op; its cloud and centres need no gradient (the cloud needs none and
    the centres are gathered from it), so its backward gives the features'
    gradient only."""
    calls = []

    def spy(xyz, new_xyz, feats, idx, inv_r):
        calls.append((xyz.requires_grad, new_xyz.requires_grad,
                      feats.requires_grad, inv_r))
        return group_points_mlp_input(xyz, new_xyz, feats, idx, inv_r)

    monkeypatch.setattr(port_pointnet2, "group_points_mlp_input", spy)
    torch.manual_seed(0)
    net = Pointnet2Backbone(3, npoints=(64, 32, 16, 8),
                            dtype=torch.bfloat16).train()
    rng = np.random.RandomState(5)
    pc = torch.from_numpy(np.concatenate(
        [rng.rand(2, 1024, 3) * 3, rng.rand(2, 1024, 3) - 0.5],
        -1).astype(np.float32))
    out = net(pc)
    out["fp2_features"].float().sum().backward()
    assert [c[:3] for c in calls] == [(False, False, False)] + \
        [(False, False, True)] * 3
    assert [c[3] for c in calls] == [reciprocal_f32(r)
                                     for r in (0.2, 0.4, 0.8, 1.2)]
    assert net.sa1.mlp_module.layer0.conv.weight.grad is not None

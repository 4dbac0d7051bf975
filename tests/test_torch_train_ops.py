"""The training ops of the port (plain PyTorch versions, CPU) against the
JAX package on the same numpy inputs: the row scatter-add and the gathers'
gradients, the attention backward against `jax.grad` of the Pallas kernel
in interpret mode, and attention dropout with an explicit mask.

Tolerances are stated per test. The TPU's random bits cannot be had here,
so the two packages are compared at p = 0; dropout is checked against the
written-out expression with the port's own mask.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from butd_detr_tpu.ops.pallas_attention import fused_attention
from butd_detr_tpu.ops.pallas_scatter import (
    scatter_rows_add_pallas,
    scatter_rows_add_xla,
)
from butd_detr_tpu.ops.pointcloud import (
    gather_points as j_gather_points,
    group_points as j_group_points,
    group_points_split as j_group_points_split,
    three_interpolate as j_three_interpolate,
)
from butd_detr_tpu_torch.ops import (
    _cuda,
    attention,
    attention_backward_plain,
    attention_plain,
    dropout_keep_mask,
    dropout_keep_mask_plain,
    gather_points,
    group_points,
    group_points_split,
    scatter_rows_add,
    scatter_rows_add_plain,
    three_interpolate,
)
from butd_detr_tpu_torch.ops.attention import dropout_threshold, philox4x32


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_() if grad else t


# ------------------------------------------------------------ scatter-add

def test_scatter_rows_add_matches_xla_and_pallas_interpret():
    rng = np.random.RandomState(12)
    B, M, C, n = 2, 300, 9, 130
    g = rng.randn(B, M, C).astype(np.float32)
    idx = rng.randint(0, n, (B, M)).astype(np.int32)
    idx[0, :7] = n  # dropped
    idx[1, 5::40] = n
    got = scatter_rows_add_plain(_t(g), _t(idx), n)
    assert got.dtype == torch.float32 and got.shape == (B, n, C)
    xla = scatter_rows_add_xla(jnp.asarray(g), jnp.asarray(idx), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=1e-5)
    pallas = scatter_rows_add_pallas(jnp.asarray(g), jnp.asarray(idx), n,
                                     True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)
    # the dispatching wrapper takes the plain version on the CPU
    before = dict(_cuda.LAUNCHES)
    np.testing.assert_array_equal(
        scatter_rows_add(_t(g), _t(idx), n).numpy(), got.numpy())
    assert _cuda.LAUNCHES == before


def test_scatter_rows_add_drops_negative_indices_as_the_tpu_kernel():
    """An index < 0 matches no one-hot column of the TPU kernel (Pallas,
    interpret mode), so its row is dropped, in every batch element."""
    rng = np.random.RandomState(5)
    B, M, C, n = 3, 200, 8, 40
    g = rng.randn(B, M, C).astype(np.float32)
    idx = rng.randint(-3, n + 3, (B, M)).astype(np.int32)
    got = scatter_rows_add_plain(_t(g), _t(idx), n)
    pallas = scatter_rows_add_pallas(jnp.asarray(g), jnp.asarray(idx), n,
                                     True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_rows_add_plain_adds_in_ascending_m(dtype):
    """The plain version on the CPU is a sequential sum of each output
    row's rows in ascending m (numpy's unbuffered `add.at`, f32): the order
    the CUDA kernel reproduces bit for bit (csrc/scatter.cu)."""
    rng = np.random.RandomState(9)
    B, M, C, n = 2, 4096, 12, 64
    g = _t(rng.randn(B, M, C).astype(np.float32)).to(dtype)
    idx = rng.randint(0, n + 2, (B, M))
    idx[1, :1500] = 3  # a long segment
    got = scatter_rows_add_plain(g, _t(idx), n).numpy()
    gf = g.float().numpy()
    for b in range(B):
        want = np.zeros((n + 2, C), np.float32)
        np.add.at(want, idx[b], gf[b])
        np.testing.assert_array_equal(got[b], want[:n])


def test_scatter_rows_add_bf16_rows_accumulate_in_f32():
    rng = np.random.RandomState(2)
    g = rng.randn(1, 64, 4).astype(np.float32)
    idx = np.zeros((1, 64), np.int32)  # all rows on one index
    gb = _t(g).to(torch.bfloat16)
    got = scatter_rows_add(gb, _t(idx), 3)
    want = gb.float().sum(dim=1)
    np.testing.assert_allclose(got[0, 0].numpy(), want[0].numpy(),
                               atol=1e-5)
    assert float(got[0, 1:].abs().max()) == 0.0


def _vjp(fn, args, ct):
    out, pull = jax.vjp(fn, *args)
    return out, pull(ct)


@pytest.mark.parametrize("name", ["gather_points", "group_points",
                                  "three_interpolate"])
def test_gather_gradients_match_jax(name):
    """atol 1e-5: the same f32 sums in another order."""
    rng = np.random.RandomState(13)
    B, N, C = 2, 64, 5
    pts = rng.randn(B, N, C).astype(np.float32)
    if name == "gather_points":
        idx = rng.randint(0, N, (B, 40)).astype(np.int32)
        ct = rng.randn(B, 40, C).astype(np.float32)
        jf = lambda p: j_gather_points(p, jnp.asarray(idx))
        tf = lambda p: gather_points(p, _t(idx))
    elif name == "group_points":
        idx = rng.randint(0, N, (B, 10, 4)).astype(np.int32)
        ct = rng.randn(B, 10, 4, C).astype(np.float32)
        jf = lambda p: j_group_points(p, jnp.asarray(idx))
        tf = lambda p: group_points(p, _t(idx))
    else:
        idx = rng.randint(0, N, (B, 30, 3)).astype(np.int32)
        w = rng.rand(B, 30, 3).astype(np.float32)
        ct = rng.randn(B, 30, C).astype(np.float32)
        jf = lambda p: j_three_interpolate(p, jnp.asarray(idx),
                                           jnp.asarray(w))
        tf = lambda p: three_interpolate(p, _t(idx), _t(w))
    want_out, (want_grad,) = _vjp(jf, (jnp.asarray(pts),), jnp.asarray(ct))
    p = _t(pts, grad=True)
    out = tf(p)
    out.backward(_t(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad),
                               atol=1e-5)


def test_three_interpolate_weight_gradient_matches_jax():
    rng = np.random.RandomState(14)
    feats = rng.randn(2, 20, 6).astype(np.float32)
    idx = rng.randint(0, 20, (2, 30, 3)).astype(np.int32)
    w = rng.rand(2, 30, 3).astype(np.float32)
    ct = rng.randn(2, 30, 6).astype(np.float32)
    _, (want,) = _vjp(
        lambda ww: j_three_interpolate(jnp.asarray(feats), jnp.asarray(idx),
                                       ww), (jnp.asarray(w),),
        jnp.asarray(ct))
    wt = _t(w, grad=True)
    three_interpolate(_t(feats), _t(idx), wt).backward(_t(ct))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want), atol=1e-5)


def test_group_points_split_gradients_match_jax_with_a_bf16_leg():
    """The feature leg carries a bf16 cotangent: its gradient has that
    dtype and equals the f32 sum rounded once."""
    rng = np.random.RandomState(15)
    B, N, m, ns, C = 2, 48, 9, 4, 5
    xyz = rng.randn(B, N, 3).astype(np.float32)
    feats = rng.randn(B, N, C).astype(np.float32)
    idx = rng.randint(0, N, (B, m, ns)).astype(np.int32)
    ctx = rng.randn(B, m, ns, 3).astype(np.float32)
    ctf = rng.randn(B, m, ns, C).astype(np.float32)

    jfe = jnp.asarray(feats).astype(jnp.bfloat16)
    _, (jgx, jgf) = _vjp(
        lambda x, f: j_group_points_split(x, f, jnp.asarray(idx)),
        (jnp.asarray(xyz), jfe),
        (jnp.asarray(ctx), jnp.asarray(ctf).astype(jnp.bfloat16)))

    x = _t(xyz, grad=True)
    f = _t(feats).to(torch.bfloat16).requires_grad_()
    gx, gf = group_points_split(x, f, _t(idx))
    assert gf.dtype == torch.bfloat16 and gx.dtype == torch.float32
    torch.autograd.backward([gx, gf], [_t(ctx), _t(ctf).to(torch.bfloat16)])
    assert f.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), atol=1e-5)
    # rounded once from the f32 sum: bit-equal to JAX unless the two f32
    # sums straddle a rounding boundary (one bf16 step, 2^-8 relative)
    want = np.asarray(jgf.astype(jnp.float32))
    np.testing.assert_allclose(f.grad.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)
    f32_sum = scatter_rows_add_plain(
        _t(ctf).to(torch.bfloat16).reshape(B, m * ns, C),
        _t(idx).reshape(B, m * ns), N)
    assert torch.equal(f.grad, f32_sum.to(torch.bfloat16))


def test_gather_needs_no_gradient_for_a_constant_source():
    """No scatter is computed where the source needs no gradient."""
    xyz = torch.randn(1, 10, 3)
    feats = torch.randn(1, 10, 4, requires_grad=True)
    idx = torch.randint(0, 10, (1, 5, 2), dtype=torch.int32)
    gx, gf = group_points_split(xyz, feats, idx)
    (gx.sum() + gf.sum()).backward()
    assert xyz.grad is None and feats.grad is not None
    assert not gather_points(xyz, idx[:, :, 0]).requires_grad


# ------------------------------------------------------- attention backward

def _attention_case(lk, fully_masked):
    rng = np.random.RandomState(lk)
    B, H, Lq, Dh = 2, 4, 40, 36
    q = rng.randn(B, H, Lq, Dh).astype(np.float32)
    k = rng.randn(B, H, lk, Dh).astype(np.float32)
    v = rng.randn(B, H, lk, Dh).astype(np.float32)
    do = rng.randn(B, H, Lq, Dh).astype(np.float32)
    pad = np.zeros((B, lk), bool)
    pad[:, lk - 10:] = True
    if fully_masked:
        pad[1] = True
    return q, k, v, do, pad, 1.0 / np.sqrt(Dh)


# Lk = 70: keys 60-69 padded. Lk = 128 with one fully masked batch row:
# only at a multiple of 128 keys does the TPU wrapper add no zero padding
# keys, whose zeros would enter the uniform row's average.
@pytest.mark.parametrize("lk,fully_masked", [(70, False), (128, True)])
@pytest.mark.parametrize("precise", [True, False])
def test_attention_backward_matches_jax_grad_of_pallas_interpret(
        lk, fully_masked, precise):
    q, k, v, do, pad, scale = _attention_case(lk, fully_masked)
    want = jax.grad(lambda a: jnp.sum(fused_attention(
        a[0], a[1], a[2], jnp.asarray(pad), sm_scale=scale, interpret=True,
        precise=precise) * jnp.asarray(do)))(
            (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    plain = attention_backward_plain(_t(q), _t(k), _t(v), _t(do), _t(pad),
                                     sm_scale=scale, precise=precise)
    leaves = [_t(a, grad=True) for a in (q, k, v)]
    attention(*leaves, _t(pad), sm_scale=scale,
              precise=precise).backward(_t(do))
    for w, p, leaf in zip(want, plain, leaves):
        w = np.asarray(w)
        # the op's backward IS the plain version on the CPU
        np.testing.assert_array_equal(leaf.grad.numpy(), p.numpy())
        if precise:
            np.testing.assert_allclose(p.numpy(), w, atol=5e-5)
        else:
            # the bound of the JAX package's own test of its bf16 mode
            err = np.abs(p.numpy() - w).max()
            assert err < 0.05 * (np.abs(w).max() + 1e-6), err


def test_attention_backward_plain_matches_autograd_of_softmax_attention():
    q, k, v, do, pad, scale = _attention_case(70, False)
    leaves = [_t(a, grad=True) for a in (q, k, v)]
    s = torch.matmul(leaves[0] * scale, leaves[1].transpose(-1, -2))
    s = s.masked_fill(_t(pad)[:, None, None, :],
                      torch.finfo(torch.float32).min)
    torch.matmul(torch.softmax(s, -1), leaves[2]).backward(_t(do))
    got = attention_backward_plain(_t(q), _t(k), _t(v), _t(do), _t(pad),
                                   sm_scale=scale, precise=True)
    for g, leaf in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=1e-5)


# ------------------------------------------------------------------ dropout

def test_dropout_with_an_explicit_mask_is_mask_over_keep_times_softmax():
    """Plain forward == (mask / (1 - p) o softmax) V and plain backward ==
    autograd through that expression (atol 1e-5), f32 mode."""
    q, k, v, do, pad, scale = _attention_case(70, False)
    p = 0.1
    rng = np.random.RandomState(9)
    keep = _t(rng.rand(2, 4, 40, 70) >= p)
    leaves = [_t(a, grad=True) for a in (q, k, v)]
    s = torch.matmul(leaves[0] * scale, leaves[1].transpose(-1, -2))
    s = s.masked_fill(_t(pad)[:, None, None, :],
                      torch.finfo(torch.float32).min)
    want = torch.matmul(torch.softmax(s, -1) * keep / (1 - p), leaves[2])
    want.backward(_t(do))
    got = attention_plain(_t(q), _t(k), _t(v), _t(pad), sm_scale=scale,
                          precise=True, keep_mask=keep, dropout_p=p)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                               atol=1e-5)
    grads = attention_backward_plain(
        _t(q), _t(k), _t(v), _t(do), _t(pad), sm_scale=scale, precise=True,
        keep_mask=keep, dropout_p=p)
    for g, leaf in zip(grads, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=1e-5)


def test_attention_dropout_regenerates_its_mask_from_the_seed():
    """attention(dropout_p, seed) applies `dropout_keep_mask(seed)` in the
    forward and again in the backward; another seed gives another mask."""
    q, k, v, do, pad, scale = _attention_case(70, False)
    p, seed = 0.1, 1234567891011
    keep = dropout_keep_mask(seed, 2, 4, 40, 70, p)
    assert keep.dtype == torch.bool and keep.shape == (2, 4, 40, 70)
    assert torch.equal(keep, dropout_keep_mask(seed, 2, 4, 40, 70, p))
    assert not torch.equal(keep, dropout_keep_mask(seed + 1, 2, 4, 40, 70,
                                                   p))
    leaves = [_t(a, grad=True) for a in (q, k, v)]
    out = attention(*leaves, _t(pad), sm_scale=scale, dropout_p=p,
                    seed=seed)
    want = attention_plain(_t(q), _t(k), _t(v), _t(pad), sm_scale=scale,
                           keep_mask=keep, dropout_p=p)
    np.testing.assert_array_equal(out.detach().numpy(), want.numpy())
    out.backward(_t(do))
    grads = attention_backward_plain(_t(q), _t(k), _t(v), _t(do), _t(pad),
                                     sm_scale=scale, keep_mask=keep,
                                     dropout_p=p)
    for g, leaf in zip(grads, leaves):
        np.testing.assert_array_equal(leaf.grad.numpy(), g.numpy())
    with pytest.raises(ValueError, match="seed"):
        attention(*leaves, dropout_p=p)


def test_dropout_keep_rate_is_within_four_sigma():
    p, n = 0.1, 10 ** 6
    keep = dropout_keep_mask_plain(77, 2, 5, 100, 1000, p)
    assert keep.numel() == n
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(float(keep.float().mean()) - (1 - p)) <= 4 * sigma
    # a key length that is no multiple of the 4 keys of one Philox draw
    odd = dropout_keep_mask_plain(77, 1, 2, 7, 13, p)
    wide = dropout_keep_mask_plain(77, 1, 2, 7, 16, p)
    assert torch.equal(odd, wide[..., :13])
    assert dropout_threshold(0.0) == 0
    assert dropout_threshold(1.0) == 2 ** 32 - 1


def test_philox_matches_the_published_test_vectors():
    """Philox4x32-10 known answers (Random123 kat_vectors)."""
    def run(ctr, key):
        c = tuple(torch.tensor([x], dtype=torch.int64) for x in ctr)
        return [int(x) for x in philox4x32(c, key[0] | (key[1] << 32))]

    assert run((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = 0xFFFFFFFF
    assert run((f, f, f, f), (f, f)) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
               (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_attention_without_dropout_is_bit_identical_to_the_serving_forward():
    """p = 0 takes the same arithmetic as before dropout existed: the
    written-out serving forward, bit for bit, in both modes."""
    q, k, v, _, pad, scale = _attention_case(70, False)
    for precise in (True, False):
        rnd = (lambda x: x) if precise else (
            lambda x: x.to(torch.bfloat16).float())
        qf, kf, vf = rnd(_t(q) * scale), rnd(_t(k)), rnd(_t(v))
        s = torch.matmul(qf, kf.transpose(-1, -2)).masked_fill(
            _t(pad)[:, None, None, :], torch.finfo(torch.float32).min)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        want = torch.matmul(rnd(e / e.sum(dim=-1, keepdim=True)), vf)
        got = attention(_t(q), _t(k), _t(v), _t(pad), sm_scale=scale,
                        precise=precise)
        assert torch.equal(got, want)

"""The port's point-cloud and attention ops (plain PyTorch versions, CPU)
against the JAX package: the XLA functions and the Pallas kernels in
interpret mode, on the same numpy inputs.

Integers must be bit-equal. Float tolerances are stated per test.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from butd_detr_tpu.ops.pallas_attention import fused_attention
from butd_detr_tpu.ops.pallas_fps import furthest_point_sample_pallas
from butd_detr_tpu.ops.pointcloud import (
    _ball_query_pruned_pallas,
    _ball_query_scan,
    furthest_point_sample_xla,
    gather_points as j_gather_points,
    group_points as j_group_points,
    group_points_split as j_group_points_split,
    three_interpolate as j_three_interpolate,
    three_nn as j_three_nn,
)
from butd_detr_tpu_torch.ops import (
    _cuda,
    attention,
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
    group_points_split,
    three_interpolate,
    three_nn,
)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(rng, b, n):
    return (rng.rand(b, n, 3) * 4).astype(np.float32)


def _fps_cloud(n, kind):
    """Two clouds of n points. "mixed": invalid points and a duplicate;
    "ties": duplicates on both sides of the slice boundaries of the CUDA
    kernel's cluster (8 blocks of ceil(n / 8) points), so that argmax ties
    fall between two blocks; "invalid": no valid point in the first cloud,
    one (at a slice boundary) in the second."""
    rng = np.random.RandomState(n)
    xyz = _cloud(rng, 2, n)
    s = -(-n // 8)
    if kind == "mixed":
        xyz[0, 5:40] = 0.0  # |p|^2 <= 1e-3: never chosen
        xyz[1, 7] = xyz[1, 3]  # duplicate point: distance ties
    elif kind == "ties":
        xyz[0, [s - 1, s]] = 9.0  # the farthest pair, blocks 0 and 1
        xyz[1, [3 * s, 6 * s - 1]] = [-5.0, 9.0, 2.0]  # blocks 3 and 5
        for b in range(1, 8):  # a random point on each boundary
            xyz[:, b * s] = xyz[:, b * s - 1]
    else:
        xyz[:] = 0.0
        xyz[1, 4 * s, 2] = 1.0
    return xyz


@pytest.mark.parametrize("n,npoint,kind", [
    pytest.param(257, 48, "mixed", id="257-48"),
    pytest.param(1500, 200, "mixed", id="1500-200"),
    pytest.param(8 * 128 - 1, 150, "ties", id="1023-150-ties"),
    pytest.param(8 * 128 + 1, 150, "ties", id="1025-150-ties"),
    pytest.param(777, 40, "invalid", id="777-40-invalid"),
])
def test_fps_bit_equal_to_xla_and_pallas(n, npoint, kind):
    xyz = _fps_cloud(n, kind)
    got = furthest_point_sample(_t(xyz), npoint).numpy()
    want = np.asarray(furthest_point_sample_xla(jnp.asarray(xyz), npoint))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(furthest_point_sample_pallas(
        jnp.asarray(xyz), npoint, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == np.int32


def test_fps_all_invalid_cloud_gives_zeros():
    xyz = np.zeros((2, 300, 3), np.float32)
    xyz[1, :, 0] = 1e-3  # |p|^2 = 1e-6: still invalid
    got = furthest_point_sample(_t(xyz), 16).numpy()
    np.testing.assert_array_equal(got, 0)
    np.testing.assert_array_equal(
        got, np.asarray(furthest_point_sample_xla(jnp.asarray(xyz), 16)))


@pytest.mark.parametrize("radius,nsample", [(0.2, 64), (0.4, 32),
                                            (1.2, 16)])
def test_ball_query_bit_equal_to_scan(radius, nsample):
    rng = np.random.RandomState(int(radius * 10))
    xyz = _cloud(rng, 2, 1600)
    cen = xyz[:, rng.randint(0, 1600, 128)].copy()
    cen[:, ::5] += 50.0  # centers with no neighbour: all-zero rows
    got = ball_query(radius, nsample, _t(xyz), _t(cen)).numpy()
    want, _ = _ball_query_scan(radius, nsample, jnp.asarray(xyz),
                               jnp.asarray(cen))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got[:, ::5], 0)


def test_ball_query_bit_equal_to_pallas_interpret():
    rng = np.random.RandomState(23)
    pts = [c + rng.normal(0, 0.15, (40, 3))
           for c in rng.uniform(0, 4, (40, 3))]
    xyz = np.concatenate(pts)[None].repeat(2, 0).astype(np.float32)
    xyz[1] = xyz[1, rng.permutation(xyz.shape[1])]
    cen = xyz[:, rng.randint(0, xyz.shape[1], 128)].copy()
    got = ball_query(0.2, 64, _t(xyz), _t(cen)).numpy()
    want = _ball_query_pruned_pallas(0.2, 64, jnp.asarray(xyz),
                                     jnp.asarray(cen), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_ball_query_radius_rounds_like_reference():
    """A point exactly at f32(r*r) is a miss; the threshold is the f32 of
    the double r*r, not the square of an f32 radius."""
    r = 0.3
    r2 = float(np.float32(r * r))
    xyz = np.zeros((1, 4, 3), np.float32)
    xyz[0, :, 0] = [np.sqrt(np.float32(r2)), 0.1, 5.0, 0.2]
    cen = np.zeros((1, 1, 3), np.float32)
    got = ball_query(r, 4, _t(xyz), _t(cen)).numpy()
    want, _ = _ball_query_scan(r, 4, jnp.asarray(xyz), jnp.asarray(cen))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_three_nn_and_interpolate_match():
    rng = np.random.RandomState(3)
    unknown = _cloud(rng, 2, 200)
    known = _cloud(rng, 2, 50)
    known[:, 7] = known[:, 3]  # equal distances: ties to the lower index
    d, i = three_nn(_t(unknown), _t(known))
    jd, ji = j_three_nn(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5,
                               rtol=1e-4)
    feats = rng.randn(2, 50, 7).astype(np.float32)
    w = rng.rand(2, 200, 3).astype(np.float32)
    got = three_interpolate(_t(feats), i, _t(w)).numpy()
    want = j_three_interpolate(jnp.asarray(feats), ji, jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-4)


def test_gathers_are_exact():
    rng = np.random.RandomState(4)
    pts = rng.randn(2, 64, 5).astype(np.float32)
    xyz = rng.randn(2, 64, 3).astype(np.float32)
    idx2 = rng.randint(0, 64, (2, 9)).astype(np.int32)
    idx3 = rng.randint(0, 64, (2, 9, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        gather_points(_t(pts), _t(idx2)).numpy(),
        np.asarray(j_gather_points(jnp.asarray(pts), jnp.asarray(idx2))))
    np.testing.assert_array_equal(
        group_points(_t(pts), _t(idx3)).numpy(),
        np.asarray(j_group_points(jnp.asarray(pts), jnp.asarray(idx3))))
    gx, gf = group_points_split(_t(xyz), _t(pts).to(torch.bfloat16),
                                _t(idx3))
    jx, jf = j_group_points_split(jnp.asarray(xyz),
                                  jnp.asarray(pts).astype(jnp.bfloat16),
                                  jnp.asarray(idx3))
    assert gf.dtype == torch.bfloat16
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gf.float().numpy(),
                                  np.asarray(jf.astype(jnp.float32)))


# attention: f32 mode agrees to f32 reassociation; the bf16 mode rounds P
# to bf16 after an f32 sum whose order differs, so a P entry may land one
# bf16 step (2^-8 relative) away — bounded below by 4e-3 of |V|'s max
@pytest.mark.parametrize("precise,atol,rtol", [(True, 1e-5, 1e-4),
                                               (False, 4e-3, 4e-3)])
@pytest.mark.parametrize("lq,lk,dh", [(40, 70, 36), (24, 128, 64),
                                      (65, 127, 16), (127, 132, 48),
                                      (65, 65, 1)])
def test_attention_matches_pallas_interpret(precise, atol, rtol, lq, lk,
                                            dh):
    rng = np.random.RandomState(lq + lk + dh)
    B, H = 2, 3
    q = rng.randn(B, H, lq, dh).astype(np.float32)
    k = rng.randn(B, H, lk, dh).astype(np.float32)
    v = rng.randn(B, H, lk, dh).astype(np.float32)
    pad = np.zeros((B, lk), bool)
    pad[0, lk - 9:] = True
    if lk % 128 == 0:
        # a fully masked row; only at a multiple of 128 keys does the TPU
        # wrapper add no zero padding keys, whose zeros would enter the
        # uniform average
        pad[1] = True
    scale = 1.0 / np.sqrt(dh)
    got = attention(_t(q), _t(k), _t(v), _t(pad), sm_scale=scale,
                    precise=precise).numpy()
    want = np.asarray(fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad),
        sm_scale=scale, interpret=True, precise=precise))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_attention_fully_masked_row_is_uniform_over_its_keys():
    rng = np.random.RandomState(5)
    q = rng.randn(1, 2, 5, 8).astype(np.float32)
    k = rng.randn(1, 2, 11, 8).astype(np.float32)
    v = rng.randn(1, 2, 11, 8).astype(np.float32)
    got = attention(_t(q), _t(k), _t(v), torch.ones(1, 11, dtype=bool),
                    precise=True).numpy()
    np.testing.assert_allclose(
        got, np.broadcast_to(v.mean(2, keepdims=True), got.shape),
        atol=1e-6)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU no kernel is built or launched and no counter moves."""
    before = dict(_cuda.LAUNCHES)
    rng = np.random.RandomState(6)
    xyz = _t(_cloud(rng, 1, 100))
    furthest_point_sample(xyz, 8)
    ball_query(0.5, 4, xyz, xyz[:, :8])
    x = torch.randn(1, 2, 4, 8)
    attention(x, x, x)
    assert _cuda.LAUNCHES == before
    assert _cuda._LIBS == {}


def test_attention_dropout_is_not_ported():
    """It is ported now (the name is kept): dropout needs an explicit
    seed, drops about p of the probabilities and is a function of the
    seed; tests/test_torch_train_ops.py holds its arithmetic."""
    x = torch.randn(1, 2, 4, 8)
    with pytest.raises(ValueError, match="seed"):
        attention(x, x, x, dropout_p=0.1)
    with pytest.raises(ValueError, match="dropout_p"):
        attention(x, x, x, dropout_p=1.0, seed=1)
    plain = attention(x, x, x)
    dropped = attention(x, x, x, dropout_p=0.5, seed=1)
    assert dropped.shape == plain.shape and not torch.equal(dropped, plain)
    assert torch.equal(dropped, attention(x, x, x, dropout_p=0.5, seed=1))
    assert not torch.equal(dropped, attention(x, x, x, dropout_p=0.5, seed=2))

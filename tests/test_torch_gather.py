"""The row gathers of the port (plain PyTorch versions, CPU) against the TPU
kernels of the JAX package run in interpret mode, on the same numpy inputs:
`gather_rows_plain` against `gather_rows_pallas`, `group_rows_plain` and
`group_rows_split_plain` against `windowed_group_points` (two payloads under
one shared `_Prep`), and the gradients through the new forwards against
`jax.grad`.

Copies are compared bit for bit, as integer views; gradients to 1e-5 (the
same f32 sums in another order). The payloads are normal numbers: the TPU
kernels copy through a one-hot product, which turns -0.0 into +0.0 and
flushes denormals, so those are held only between the CUDA kernels and
their plain versions (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from butd_detr_tpu.ops.pallas_scatter import gather_rows_pallas
from butd_detr_tpu.ops.pallas_window_gather import (
    _Prep,
    windowed_group_points,
)
from butd_detr_tpu.ops.pointcloud import (
    group_points as j_group_points,
    group_points_split as j_group_points_split,
)
from butd_detr_tpu_torch.ops import (
    _cuda,
    gather_points,
    gather_rows,
    gather_rows_plain,
    group_points,
    group_points_split,
    group_rows,
    group_rows_plain,
    group_rows_split,
    group_rows_split_plain,
)
from butd_detr_tpu_torch.ops.gather import copy_unit
from butd_detr_tpu_torch.ops.pointcloud import _is_large_grouping
from torch_threads import one_torch_thread  # noqa: F401

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _bits(a) -> np.ndarray:
    """A torch tensor's or a JAX array's bits as integers."""
    if isinstance(a, torch.Tensor):
        t = a.contiguous()
        return t.view(torch.int32 if t.element_size() == 4
                      else torch.int16).numpy()
    a = jnp.asarray(a)
    return np.asarray(jax.lax.bitcast_convert_type(
        a, jnp.int32 if a.dtype.itemsize == 4 else jnp.int16))


def _payloads(rng, shape, kind):
    """The same values for both packages, in dtype `kind`."""
    x = (rng.randn(*shape) * 3.7).astype(np.float32)
    t = torch.from_numpy(x).to(TDT[kind])
    j = jnp.asarray(x).astype(JDT[kind])
    assert np.array_equal(_bits(t), _bits(j))  # one rounding in both
    return t, j


def _local_idx(rng, B, N, m, ns, window=256):
    """Ball-query-like indices: each row's neighbours within a local
    window (tests/test_window_gather.py)."""
    base = rng.randint(0, max(1, N - window), size=(B, m))
    off = rng.randint(0, window, size=(B, m, ns))
    return (base[..., None] + off).astype(np.int32)


# -------------------------------------------------- K6: gather_rows_pallas

@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("n,m,c", [
    (128, 512, 128),  # nothing padded
    (777, 300, 5),  # N, M and C all padded on the TPU side
    (50, 1, 1),
    (1024, 256, 288),  # the kps feature gather
    (300, 3 * 70, 256),  # an FP interpolation: 3 rows an output point
])
def test_gather_rows_plain_is_the_pallas_gather_bit_for_bit(kind, n, m, c):
    rng = np.random.RandomState(n + m + c)
    src_t, src_j = _payloads(rng, (2, n, c), kind)
    idx = rng.randint(0, n, (2, m)).astype(np.int32)
    idx[0, : m // 2] = idx[0, 0]  # duplicates
    idx[1, -1] = n - 1
    want = gather_rows_pallas(src_j, jnp.asarray(idx), True)
    got = gather_rows_plain(src_t, torch.from_numpy(idx))
    assert got.dtype == TDT[kind] and got.shape == (2, m, c)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # int64 indices give the same rows
    again = gather_rows_plain(src_t, torch.from_numpy(idx).long())
    assert torch.equal(again, got)


def test_gather_rows_widens_other_dtypes_and_zeroes_rows_out_of_range():
    rng = np.random.RandomState(3)
    src = rng.randn(1, 20, 4).astype(np.float16)
    idx = np.array([[0, 19, 20, -1, 7]], np.int32)
    got = gather_rows_plain(torch.from_numpy(src), torch.from_numpy(idx))
    assert got.dtype == torch.float32  # as pallas_scatter.py:211
    want = gather_rows_pallas(jnp.asarray(src), jnp.asarray(idx[:, :2]), True)
    assert want.dtype == jnp.float32
    np.testing.assert_array_equal(got[:, :2].numpy(), np.asarray(want))
    # an all-zero one-hot row on the TPU: a zero row here
    assert float(got[0, 2:4].abs().max()) == 0.0
    np.testing.assert_array_equal(got[0, 4].numpy(),
                                  src[0, 7].astype(np.float32))


def test_wrappers_take_the_plain_version_on_the_cpu_and_launch_nothing():
    rng = np.random.RandomState(4)
    pts = torch.from_numpy(rng.randn(2, 40, 6).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 40, (2, 5, 3)))
    before = dict(_cuda.LAUNCHES)
    assert torch.equal(gather_rows(pts, idx[:, :, 0]),
                       gather_rows_plain(pts, idx[:, :, 0]))
    assert torch.equal(group_rows(pts, idx), group_rows_plain(pts, idx))
    gx, gf = group_rows_split(pts[..., :3], pts[..., 3:].bfloat16(), idx)
    wx, wf = group_rows_split_plain(pts[..., :3], pts[..., 3:].bfloat16(),
                                    idx)
    assert torch.equal(gx, wx) and torch.equal(gf, wf)
    assert gf.dtype == torch.bfloat16 and gx.dtype == torch.float32
    assert _cuda.LAUNCHES == before
    assert {"gather", "group_gather"} <= set(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="integer"):
        gather_rows(pts, idx[:, :, 0].float())
    with pytest.raises(ValueError, match="do not form"):
        group_rows(pts, idx[:, :, 0])


@pytest.mark.parametrize("row_bytes,addresses,unit", [
    (12, (0, 256), 4),  # xyz in f32
    (6, (0, 256), 2),  # three bf16 colours
    (256, (512, 1024), 16),  # 128 bf16 channels
    (1152, (512, 1024), 16),  # 288 f32 channels
    (16, (4, 1024), 4),  # a view 4 bytes off a 16-byte boundary
    (16, (0, 1026), 2),
    (10, (0, 0), 2),
])
def test_copy_unit_divides_the_row_and_every_address(row_bytes, addresses,
                                                     unit):
    assert copy_unit(row_bytes, *addresses) == unit


def test_routing_rule_is_the_jax_packages():
    """`group_points` hands the grouped gather kernel what the JAX package
    hands its windowed gather (ops/pointcloud.py:804-811)."""
    assert _is_large_grouping(50000, 2048, 64)
    assert _is_large_grouping(16384, 512, 32)
    for shape in ((16383, 512, 32), (16384, 511, 32), (16384, 512, 31),
                  (2048, 1024, 32)):
        assert not _is_large_grouping(*shape)


# ---------------------------------------- K7: windowed_group_points, _Prep

WINDOW_CASES = {
    # name: (seed, B, N, C, m, ns, index maker)
    "local": (0, 2, 1000, 6, 128, 64,
              lambda r, B, N, m, ns: _local_idx(r, B, N, m, ns)),
    "adversarial_fallback": (
        1, 2, 4096, 6, 64, 64,
        lambda r, B, N, m, ns: r.randint(0, N, (B, m, ns)).astype(np.int32)),
    "pad_paths": (2, 1, 777, 5, 40, 16,
                  lambda r, B, N, m, ns: _local_idx(r, B, N, m, ns, 100)),
    "mid_tier": (5, 1, 8192, 6, 64, 64,
                 lambda r, B, N, m, ns: _local_idx(r, B, N, m, ns, 3300)),
}


def _duplicate_and_zero_rows(rng, B, N, m, ns):
    idx = np.zeros((B, m, ns), np.int32)
    idx[:, ::2] = rng.randint(0, N, size=(B, m // 2, 1))
    return idx


WINDOW_CASES["duplicates_and_zero_rows"] = (3, 1, 512, 6, 64, 32,
                                            _duplicate_and_zero_rows)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_group_rows_plain_is_the_windowed_gather_bit_for_bit(case, kind):
    seed, B, N, C, m, ns, make = WINDOW_CASES[case]
    rng = np.random.RandomState(seed)
    pts_t, pts_j = _payloads(rng, (B, N, C), kind)
    idx = make(rng, B, N, m, ns)
    want = windowed_group_points(pts_j, jnp.asarray(idx), interpret=True)
    got = group_rows_plain(pts_t, torch.from_numpy(idx))
    assert got.dtype == TDT[kind] and got.shape == (B, m, ns, C)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_group_rows_split_plain_is_two_windowed_gathers_under_one_prep(case):
    """xyz in f32 and the features in bf16 with ONE index preparation, as
    `_group_points_split_vjp` runs the windowed kernel."""
    seed, B, N, C, m, ns, make = WINDOW_CASES[case]
    rng = np.random.RandomState(seed + 100)
    xyz_t, xyz_j = _payloads(rng, (B, N, 3), "f32")
    f_t, f_j = _payloads(rng, (B, N, C), "bf16")
    idx = make(rng, B, N, m, ns)
    jidx = jnp.asarray(idx)
    prep = _Prep(jidx, m, ns)
    want_x = windowed_group_points(xyz_j, jidx, prep=prep, interpret=True)
    want_f = windowed_group_points(f_j, jidx, prep=prep, interpret=True)
    got_x, got_f = group_rows_split_plain(xyz_t, f_t, torch.from_numpy(idx))
    assert got_x.dtype == torch.float32 and got_f.dtype == torch.bfloat16
    assert got_x.shape == (B, m, ns, 3) and got_f.shape == (B, m, ns, C)
    np.testing.assert_array_equal(_bits(got_x), _bits(want_x))
    np.testing.assert_array_equal(_bits(got_f), _bits(want_f))


# ------------------------------------------------ gradients through them

def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_() if grad else t


def test_large_grouping_forward_and_gradient_match_jax():
    """A grouping of the first tier's size (the grouped gather's route):
    forward bit-equal to the JAX op, gradient to 1e-5."""
    rng = np.random.RandomState(21)
    B, N, C, m, ns = 1, 16384, 4, 512, 32
    assert _is_large_grouping(N, m, ns)
    pts = rng.randn(B, N, C).astype(np.float32)
    idx = _local_idx(rng, B, N, m, ns)
    ct = rng.randn(B, m, ns, C).astype(np.float32)
    want, pull = jax.vjp(lambda p: j_group_points(p, jnp.asarray(idx)),
                         jnp.asarray(pts))
    (want_grad,) = pull(jnp.asarray(ct))
    p = _t(pts, grad=True)
    out = group_points(p, _t(idx))
    out.backward(_t(ct))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad),
                               atol=1e-5)


def test_split_forward_and_both_gradients_match_jax():
    """Both legs need a gradient here (sa2-sa4: xyz comes from no
    parameter in the model, but the Function must serve either)."""
    rng = np.random.RandomState(22)
    B, N, C, m, ns = 2, 96, 7, 12, 5
    xyz = rng.randn(B, N, 3).astype(np.float32)
    feats = rng.randn(B, N, C).astype(np.float32)
    idx = rng.randint(0, N, (B, m, ns)).astype(np.int32)
    ctx = rng.randn(B, m, ns, 3).astype(np.float32)
    ctf = rng.randn(B, m, ns, C).astype(np.float32)
    (wx, wf), pull = jax.vjp(
        lambda x, f: j_group_points_split(x, f, jnp.asarray(idx)),
        jnp.asarray(xyz), jnp.asarray(feats))
    gx_want, gf_want = pull((jnp.asarray(ctx), jnp.asarray(ctf)))
    x, f = _t(xyz, grad=True), _t(feats, grad=True)
    gx, gf = group_points_split(x, f, _t(idx))
    np.testing.assert_array_equal(gx.detach().numpy(), np.asarray(wx))
    np.testing.assert_array_equal(gf.detach().numpy(), np.asarray(wf))
    torch.autograd.backward([gx, gf], [_t(ctx), _t(ctf)])
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx_want), atol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gf_want), atol=1e-5)


def test_gather_points_keeps_the_sources_dtype_and_int64_indices_work():
    rng = np.random.RandomState(23)
    pts = _t(rng.randn(2, 30, 4).astype(np.float32))
    idx64 = _t(rng.randint(0, 30, (2, 9)))
    assert idx64.dtype == torch.int64
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        src = pts.to(dtype)
        got = gather_points(src, idx64)
        assert got.dtype == dtype
        want = torch.stack([src[b, idx64[b]] for b in range(2)])
        assert torch.equal(got, want)

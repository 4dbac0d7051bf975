"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU (sm_90a) and nvcc; without one
it skips. On the card, with no JAX installed:

    python -m pytest -m cuda --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

Integers bit-equal; attention, its backward and the scatter-add within the
bounds of chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from butd_detr_tpu_torch.ops import (
    _cuda,
    attention,
    attention_backward,
    attention_backward_plain,
    attention_plain,
    ball_query,
    ball_query_plain,
    dropout_keep_mask,
    dropout_keep_mask_plain,
    furthest_point_sample,
    furthest_point_sample_plain,
    gather_points,
    group_points_split,
    scatter_rows_add,
    scatter_rows_add_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(seed, b, n):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.rand(b, n, 3) * 4).astype(np.float32))


@pytest.mark.parametrize("n,npoint", [(100, 100), (1500, 200),
                                      (60000, 64)])
def test_fps_kernel_bit_equal(gpu, n, npoint):
    xyz = _cloud(n, 2, n)
    xyz[0, 3:20] = 0.0
    xyz[1, 9] = xyz[1, 4]
    want = furthest_point_sample_plain(xyz, npoint)
    before = _cuda.LAUNCHES["fps"]
    got = furthest_point_sample(xyz.to(gpu), npoint)
    assert _cuda.LAUNCHES["fps"] == before + 1
    assert torch.equal(got.cpu(), want)
    zeros = torch.zeros(1, n, 3, device=gpu)
    assert int(furthest_point_sample(zeros, npoint).abs().max()) == 0


@pytest.mark.parametrize("radius,nsample", [(0.2, 64), (0.8, 16),
                                            (5.0, 40)])
def test_ball_query_kernel_bit_equal(gpu, radius, nsample):
    xyz = _cloud(1, 2, 3000)
    cen = xyz[:, ::11].clone()
    cen[:, ::4] += 100.0
    want = ball_query_plain(radius, nsample, xyz, cen)
    got = ball_query(radius, nsample, xyz.to(gpu), cen.to(gpu))
    assert torch.equal(got.cpu(), want)
    assert int(got[:, ::4].abs().max()) == 0


@pytest.mark.parametrize("precise,atol", [(True, 2e-5), (False, 4e-3)])
@pytest.mark.parametrize("lq,lk,dh", [(33, 70, 36), (128, 128, 64),
                                      (5, 200, 8)])
def test_attention_kernel_matches_plain(gpu, precise, atol, lq, lk, dh):
    g = torch.Generator(device=gpu).manual_seed(lq + lk + dh)
    B, H = 2, 3
    # a (B, L, H, Dh) projection viewed as (B, H, L, Dh): strided input
    q = torch.randn(B, lq, H, dh, device=gpu, generator=g).transpose(1, 2)
    k = torch.randn(B, lk, H, dh, device=gpu, generator=g).transpose(1, 2)
    v = torch.randn(B, H, lk, dh, device=gpu, generator=g)
    pad = torch.zeros(B, lk, dtype=torch.bool, device=gpu)
    pad[0, lk // 2:] = True
    pad[1] = True  # fully masked
    got = attention(q, k, v, pad, sm_scale=dh ** -0.5, precise=precise)
    want = attention_plain(q, k, v, pad, sm_scale=dh ** -0.5,
                           precise=precise)
    torch.testing.assert_close(got, want, atol=atol, rtol=atol)


def _qkv(gpu, seed, B, H, lq, lk, dh):
    """Strided (B, L, H, Dh) projections viewed as (B, H, L, Dh), a
    cotangent, and a padding mask with one fully masked batch row."""
    g = torch.Generator(device=gpu).manual_seed(seed)
    q, k, v, do = (torch.randn(B, L, H, dh, device=gpu, generator=g)
                   .transpose(1, 2) for L in (lq, lk, lk, lq))
    pad = torch.zeros(B, lk, dtype=torch.bool, device=gpu)
    pad[0, lk // 2:] = True
    pad[-1] = True
    return q, k, v, do, pad


@pytest.mark.parametrize("lq,lk", [(33, 70), (7, 13), (128, 128)])
def test_dropout_mask_kernel_is_the_plain_philox_mask(gpu, lq, lk):
    seed, p = 0xABCDEF0123456789, 0.1
    got = dropout_keep_mask(seed, 2, 3, lq, lk, p, device=gpu)
    assert got.dtype == torch.bool and got.shape == (2, 3, lq, lk)
    assert torch.equal(got.cpu(), dropout_keep_mask_plain(seed, 2, 3, lq, lk,
                                                          p))


@pytest.mark.parametrize("precise,atol", [(True, 2e-5), (False, 4e-3)])
@pytest.mark.parametrize("lq,lk,dh", [(33, 70, 36), (128, 128, 64),
                                      (5, 200, 8)])
def test_attention_kernel_with_dropout_matches_plain_fed_its_own_mask(
        gpu, precise, atol, lq, lk, dh):
    B, H, p, seed = 2, 3, 0.1, 991 + lq
    q, k, v, _, pad = _qkv(gpu, lq + lk, B, H, lq, lk, dh)
    keep = dropout_keep_mask(seed, B, H, lq, lk, p, device=gpu)
    got = attention(q, k, v, pad, sm_scale=dh ** -0.5, dropout_p=p,
                    seed=seed, precise=precise)
    want = attention_plain(q, k, v, pad, sm_scale=dh ** -0.5,
                           precise=precise, keep_mask=keep, dropout_p=p)
    torch.testing.assert_close(got, want, atol=atol, rtol=atol)
    other = attention(q, k, v, pad, sm_scale=dh ** -0.5, dropout_p=p,
                      seed=seed + 1, precise=precise)
    assert not torch.equal(got, other)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("lq,lk,dh", [(33, 70, 36), (128, 132, 64),
                                      (5, 200, 8), (50, 3, 36)])
def test_attention_backward_kernel_matches_plain(gpu, p, precise, lq, lk,
                                                 dh):
    """Precise: 2e-5 + 1e-4 |plain|. Default mode: dS and D o P are rounded
    to bf16 after f32 sums of another order, so an entry may land one bf16
    step away: 4e-3 + 4e-3 max|plain|. Two runs are bit-equal."""
    B, H, seed = 2, 3, 77 + lk
    q, k, v, do, pad = _qkv(gpu, lq * lk, B, H, lq, lk, dh)
    keep = dropout_keep_mask(seed, B, H, lq, lk, p, device=gpu) if p else None
    kw = dict(sm_scale=dh ** -0.5, dropout_p=p, precise=precise)
    before = _cuda.LAUNCHES["attention_bwd"]
    got = attention_backward(q, k, v, do, pad, seed=seed, **kw)
    assert _cuda.LAUNCHES["attention_bwd"] == before + 1
    again = attention_backward(q, k, v, do, pad, seed=seed, **kw)
    want = attention_backward_plain(q, k, v, do, pad, keep_mask=keep, **kw)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        if precise:
            torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-4)
        else:
            assert float((g - w).abs().max()) <= 4e-3 + 4e-3 * float(
                w.abs().max())


def test_attention_autograd_runs_both_kernels(gpu):
    """backward() through `attention` launches the backward kernel once and
    returns what `attention_backward` returns, in the leaves' layout."""
    q, k, v, do, pad = _qkv(gpu, 5, 2, 4, 40, 70, 36)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = dict(_cuda.LAUNCHES)
    out = attention(*leaves, pad, sm_scale=1 / 6, dropout_p=0.1, seed=9)
    out.backward(do)
    assert _cuda.LAUNCHES["attention"] == before["attention"] + 1
    assert _cuda.LAUNCHES["attention_bwd"] == before["attention_bwd"] + 1
    want = attention_backward(q, k, v, do, pad, sm_scale=1 / 6,
                              dropout_p=0.1, seed=9)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c,n", [(300, 9, 130), (1000, 128, 64),
                                   (17, 4, 5000), (64, 6, 1)])
def test_scatter_kernel_matches_plain(gpu, dtype, m, c, n):
    """|err| <= 1e-5 * sum |g| per output: the atomic additions' order is
    not fixed. Entries with idx >= n are dropped."""
    g = torch.Generator(device=gpu).manual_seed(m + c)
    rows = torch.randn(3, m, c, device=gpu, generator=g).to(dtype)
    idx = torch.randint(0, n + 1, (3, m), device=gpu, generator=g,
                        dtype=torch.int32)
    idx[0, : m // 2] = n - 1  # many rows on one index
    before = _cuda.LAUNCHES["scatter"]
    got = scatter_rows_add(rows, idx, n)
    assert _cuda.LAUNCHES["scatter"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (3, n, c)
    want = scatter_rows_add_plain(rows.cpu(), idx.cpu(), n)
    lim = 1e-5 * scatter_rows_add_plain(rows.cpu().abs(), idx.cpu(), n) \
        + 1e-30
    assert bool(((got.cpu() - want).abs() <= lim).all())


def test_gather_gradients_run_the_scatter_kernel(gpu):
    xyz = torch.randn(2, 50, 3, device=gpu)  # needs no gradient: no launch
    feats = torch.randn(2, 50, 8, device=gpu).to(torch.bfloat16) \
        .requires_grad_()
    idx = torch.randint(0, 50, (2, 9, 4), device=gpu, dtype=torch.int32)
    before = _cuda.LAUNCHES["scatter"]
    gx, gf = group_points_split(xyz, feats, idx)
    ct = torch.randn_like(gf)
    (gx.sum() + (gf * ct).sum()).backward()
    assert _cuda.LAUNCHES["scatter"] == before + 1
    assert feats.grad.dtype == torch.bfloat16
    want = scatter_rows_add_plain(ct.reshape(2, 36, 8).cpu(),
                                  idx.reshape(2, 36).cpu(), 50)
    torch.testing.assert_close(feats.grad.float().cpu(), want, atol=1e-5,
                               rtol=2 ** -7)
    pts = torch.randn(2, 50, 5, device=gpu, requires_grad=True)
    gather_points(pts, idx[:, :, 0]).sum().backward()
    assert _cuda.LAUNCHES["scatter"] == before + 2


def test_attention_rejects_what_the_kernel_does_not_take(gpu):
    x = torch.randn(1, 2, 4, 80, device=gpu)
    with pytest.raises(ValueError):
        attention(x, x, x)
    y = torch.randn(1, 2, 4, 8, device=gpu)
    with pytest.raises(ValueError, match="seed"):
        attention(y, y, y, dropout_p=0.1)

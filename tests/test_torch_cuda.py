"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU (sm_90a) and nvcc; without one
it skips. On the card, with no JAX installed:

    python -m pytest -m cuda --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

Integers bit-equal; attention within the bounds of chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from butd_detr_tpu_torch.ops import (
    _cuda,
    attention,
    attention_plain,
    ball_query,
    ball_query_plain,
    furthest_point_sample,
    furthest_point_sample_plain,
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


def test_attention_rejects_what_the_kernel_does_not_take(gpu):
    x = torch.randn(1, 2, 4, 80, device=gpu)
    with pytest.raises(ValueError):
        attention(x, x, x)
    y = torch.randn(1, 2, 4, 8, device=gpu)
    with pytest.raises(NotImplementedError):
        attention(y, y, y, dropout_p=0.1)

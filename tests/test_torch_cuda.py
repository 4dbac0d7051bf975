"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU (sm_90a) and nvcc; without one
it skips. On the card, with no JAX installed:

    python -m pytest -m cuda --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

Integers and the row gathers bit-equal (FPS also with argmax ties across
the blocks of its cluster); attention and its backward (both modes:
tensor cores for bf16 operands, CUDA cores for precise) and the
scatter-add within the bounds of chip_smoke.py; the launch path's rules
(the index in its own type, no cast kernel, the caller's current stream)
through torch.profiler. The ball query's hashed-grid kernel (sa1) on clouds
made to break a grid; the scatter-add bit-equal to its plain version on
the CPU and from run to run.
"""

import os
import sys

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
    ball_query_stats,
    dropout_keep_mask,
    dropout_keep_mask_plain,
    furthest_point_sample,
    furthest_point_sample_plain,
    gather_points,
    gather_rows,
    gather_rows_plain,
    group_points,
    group_points_split,
    group_rows,
    group_rows_plain,
    group_rows_split,
    group_rows_split_plain,
    scatter_rows_add,
    scatter_rows_add_plain,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import GRID_CLOUDS, grid_breaking_cloud  # noqa: E402

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


def _fps_cloud(n, kind, b=2):
    """b clouds of n points, as tests/test_torch_ops.py:_fps_cloud builds
    them. "ties": duplicate far points on both sides of every boundary of
    the cluster's slices (8 blocks of ceil(n / 8) points), picked in the
    first steps, so argmax ties fall between two blocks; "invalid": no
    valid point in the first cloud, one in the second."""
    rng = np.random.RandomState(n)
    xyz = (rng.rand(b, n, 3) * 4).astype(np.float32)
    s = -(-n // 8)
    if kind == "ties":
        for blk in range(1, 8):
            corner = [9.0 if blk >> i & 1 else -5.0 for i in range(3)]
            xyz[:, [blk * s - 1, blk * s]] = corner
        xyz[1, [2 * s + 5, 5 * s + 7]] = -5.0  # blocks 2 and 5
    else:
        xyz[:] = 0.0
        xyz[1, 4 * s, 2] = 1.0
    return torch.from_numpy(xyz)


@pytest.mark.parametrize("n", [8191, 8192, 8193, 15999, 16001, 49999,
                               50001, 65535, 65536, 65537])
def test_fps_kernel_ties_across_blocks_bit_equal(gpu, n):
    """Around the switch from one block to a cluster (8192), around the
    cluster's slices (8 k - 1, 8 k + 1) and around the switch to the
    scratch-row kernel (65536): ties between two blocks resolve to the
    lower index, as torch.argmax does in the plain version."""
    xyz = _fps_cloud(n, "ties").to(gpu)
    want = furthest_point_sample_plain(xyz, 256)
    before = _cuda.LAUNCHES["fps"]
    got = furthest_point_sample(xyz, 256)
    assert _cuda.LAUNCHES["fps"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [2000, 50000])
def test_fps_kernel_invalid_clouds(gpu, n):
    """No valid point: every score ties at -1 and index 0 is returned; one
    valid point: it, and then itself again."""
    xyz = _fps_cloud(n, "invalid").to(gpu)
    got = furthest_point_sample(xyz, 64)
    assert torch.equal(got, furthest_point_sample_plain(xyz, 64))
    assert int(got[0].abs().max()) == 0
    assert int(got[1, 1]) == 4 * (-(-n // 8))


def test_fps_kernel_batch_of_full_clouds(gpu):
    """Eight clouds of 50000 points, 2048 samples each (sa1 of a training
    step): one cluster a cloud, all resident at once, bit-equal."""
    xyz = _cloud(8, 8, 50000).to(gpu)
    lib = _cuda.lib("fps")
    assert lib.fps_cluster_size(50000) == 8
    assert lib.fps_max_active_clusters(gpu.index or 0, 50000) >= 8
    got = furthest_point_sample(xyz, 2048)
    assert torch.equal(got, furthest_point_sample_plain(xyz, 2048))


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


@pytest.mark.parametrize("kind", GRID_CLOUDS)
def test_ball_query_grid_kernel_bit_equal(gpu, kind):
    """The hashed-grid kernel (sa1's shape: 50000 points, r = 0.2, 64
    samples) on chip_smoke.py's clouds made to break a grid: bit-equal to
    the plain version; the dense clouds send centers through the
    per-center guard."""
    xyz, cen = grid_breaking_cloud(kind)
    want = ball_query_plain(0.2, 64, xyz, cen)
    before = _cuda.LAUNCHES["ball_query"]
    got, stats, path = ball_query_stats(0.2, 64, xyz.to(gpu), cen.to(gpu))
    assert _cuda.LAUNCHES["ball_query"] == before + 1
    assert path == "grid"
    assert torch.equal(got.cpu(), want)
    assert torch.equal(ball_query(0.2, 64, xyz.to(gpu), cen.to(gpu)), got)
    guards = int(stats[..., 1].sum())
    if kind in ("dense", "identical"):
        assert guards > 0
    if kind == "uniform":
        assert guards == 0
        # a center tests its 27 cells, not the cloud
        assert int(stats[..., 0].max()) < xyz.shape[1] // 20


@pytest.mark.parametrize("n,m,path", [(16383, 64, "scan"),
                                      (16384, 63, "scan"),
                                      (16384, 64, "grid")])
def test_ball_query_paths_split_by_shape_and_agree(gpu, n, m, path):
    """The JAX package's split (N >= 16384 and m >= 64 take the pruned
    kernel): both kernels give the plain version's bits."""
    xyz = _cloud(n, 1, n)
    cen = xyz[:, :m].clone()
    got, _, took = ball_query_stats(0.4, 32, xyz.to(gpu), cen.to(gpu))
    assert took == path
    assert torch.equal(got.cpu(), ball_query_plain(0.4, 32, xyz, cen))


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


def _check_backward(gpu, B, H, lq, lk, dh, p, precise, seed):
    """K4 at one shape against its plain version, with one fully masked
    batch row; two runs bit-equal. Bounds as in
    test_attention_backward_kernel_matches_plain."""
    q, k, v, do, pad = _qkv(gpu, seed, B, H, lq, lk, dh)
    keep = dropout_keep_mask(seed, B, H, lq, lk, p, device=gpu) if p else None
    kw = dict(sm_scale=dh ** -0.5, dropout_p=p, precise=precise)
    got = attention_backward(q, k, v, do, pad, seed=seed, **kw)
    again = attention_backward(q, k, v, do, pad, seed=seed, **kw)
    want = attention_backward_plain(q, k, v, do, pad, keep_mask=keep, **kw)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert bool(torch.isfinite(g).all())
        if precise:
            torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-4)
        else:
            assert float((g - w).abs().max()) <= 4e-3 + 4e-3 * float(
                w.abs().max())
    return got


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("lq,lk", [(1024, 1024), (256, 1024)])
def test_attention_backward_kernel_at_training_lengths(gpu, p, precise, lq,
                                                       lk):
    """The largest training shapes (visual self, decoder to visual) at
    B = 2, H 8, Dh 36, with a fully masked batch row."""
    _check_backward(gpu, 2, 8, lq, lk, 36, p, precise, lq + lk)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("lq,lk,dh", [(77, 45, 1), (65, 129, 17),
                                      (17, 63, 17), (130, 100, 33)])
def test_attention_backward_kernel_ragged_lengths_and_head_dims(
        gpu, p, precise, lq, lk, dh):
    """Lengths that are multiples of neither 16 nor 64 (the last query and
    key tiles are masked) and head dims that are not multiples of 4 or 16
    (4-byte loads, zero-padded to the mma depth)."""
    _check_backward(gpu, 2, 3, lq, lk, dh, p, precise, lq * lk + dh)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("lq,lk", [(65, 127), (127, 132), (132, 65)])
@pytest.mark.parametrize("dh", [1, 16, 36, 48, 64])
def test_attention_mma_kernel_ragged_shapes(gpu, dh, lq, lk, p):
    """K3's default mode (tensor cores): lengths that are not multiples of
    64 (the last query and key tiles are masked), head dims padded to
    16/32/48/64, a fully masked batch row; at p = 0.1 against the plain
    version fed the kernel's own mask. Within 4e-3 (one bf16 step of P);
    two runs bit-equal."""
    B, H, seed = 2, 3, 11 + lq + dh
    q, k, v, _, pad = _qkv(gpu, lq * lk + dh, B, H, lq, lk, dh)
    keep = dropout_keep_mask(seed, B, H, lq, lk, p, device=gpu) if p else None
    before = _cuda.LAUNCHES["attention"]
    got = attention(q, k, v, pad, sm_scale=dh ** -0.5, dropout_p=p,
                    seed=seed)
    assert _cuda.LAUNCHES["attention"] == before + 1
    again = attention(q, k, v, pad, sm_scale=dh ** -0.5, dropout_p=p,
                      seed=seed)
    assert torch.equal(got, again)
    want = attention_plain(q, k, v, pad, sm_scale=dh ** -0.5,
                           keep_mask=keep, dropout_p=p)
    torch.testing.assert_close(got, want, atol=4e-3, rtol=4e-3)


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_attention_mma_kernel_unaligned_rows(gpu, p):
    """Rows that do not start on a 16-byte boundary take the 4-byte copies
    of the staging; the result is the aligned input's."""
    B, H, lq, lk, dh, seed = 2, 3, 70, 90, 36, 3
    q, k, v, _, pad = _qkv(gpu, 21, B, H, lq, lk, dh)
    flat = torch.empty(B * lq * H * dh + 1, device=gpu)
    shifted = flat[1:].view(B, lq, H, dh).transpose(1, 2)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16 == 4
    kw = dict(sm_scale=dh ** -0.5, dropout_p=p, seed=seed)
    assert torch.equal(attention(shifted, k, v, pad, **kw),
                       attention(q, k, v, pad, **kw))


def _cuda_kernels(fn):
    """(name, stream) of every CUDA kernel that `fn()` launches, by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.device_resource_id) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gathers_launch_one_kernel_and_no_cast(gpu, idx_dtype):
    """K6 and K7 read an int32 or int64 index as it is: one kernel a call,
    no cast kernel before it, bit-equal to the plain version."""
    src = _rows(5, 2, 700, 6, torch.float32).to(gpu)
    idx = torch.randint(0, 700, (2, 40, 8), device=gpu).to(idx_dtype)
    idx[0, 0, 0] = 0
    flat = idx.reshape(2, 320)
    got = {}
    kernels = _cuda_kernels(lambda: got.update(g=gather_rows(src, flat)))
    assert len(kernels) == 1 and "gather_rows_kernel" in kernels[0][0], \
        kernels
    assert torch.equal(_bits(got["g"]), _bits(gather_rows_plain(src, flat)))
    xyz = src[..., :3].contiguous()
    feats = src[..., 3:].to(torch.bfloat16)
    kernels = _cuda_kernels(lambda: got.update(
        s=group_rows_split(xyz, feats, idx)))
    assert len(kernels) == 1 and "group_gather_kernel" in kernels[0][0], \
        kernels
    wx, wf = group_rows_split_plain(src[..., :3], feats, idx)
    assert torch.equal(_bits(got["s"][0]), _bits(wx))
    assert torch.equal(_bits(got["s"][1]), _bits(wf))


def test_kernels_launch_on_the_current_stream(gpu):
    """A launch inside `torch.cuda.stream(s)` runs on `s`: K4 and K6 land
    on the stream of a PyTorch operator issued beside them, not on the
    default stream's."""
    q, k, v, do, pad = _qkv(gpu, 3, 2, 2, 40, 70, 36)
    src = torch.randn(2, 300, 8, device=gpu)
    idx = torch.randint(0, 300, (2, 50), device=gpu)
    x = torch.randn(1000, device=gpu)
    s = torch.cuda.Stream()

    def on_side_stream():
        with torch.cuda.stream(s):
            torch.neg(x)
            gather_rows(src, idx)
            attention_backward(q, k, v, do, pad, sm_scale=1 / 6)
    kernels = _cuda_kernels(on_side_stream)
    side = {st for name, st in kernels if "neg" in name.lower()}
    ours = {st for name, st in kernels if "gather_rows" in name
            or "attention_bwd" in name}
    assert len(side) == 1 and ours == side, kernels
    default = {st for name, st in _cuda_kernels(lambda: torch.neg(x))}
    assert default and not default & side


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
    """|err| <= 1e-5 * sum |g| per output, and in fact bit-equal to the
    plain version on the CPU: both add each output row's rows in ascending
    m. Entries with idx >= n or < 0 are dropped; int32 and int64 indices
    give the same bits."""
    g = torch.Generator(device=gpu).manual_seed(m + c)
    rows = torch.randn(3, m, c, device=gpu, generator=g).to(dtype)
    idx = torch.randint(-1, n + 1, (3, m), device=gpu, generator=g,
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
    assert torch.equal(got.cpu(), want)
    assert torch.equal(scatter_rows_add(rows, idx.long(), n), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c,n,one", [(32768, 128, 2048, False),
                                       (4096, 256, 512, True),
                                       (1536, 256, 256, False),
                                       (256, 288, 1024, False)])
def test_scatter_kernel_is_reproducible(gpu, dtype, m, c, n, one):
    """Five runs give the same bits, also with all rows on one index (a
    segment longer than the shared-memory sort: the index-order walk);
    no torch.zeros or cast kernel runs around the call."""
    g = torch.Generator(device=gpu).manual_seed(m + n)
    rows = torch.randn(8, m, c, device=gpu, generator=g).to(dtype)
    idx = torch.randint(0, n, (8, m), device=gpu, generator=g)
    if one:
        idx[:] = n // 2
    first = scatter_rows_add(rows, idx, n)
    for _ in range(4):
        assert torch.equal(scatter_rows_add(rows, idx, n), first)
    assert torch.equal(first.cpu(),
                       scatter_rows_add_plain(rows.cpu(), idx.cpu(), n))
    kernels = _cuda_kernels(lambda: scatter_rows_add(rows, idx, n))
    assert len(kernels) == 2 and all(
        "scatter_rows_add_" in name for name, _ in kernels), kernels


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


def _bits(t):
    """The tensor's bits as integers: equality then includes -0.0, NaN
    payloads and denormals."""
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int16)


def _rows(seed, b, n, c, dtype):
    """Rows with the values a bit-exact copy must keep: -0.0, a NaN with a
    payload, a denormal, an infinity."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, n, c).astype(np.float32))
    flat = x.view(-1)
    specials = torch.tensor([-0.0, float("inf"), 1e-42], dtype=torch.float32)
    flat[: len(specials)] = specials[: flat.numel()]
    if flat.numel() > 3:
        flat[3:4].view(torch.int32)[0] = 0x7FC12345  # NaN with a payload
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,c", [(50, 1, 1), (777, 333, 3), (64, 1000, 5),
                                   (5000, 257, 6), (1024, 255, 288),
                                   (300, 70, 256), (40, 9, 8)])
def test_gather_kernel_bit_equal(gpu, dtype, n, m, c):
    src = _rows(n + c, 3, n, c, dtype)
    rng = np.random.RandomState(m)
    idx = torch.from_numpy(rng.randint(0, n, (3, m)))  # int64
    idx[0, 0] = 0  # the row of special values
    want = gather_rows_plain(src, idx)
    before = _cuda.LAUNCHES["gather"]
    got = gather_rows(src.to(gpu), idx.to(gpu))
    assert _cuda.LAUNCHES["gather"] == before + 1
    assert got.dtype == dtype and got.shape == (3, m, c)
    assert torch.equal(_bits(got.cpu()), _bits(want))
    got32 = gather_rows(src.to(gpu), idx.to(gpu, torch.int32))
    assert torch.equal(_bits(got32), _bits(got))


def test_gather_kernel_non_contiguous_and_misaligned_sources(gpu):
    cloud = _rows(1, 2, 400, 6, torch.float32).to(gpu)
    idx = torch.randint(0, 400, (2, 77), device=gpu)
    xyz = cloud[..., :3]  # a strided view, as the backbone hands it over
    assert not xyz.is_contiguous()
    assert torch.equal(_bits(gather_rows(xyz, idx)),
                       _bits(gather_rows_plain(xyz, idx)))
    # rows of 16 bytes whose base is 4 bytes off a 16-byte boundary
    flat = torch.randn(2 * 400 * 4 + 1, device=gpu)
    off = flat[1:].view(2, 400, 4)
    assert off.data_ptr() % 16 == 4 and off.is_contiguous()
    assert torch.equal(_bits(gather_rows(off, idx)),
                       _bits(gather_rows_plain(off, idx)))
    # bf16 rows of an odd channel count: 2-byte units
    odd = _rows(2, 2, 400, 5, torch.bfloat16).to(gpu)
    assert torch.equal(_bits(gather_rows(odd, idx)),
                       _bits(gather_rows_plain(odd, idx)))


def test_gather_kernel_out_of_range_index_gives_a_zero_row(gpu):
    src = torch.ones(2, 30, 7, device=gpu)
    idx = torch.tensor([[0, 30, -1, 29], [2 ** 31 - 1, 5, 31, 1]],
                       device=gpu, dtype=torch.int32)
    got = gather_rows(src, idx)
    want = torch.ones(2, 4, 7)
    want[0, 1:3] = 0
    want[1, 0] = 0
    want[1, 2] = 0
    assert torch.equal(got.cpu(), want)
    assert torch.equal(gather_rows_plain(src.cpu(), idx.cpu()), want)
    pts = torch.ones(2, 30, 3, device=gpu)
    gx, gf = group_rows_split(pts, src.to(torch.bfloat16),
                              idx.reshape(2, 2, 2))
    assert torch.equal(gx.cpu(), want[..., :3].reshape(2, 2, 2, 3))
    assert torch.equal(gf.float().cpu(), want.reshape(2, 2, 2, 7))


def test_gather_kernel_widens_other_dtypes_to_f32(gpu):
    src = torch.randn(1, 20, 4, device=gpu).half()
    idx = torch.randint(0, 20, (1, 6), device=gpu)
    got = gather_rows(src, idx)
    assert got.dtype == torch.float32
    assert torch.equal(got.cpu(), gather_rows_plain(src.cpu(), idx.cpu()))
    assert gather_points(src, idx).dtype == torch.float16


@pytest.mark.parametrize("fdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,m,ns,cf", [(3000, 130, 64, 3), (512, 100, 32, 128),
                                       (256, 33, 16, 256), (100, 7, 5, 1),
                                       (90, 3, 2, 5)])
def test_group_gather_kernel_bit_equal(gpu, fdtype, n, m, ns, cf):
    cloud = _rows(n, 2, n, 3 + cf, torch.float32)
    xyz = cloud[..., :3]  # strided
    feats = cloud[..., 3:].to(fdtype)
    rng = np.random.RandomState(ns)
    idx = torch.from_numpy(rng.randint(0, n, (2, m, ns)))  # int64
    idx[0, 0, 0] = 0
    wx, wf = group_rows_split_plain(xyz, feats, idx)
    before = dict(_cuda.LAUNCHES)
    gx, gf = group_rows_split(xyz.to(gpu), feats.to(gpu), idx.to(gpu))
    assert _cuda.LAUNCHES["group_gather"] == before["group_gather"] + 1
    assert _cuda.LAUNCHES["gather"] == before["gather"]
    assert gx.dtype == torch.float32 and gf.dtype == fdtype
    assert gx.shape == (2, m, ns, 3) and gf.shape == (2, m, ns, cf)
    assert torch.equal(_bits(gx.cpu()), _bits(wx))
    assert torch.equal(_bits(gf.cpu()), _bits(wf))
    one = group_rows(feats.to(gpu), idx.to(gpu, torch.int32))
    assert _cuda.LAUNCHES["group_gather"] == before["group_gather"] + 2
    assert torch.equal(_bits(one.cpu()), _bits(group_rows_plain(feats, idx)))


def test_pointcloud_gathers_launch_their_kernels(gpu):
    """gather_points and a small group_points launch the row gather, a
    grouping of the first tier's size and group_points_split the grouped
    gather; none of them anything else."""
    pts = torch.randn(1, 16384, 6, device=gpu)
    small = torch.randint(0, 16384, (1, 40, 8), device=gpu)
    large = torch.randint(0, 16384, (1, 512, 32), device=gpu)
    before = dict(_cuda.LAUNCHES)
    gather_points(pts, small[:, :, 0])
    group_points(pts, small)
    assert _cuda.LAUNCHES["gather"] == before["gather"] + 2
    assert _cuda.LAUNCHES["group_gather"] == before["group_gather"]
    got = group_points(pts, large)
    group_points_split(pts[..., :3], pts[..., 3:].to(torch.bfloat16), small)
    assert _cuda.LAUNCHES["gather"] == before["gather"] + 2
    assert _cuda.LAUNCHES["group_gather"] == before["group_gather"] + 2
    assert torch.equal(got.cpu(), group_rows_plain(pts.cpu(), large.cpu()))


def test_attention_rejects_what_the_kernel_does_not_take(gpu):
    x = torch.randn(1, 2, 4, 80, device=gpu)
    with pytest.raises(ValueError):
        attention(x, x, x)
    y = torch.randn(1, 2, 4, 8, device=gpu)
    with pytest.raises(ValueError, match="seed"):
        attention(y, y, y, dropout_p=0.1)

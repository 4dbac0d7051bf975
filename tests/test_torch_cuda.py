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
the CPU and from run to run. K3 and K4 with bf16 operands bit-equal to
f32 operands of the same values. The grouped gather's MLP-input kernel
bit-equal to its plain version at the four set-abstraction tiers (B = 1
and 8, int32 and int64 indices, special values, indices out of range) and
at shapes whose tiles are not multiples of 16 bytes. The assignment
kernel bit-equal to its plain version at the loss's shapes and around its
warp's slice (n_valid 0, 1, R staged rows, R + 1, min(G, Q); the rows past
R read from device memory), with NaN costs, all costs tied, more valid rows
than columns and more targets than queries, int32 and int64 counts, one
launch a call and no synchronisation. The row gather's tile kernel at
spans that are no multiple of 16 bytes, sources off a 16-byte boundary,
rows of 131 and 259 f32 and the limits it refuses.
"""

import os
import sys

import numpy as np
import pytest
import torch

from butd_detr_tpu_torch.ops import (
    _cuda,
    batched_linear_sum_assignment,
    batched_linear_sum_assignment_plain,
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
    group_points_mlp_input,
    group_rows,
    group_rows_mlp_input,
    group_rows_mlp_input_plain,
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


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("lq,lk", [(65, 127), (132, 1024)])
@pytest.mark.parametrize("dh", [1, 18, 33, 36, 64])
def test_attention_bf16_operands_equal_f32_operands(gpu, dh, lq, lk, p):
    """K3 and K4 read bf16 q, k, v and dO as they are (the `--use_bf16`
    model's): their outputs and gradients are the bits of the same
    kernels fed f32 operands of the same values, at ragged lengths, head
    dims whose rows take the 8-byte copies (dh % 4 == 0) or the plain
    loads (odd and even dh), a fully masked row, with and without
    dropout; gradients come back f32, and through autograd in bf16."""
    B, H, seed = 2, 3, 5 + dh
    q, k, v, do, pad = (t.to(torch.bfloat16) if t.is_floating_point() else t
                        for t in _qkv(gpu, dh + lq, B, H, lq, lk, dh))
    f32 = [t.float() for t in (q, k, v, do)]
    kw = dict(sm_scale=dh ** -0.5, dropout_p=p, seed=seed)
    got = attention(q, k, v, pad, **kw)
    assert got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(attention(*f32[:3], pad, **kw)))
    grads = attention_backward(q, k, v, do, pad, **kw)
    for g, w in zip(grads, attention_backward(*f32, pad, **kw)):
        assert g.dtype == torch.float32
        assert torch.equal(_bits(g), _bits(w))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    attention(*leaves, pad, **kw).backward(do.float())
    for leaf, w in zip(leaves, grads):
        assert leaf.grad.dtype == torch.bfloat16
        assert torch.equal(leaf.grad, w.to(torch.bfloat16))


def test_attention_bf16_operands_unaligned_rows(gpu):
    """bf16 rows that start 2 bytes off an 8-byte boundary take the plain
    loads; the result is the aligned input's."""
    B, H, lq, lk, dh, seed = 2, 3, 70, 90, 36, 3
    q, k, v, do, pad = _qkv(gpu, 22, B, H, lq, lk, dh)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    flat = torch.empty(B * lq * H * dh + 1, device=gpu,
                       dtype=torch.bfloat16)
    shifted = flat[1:].view(B, lq, H, dh).transpose(1, 2)
    shifted.copy_(q)
    assert shifted.data_ptr() % 8 == 2
    kw = dict(sm_scale=dh ** -0.5, dropout_p=0.1, seed=seed)
    assert torch.equal(attention(shifted, k, v, pad, **kw),
                       attention(q, k, v, pad, **kw))
    for a, b in zip(attention_backward(shifted, k, v, do, pad, **kw),
                    attention_backward(q, k, v, do, pad, **kw)):
        assert torch.equal(a, b)


def _cuda_kernels(fn):
    """(name, stream) of every CUDA kernel that `fn()` launches, by
    torch.profiler. The profiler on the card now and then loses the first
    kernel record of a session (a PyTorch operator's as well as the
    port's), so the session opens with a marker kernel
    (`torch.cuda._sleep`'s spin_kernel), which is left out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.device_resource_id) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.name]


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
    assert len(kernels) == 1 and "gather_tile_kernel" in kernels[0][0], \
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
    ours = {st for name, st in kernels if "gather_tile" in name
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
    each call launches the kernel once (the launch count), and no
    torch.zeros or cast kernel runs around the call (the profiler)."""
    g = torch.Generator(device=gpu).manual_seed(m + n)
    rows = torch.randn(8, m, c, device=gpu, generator=g).to(dtype)
    idx = torch.randint(0, n, (8, m), device=gpu, generator=g)
    if one:
        idx[:] = n // 2
    before = _cuda.LAUNCHES["scatter"]
    first = scatter_rows_add(rows, idx, n)
    for _ in range(4):
        assert torch.equal(scatter_rows_add(rows, idx, n), first)
    assert _cuda.LAUNCHES["scatter"] == before + 5
    assert torch.equal(first.cpu(),
                       scatter_rows_add_plain(rows.cpu(), idx.cpu(), n))
    kernels = _cuda_kernels(lambda: scatter_rows_add(rows, idx, n))
    assert kernels and all(
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


def _offset_rows(gpu, seed, b, n, c, dtype, offset):
    """(b, n, c) rows of `dtype` that start `offset` elements into their
    buffer, with -0.0, an infinity, a denormal and a NaN with a payload in
    row 0 of every scene."""
    rng = np.random.RandomState(seed)
    buf = torch.from_numpy(rng.randn(b * n * c + offset).astype(np.float32))
    src = buf.to(dtype).to(gpu)[offset:].view(b, n, c)
    specials = torch.tensor([-0.0, float("inf"), 1e-42, float("nan")])
    src[:, 0, :min(c, 4)] = specials[:min(c, 4)].to(dtype).to(gpu)
    if c > 4 and dtype == torch.float32:
        src[:, 0, 4:5].view(torch.int32).fill_(0x7FC12345)
    return src


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,c,offset", [
    (8, 2048, 1000, 131, 0),  # sa2's f32 grouping: 524-byte rows
    (3, 1024, 700, 259, 1),  # sa3/sa4's 1,036-byte rows, 4 bytes off 16
    (2, 300, 77, 3, 0),  # 924 bytes a scene: scene 1 starts 12 bytes off 16
    (2, 300, 5, 3, 1),  # 60 bytes a scene
    (1, 40, 1, 1, 0),  # one 4-byte row: no 16 aligned bytes to store
    (2, 513, 1500, 5, 3),  # an odd width: bf16's 2-byte granules
    (4, 256, 2500, 288, 2),  # more than one tile a scene
])
def test_gather_tile_kernel_bit_equal(gpu, dtype, b, n, m, c, offset):
    """The tile kernel at spans that are no multiple of 16 bytes, sources
    4 (f32) or 2 (bf16) bytes off a 16-byte boundary, rows of 131 and 259
    f32, indices out of range (-1, n, n + 5), and the bits of -0.0, NaN
    payloads and denormals: bit-equal to the plain version on the CPU,
    with int32 and int64 indices, one launch a call."""
    src = _offset_rows(gpu, b * 1000 + c, b, n, c, dtype, offset)
    assert src.is_contiguous()
    assert (src.data_ptr() % 16 == 0) == (offset == 0)
    rng = np.random.RandomState(m)
    idx = torch.from_numpy(rng.randint(0, n, (b, m)))
    idx[:, 0] = 0
    idx[0, -1] = -1
    idx[-1, -1] = n
    if m > 2:
        idx[0, 1] = n + 5
    want = gather_rows_plain(src.cpu(), idx)
    for index in (idx, idx.int()):
        before = _cuda.LAUNCHES["gather"]
        got = gather_rows(src, index.to(gpu))
        assert _cuda.LAUNCHES["gather"] == before + 1
        assert got.dtype == dtype and got.shape == (b, m, c)
        assert torch.equal(_bits(got.cpu()), _bits(want))
    assert float(want[0, -1].float().abs().max()) == 0.0


def test_gather_kernel_refuses_what_it_does_not_index(gpu):
    before = _cuda.LAUNCHES["gather"]
    with pytest.raises(ValueError, match="gather_rows: batch 65536"):
        gather_rows(torch.zeros(65536, 1, 1, device=gpu),
                    torch.zeros(65536, 1, dtype=torch.int32, device=gpu))
    with pytest.raises(ValueError, match="row bytes 240000"):
        gather_rows(torch.zeros(1, 2, 60000, device=gpu),
                    torch.zeros(1, 3, dtype=torch.int32, device=gpu))
    assert _cuda.LAUNCHES["gather"] == before  # a refusal launches nothing
    # the widest row a block holds still gathers
    wide = torch.randn(1, 2, 50000, device=gpu)
    idx = torch.tensor([[1, 0, 5]], device=gpu)
    assert torch.equal(gather_rows(wide, idx).cpu(),
                       gather_rows_plain(wide.cpu(), idx.cpu()))


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


# the four set-abstraction tiers: source points, centres, samples, feature
# channels, radius
SA_TIERS = [(50000, 2048, 64, 3, 0.2), (2048, 1024, 32, 128, 0.4),
            (1024, 512, 16, 256, 0.8), (512, 256, 16, 256, 1.2)]


def _mlp_input_case(gpu, seed, b, n, m, ns, c, idx_dtype):
    """A strided f32 cloud and bf16 features with -0.0, an infinity, a
    denormal and a NaN in rows 0 and 1 of every scene, centres with them in
    centre 0 and centre 1 at the origin, both centres grouping rows 0 and
    1, and an index with rows out of range."""
    gen = torch.Generator(device=gpu).manual_seed(seed)
    cloud = torch.rand(b, n, 3 + c, device=gpu, generator=gen) * 4
    specials = torch.tensor([-0.0, float("inf"), 1e-42, float("nan")],
                            device=gpu)
    cloud[:, 0, :3] = specials[[0, 2, 3]]
    cloud[:, 1, :3] = specials[[1, 2, 0]]
    feats = cloud[..., 3:].to(torch.bfloat16)
    feat_specials = torch.tensor([-0.0, float("inf"), 1e-39],
                                 device=gpu).to(torch.bfloat16)
    feats[:, 0, :min(c, 3)] = feat_specials[:min(c, 3)]
    if c >= 4:  # a NaN with a payload, copied as it is
        feats[:, 0, 3:4].view(torch.int16)[...] = 0x7FA5
    centres = torch.rand(b, m, 3, device=gpu, generator=gen) * 4
    centres[:, 0] = specials[[0, 3, 2]]
    centres[:, 1] = 0.0
    idx = torch.randint(0, n, (b, m, ns), device=gpu, generator=gen)
    idx[:, :2, :2] = torch.tensor([0, 1], device=gpu)
    idx[:, 2, 0] = n
    idx[:, 2, 1] = -1
    idx[-1, -1, -1] = 2 ** 31 - 1
    return cloud[..., :3], centres, feats, idx.to(idx_dtype)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("n,m,ns,c,radius", SA_TIERS)
def test_group_mlp_input_kernel_bit_equal_at_the_tiers(gpu, n, m, ns, c,
                                                       radius, b, idx_dtype):
    xyz, centres, feats, idx = _mlp_input_case(gpu, n + b, b, n, m, ns, c,
                                               idx_dtype)
    inv_r = float(np.float32(1) / np.float32(radius))
    before = dict(_cuda.LAUNCHES)
    got = group_rows_mlp_input(xyz, centres, feats, idx, inv_r)
    assert _cuda.LAUNCHES["group_gather"] == before["group_gather"] + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, m, ns, 3 + c)
    want = group_rows_mlp_input_plain(xyz, centres, feats, idx, inv_r)
    assert torch.equal(_bits(got), _bits(want))
    # and the plain version's bits on the CPU
    cpu = group_rows_mlp_input_plain(xyz.cpu(), centres.cpu(), feats.cpu(),
                                     idx.cpu(), inv_r)
    assert torch.equal(_bits(got).cpu(), _bits(cpu))
    assert _bits(got)[0, 0, 0, 1].item() == 0x7FC0  # a NaN, pinned


@pytest.mark.parametrize("b,n,m,ns,c", [
    (1, 40, 3, 5, 1),     # 8-byte rows, 15 of them: a 120-byte tile
    (2, 70, 5, 3, 2),     # 4-byte feature units, odd row counts
    (1, 90, 7, 9, 5),     # 2-byte feature units, 16-byte rows
    (3, 300, 11, 7, 4),   # 8-byte feature units
    (2, 64, 9, 13, 120),  # 16-byte units, 13 rows a centre
    (1, 50, 4, 3, 2000),  # two stages beyond 48 KB of shared memory
])
def test_group_mlp_input_kernel_ragged_tiles(gpu, b, n, m, ns, c):
    xyz, centres, feats, idx = _mlp_input_case(gpu, c, b, n, m, ns, c,
                                               torch.int64)
    got = group_rows_mlp_input(xyz, centres, feats, idx, 2.5)
    want = group_rows_mlp_input_plain(xyz, centres, feats, idx, 2.5)
    assert torch.equal(_bits(got), _bits(want))
    # a feature base 2 bytes off a 4-byte boundary: 2-byte units
    buf = torch.empty(b * n * c + 1, device=gpu, dtype=torch.bfloat16)
    off = buf[1:].view(b, n, c)
    off.copy_(feats)
    assert off.data_ptr() % 4 == 2
    got = group_rows_mlp_input(xyz, centres, off, idx, 2.5)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_group_mlp_input_launches_one_kernel_and_no_copy(gpu, idx_dtype):
    """A strided cloud, bf16 features and either index type: one kernel,
    no cast or copy before it."""
    xyz, centres, feats, idx = _mlp_input_case(gpu, 3, 2, 3000, 64, 32, 3,
                                               idx_dtype)
    assert not xyz.is_contiguous()
    got = {}
    kernels = _cuda_kernels(lambda: got.update(o=group_rows_mlp_input(
        xyz, centres, feats, idx, 5.0)))
    assert len(kernels) == 1 and \
        "group_gather_mlp_input_kernel" in kernels[0][0], kernels


def test_group_mlp_input_gradient_is_the_eager_chains(gpu):
    """The features' gradient on the card: K5 over the cotangent's
    channels 3:, bit-equal to autograd through the eager chain on the CPU;
    the cloud needs none, so K5 runs once."""
    xyz, centres, feats, idx = _mlp_input_case(gpu, 9, 2, 2048, 256, 32,
                                               128, torch.int32)
    xyz = torch.nan_to_num(xyz.contiguous())
    feats = torch.nan_to_num(feats.float()).to(torch.bfloat16)
    centres = torch.nan_to_num(centres)
    ct = torch.randn(2, 256, 32, 131, device=gpu).to(torch.bfloat16)
    f = feats.clone().requires_grad_()
    before = _cuda.LAUNCHES["scatter"]
    group_points_mlp_input(xyz, centres, f, idx, 2.5).backward(ct)
    assert _cuda.LAUNCHES["scatter"] == before + 1
    fc = feats.cpu().requires_grad_()
    gx, gf = group_points_split(xyz.cpu(), fc, idx.cpu())
    chain = torch.cat([(gx - centres.cpu()[:, :, None, :]) * 2.5, gf], -1)
    chain.to(torch.bfloat16).backward(ct.cpu())
    assert f.grad.dtype == torch.bfloat16
    assert torch.equal(_bits(f.grad.cpu()), _bits(fc.grad))


# --------------------------------------------------------------- assignment

@pytest.mark.parametrize("count_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("m,g,q,layout", [
    (56, 132, 256, "view"),  # a training step's loss at B = 8
    (84, 16, 32, "view"),  # the probe's: B = 12, 32 queries
    (8, 300, 256, "view"),  # more targets than queries
    (6, 5, 1000, "contiguous"),  # 32 columns a lane, R = 2
    (5, 40, 32, "contiguous"),  # more valid rows than columns
    (4, 132, 256, "contiguous"),
])
def test_assignment_kernel_bit_equal(gpu, count_dtype, m, g, q, layout):
    rng = np.random.RandomState(m * g + q)
    cost = torch.from_numpy(rng.rand(m, q, g).astype(np.float32))
    cost[0, 1, 2] = float("nan")
    cost[-1, :, 0] = float("inf")
    cost = cost.transpose(1, 2)
    if layout == "contiguous":
        cost = cost.contiguous()
    n_valid = torch.from_numpy(rng.randint(0, g + 1, m)).to(count_dtype)
    n_valid[0] = g
    want = batched_linear_sum_assignment_plain(cost, n_valid)
    before = _cuda.LAUNCHES["assignment"]
    got = batched_linear_sum_assignment(cost.to(gpu), n_valid.to(gpu))
    assert _cuda.LAUNCHES["assignment"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", ["none", "one", "R", "R+1", "all", "nan",
                                  "all_tied", "more_targets"])
def test_assignment_kernel_at_the_staged_rows(gpu, case):
    """The warp kernel around its slice: n_valid 0, 1, R (every valid row
    staged in shared memory), R + 1 (one row read from device memory) and
    min(G, Q), NaN and infinite costs, every cost tied, more targets than
    queries (G 300 > Q 256): bit-equal to the plain version on the CPU, as
    the matcher hands the costs over (a transposed view, int64 counts). R
    is the kernel's own, from its C entry."""
    G, Q, M = (300, 256, 6) if case == "more_targets" else (132, 256, 12)
    R = int(_cuda.lib("assignment").assignment_staged_rows(G, Q))
    rng = np.random.RandomState(len(case))
    cost_mqg = torch.from_numpy(rng.rand(M, Q, G).astype(np.float32))
    counts = {"none": 0, "one": 1, "R": R, "R+1": R + 1, "all": min(G, Q),
              "nan": R + 1, "all_tied": R + 1, "more_targets": min(G, Q)}
    n_valid = torch.full((M,), counts[case], dtype=torch.int64)
    n_valid[0] = min(G, Q) if case in ("nan", "all_tied") else n_valid[0]
    n_valid[1] = R if case in ("nan", "all_tied") else n_valid[1]
    if case == "nan":
        cost_mqg[0, 3, :] = float("nan")
        cost_mqg[1, :, R] = float("inf")
        cost_mqg[2] = float("nan")
        cost_mqg[3, 5, 2] = -float("inf")
    if case == "all_tied":
        cost_mqg.fill_(0.5)
    if case == "all":
        M = 3  # the plain version's full solve takes seconds
        cost_mqg, n_valid = cost_mqg[:M], n_valid[:M]
    cost = cost_mqg.transpose(1, 2)
    want = batched_linear_sum_assignment_plain(cost, n_valid)
    before = _cuda.LAUNCHES["assignment"]
    got = batched_linear_sum_assignment(cost.to(gpu), n_valid.to(gpu))
    assert _cuda.LAUNCHES["assignment"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


def test_assignment_kernel_ties_and_empty_matrices(gpu):
    cost = torch.full((4, 132, 256), 0.5)
    cost[1, :, 1::2] = 0.25
    n_valid = torch.tensor([132, 77, 1, 0])
    got = batched_linear_sum_assignment(cost.to(gpu), n_valid.to(gpu))
    assert torch.equal(got.cpu(),
                       batched_linear_sum_assignment_plain(cost, n_valid))
    assert int(got[3].abs().max()) == 0


def test_assignment_launches_one_kernel_and_never_syncs(gpu):
    """The matcher's call: a transposed view and int64 counts, read as
    they are (one kernel, no copy or cast), with no synchronisation."""
    cost = torch.rand(56, 256, 132, device=gpu).transpose(1, 2)
    n_valid = torch.full((56,), 6, device=gpu, dtype=torch.int64)
    batched_linear_sum_assignment(cost, n_valid)  # built and loaded

    def call():
        torch.cuda.set_sync_debug_mode("error")
        try:
            batched_linear_sum_assignment(cost, n_valid)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    kernels = _cuda_kernels(call)
    assert len(kernels) == 1 and "assignment_kernel" in kernels[0][0], \
        kernels


def test_assignment_refuses_what_the_kernel_does_not_take(gpu):
    before = _cuda.LAUNCHES["assignment"]
    with pytest.raises(ValueError, match="1024"):
        batched_linear_sum_assignment(torch.zeros(1, 2, 1025, device=gpu),
                                      torch.ones(1, device=gpu,
                                                 dtype=torch.int32))
    assert _cuda.LAUNCHES["assignment"] == before
    with pytest.raises(ValueError, match="lies on"):
        batched_linear_sum_assignment(torch.zeros(1, 2, 4, device=gpu),
                                      torch.ones(1, dtype=torch.int32))


def test_hungarian_loss_never_syncs(gpu):
    """compute_hungarian_loss on the card (soft-token and label costs):
    no operation makes the host wait, the matching included; one
    assignment launch and one matched-box gather for all prefixes, and
    one scatter-add in the backward."""
    from butd_detr_tpu_torch.losses import (
        CriterionConfig,
        compute_hungarian_loss,
    )

    g = torch.Generator().manual_seed(0)
    B, Q, G, L, K, N, layers = 3, 24, 7, 14, 40, 200, 3
    mask = (torch.arange(G)[None] < torch.tensor([[4], [7], [1]])).float()
    text_mask = (torch.arange(L)[None] < torch.tensor([[9], [14], [6]]))
    unit = lambda *s: torch.nn.functional.normalize(
        torch.randn(*s, generator=g), dim=-1)
    ep = {
        "center_label": torch.rand(B, G, 3, generator=g) * 3,
        "size_gts": torch.rand(B, G, 3, generator=g) * 0.5 + 0.2,
        "sem_cls_label": torch.randint(0, 256, (B, G), generator=g),
        "box_label_mask": mask,
        "positive_map": torch.rand(B, G, 256, generator=g) * mask[..., None],
        "text_mask": text_mask.int(),
        "point_instance_label": torch.randint(-1, G, (B, N), generator=g),
        "seed_inds": torch.randint(0, N, (B, K), generator=g),
        "seed_xyz": torch.rand(B, K, 3, generator=g) * 3,
        "seeds_obj_cls_logits": torch.randn(B, K, generator=g),
        "proj_tokens": unit(B, L, 64),
    }
    for p in ["proposal_", "0head_", "1head_", "last_"]:
        ep[p + "center"] = torch.rand(B, Q, 3, generator=g) * 3
        ep[p + "pred_size"] = torch.rand(B, Q, 3, generator=g) * 0.6 + 0.1
        ep[p + "sem_cls_scores"] = torch.randn(B, Q, 256, generator=g)
        ep[p + "proj_queries"] = unit(B, Q, 64)
    ep = {k: v.to(gpu) for k, v in ep.items()}
    for k in ep:
        if k.endswith(("center", "pred_size", "sem_cls_scores",
                       "proj_queries")):
            ep[k].requires_grad_()
    for soft_token in (True, False):
        cfg = CriterionConfig(use_soft_token=soft_token)
        compute_hungarian_loss(dict(ep), layers, cfg, 4)[0].backward()  # warm
        torch.cuda.synchronize()
        before = dict(_cuda.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss, _ = compute_hungarian_loss(dict(ep), layers, cfg, 4)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launched = {k: _cuda.LAUNCHES[k] - before.get(k, 0)
                    for k in ("assignment", "gather", "scatter")}
        assert launched == {"assignment": 1, "gather": 1, "scatter": 0}
        loss.backward()
        assert _cuda.LAUNCHES["scatter"] - before.get("scatter", 0) == 1
        assert torch.isfinite(loss).item()

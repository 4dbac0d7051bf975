"""Plain PyTorch versions of the point-cloud and attention operations, in
float32, for the benchmark's reference model.

A frozen copy of the plain paths of `butd_detr_tpu_torch/ops/`, imported
from nothing of the program: furthest-point sampling and the ball query
with the reference's order of rounded products and sums (so that their
indices are the ones the program's kernels promise), gathers by
`torch.gather` (autograd gives their gradients), and attention as
softmax(s Q K^T) V over materialised probabilities, with the dropout mask
of Philox4x32-10 keyed by the call's seed and counted by (batch * heads +
head, query row, key // 4), the program's mask bit for bit.
"""

import numpy as np
import torch
import torch.distributed as dist

FINFO_MIN = torch.finfo(torch.float32).min


class _SumOverRanks(torch.autograd.Function):
    """The sum over a process group; every rank's result feeds every
    rank's loss, so the backward sums the gradients over the group too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """`torch.distributed.all_reduce` of `x` over `group`, differentiable."""
    return _SumOverRanks.apply(x, group)


def _sqnorm3(dx, dy, dz):
    return (dx * dx + dy * dy) + dz * dz


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int64: index 0 first, running distance
    from 1e10, points with |p|^2 <= 1e-3 never chosen, ties to the lower
    index."""
    xyz = xyz.float()
    B, N, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    valid = _sqnorm3(x, y, z) > 1e-3
    temp = torch.where(valid, torch.full_like(x, 1e10),
                       torch.full_like(x, -1.0))
    out = torch.zeros(B, npoint, dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    old = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        c = xyz[rows, old]
        d = _sqnorm3(x - c[:, 0:1], y - c[:, 1:2], z - c[:, 2:3])
        temp = torch.minimum(temp, d)
        old = torch.argmax(temp, dim=1)
        out[:, j] = old
    return out


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, m, 3) -> (B, m, nsample) int64: the first `nsample`
    points in index order with d^2 < f32(radius^2), a short row padded with
    its first hit, a row with none all 0."""
    xyz, new_xyz = xyz.float(), new_xyz.float()
    B, N, _ = xyz.shape
    m = new_xyz.shape[1]
    r2 = float(np.float32(float(radius) * float(radius)))
    k = min(nsample, N)
    keys = torch.arange(N, device=xyz.device)
    chunk = max(1, (1 << 24) // max(1, B * N))
    out = torch.zeros(B, m, nsample, dtype=torch.long, device=xyz.device)
    slot = torch.arange(nsample, device=xyz.device)
    for c0 in range(0, m, chunk):
        cen = new_xyz[:, c0:c0 + chunk]
        d2 = _sqnorm3(cen[:, :, None, 0] - xyz[:, None, :, 0],
                      cen[:, :, None, 1] - xyz[:, None, :, 1],
                      cen[:, :, None, 2] - xyz[:, None, :, 2])
        hit = d2 < r2
        first_k = torch.topk(torch.where(hit, keys, N), k, dim=-1,
                             largest=False, sorted=True).values
        if k < nsample:
            first_k = torch.cat([first_k, first_k.new_full(
                (*first_k.shape[:2], nsample - k), N)], -1)
        nfound = hit.sum(-1, keepdim=True).clamp(max=nsample)
        first = torch.where(nfound > 0, first_k[..., :1],
                            torch.zeros_like(first_k[..., :1]))
        out[:, c0:c0 + chunk] = torch.where(slot < nfound, first_k, first)
    return out


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, j...] = points[b, idx[b, j...]]: (B, N, C), (B, ...) ->
    (B, ..., C)."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """Three nearest known points: (distances (B, n, 3), indices)."""
    u, k = unknown.float(), known.float()
    d2 = _sqnorm3(u[:, :, None, 0] - k[:, None, :, 0],
                  u[:, :, None, 1] - k[:, None, :, 1],
                  u[:, :, None, 2] - k[:, None, :, 2])
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return torch.sqrt(torch.clamp_min(vals[..., :3], 0.0)), idx[..., :3]


def three_interpolate(features, idx, weight):
    g = gather_points(features, idx)  # (B, n, 3, C)
    return torch.einsum("bnt,bntc->bnc", weight, g)


# ------------------------------------------------------------ attention

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    t0 = b * (a & 0xFFFF)
    t1 = b * (a >> 16) + (t0 >> 16)
    return t1 >> 16, ((t1 & 0xFFFF) << 16) | (t0 & 0xFFFF)


def philox4x32(counter, seed: int):
    """Philox4x32-10 of four int64 tensors of uint32 values."""
    c0, c1, c2, c3 = counter
    k0, k1 = seed & _U32, (seed >> 32) & _U32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
    return c0, c1, c2, c3


def dropout_keep_mask(seed: int, B: int, H: int, Lq: int, Lk: int, p: float,
                      device) -> torch.Tensor:
    """(B, H, Lq, Lk) bool, True == kept, built a block of heads at a time
    so that the int64 words stay small."""
    threshold = min(int(p * 2.0 ** 32), 2 ** 32 - 1)
    groups = (Lk + 3) // 4
    keep = torch.empty(B * H, Lq, Lk, dtype=torch.bool, device=device)
    step = max(1, (1 << 24) // max(1, Lq * groups))
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    for h0 in range(0, B * H, step):
        n = min(step, B * H - h0)
        bh = (h0 + ar(n))[:, None, None].expand(n, Lq, groups)
        row = ar(Lq)[None, :, None].expand(n, Lq, groups)
        grp = ar(groups)[None, None, :].expand(n, Lq, groups)
        bits = torch.stack(philox4x32(
            (grp, row, bh, torch.zeros_like(grp)), seed), dim=-1)
        keep[h0:h0 + n] = bits.reshape(n, Lq, groups * 4)[:, :, :Lk] \
            >= threshold
    return keep.reshape(B, H, Lq, Lk)


def attention(q, k, v, key_padding_mask=None, *, sm_scale=1.0,
              dropout_p=0.0, seed=None):
    """(B, H, Lq, Dh), (B, H, Lk, Dh) x2, (B, Lk) True == PAD -> (B, H, Lq,
    Dh) in f32; padded keys score FINFO_MIN; dropout on the normalised
    probabilities, the kept ones scaled by f32(1 / (1 - p))."""
    q, k, v = q.float(), k.float(), v.float()
    s = torch.einsum("bhqd,bhkd->bhqk", q * sm_scale, k)
    if key_padding_mask is not None:
        s = s.masked_fill(key_padding_mask[:, None, None, :].bool(),
                          FINFO_MIN)
    p = torch.softmax(s, dim=-1)
    if dropout_p > 0.0:
        B, H, Lq, Lk = p.shape
        keep = dropout_keep_mask(int(seed), B, H, Lq, Lk, dropout_p,
                                 q.device)
        inv = float(np.float32(1.0 / (1.0 - dropout_p)))
        p = torch.where(keep, p * inv, torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p, v)

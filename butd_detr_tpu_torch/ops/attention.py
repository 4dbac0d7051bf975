"""Attention forward and backward: the CUDA kernels (csrc/attention.cu,
csrc/attention_bwd.cu) and their plain PyTorch versions.

Counterpart of the TPU kernels of `butd_detr_tpu/ops/pallas_attention.py`
(`_attend_fwd`, `_attend_bwd` behind `fused_attention`):
softmax(sm_scale * Q K^T) V with torch key-padding semantics (padded keys
get FINFO_MIN, so a fully masked row is uniform over its keys) and dropout
on the normalized probabilities. Two modes, as there:
  * default: q is scaled in f32 and rounded to bf16, k and v are rounded to
    bf16, scores and softmax are f32, and the normalized (and dropped) P is
    rounded to bf16 before P V, which accumulates in f32; the backward
    rounds dO, dS and D o P to bf16 before their products;
  * precise: f32 throughout.
The kernels differ by mode: the default mode's products (two in the
forward, five in the backward) run on the tensor cores (bf16 x bf16 -> f32
mma, csrc/mma.cuh), the precise mode's on CUDA cores in f32. The mode is
the caller's `precise`. The default mode's kernels read bf16 q, k, v (and
dO) as they are, as the bf16 model (`--use_bf16`) hands them over, and
f32 operands otherwise: the same values give the same bits either way.
The outputs are f32 in both, as the TPU kernel's; the precise mode widens
bf16 operands to f32.

Dropout keeps an entry iff its random uint32 >= min(int(p * 2^32),
2^32 - 1) and scales the kept entries by 1 / (1 - p). The bits are
Philox4x32-10 keyed by a 64-bit seed and counted by the absolute position
(batch * heads + head, query row, key // 4), so the forward and the backward
regenerate one mask from the seed, whatever their tiling. `philox4x32` is the
same generator in PyTorch integer arithmetic: the CPU path draws its mask
from it, bit for bit the mask of the kernels. The TPU's random bits are other
bits; the two packages are compared at p = 0 or through an explicit mask.

`attention` is one `torch.autograd.Function` over both kernels; it saves
q, k, v, the padding mask and the seed, nothing else, and returns the
gradients in the operands' dtype. A call with nothing to differentiate
launches the forward without it.
"""

from typing import Optional

import numpy as np
import torch

from butd_detr_tpu_torch.ops import _cuda

FINFO_MIN = torch.finfo(torch.float32).min
MAX_HEAD_DIM = 64


def _operand(x: torch.Tensor, precise: bool) -> torch.Tensor:
    return x if precise else x.to(torch.bfloat16).float()


# ------------------------------------------------------------- dropout mask

def dropout_threshold(p: float) -> int:
    """Entries whose uint32 bits are below this are dropped."""
    return min(int(p * 2.0 ** 32), 2 ** 32 - 1)


def _inv_keep(p: float) -> float:
    return float(np.float32(1.0 / (1.0 - p)))


_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of a * b for a constant a < 2^32 and an
    int64 tensor b of values < 2^32, without leaving int64."""
    t0 = b * (a & 0xFFFF)
    t1 = b * (a >> 16) + (t0 >> 16)
    return t1 >> 16, ((t1 & 0xFFFF) << 16) | (t0 & 0xFFFF)


def philox4x32(counter, seed: int):
    """Philox4x32-10 of a 4-tuple of int64 tensors (values < 2^32) under a
    64-bit seed: four int64 tensors of uint32 values. The function of
    csrc/common.cuh:philox4x32_10."""
    c0, c1, c2, c3 = counter
    k0, k1 = seed & _U32, (seed >> 32) & _U32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _U32, (k1 + _PHILOX_W1) & _U32
    return c0, c1, c2, c3


def dropout_keep_mask_plain(seed: int, B: int, H: int, Lq: int, Lk: int,
                            p: float, device="cpu") -> torch.Tensor:
    """(B, H, Lq, Lk) bool, True == kept: the mask of (seed, p), computed
    with `philox4x32` in plain tensor arithmetic."""
    groups = (Lk + 3) // 4
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    bh = ar(B * H)[:, None, None].expand(B * H, Lq, groups)
    row = ar(Lq)[None, :, None].expand(B * H, Lq, groups)
    grp = ar(groups)[None, None, :].expand(B * H, Lq, groups)
    bits = torch.stack(philox4x32((grp, row, bh, torch.zeros_like(grp)),
                                  seed), dim=-1)
    keep = bits.reshape(B * H, Lq, groups * 4)[:, :, :Lk] \
        >= dropout_threshold(p)
    return keep.reshape(B, H, Lq, Lk)


def dropout_keep_mask(seed: int, B: int, H: int, Lq: int, Lk: int, p: float,
                      device="cpu") -> torch.Tensor:
    """The keep mask that `attention(..., dropout_p=p, seed=seed)` applies:
    the plain generator on the CPU, the kernels' own mask writer on CUDA."""
    device = torch.device(device)
    if device.type == "cpu":
        return dropout_keep_mask_plain(seed, B, H, Lq, Lk, p)
    keep = torch.empty(B, H, Lq, Lk, dtype=torch.uint8, device=device)
    _cuda.launch("attention_dropout_mask_launch", keep.get_device(),
                 keep.data_ptr(), B * H, Lq, Lk, dropout_threshold(p),
                 int(seed) & (2 ** 64 - 1), count=False)
    return keep.bool()


# ------------------------------------------------------------ plain versions

def _probabilities(qf, kf, key_padding_mask):
    s = torch.matmul(qf, kf.transpose(-1, -2))
    if key_padding_mask is not None:
        s = s.masked_fill(key_padding_mask[:, None, None, :], FINFO_MIN)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def attention_plain(q, k, v, key_padding_mask=None, *, sm_scale=1.0,
                    precise=False, keep_mask=None, dropout_p=0.0):
    """(B, H, Lq, Dh), (B, H, Lk, Dh) x2, (B, Lk) bool True == PAD ->
    (B, H, Lq, Dh) float32, in the kernel's order of operations.
    `keep_mask` (B, H, Lq, Lk) bool with `dropout_p` applies dropout."""
    qf = _operand(q.float() * sm_scale, precise)
    kf = _operand(k.float(), precise)
    vf = _operand(v.float(), precise)
    p = _probabilities(qf, kf, key_padding_mask)
    if keep_mask is not None:
        p = p * (keep_mask.float() * _inv_keep(dropout_p))
    return torch.matmul(_operand(p, precise), vf)


def attention_backward_plain(q, k, v, dout, key_padding_mask=None, *,
                             sm_scale=1.0, precise=False, keep_mask=None,
                             dropout_p=0.0):
    """(dq, dk, dv) of `attention_plain` for the cotangent `dout`, float32,
    written out in the backward kernel's order of operations and rounding
    (pallas_attention.py:110-143): P is recomputed and stays f32; dO, dS
    and D o P are rounded to bf16 before their products unless `precise`;
    dq is the gradient of the caller's unscaled q."""
    qf = _operand(q.float() * sm_scale, precise)
    kf = _operand(k.float(), precise)
    vf = _operand(v.float(), precise)
    dof = _operand(dout.float(), precise)
    p = _probabilities(qf, kf, key_padding_mask)
    dpt = torch.matmul(dof, vf.transpose(-1, -2))
    dp_eff = p
    if keep_mask is not None:
        d = keep_mask.float() * _inv_keep(dropout_p)
        dpt = d * dpt
        dp_eff = d * p
    ds = p * (dpt - (dpt * p).sum(dim=-1, keepdim=True))
    ds = _operand(ds, precise)
    dp_eff = _operand(dp_eff, precise)
    dq = torch.matmul(ds, kf) * sm_scale
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(dp_eff.transpose(-1, -2), dof)
    return dq, dk, dv


# --------------------------------------------------------- kernel wrappers

def _unit_stride(t: torch.Tensor) -> torch.Tensor:
    if t.dtype is not torch.float32:
        t = t.float()
    return t if t.stride(-1) == 1 else t.contiguous()


def _kernel_operands(precise, *ts):
    """(bf16, operands) as the kernels read them: bf16 operands pass as
    they are to the default mode's kernels (the bf16 model's), any other
    mix, and every operand of the precise mode, are widened to f32."""
    bf16 = not precise and all(t.dtype is torch.bfloat16 for t in ts)
    if not bf16:
        return False, [_unit_stride(t) for t in ts]
    return True, [t if t.stride(-1) == 1 else t.contiguous() for t in ts]


def _pad_bytes(key_padding_mask, device):
    """The padding mask as one byte a key, nonzero == padded: a contiguous
    bool mask on the device is that already (no cast kernel)."""
    if key_padding_mask is None:
        return None
    m = key_padding_mask
    if m.dtype is not torch.bool and m.dtype is not torch.uint8:
        m = m.to(torch.uint8)
    return m.to(device).contiguous()


def _heads_buffer(B, H, L, Dh, device):
    """A (B, H, L, Dh) view of a new (B, L, H, Dh) buffer: what the
    multi-head wrapper reshapes to (B, L, H * Dh) without a copy."""
    return torch.empty_strided((B, H, L, Dh), (L * H * Dh, Dh, H * Dh, 1),
                               dtype=torch.float32, device=device)


def _dropout_args(dropout_p, seed):
    if dropout_p <= 0.0:
        return 0, 1.0, 0
    return (dropout_threshold(dropout_p), _inv_keep(dropout_p),
            int(seed) & (2 ** 64 - 1))


def _forward_cuda(q, k, v, key_padding_mask, sm_scale, dropout_p, seed,
                  precise):
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    bf16, (q, k, v) = _kernel_operands(precise, q, k, v)
    out = _heads_buffer(B, H, Lq, Dh, q.device)
    pad = _pad_bytes(key_padding_mask, q.device)
    _cuda.launch(
        "attention_fwd_launch", q.get_device(),
        q.data_ptr(), *q.stride()[:3],
        k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3],
        0 if pad is None else pad.data_ptr(),
        out.data_ptr(), *out.stride()[:3],
        B, H, Lq, Lk, Dh, float(sm_scale), int(bool(precise)), int(bf16),
        *_dropout_args(dropout_p, seed))
    return out


def _backward_cuda(q, k, v, dout, key_padding_mask, sm_scale, dropout_p,
                   seed, precise):
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    if not precise and q.dtype is torch.bfloat16 \
            and dout.dtype is not torch.bfloat16:
        # the kernels round dO to bf16 on load: with bf16 operands it is
        # read in their type, as the TPU wrapper casts it (_attend_bwd)
        dout = dout.to(torch.bfloat16)
    bf16, (q, k, v, dout) = _kernel_operands(precise, q, k, v, dout)
    dq = _heads_buffer(B, H, Lq, Dh, q.device)
    dk = _heads_buffer(B, H, Lk, Dh, q.device)
    dv = _heads_buffer(B, H, Lk, Dh, q.device)
    # per query row: max, sum and rowsum(dPt o P), from the dQ kernel to
    # the dK/dV kernel
    stats = torch.empty(B * H, Lq, 3, dtype=torch.float32, device=q.device)
    # the dropout mask, 1 bit a (row, key), drawn once by the dQ kernel of
    # the default mode and read back by its second walk and the dK/dV kernel
    keep_bits = None
    if dropout_p > 0.0 and not precise:
        keep_bits = torch.empty(B * H, Lq, (Lk + 31) // 32,
                                dtype=torch.int32, device=q.device)
    pad = _pad_bytes(key_padding_mask, q.device)
    _cuda.launch(
        "attention_bwd_launch", q.get_device(),
        q.data_ptr(), *q.stride()[:3],
        k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3],
        0 if pad is None else pad.data_ptr(),
        dout.data_ptr(), *dout.stride()[:3],
        dq.data_ptr(), *dq.stride()[:3],
        dk.data_ptr(), *dk.stride()[:3],
        dv.data_ptr(), *dv.stride()[:3],
        stats.data_ptr(), 0 if keep_bits is None else keep_bits.data_ptr(),
        B, H, Lq, Lk, Dh, float(sm_scale),
        int(bool(precise)), int(bf16), *_dropout_args(dropout_p, seed))
    return dq, dk, dv


def _keep_mask_cpu(q, k, dropout_p, seed):
    if dropout_p <= 0.0:
        return None
    return dropout_keep_mask_plain(seed, *q.shape[:3], k.shape[2], dropout_p)


def _check_shapes(q, k, v, key_padding_mask):
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, Dh) or v.shape != k.shape:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "do not form (B, H, L, Dh) triples")
    if not 1 <= Dh <= MAX_HEAD_DIM or Lk < 1:
        raise ValueError(f"need 1 <= Dh <= {MAX_HEAD_DIM} and Lk >= 1, got "
                         f"Dh={Dh}, Lk={Lk}")
    if key_padding_mask is not None and key_padding_mask.shape != (B, Lk):
        raise ValueError(f"key_padding_mask must be (B, Lk) = {(B, Lk)}, "
                         f"got {tuple(key_padding_mask.shape)}")


def attention_backward(q, k, v, dout, key_padding_mask=None, *,
                       sm_scale: float = 1.0, dropout_p: float = 0.0,
                       seed: Optional[int] = None, precise: bool = False):
    """(dq, dk, dv), float32, of `attention` at the same arguments for the
    cotangent `dout` (B, H, Lq, Dh); the dropout mask is regenerated from
    `seed`. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernels (or raises)."""
    if dropout_p > 0.0 and seed is None:
        raise ValueError("dropout_p > 0 needs a seed")
    if q.device.type == "cpu":
        return attention_backward_plain(
            q, k, v, dout, key_padding_mask, sm_scale=sm_scale,
            precise=precise, keep_mask=_keep_mask_cpu(q, k, dropout_p, seed),
            dropout_p=dropout_p)
    _cuda.require_cuda(q, "attention_backward")
    _check_shapes(q, k, v, key_padding_mask)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} is not q's shape "
                         f"{tuple(q.shape)}")
    return _backward_cuda(q, k, v, dout, key_padding_mask, sm_scale,
                          dropout_p, seed, precise)


def _attention_forward(q, k, v, key_padding_mask, sm_scale, dropout_p, seed,
                       precise):
    if q.device.type == "cpu":
        return attention_plain(
            q, k, v, key_padding_mask, sm_scale=sm_scale, precise=precise,
            keep_mask=_keep_mask_cpu(q, k, dropout_p, seed),
            dropout_p=dropout_p)
    _cuda.require_cuda(q, "attention")
    _check_shapes(q, k, v, key_padding_mask)
    return _forward_cuda(q, k, v, key_padding_mask, sm_scale, dropout_p,
                         seed, precise)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, sm_scale, dropout_p, seed,
                precise):
        ctx.save_for_backward(q, k, v, key_padding_mask)
        ctx.args = (sm_scale, dropout_p, seed, precise)
        return _attention_forward(q, k, v, key_padding_mask, sm_scale,
                                  dropout_p, seed, precise)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_padding_mask = ctx.saved_tensors
        sm_scale, dropout_p, seed, precise = ctx.args
        dq, dk, dv = attention_backward(
            q, k, v, dout, key_padding_mask, sm_scale=sm_scale,
            dropout_p=dropout_p, seed=seed, precise=precise)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_padding_mask: Optional[torch.Tensor] = None, *,
              sm_scale: float = 1.0, dropout_p: float = 0.0,
              seed: Optional[int] = None,
              precise: bool = False) -> torch.Tensor:
    """softmax(sm_scale * Q K^T) V over (B, H, L, Dh) views of any strides,
    f32 or bf16. Returns (B, H, Lq, Dh) float32 (a view of a (B, Lq, H, Dh)
    buffer on CUDA). Differentiable in q, k and v.

    `dropout_p` > 0 drops normalized probabilities by the mask of the 64-bit
    `seed` (`dropout_keep_mask` returns that mask). A CPU tensor takes the
    plain versions; a CUDA tensor launches the kernels (or raises)."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must lie in [0, 1), got {dropout_p}")
    if dropout_p > 0.0 and seed is None:
        raise ValueError("dropout_p > 0 needs a seed")
    args = (float(sm_scale), float(dropout_p), seed, bool(precise))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, key_padding_mask, *args)
    # nothing to differentiate (serving, evaluation, the frozen text
    # tower): no autograd node, whose bookkeeping costs a small call more
    # host time than its kernel takes
    return _attention_forward(q, k, v, key_padding_mask, *args)

"""Attention forward: the CUDA kernel (csrc/attention.cu) and its plain
PyTorch version.

Counterpart of the TPU kernel `butd_detr_tpu/ops/pallas_attention.py:
fused_attention` (forward, `_fwd_kernel`): softmax(sm_scale * Q K^T) V with
torch key-padding semantics (padded keys get FINFO_MIN, so a fully masked
row is uniform over its keys). Two modes, as there:
  * default: q is scaled in f32 and rounded to bf16, k and v are rounded to
    bf16, scores and softmax are f32, and the normalized P is rounded to
    bf16 before P V, which accumulates in f32;
  * precise: f32 throughout.
Dropout (training) is not part of this slice: `dropout_p > 0` raises.
"""

from typing import Optional

import torch

from butd_detr_tpu_torch.ops import _cuda

FINFO_MIN = torch.finfo(torch.float32).min
MAX_HEAD_DIM = 64


def _operand(x: torch.Tensor, precise: bool) -> torch.Tensor:
    return x if precise else x.to(torch.bfloat16).float()


def attention_plain(q, k, v, key_padding_mask=None, *, sm_scale=1.0,
                    precise=False):
    """(B, H, Lq, Dh), (B, H, Lk, Dh) x2, (B, Lk) bool True == PAD ->
    (B, H, Lq, Dh) float32, in the kernel's order of operations."""
    qf = _operand(q.float() * sm_scale, precise)
    kf = _operand(k.float(), precise)
    vf = _operand(v.float(), precise)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    if key_padding_mask is not None:
        s = s.masked_fill(key_padding_mask[:, None, None, :], FINFO_MIN)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = _operand(e / e.sum(dim=-1, keepdim=True), precise)
    return torch.matmul(p, vf)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_padding_mask: Optional[torch.Tensor] = None, *,
              sm_scale: float = 1.0, dropout_p: float = 0.0,
              precise: bool = False) -> torch.Tensor:
    """softmax(sm_scale * Q K^T) V over (B, H, L, Dh) views of any strides
    (the head dim must be unit-stride on CUDA). Returns (B, H, Lq, Dh)
    float32 (a view of a (B, Lq, H, Dh) buffer on CUDA).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    if dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet (serving runs with p=0)")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, key_padding_mask,
                               sm_scale=sm_scale, precise=precise)
    _cuda.require_cuda(q, "attention")
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

    def prep(t):
        t = t.float()
        return t if t.stride(-1) == 1 else t.contiguous()

    q, k, v = prep(q), prep(k), prep(v)
    lib = _cuda.lib("attention")
    out = torch.empty(B, Lq, H, Dh, dtype=torch.float32,
                      device=q.device).transpose(1, 2)
    pad = None
    if key_padding_mask is not None:
        pad = key_padding_mask.to(device=q.device, dtype=torch.uint8)
        pad = pad.contiguous()
    with torch.cuda.device(q.device):
        code = lib.attention_fwd_launch(
            _cuda.ptr(q), *q.stride()[:3],
            _cuda.ptr(k), *k.stride()[:3],
            _cuda.ptr(v), *v.stride()[:3],
            None if pad is None else _cuda.ptr(pad),
            _cuda.ptr(out), *out.stride()[:3],
            B, H, Lq, Lk, Dh, float(sm_scale), int(bool(precise)),
            _cuda.stream_of(q))
        _cuda.LAUNCHES["attention"] += 1
    _cuda.check("attention", code)
    return out

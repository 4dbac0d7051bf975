"""Multi-head attention with torch nn.MultiheadAttention semantics and
parameter names (`in_proj_weight`, `in_proj_bias`, `out_proj`).

Counterpart of `butd_detr_tpu/nn/attention.py`: separate q/k/v/out
projections (here slices of the packed in_proj), the attention core in
`ops.attention` (the CUDA kernels for CUDA tensors), key padding with
True == PAD masked by FINFO_MIN. In train mode the attention probabilities
are dropped inside the kernel, by the mask of a seed that the layer's
`DropoutRng` hands out on the host.
"""

import torch
import torch.nn.functional as F
from torch import nn

from butd_detr_tpu_torch.nn.dropout import DropoutRng
from butd_detr_tpu_torch.ops import attention


def multi_head(q, k, v, num_heads, key_padding_mask, *, dropout_p,
               precise, seed=None):
    """Projected (B, L, H*Dh) q/k/v -> attended (B, Lq, H*Dh). `seed` is
    the dropout seed of this call (needed when dropout_p > 0)."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    Dh = D // num_heads
    out = attention(
        q.view(B, Lq, num_heads, Dh).transpose(1, 2),
        k.view(B, Lk, num_heads, Dh).transpose(1, 2),
        v.view(B, Lk, num_heads, Dh).transpose(1, 2),
        key_padding_mask,
        sm_scale=1.0 / (float(Dh) ** 0.5),
        dropout_p=dropout_p,
        seed=seed,
        precise=precise,
    )
    return out.transpose(1, 2).reshape(B, Lq, D)


class MultiheadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 precise: bool = False):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"{d_model} is not divisible by {num_heads}")
        self.d_model = d_model
        self.num_heads = num_heads
        self.dropout = dropout
        self.precise = precise
        self.rng = DropoutRng()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, query, key, value, key_padding_mask=None):
        """(B, Lq, F), (B, Lk, F), (B, Lk, F), (B, Lk) True == PAD."""
        d = self.d_model
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(query, w[:d], b[:d])
        k = F.linear(key, w[d:2 * d], b[d:2 * d])
        v = F.linear(value, w[2 * d:], b[2 * d:])
        p = self.dropout if self.training else 0.0
        out = multi_head(q, k, v, self.num_heads, key_padding_mask,
                         dropout_p=p, precise=self.precise,
                         seed=self.rng.next_seed() if p > 0.0 else None)
        return self.out_proj(out)

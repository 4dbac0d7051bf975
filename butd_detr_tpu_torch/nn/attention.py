"""Multi-head attention with torch nn.MultiheadAttention semantics and
parameter names (`in_proj_weight`, `in_proj_bias`, `out_proj`).

Counterpart of `butd_detr_tpu/nn/attention.py`: separate q/k/v/out
projections (here slices of the packed in_proj), the attention core in
`ops.attention` (the CUDA kernels for CUDA tensors), key padding with
True == PAD masked by FINFO_MIN. In train mode the attention probabilities
are dropped inside the kernel, by the mask of a seed that the layer's
`DropoutRng` hands out on the host.

The projections compute in `dtype` (`nn.mlp.dense`): under bf16 the core
gets bf16 q, k and v, which the kernels read as they are, and its f32
output is cast to bf16 by the out projection, as the JAX module casts the
Pallas kernel's f32 output before `out_proj`.

Under tensor parallelism (`parallel/tp.py`) `mp_group` is set and the
layer holds its rank's shard: q/k/v rows of its H/mp heads (column-
parallel; the inputs' gradients are all-reduced over the group) and the
matching input columns of `out_proj` (row-parallel: the partial products
are all-reduced in f32, the bias added after, in the compute dtype).
"""

import torch
from torch import nn

from butd_detr_tpu_torch.nn.dropout import DropoutRng
from butd_detr_tpu_torch.nn.mlp import Dense, dense, row_parallel_dense
from butd_detr_tpu_torch.ops import attention
from butd_detr_tpu_torch.parallel.collectives import copy_to_group


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
                 precise: bool = False, dtype=torch.float32):
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
        self.out_proj = Dense(d_model, d_model, dtype=dtype)
        self.dtype = dtype
        self.mp_group = None

    def forward(self, query, key, value, key_padding_mask=None):
        """(B, Lq, F), (B, Lk, F), (B, Lk, F), (B, Lk) True == PAD."""
        g, dt = self.mp_group, self.dtype
        d = self.in_proj_weight.shape[0] // 3  # d_model / mp under mp
        w, b = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        q = dense(copy_to_group(query, g), w[:d], b[:d], dt)
        k = dense(copy_to_group(key, g), w[d:2 * d], b[d:2 * d], dt)
        v = dense(copy_to_group(value, g), w[2 * d:], b[2 * d:], dt)
        p = self.dropout if self.training else 0.0
        out = multi_head(q, k, v, self.num_heads * d // self.d_model,
                         key_padding_mask, dropout_p=p, precise=self.precise,
                         seed=self.rng.next_seed() if p > 0.0 else None)
        if g is None:
            return self.out_proj(out)
        return row_parallel_dense(out, self.out_proj.weight,
                                  self.out_proj.bias, dt, g)

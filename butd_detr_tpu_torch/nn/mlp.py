"""Pointwise building blocks, channels-last, with the reference's torch
parameter names and shapes.

Counterpart of `butd_detr_tpu/nn/mlp.py`. A 1x1 convolution over points is
a dense layer applied per point; `PointwiseConv` computes it as one on a
channels-last tensor while keeping the reference's Conv1d/Conv2d weight
shape (out, in, 1[, 1]), so a reference state dict loads unchanged.
BatchNorm runs on the last axis, in f32, with eps 1e-5: in eval with the
running statistics, in train mode with the batch's, updating the running
ones as the JAX package's flax BatchNorm does.

`dense` is the port's flax `nn.Dense(dtype=...)`: the layers of the model
hold f32 parameters and compute in a compute dtype (bf16 under
`--use_bf16`); `Dense` is `nn.Linear` with one, and `LayerNorm` normalizes
in f32 whatever its input's dtype, as the JAX package's LayerNorms
(`dtype=jnp.float32`) do.

Across processes (`parallel/`): a `BatchNorm` whose `group` is set
normalises with the statistics of every rank's rows, and
`row_parallel_dense` is the tensor-parallel half of a split product.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from butd_detr_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    reduce_from_group,
)

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention (flax's 0.9 decay)


def dense(x: torch.Tensor, weight: torch.Tensor, bias=None,
          dtype=None) -> torch.Tensor:
    """x W^T + b in the compute dtype `dtype` (None: x's), the result in
    that dtype: flax `nn.Dense(dtype=dtype)`. x, W and b are cast to it.
    In f32 one `F.linear`; in a narrower dtype the product is rounded to
    it and the bias is added after, in that dtype, as flax does (a bias
    fused into the product would be added before the one rounding)."""
    dtype = x.dtype if dtype is None else dtype
    x, w = x.to(dtype), weight.to(dtype)
    if bias is None:
        return F.linear(x, w)
    if dtype is torch.float32:
        return F.linear(x, w, bias.to(dtype))
    return F.linear(x, w) + bias.to(dtype)


def row_parallel_dense(x: torch.Tensor, weight: torch.Tensor, bias,
                       dtype, group) -> torch.Tensor:
    """`dense` of a product split along its inputs over `group`: x and
    `weight` are this rank's columns; the partial products (rounded to
    `dtype`, as the one product would be) are summed over the group in f32
    and the bias is added after, in `dtype`. The backward passes the
    output's gradient to every rank unchanged."""
    partial = dense(x, weight, None, dtype).float()
    y = reduce_from_group(partial, group).to(dtype)
    return y if bias is None else y + bias.to(dtype)


class Dense(nn.Linear):
    """`nn.Linear` (f32 parameters `weight`, `bias`) computing in
    `dtype` (`dense`)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` over an f32 copy of its input: f32 out of an f32 or
    bf16 input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class PointwiseConv(nn.Module):
    """1x1 convolution as a dense layer over the last axis, computing in
    `dtype` (None: the input's; `dense`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = True, kernel_dims: int = 1, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *([1] * kernel_dims)))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_channels))
        else:
            self.register_parameter("bias", None)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight.flatten(1), self.bias, self.dtype)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last (channel) axis of a channels-last tensor,
    computed in f32 and returned in `dtype` (None: the input's; flax's
    `nn.BatchNorm(dtype=...)`).

    In train mode the batch is normalized with its biased variance, and
    the running average takes that same BIASED variance, as flax's
    `nn.BatchNorm` does; `torch.nn.BatchNorm1d` would store the unbiased
    one (larger by n / (n - 1)). The port is held against the JAX package,
    so the buffers are updated by hand here. The variance is the mean
    squared deviation from the mean (two passes), as `F.batch_norm`
    normalizes with; flax's E[x^2] - E[x]^2 loses digits where the mean is
    large against the spread.

    With a process `group` (the dp group, `parallel.bind_batchnorm`) the
    train-mode statistics are the group's: the mean and then the variance
    from sums over every rank's rows, each all-reduced with a backward
    that sums the gradients too, so each rank's rows get the gradient of
    the global normalisation, as under the JAX package's dp-sharded step."""

    def __init__(self, num_features: int, dtype=None):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.out_dtype = dtype
        self.group = None

    def _update_running(self, mean, var) -> None:
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked += 1

    def _global_forward(self, xf: torch.Tensor) -> torch.Tensor:
        C = xf.shape[-1]
        sums = all_reduce_sum(
            torch.cat([xf.sum(dim=0), xf.new_full((1,), xf.shape[0])]),
            self.group)
        rows = sums[C]
        mean = sums[:C] / rows
        d = xf - mean
        var = all_reduce_sum((d * d).sum(dim=0), self.group) / rows
        self._update_running(mean.detach(), var.detach())
        return d * torch.rsqrt(var + self.eps) * self.weight + self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype if self.out_dtype is None else self.out_dtype
        xf = x.reshape(-1, x.shape[-1]).float()
        if not self.training:
            return super().forward(xf).reshape(x.shape).to(dtype)
        if self.group is not None:
            return self._global_forward(xf).reshape(x.shape).to(dtype)
        with torch.no_grad():
            mean = xf.mean(dim=0)
            var = (xf - mean).square_().mean(dim=0)
        self._update_running(mean, var)
        y = F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        return y.reshape(x.shape).to(dtype)


class _BNWrap(nn.Module):
    """Holds the BatchNorm as `.bn`, the reference's `pt_utils` nesting
    (keys `...bn.bn.weight`)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.bn = BatchNorm(num_features)

    def forward(self, x):
        return self.bn(x)


class _ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_dims: int):
        super().__init__()
        self.conv = PointwiseConv(cin, cout, bias=False,
                                  kernel_dims=kernel_dims)
        self.bn = _BNWrap(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class SharedMLP(nn.Module):
    """Pointwise (1x1 Conv2d + BN + ReLU) stack over the last axis of
    (..., C_in); reference `pt_utils.SharedMLP`, keys `layer{i}.conv` and
    `layer{i}.bn.bn`. `dtype` is the compute dtype of the convs (bf16 for
    the default backbone); BN statistics stay f32."""

    def __init__(self, channels: Sequence[int], dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
            self.add_module(f"layer{i}", _ConvBNReLU(cin, cout, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for layer in self.children():
            x = layer(x)
        return x


class ConvBNRelu1d(_ConvBNReLU):
    """Single pointwise Conv1d + BN + ReLU over (B, N, C); reference
    `pt_utils.Conv1d` with bn=True (keys `conv`, `bn.bn`)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 1)


class BNMomentumScheduler:
    """Epoch-indexed BatchNorm-momentum schedule (reference
    pytorch_utils.BNMomentumScheduler; JAX counterpart nn/mlp.py:86-110):
    `step` evaluates `bn_lambda(epoch)` and sets it as the momentum (torch
    convention: the weight of the new batch) of every BatchNorm of
    `model`. BeaUTyDETR training does not use it (the reference sets 0.1
    once); provided for parity."""

    def __init__(self, model: nn.Module, bn_lambda, last_epoch: int = -1):
        self.model = model
        self.lmbd = bn_lambda
        self.last_epoch = last_epoch

    def step(self, epoch=None) -> float:
        if epoch is None:
            epoch = self.last_epoch + 1
        self.last_epoch = epoch
        momentum = float(self.lmbd(epoch))
        for m in self.model.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.momentum = momentum
        return momentum

    @property
    def momentum(self) -> float:
        return float(self.lmbd(max(self.last_epoch, 0)))

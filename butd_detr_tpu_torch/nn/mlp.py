"""Pointwise building blocks, channels-last, with the reference's torch
parameter names and shapes.

Counterpart of `butd_detr_tpu/nn/mlp.py`. A 1x1 convolution over points is
a dense layer applied per point; `PointwiseConv` computes it as one on a
channels-last tensor while keeping the reference's Conv1d/Conv2d weight
shape (out, in, 1[, 1]), so a reference state dict loads unchanged.
BatchNorm runs on the last axis, in f32, with eps 1e-5: in eval with the
running statistics, in train mode with the batch's, updating the running
ones as the JAX package's flax BatchNorm does.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention (flax's 0.9 decay)


class PointwiseConv(nn.Module):
    """1x1 convolution as a dense layer over the last axis; computes in
    the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = True, kernel_dims: int = 1):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *([1] * kernel_dims)))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_channels))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.flatten(1).to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, w, b)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last (channel) axis of a channels-last tensor,
    computed in f32 and returned in the input's dtype.

    In train mode the batch is normalized with its biased variance, and
    the running average takes that same BIASED variance, as flax's
    `nn.BatchNorm` does; `torch.nn.BatchNorm1d` would store the unbiased
    one (larger by n / (n - 1)). The port is held against the JAX package,
    so the buffers are updated by hand here."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.reshape(-1, x.shape[-1]).float()
        if not self.training:
            return super().forward(xf).reshape(x.shape).to(x.dtype)
        with torch.no_grad():
            mean = xf.mean(dim=0)
            # E[x^2] - E[x]^2, clipped at 0: flax's variance
            var = ((xf * xf).mean(dim=0) - mean * mean).clamp_min(0.0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked += 1
        y = F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        return y.reshape(x.shape).to(x.dtype)


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

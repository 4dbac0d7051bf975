"""The collectives of a training step, as autograd functions.

Three shapes of all-reduce (a sum over a process group) appear in the
port's step, and each has its own backward:

  * `all_reduce_sum`: the BatchNorm statistics over the dp group. Every
    rank's loss depends on the sum, so the gradient of a rank's
    contribution is the sum of every rank's gradient: the backward
    all-reduces too.
  * `reduce_from_group`: a row-parallel product's partial sums over the mp
    group (Megatron's "g"). The mp ranks hold replicas of one loss, so the
    backward passes the gradient through unchanged.
  * `copy_to_group`: the replicated input of a column-parallel product
    (Megatron's "f"): identity forward; each mp rank's gradient covers only
    its columns, so the backward all-reduces.

A group of None is one process: each function is then the identity.
Under gloo a CUDA tensor is reduced through the host; under NCCL on the
device.
"""

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group`; the backward sums the gradients over it too."""
    return x if group is None else _AllReduceSum.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group`; the backward is the identity."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; the backward sums the gradients over `group`."""
    return x if group is None else _CopyToGroup.apply(x, group)

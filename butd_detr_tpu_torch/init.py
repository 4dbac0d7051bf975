"""Seeded random weights for the port's modules.

The released RoBERTa and BUTD-DETR weights are not in the repository, so
the card runs with random weights made here from an explicit
`torch.Generator` on the CPU (the same numbers on every machine), before
the model moves to its device. BatchNorm running statistics are randomized
too, so the eval-mode BN path does real work.
"""

import torch
from torch import nn

from butd_detr_tpu_torch.nn.attention import MultiheadAttention
from butd_detr_tpu_torch.nn.mlp import PointwiseConv


@torch.no_grad()
def init_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and BN statistic of a CPU model from `seed`."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Linear, PointwiseConv)):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=g)
            if m.bias is not None:
                m.bias.normal_(0.0, 0.02, generator=g)
        elif isinstance(m, MultiheadAttention):
            m.in_proj_weight.normal_(0.0, m.d_model ** -0.5, generator=g)
            m.in_proj_bias.normal_(0.0, 0.02, generator=g)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=g)
        elif isinstance(m, nn.LayerNorm):
            m.weight.normal_(1.0, 0.05, generator=g)
            m.bias.normal_(0.0, 0.02, generator=g)
        elif isinstance(m, nn.BatchNorm1d):
            m.weight.normal_(1.0, 0.05, generator=g)
            m.bias.normal_(0.0, 0.02, generator=g)
            m.running_mean.normal_(0.0, 0.1, generator=g)
            m.running_var.uniform_(0.5, 1.5, generator=g)
    return model

"""Seeded random weights, made on the device in a few large calls.

The released RoBERTa and BUTD-DETR weights are not in the repository. The
benchmark draws one normal vector on the device from the run's seed and
cuts every parameter and BatchNorm statistic of the reference model's
state dict out of it, scaled by its module's rule (dense weights by
fan-in^-1/2, small biases, LayerNorm and BatchNorm gains near 1, running
variances in (0.5, 1.5)). Both the program and the reference load this one
state dict; the reference model shares the program's parameter names.
"""

from typing import Dict

import torch
from torch import nn

from benchmark.reference import model as ref


def _rules(model: nn.Module) -> Dict[str, tuple]:
    """{state-dict key: (kind, scale)} by the owning module's type."""
    rules = {}
    for mname, m in model.named_modules():
        pre = mname + "." if mname else ""
        if isinstance(m, (nn.Linear, ref.PointwiseConv)):
            rules[pre + "weight"] = ("normal", m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                rules[pre + "bias"] = ("normal", 0.02)
        elif isinstance(m, ref.MultiheadAttention):
            rules[pre + "in_proj_weight"] = ("normal", m.d_model ** -0.5)
            rules[pre + "in_proj_bias"] = ("normal", 0.02)
        elif isinstance(m, nn.Embedding):
            rules[pre + "weight"] = ("normal", 0.02)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            rules[pre + "weight"] = ("gain", 0.05)
            rules[pre + "bias"] = ("normal", 0.02)
            if isinstance(m, nn.BatchNorm1d):
                rules[pre + "running_mean"] = ("normal", 0.1)
                rules[pre + "running_var"] = ("variance", 0.5)
                rules[pre + "num_batches_tracked"] = ("count", 0)
    return rules


def reference_model(config: Dict, device="meta") -> nn.Module:
    with torch.device(device):
        return ref.BeaUTyDETR(config["model"], config["text_encoder"])


@torch.no_grad()
def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of `config`'s model, on `device`, from `seed`. The
    shapes and rules come from the reference model built on `device` (a
    model on the meta device costs seconds of imports the first time)."""
    model = reference_model(config, device=device)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    rules = _rules(model)
    del model
    missing = sorted(set(shapes) - set(rules))
    if missing:
        raise KeyError(f"no weight rule for {missing[:5]}")
    floats = [k for k in shapes if rules[k][0] != "count"]
    total = sum(shapes[k].numel() for k in floats)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    z = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for k in shapes:
        kind, scale = rules[k]
        if kind == "count":
            out[k] = torch.zeros((), dtype=torch.long, device=device)
            continue
        n = shapes[k].numel()
        x = z[at:at + n].view(shapes[k])
        at += n
        if kind == "normal":
            out[k] = x * scale
        elif kind == "gain":
            out[k] = 1.0 + x * scale
        else:  # a running variance in (1 - scale, 1 + scale)
            out[k] = 1.0 + scale * torch.tanh(x)
    return out
